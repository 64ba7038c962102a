// K4 flash_attention, route A: bf16 grouped-query attention on the tensor
// cores, for calls with more than 16 rows per (batch, KV head) (prefill).
//
//     O[b, i, h] = softmax_j(scale * Q[b, i, h] . K[b, j, h / g]) V[b, j, h / g]
//
// over the keys j < lk_valid that row i may see: with causal masking, j <=
// i + (lk_valid - Lq), the diagonal aligned to the end of the valid keys, and
// with a local window > 0 also j > i + (lk_valid - Lq) - window.  A row that
// sees no key gives 0.  Inputs and output are bf16; the softmax and both
// products accumulate in float32.
//
// Replaces the TPU kernel `_flash_kernel` (repro/kernels/flash_attention.py,
// via `flash_attention_pallas`) on its bf16 prefill calls; the decode calls
// go to flash_decode.cu, float32 prefill to flash_attention.cu.
//
// What bounds it on Hopper: operations.  A causal prefill at Lq = Lk = 1000,
// D = 128 does 4 * D flops per visible (query, key) pair and query head
// against 2 * (Lq + Lk) * D bytes per head, far above the card's ~295 bf16
// flops per byte, so only the tensor cores can come near the bound.
//
// Design (FlashAttention-2's shape on mma.sync):
// - A block takes (batch, KV head, 64 rows).  Rows are (query position, group
//   head) pairs flattened as i * g + h, so every K/V tile serves all g query
//   heads of its KV head.  Each of the 4 warps owns 16 rows and keeps its
//   score tile, its running max and sum and its O accumulator in registers;
//   its Q fragments are read again from shared memory for every key tile.
//   That and 32-key tiles hold a thread to 168 registers, so 3 blocks (12
//   warps) share an SM, where 64-key tiles with Q held in registers took
//   251 registers and 2 blocks: more warps hide the tensor cores' latency.
// - Q.K^T and P.V are `mma.sync.aligned.m16n8k16` with bf16 operands and
//   float32 accumulators; fragments come from shared memory by `ldmatrix`
//   (`.trans` for V).  Products of bf16 values are exact, so Q.K^T matches the
//   TPU kernel's float32 dot up to the order of additions.
// - P stays in registers: its score accumulators are rescaled, exponentiated
//   and packed into the A fragments of P.V.  P is split into a bf16 high part
//   and a bf16 low part (p - hi), and P.V runs once for each, so P keeps ~16
//   bits and the one rounding a single bf16 P would add (up to 2^-9 of each
//   p v term, above the 1e-3 tolerance for rows that see few keys) is gone.
// - K and V tiles (32 keys) stay bf16 in a 2-stage ring of shared memory,
//   filled by 16-byte `cp.async` copies, so the next tile loads while this
//   one computes.  Row pitches are padded by 16 bytes, which makes the 8
//   rows of every `ldmatrix` hit distinct banks.
// - The head dim is zero-padded in shared memory to DP = 16, 32, 64, 128 or
//   256.  Views whose rows are not 16-byte aligned (odd head dims) are copied
//   by plain loads instead of `cp.async`; everything else is the same.  At
//   DP = 256 (recurrentgemma-2b) a warp's 16 x 256 float32 O accumulator is
//   128 registers a thread; Q stays in shared memory as at every DP, and the
//   block takes up to 255 registers, 2 blocks (8 warps) an SM.
// - A local window starts the key loop at the tile that holds the first key
//   of the block's first row's band and skips the tiles wholly left of it, so
//   a banded prefill does O(L * (window + tile)) work, as the reference's
//   `_attention_banded` does; a warp skips a tile wholly left of its own
//   rows' bands, and masks only a tile that straddles a band's left edge.
// - Key tiles wholly past lk_valid or past the causal diagonal of the block's
//   last row are never loaded, a warp skips a tile wholly past its own rows'
//   diagonal, and the element mask is applied only on tiles that straddle a
//   boundary.  Masked scores are -1e30 and give p = 0, so a row that sees no
//   key ends with l = 0 and O = 0.
// - The row block index runs slowest in the grid, heaviest (last, under the
//   causal mask) first, so the short blocks fill the tail.
// - Q, K, V and O take batch, row and head strides (the last axis is
//   contiguous), so a layer's slice of the KV cache is read in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;      // (query position, group head) rows per block
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 128;  // 4 warps of 16 rows
constexpr int MIN_BLOCKS = 3; // blocks an SM for DP <= 128 (<= 168 registers)
constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, the first `bytes` of them read and
// the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// c += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, f32 acc
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as a bf16 pair hi plus the bf16 pair lo of what hi leaves out
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi = as_u32(h);
    lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// one 16-byte chunk (8 values) of a row into shared memory: the first n from
// src, zeros after; `vec` when src is 16-byte aligned
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, int n,
                                           bool vec) {
    if (vec) {
        cp_async16(dst, src, 2 * n);
    } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
            dst[u] = u < n ? src[u] : __float2bfloat16(0.0f);
    }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, DP > 128 ? 2 : MIN_BLOCKS)
flash_attention_mma_kernel(bf16* o, const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, int lq, int lk_valid,
                           int g, int d, int causal, int window,
                           float scale_log2,
                           int hkv, int nrb, int vec,
                           long long sq_b, long long sq_l, long long sq_h,
                           long long sk_b, long long sk_l, long long sk_h,
                           long long sv_b, long long sv_l, long long sv_h,
                           long long so_b, long long so_l, long long so_h) {
    constexpr int PITCH = DP + 8;  // bf16 per shared row: 16 bytes of padding
    constexpr int CH = DP / 8;     // 16-byte chunks per row
    constexpr int KC = DP / 16;    // k16 steps of Q.K^T
    constexpr int NT = DP / 8;     // n8 tiles of O
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][PITCH]
    bf16* ks = qs + ROWS * PITCH;                  // [2][BK][PITCH]
    bf16* vs = ks + 2 * BK * PITCH;                // [2][BK][PITCH]

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int hk = blockIdx.x % hkv;
    const long long b = blockIdx.x / hkv;
    const int r0 = (nrb - 1 - static_cast<int>(blockIdx.y)) * ROWS;
    const int nrows = lq * g;
    const int offset = lk_valid - lq;  // query i sits at key position i + offset
    const int last_row = min(r0 + ROWS, nrows) - 1;
    int kend = lk_valid;
    if (causal) kend = min(kend, last_row / g + offset + 1);
    const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;
    // the first tile the band of the block's first row reaches
    const int t0 = window > 0 ? max(0, r0 / g + offset - window + 1) / BK : 0;

    if (t0 >= ntiles) {  // no row of the block sees a key
        for (int e = tid; e < ROWS * d; e += THREADS) {
            const int gr = r0 + e / d;
            if (gr >= nrows) break;
            const int qi = gr / g, h = hk * g + gr % g;
            o[b * so_b + qi * so_l + h * so_h + e % d] = __float2bfloat16(0.0f);
        }
        return;
    }

    const bf16* kb = k + b * sk_b + hk * sk_h;
    const bf16* vb = v + b * sv_b + hk * sv_h;
    auto load_kv = [&](int t) {
        bf16* kt = ks + (t & 1) * BK * PITCH;
        bf16* vt = vs + (t & 1) * BK * PITCH;
        const int k0 = t * BK;
        for (int e = tid; e < BK * CH; e += THREADS) {
            const int j = e / CH, c = e % CH;
            const int gj = k0 + j;
            const int n = gj < kend ? max(0, min(8, d - 8 * c)) : 0;
            copy_chunk(kt + j * PITCH + 8 * c, n ? kb + gj * sk_l + 8 * c : kb, n,
                       vec);
            copy_chunk(vt + j * PITCH + 8 * c, n ? vb + gj * sv_l + 8 * c : vb, n,
                       vec);
        }
    };

    // the block's Q rows and the first K/V tile: one group
    for (int e = tid; e < ROWS * CH; e += THREADS) {
        const int r = e / CH, c = e % CH;
        const int gr = r0 + r;
        const int n = gr < nrows ? max(0, min(8, d - 8 * c)) : 0;
        const bf16* src = q;
        if (n) {
            const int qi = gr / g, h = hk * g + gr % g;
            src = q + b * sq_b + qi * sq_l + h * sq_h + 8 * c;
        }
        copy_chunk(qs + r * PITCH + 8 * c, src, n, vec);
    }
    load_kv(t0);
    cp_async_commit();

    // this thread's two rows of the warp's 16: lane / 4 and lane / 4 + 8
    const int wr0 = r0 + warp * 16;
    const bool warp_active = wr0 < nrows;
    const int ra = wr0 + lane / 4, rb = ra + 8;
    const int qpos_a = ra / g + offset, qpos_b = rb / g + offset;
    const int qpos_first = wr0 / g + offset;
    const int qpos_last = min(wr0 + 15, nrows - 1) / g + offset;

    float acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][u] = 0.0f;
    float m_a = NEG, m_b = NEG, l_a = 0.0f, l_b = 0.0f;

    for (int t = t0; t < ntiles; ++t) {
        if (t + 1 < ntiles) {
            load_kv(t + 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int k0 = t * BK;
        if (warp_active && !(causal && k0 > qpos_last)
            && !(window > 0 && k0 + BK - 1 <= qpos_first - window)) {
            const bf16* kt = ks + (t & 1) * BK * PITCH;
            const bf16* vt = vs + (t & 1) * BK * PITCH;

            // S = Q . K^T: BK / 8 n8 tiles of 8 keys
            float s[BK / 8][4];
#pragma unroll
            for (int i = 0; i < BK / 8; ++i)
#pragma unroll
                for (int u = 0; u < 4; ++u) s[i][u] = 0.0f;
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
                uint32_t qa[4];
                ldsm_x4(qa, qs + (warp * 16 + lane % 16) * PITCH + kc * 16
                                + (lane / 16) * 8);
#pragma unroll
                for (int np = 0; np < BK / 16; ++np) {
                    uint32_t bk[4];
                    ldsm_x4(bk, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * PITCH
                                    + kc * 16 + ((lane / 8) & 1) * 8);
                    mma_bf16(s[2 * np], qa, bk[0], bk[1]);
                    mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
                }
            }

            // mask (only a tile that straddles a boundary), running max
            const bool edge = k0 + BK > lk_valid
                              || (causal && k0 + BK - 1 > qpos_first)
                              || (window > 0 && k0 <= qpos_last - window);
            float mx_a = NEG, mx_b = NEG;
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    float xa = s[nt][u] * scale_log2, xb = s[nt][2 + u] * scale_log2;
                    if (edge) {
                        const int kp = k0 + nt * 8 + (lane % 4) * 2 + u;
                        const bool in = kp < lk_valid;
                        if (!(in && (!causal || kp <= qpos_a)
                              && (window <= 0 || kp > qpos_a - window)))
                            xa = NEG;
                        if (!(in && (!causal || kp <= qpos_b)
                              && (window <= 0 || kp > qpos_b - window)))
                            xb = NEG;
                    }
                    s[nt][u] = xa;
                    s[nt][2 + u] = xb;
                    mx_a = fmaxf(mx_a, xa);
                    mx_b = fmaxf(mx_b, xb);
                }
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
                mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
            }
            const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
            // a row that has seen no key yet keeps base 0: its -1e30 scores
            // then give exp2(-1e30) = 0, never exp2(0)
            const float base_a = mn_a == NEG ? 0.0f : mn_a;
            const float base_b = mn_b == NEG ? 0.0f : mn_b;
            const float al_a = exp2f(m_a - base_a), al_b = exp2f(m_b - base_b);
            m_a = mn_a;
            m_b = mn_b;
            float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    s[nt][u] = exp2f(s[nt][u] - base_a);
                    s[nt][2 + u] = exp2f(s[nt][2 + u] - base_b);
                    sum_a += s[nt][u];
                    sum_b += s[nt][2 + u];
                }
            }
            // per-thread partial sums; the quad's four are added at the end
            l_a = l_a * al_a + sum_a;
            l_b = l_b * al_b + sum_b;
#pragma unroll
            for (int i = 0; i < NT; ++i) {
                acc[i][0] *= al_a;
                acc[i][1] *= al_a;
                acc[i][2] *= al_b;
                acc[i][3] *= al_b;
            }

            // O += P . V, P = hi + lo from the score registers
#pragma unroll
            for (int kc = 0; kc < BK / 16; ++kc) {
                uint32_t ph[4], pl[4];
                split_bf16(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
                split_bf16(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
                split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
                split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
                for (int dp = 0; dp < DP / 16; ++dp) {
                    uint32_t bv[4];
                    ldsm_x4_trans(bv, vt + (kc * 16 + lane % 16) * PITCH + dp * 16
                                          + (lane / 16) * 8);
                    mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
                    mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
                    mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
                    mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
                }
            }
        }
        __syncthreads();  // this tile's stage is refilled next iteration
    }

    if (!warp_active) return;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;
    const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
    const bool pairs = ((so_b | so_l | so_h) & 1) == 0;  // rows start even
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int gr = half ? rb : ra;
        if (gr >= nrows) continue;
        const float inv = half ? inv_b : inv_a;
        const int qi = gr / g, h = hk * g + gr % g;
        bf16* orow = o + b * so_b + qi * so_l + h * so_h;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int col = nt * 8 + (lane % 4) * 2;
            const float x0 = acc[nt][2 * half] * inv, x1 = acc[nt][2 * half + 1] * inv;
            if (pairs && col + 1 < d) {
                *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                    __floats2bfloat162_rn(x0, x1);
            } else {
                if (col < d) orow[col] = __float2bfloat16(x0);
                if (col + 1 < d) orow[col + 1] = __float2bfloat16(x1);
            }
        }
    }
}

template <int DP>
int launch(void* o, const void* q, const void* k, const void* v, int batch,
           int lq, int lk_valid, int g, int hkv, int d, int causal, int window,
           float scale, int vec, const long long* st, cudaStream_t stream) {
    const int smem = (ROWS + 4 * BK) * (DP + 8) * static_cast<int>(sizeof(bf16));
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nrb = (lq * g + ROWS - 1) / ROWS;
    dim3 grid(batch * hkv, nrb);
    flash_attention_mma_kernel<DP><<<grid, THREADS, smem, stream>>>(
        static_cast<bf16*>(o), static_cast<const bf16*>(q),
        static_cast<const bf16*>(k), static_cast<const bf16*>(v), lq, lk_valid,
        g, d, causal, window, scale * LOG2E, hkv, nrb, vec, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// bf16 only, head dim <= 256; window 0 means none.  Strides are in elements:
// (batch, row, head) for q, k, v and o in that order; the head-dim axis is
// contiguous.
extern "C" int flash_attention_mma(void* o, const void* q, const void* k,
                                   const void* v, int batch, int lq,
                                   int lk_valid, int hq, int hkv, int d,
                                   int causal, int window, float scale,
                                   long long sq_b, long long sq_l, long long sq_h,
                                   long long sk_b, long long sk_l, long long sk_h,
                                   long long sv_b, long long sv_l, long long sv_h,
                                   long long so_b, long long so_l, long long so_h,
                                   void* stream) {
    if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0 || window < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch <= 0 || lq <= 0) return static_cast<int>(cudaGetLastError());
    const int g = hq / hkv;
    if ((static_cast<long long>(lq) * g + ROWS - 1) / ROWS > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long st[12] = {sq_b, sq_l, sq_h, sk_b, sk_l, sk_h,
                              sv_b, sv_l, sv_h, so_b, so_l, so_h};
    // cp.async needs every row chunk 16-byte aligned: base pointers and the
    // strides of q, k and v in multiples of 8 elements
    int vec = aligned16(q) && aligned16(k) && aligned16(v);
    for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d <= 16)
        return launch<16>(o, q, k, v, batch, lq, lk_valid, g, hkv, d, causal,
                          window, scale, vec, st, s);
    if (d <= 32)
        return launch<32>(o, q, k, v, batch, lq, lk_valid, g, hkv, d, causal,
                          window, scale, vec, st, s);
    if (d <= 64)
        return launch<64>(o, q, k, v, batch, lq, lk_valid, g, hkv, d, causal,
                          window, scale, vec, st, s);
    if (d <= 128)
        return launch<128>(o, q, k, v, batch, lq, lk_valid, g, hkv, d, causal,
                           window, scale, vec, st, s);
    return launch<256>(o, q, k, v, batch, lq, lk_valid, g, hkv, d, causal,
                       window, scale, vec, st, s);
}
