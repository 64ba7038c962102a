// K4 flash_attention, route "f32": grouped-query attention with an online
// softmax, in float32 on the tensor cores.
//
//     O[b, i, h] = softmax_j(scale * Q[b, i, h] . K[b, j, h / g]) V[b, j, h / g]
//
// over the keys j < lk_valid that row i may see: with causal masking, j <=
// i + (lk_valid - Lq), i.e. the diagonal is aligned to the end of the valid
// keys, and with a local window > 0 also j > i + (lk_valid - Lq) - window.  A
// row that sees no key gives 0.  Inputs, output and every sum are float32;
// bf16 takes routes "mma" (flash_attention_mma.cu) and "decode"
// (flash_decode.cu).
//
// Replaces the TPU kernel `_flash_kernel` (repro/kernels/flash_attention.py,
// via `flash_attention_pallas`), which the model's blockwise jnp attention
// (repro/models/layers.py `attention`) stands in for at prefill.
//
// What bounds it on Hopper: operations.  A visible (row, key) pair costs 4 D
// flops (S = Q K^T and P V) against q, k, v and o read or written once, far
// above the card's flops per byte.  On the CUDA cores float32 peaks at 67
// TFLOP/s; the TF32 tensor cores give 495, but TF32 keeps 10 mantissa bits,
// and one TF32 rounding of S's or of P V's operands misses K4's float32
// tolerance (2e-5 + 1e-4 |x|; tests/test_torch_flash_f32.py).  So each
// product runs as 3xTF32: 12 D tensor-core flops a pair.
//
// Design: K4b route "f32"'s pass 1 (flash_attention_bwd.cu `bwd_tf32_lse`:
// S, the running max and sum) fused with its pass 3's product shape
// (`bwd_tf32_dq`: an accumulator fed back as the A operand of a product with
// rows of a staged tile, here V).  The helpers below are copies of that
// file's.
// - One block per (batch, KV head, 128 rows; 8 warps of 16; 64 rows and 4
//   warps at DP <= 64), the rows being (query position, query head of the
//   group) pairs flattened as i * g + h, so every K/V tile a block stages
//   serves all g query heads.  Row blocks run last first (the heaviest
//   under the causal mask).  Key tiles of 32 keys (16 at DP = 256) come
//   through a 2-stage `cp.async` ring; Q is staged once.  Copies are
//   16-byte `cp.async`, or plain loads for views whose rows are not
//   16-byte aligned.
// - Every product is `mma.sync.aligned.m16n8k8` with tf32 operands and
//   float32 accumulators, as 3xTF32: each operand x is split into big =
//   rna(x) (to nearest, ties away: the bits of `cvt.rna.tf32.f32`, by an
//   integer add and mask) and small = x - big (exact), whose 13 low bits the
//   tensor cores do not read; small . big, big . small and big . big are
//   issued in that order.
// - Operands stay float32 in shared memory, rows padded by 4 floats (pitch
//   DP + 4), so the 8 rows of an `ldmatrix` (b16 pairs: 8 rows of 4 floats,
//   the tf32 fragment layout) land on distinct banks.  S = Q K^T reads both
//   operands along rows by `ldmatrix`, its k8 steps taken in turn by two
//   accumulators (added at the end), so two chains of dependent `mma`s run
//   side by side where one block of 8 warps holds an SM.
// - P never leaves registers: the S accumulator, whose thread holds columns
//   2t and 2t + 1, becomes P's A fragment in the k-permuted order (k = t is
//   key 2t, k = t + 4 key 2t + 1), and V's rows are read across by scalar
//   loads in the same order (no 32-bit `ldmatrix.trans` exists), so O += P V
//   needs no shuffle.
// - The running max and sum of each row stay in registers (log2 units of
//   scale * S); O is rescaled by alpha on the CUDA cores once a tile.
// - A warp whose 16 rows all lie past the diagonal or left of the band of a
//   tile skips it; masking runs only where a tile straddles an edge.  A
//   local window starts each block's key loop at the tile of the first key
//   its first row sees, so a banded prefill does O(L * (window + tile))
//   work.
// - The head dim is zero-padded to DP = 16, 32, 64, 128 or 256.  O takes
//   DP / 2 registers a thread (128 at DP = 256); one block of 8 warps an SM
//   at DP = 128 (~132 KB of shared memory) and 256 (~195 KB), 3 blocks of
//   4 warps at DP <= 64.  The SM's 8 warps hide the latency of the `mma`
//   chains: 4 warps an SM (64-row blocks at DP = 256) took 1.7x as long.
// - The tensor cores truncate what they add to an accumulator; O's sums
//   over up to 2048 keys (recurrentgemma-2b's window) stay inside the
//   tolerance, as K4b pass 3's dQ does.
// No kernel spills (`-Xptxas -v`, which chip_smoke.py logs at build time).
// `tools/k4_variants.py` times this design against the CUDA-core design it
// replaced and against the choices set by the K4F_* macros below.
// Q, K, V and O take batch, row and head strides (the last axis is
// contiguous), so a layer's slice of the KV cache is read in place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DMAX = 256;
constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// The choices `tools/k4_variants.py` sets by -D to time alternatives; the
// defaults are this design's, in terms of the padded head dim DP.
#ifndef K4F_BK                 // keys a tile
#define K4F_BK (DP > 128 ? 16 : 32)
#endif
#ifndef K4F_BLOCKS             // blocks an SM
#define K4F_BLOCKS (DP > 64 ? 1 : 3)
#endif
#ifndef K4F_SPLIT_ONCE         // 1: each K and V tile split once a block
#define K4F_SPLIT_ONCE 0       //    into shared big and small planes
#endif
#ifndef K4F_WARPS              // warps a block, 16 rows each
#define K4F_WARPS (DP > 64 ? 8 : 4)
#endif
#ifndef K4F_S_CHAINS           // S's accumulators over the head dim (k8
#define K4F_S_CHAINS 2         // steps taken in turn), added at the end
#endif
#ifndef K4F_ONE_PRODUCT        // 1: big . big alone (1xTF32), to time the
#define K4F_ONE_PRODUCT 0      //    split's cost; misses the tolerance
#endif

template <int DP>
struct Fwd {
    static constexpr int WARPS = K4F_WARPS;
    static constexpr int ROWS = 16 * WARPS, NTH = 32 * WARPS;
    static constexpr int CHAINS = K4F_S_CHAINS < DP / 8 ? K4F_S_CHAINS : DP / 8;
    static constexpr int BK = K4F_BK;
    static constexpr int BLOCKS = K4F_BLOCKS;
    static constexpr bool ONCE = K4F_SPLIT_ONCE != 0;
    static constexpr int PITCH = DP + 4;
    // floats of shared memory: Q, the K and V ring, and the small planes
    static constexpr int SMEM = (ROWS + 4 * BK + (ONCE ? 2 * BK : 0)) * PITCH;
};

struct Geo {                  // one call's problem
    int lq, lk_valid, g, d, causal, window, hkv, nrows;
    float scale_log2;
};

struct Strides {              // element strides (batch, row, head) of each
    long long q[3], k[3], v[3], o[3];
};

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

// four 8 x 8 b16 matrices = four 8-row x 4-float tiles; lane l's register i
// is float l % 4 of row l / 4 of tile i, whose row addresses lanes 8 i .. 8 i
// + 7 give
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// x rounded to tf32, to nearest, ties away from zero; the 13 low bits zero
__device__ __forceinline__ uint32_t rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as tf32 big + small: big = rna(x), small the remainder x - big (exact),
// whose 13 low bits the tensor cores do not read
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    big = rna(x);
    small = __float_as_uint(x - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split_n(const uint32_t* x, uint32_t* big,
                                        uint32_t* small) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(__uint_as_float(x[i]), big[i], small[i]);
}

// c += a (16 x 8, row-major) . b (8 x 8, column-major), tf32 in, f32 acc
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b as 3xTF32, in a fixed order: small . big, big . small, big . big
__device__ __forceinline__ void mma3(float* c, const uint32_t* ab, const uint32_t* as,
                                     uint32_t bb0, uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
#if !K4F_ONE_PRODUCT
    mma_tf32(c, as, bb0, bb1);
    mma_tf32(c, ab, bs0, bs1);
#endif
    mma_tf32(c, ab, bb0, bb1);
}

// the A fragments (big and small) of the k8 step over accumulator tile c:
// the accumulator's rows, its columns as k in the permuted order (k = t is
// column 2t, k = t + 4 column 2t + 1)
__device__ __forceinline__ void acc_to_a(const float* c, uint32_t* big,
                                         uint32_t* small) {
    split(c[0], big[0], small[0]);
    split(c[2], big[1], small[1]);
    split(c[1], big[2], small[2]);
    split(c[3], big[3], small[3]);
}

// one 16-byte chunk (4 floats) of a row into shared memory: the first n from
// src, zeros after; `vec` when src is 16-byte aligned
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, int n,
                                           bool vec) {
    if (vec) {
        cp_async16(dst, src, 4 * n);
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[u] = u < n ? src[u] : 0.0f;
    }
}

__device__ __forceinline__ long long row_off(const long long* st, long long b,
                                             int hk, int r, int g) {
    return b * st[0] + static_cast<long long>(r / g) * st[1]
           + static_cast<long long>(hk * g + r % g) * st[2];
}

// rows r0 .. r0 + ROWS - 1 of q into dst [ROWS][DP + 4], zeros past nrows
// and d
template <int ROWS, int DP, int NTH>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          const long long* st, long long b, int hk,
                                          int r0, const Geo& geo, bool vec) {
    constexpr int PITCH = DP + 4, CH = DP / 4;
    for (int e = threadIdx.x; e < ROWS * CH; e += NTH) {
        const int r = e / CH, c = e % CH, gr = r0 + r;
        const int n = gr < geo.nrows ? max(0, min(4, geo.d - 4 * c)) : 0;
        copy_chunk(dst + r * PITCH + 4 * c,
                   n ? src + row_off(st, b, hk, gr, geo.g) + 4 * c : src, n, vec);
    }
}

// keys k0 .. k0 + R - 1 of K or V into dst [R][DP + 4], zeros from kend and
// past d
template <int R, int DP, int NTH>
__device__ __forceinline__ void load_keys(float* dst, const float* src,
                                          const long long* st, long long b, int hk,
                                          int k0, int kend, const Geo& geo, bool vec) {
    constexpr int PITCH = DP + 4, CH = DP / 4;
    const float* base = src + b * st[0] + hk * st[2];
    for (int e = threadIdx.x; e < R * CH; e += NTH) {
        const int j = e / CH, c = e % CH, gj = k0 + j;
        const int n = gj < kend ? max(0, min(4, geo.d - 4 * c)) : 0;
        copy_chunk(dst + j * PITCH + 4 * c, n ? base + gj * st[1] + 4 * c : src, n,
                   vec);
    }
}

// the staged R x DP tile at `x` split in place into big (kept at x) and
// small (written to `small`, the same layout)
template <int R, int DP, int NTH>
__device__ __forceinline__ void split_tile(float* x, float* small) {
    constexpr int PITCH = DP + 4;
    for (int e = threadIdx.x; e < R * DP; e += NTH) {
        const int at = (e / DP) * PITCH + e % DP;
        uint32_t big, sm;
        split(x[at], big, sm);
        x[at] = __uint_as_float(big);
        small[at] = __uint_as_float(sm);
    }
}

__device__ __forceinline__ bool visible(int kp, int qpos, const Geo& geo) {
    return kp < geo.lk_valid && (!geo.causal || kp <= qpos)
           && (geo.window <= 0 || kp > qpos - geo.window);
}

// c[n] = A . B^T over DP: A the 16 rows at `a`, B the NB rows at `bt` (its
// small parts at `bsm` when the tile was split once, else split here), both
// row-major over the head dim (pitch DP + 4): S = Q K^T.  The k8 steps go in
// turn to CHAINS accumulators, added in order at the end.
template <int NB, int DP, bool ONCE, int CHAINS>
__device__ __forceinline__ void dot_rows(float (*c)[4], const float* a,
                                         const float* bt, const float* bsm,
                                         int lane) {
    constexpr int PITCH = DP + 4;
    const int mi = lane / 8, lr = lane % 8;
    // tile i of the A fragment: rows (i & 1) * 8, columns (i >> 1) * 4
    const int oa = ((mi & 1) * 8 + lr) * PITCH + (mi >> 1) * 4;
    // tile i of B (16 rows): rows (i >> 1) * 8, columns (i & 1) * 4
    const int ob = ((mi >> 1) * 8 + lr) * PITCH + (mi & 1) * 4;
    float part[CHAINS][NB / 8][4];
#pragma unroll
    for (int ch = 0; ch < CHAINS; ++ch)
#pragma unroll
        for (int n = 0; n < NB / 8; ++n)
#pragma unroll
            for (int u = 0; u < 4; ++u) part[ch][n][u] = 0.0f;
#pragma unroll 2
    for (int k0 = 0; k0 < DP / 8; k0 += CHAINS) {
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch) {
            const int kc = k0 + ch;
            uint32_t fa[4], ab[4], as[4];
            ldsm_x4(fa, a + oa + kc * 8);
            split_n<4>(fa, ab, as);
#pragma unroll
            for (int np = 0; np < NB / 16; ++np) {
                uint32_t bb[4], bs[4];
                if constexpr (ONCE) {
                    ldsm_x4(bb, bt + ob + np * 16 * PITCH + kc * 8);
                    ldsm_x4(bs, bsm + ob + np * 16 * PITCH + kc * 8);
                } else {
                    uint32_t fb[4];
                    ldsm_x4(fb, bt + ob + np * 16 * PITCH + kc * 8);
                    split_n<4>(fb, bb, bs);
                }
                mma3(part[ch][2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
                mma3(part[ch][2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
            }
        }
    }
#pragma unroll
    for (int n = 0; n < NB / 8; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            float x = part[0][n][u];
#pragma unroll
            for (int ch = 1; ch < CHAINS; ++ch) x += part[ch][n][u];
            c[n][u] = x;
        }
}

// acc[n] += A . B for the k8 step of accumulator tile `c` (A its big and
// small fragments): B the 8 rows at `b` (pitch DP + 4; small parts at `bsm`
// when split once) read across rows in the permuted order, all DP columns
// (O += P V)
template <int DP, bool ONCE>
__device__ __forceinline__ void acc_rows(float (*acc)[4], const uint32_t* ab,
                                         const uint32_t* as, const float* b,
                                         const float* bsm, int lane) {
    constexpr int PITCH = DP + 4;
    const int o0 = (2 * (lane % 4)) * PITCH + lane / 4;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
        uint32_t bb0, bs0, bb1, bs1;
        if constexpr (ONCE) {
            bb0 = __float_as_uint(b[o0 + dn * 8]);
            bb1 = __float_as_uint(b[o0 + PITCH + dn * 8]);
            bs0 = __float_as_uint(bsm[o0 + dn * 8]);
            bs1 = __float_as_uint(bsm[o0 + PITCH + dn * 8]);
        } else {
            split(b[o0 + dn * 8], bb0, bs0);
            split(b[o0 + PITCH + dn * 8], bb1, bs1);
        }
        mma3(acc[dn], ab, as, bb0, bb1, bs0, bs1);
    }
}

template <int DP>
__global__ void __launch_bounds__(Fwd<DP>::NTH, Fwd<DP>::BLOCKS)
fwd_tf32(float* o, const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, Geo geo, Strides st, int nrb, int vec) {
    using C = Fwd<DP>;
    constexpr int PITCH = C::PITCH, NT = DP / 8, BK = C::BK;
    constexpr int ROWS = C::ROWS, NTH = C::NTH;
    constexpr bool ONCE = C::ONCE;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qs = reinterpret_cast<float*>(smem_raw);  // [ROWS][PITCH]
    float* ks = qs + ROWS * PITCH;                   // [2][BK][PITCH]
    float* vs = ks + 2 * BK * PITCH;                 // [2][BK][PITCH]
    float* ksm = vs + 2 * BK * PITCH;                // ONCE: [BK][PITCH] each
    float* vsm = ksm + BK * PITCH;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int hk = blockIdx.x % geo.hkv;
    const long long b = blockIdx.x / geo.hkv;
    const int r0 = (nrb - 1 - static_cast<int>(blockIdx.y)) * ROWS;
    const int offset = geo.lk_valid - geo.lq;
    const int wr0 = r0 + warp * 16;
    const int ra = wr0 + lane / 4, rb = ra + 8;

    // the key tiles [t0, ntiles) the block's rows see, and their end
    const int last_row = min(r0 + ROWS, geo.nrows) - 1;
    int kend = geo.lk_valid;
    if (geo.causal) kend = min(kend, last_row / geo.g + offset + 1);
    const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;
    const int t0 = geo.window > 0 ? max(0, r0 / geo.g + offset - geo.window + 1) / BK
                                  : 0;
    if (t0 < ntiles) {
        load_rows<ROWS, DP, NTH>(qs, q, st.q, b, hk, r0, geo, vec);
        load_keys<BK, DP, NTH>(ks + (t0 & 1) * BK * PITCH, k, st.k, b, hk, t0 * BK,
                               kend, geo, vec);
        load_keys<BK, DP, NTH>(vs + (t0 & 1) * BK * PITCH, v, st.v, b, hk, t0 * BK,
                               kend, geo, vec);
        cp_async_commit();
    }

    const bool warp_active = wr0 < geo.nrows;
    const int qpos_a = ra / geo.g + offset, qpos_b = rb / geo.g + offset;
    const int qpos_first = wr0 / geo.g + offset;
    const int qpos_last = min(wr0 + 15, geo.nrows - 1) / geo.g + offset;
    float m_a = NEG, m_b = NEG, l_a = 0.0f, l_b = 0.0f;
    float acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][u] = 0.0f;

    for (int t = t0; t < ntiles; ++t) {
        if (t + 1 < ntiles) {
            const int s = (t + 1) & 1;
            load_keys<BK, DP, NTH>(ks + s * BK * PITCH, k, st.k, b, hk, (t + 1) * BK,
                                   kend, geo, vec);
            load_keys<BK, DP, NTH>(vs + s * BK * PITCH, v, st.v, b, hk, (t + 1) * BK,
                                   kend, geo, vec);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        float* kt = ks + (t & 1) * BK * PITCH;
        float* vt = vs + (t & 1) * BK * PITCH;
        if constexpr (ONCE) {
            split_tile<BK, DP, NTH>(kt, ksm);
            split_tile<BK, DP, NTH>(vt, vsm);
            __syncthreads();
        }
        const int k0 = t * BK;
        if (warp_active && !(geo.causal && k0 > qpos_last)
            && !(geo.window > 0 && k0 + BK - 1 <= qpos_first - geo.window)) {
            // S = Q K^T: the warp's 16 rows x BK keys
            float s[BK / 8][4];
            dot_rows<BK, DP, ONCE, C::CHAINS>(s, qs + warp * 16 * PITCH, kt, ksm,
                                              lane);
            const bool edge = k0 + BK > geo.lk_valid
                              || (geo.causal && k0 + BK - 1 > qpos_first)
                              || (geo.window > 0 && k0 <= qpos_last - geo.window);
            float mx_a = NEG, mx_b = NEG;
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    float xa = s[nt][u] * geo.scale_log2;
                    float xb = s[nt][2 + u] * geo.scale_log2;
                    if (edge) {
                        const int kp = k0 + nt * 8 + (lane % 4) * 2 + u;
                        if (!visible(kp, qpos_a, geo)) xa = NEG;
                        if (!visible(kp, qpos_b, geo)) xb = NEG;
                    }
                    s[nt][u] = xa;
                    s[nt][2 + u] = xb;
                    mx_a = fmaxf(mx_a, xa);
                    mx_b = fmaxf(mx_b, xb);
                }
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, off));
                mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, off));
            }
            const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
            // a row that has seen no key yet keeps base 0: its -1e30 scores
            // then give exp2(-1e30) = 0, never exp2(0)
            const float base_a = mn_a == NEG ? 0.0f : mn_a;
            const float base_b = mn_b == NEG ? 0.0f : mn_b;
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
            const float alpha_a = exp2f(m_a - base_a);
            const float alpha_b = exp2f(m_b - base_b);
            l_a = l_a * alpha_a + sum_a;
            l_b = l_b * alpha_b + sum_b;
            m_a = mn_a;
            m_b = mn_b;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                acc[nt][0] *= alpha_a;
                acc[nt][1] *= alpha_a;
                acc[nt][2] *= alpha_b;
                acc[nt][3] *= alpha_b;
            }
            // O += P V, one k8 step (8 keys) per n8 tile of P
#pragma unroll
            for (int kc = 0; kc < BK / 8; ++kc) {
                uint32_t ab[4], as[4];
                acc_to_a(s[kc], ab, as);
                acc_rows<DP, ONCE>(acc, ab, as, vt + kc * 8 * PITCH,
                                   vsm + kc * 8 * PITCH, lane);
            }
        }
        __syncthreads();  // this tile's stage is refilled next iteration
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(FULL, l_a, off);
        l_b += __shfl_xor_sync(FULL, l_b, off);
    }
    if (!warp_active) return;
    const bool pairs = ((st.o[0] | st.o[1] | st.o[2]) & 1) == 0
                       && (reinterpret_cast<uintptr_t>(o) & 7) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int gr = half ? rb : ra;
        if (gr >= geo.nrows) continue;
        const float l = half ? l_b : l_a;
        const float inv = l > 0.0f ? 1.0f / l : 0.0f;  // no key seen: 0
        float* row = o + row_off(st.o, b, hk, gr, geo.g);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int col = nt * 8 + (lane % 4) * 2;
            const float x0 = acc[nt][2 * half] * inv;
            const float x1 = acc[nt][2 * half + 1] * inv;
            if (pairs && col + 1 < geo.d) {
                *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
            } else {
                if (col < geo.d) row[col] = x0;
                if (col + 1 < geo.d) row[col + 1] = x1;
            }
        }
    }
}

template <int DP>
int launch(float* o, const float* q, const float* k, const float* v, int batch,
           const Geo& geo, const Strides& st, int vec, cudaStream_t stream) {
    using C = Fwd<DP>;
    const int smem = C::SMEM * static_cast<int>(sizeof(float));
    const int nrb = (geo.nrows + C::ROWS - 1) / C::ROWS;
    if (nrb > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        fwd_tf32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fwd_tf32<DP><<<dim3(batch * geo.hkv, nrb), C::NTH, smem, stream>>>(
        o, q, k, v, geo, st, nrb, vec);
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// float32 only; head dim <= 256; window 0 means none.  Strides are in
// elements: (batch, row, head) for q, k, v and o in that order; the
// head-dim axis is contiguous.
extern "C" int flash_attention(void* o, const void* q, const void* k,
                               const void* v, int batch, int lq, int lk_valid,
                               int hq, int hkv, int d, int causal, int window,
                               float scale,
                               long long sq_b, long long sq_l, long long sq_h,
                               long long sk_b, long long sk_l, long long sk_h,
                               long long sv_b, long long sv_l, long long sv_h,
                               long long so_b, long long so_l, long long so_h,
                               void* stream) {
    if (d > DMAX || hkv <= 0 || hq % hkv != 0 || window < 0 || lk_valid < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch <= 0 || lq <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
    const int g = hq / hkv;
    const long long nrows = static_cast<long long>(lq) * g;
    if (nrows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const Strides st{{sq_b, sq_l, sq_h}, {sk_b, sk_l, sk_h}, {sv_b, sv_l, sv_h},
                     {so_b, so_l, so_h}};
    // cp.async needs every row chunk 16-byte aligned: base pointers and the
    // strides of q, k and v in multiples of 4 elements
    int vec = aligned16(q) && aligned16(k) && aligned16(v);
    for (const long long s : {sq_b, sq_l, sq_h, sk_b, sk_l, sk_h, sv_b, sv_l, sv_h})
        vec = vec && s % 4 == 0;
    const Geo geo{lq, lk_valid, g, d, causal, window, hkv, static_cast<int>(nrows),
                  scale * LOG2E};
    cudaStream_t cs = static_cast<cudaStream_t>(stream);
    float* fo = static_cast<float*>(o);
    const float* fq = static_cast<const float*>(q);
    const float* fk = static_cast<const float*>(k);
    const float* fv = static_cast<const float*>(v);
    if (d <= 16) return launch<16>(fo, fq, fk, fv, batch, geo, st, vec, cs);
    if (d <= 32) return launch<32>(fo, fq, fk, fv, batch, geo, st, vec, cs);
    if (d <= 64) return launch<64>(fo, fq, fk, fv, batch, geo, st, vec, cs);
    if (d <= 128) return launch<128>(fo, fq, fk, fv, batch, geo, st, vec, cs);
    return launch<256>(fo, fq, fk, fv, batch, geo, st, vec, cs);
}
