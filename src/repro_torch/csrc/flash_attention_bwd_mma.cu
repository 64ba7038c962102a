// K4b flash_attention_bwd, route "mma": the backward of K4 in bf16 on the
// tensor cores, by the FlashAttention-2 algebra:
//
//     P_ij = exp(scale * q_i . k_j - lse_i)   over the keys row i sees
//     D_i  = dO_i . O_i
//     dV_j = sum_i P_ij dO_i        dP_ij = dO_i . V_j
//     dS_ij = P_ij (dP_ij - D_i)
//     dQ_i = scale sum_j dS_ij K_j  dK_j = scale sum_i dS_ij Q_i
//
// with the rows i = (query position, query head of the group) flattened as
// i * g + h, so dK and dV of a KV head sum over its g query heads.  The
// visibility rule is K4's: key j is seen by query position i iff j <
// lk_valid, j <= i + (lk_valid - Lq) if causal, and j > i + (lk_valid - Lq)
// - window if window > 0.  A row that sees no key, and a key no row sees,
// gets zeros.  Inputs and outputs are bf16; every product accumulates in
// float32.  Float32 inputs take route "f32" (flash_attention_bwd.cu).
//
// Replaces no TPU kernel: the reference's models differentiate their jnp
// blockwise attention (repro/models/layers.py `attention`, `_attention_banded`
// for the window) through XLA, and K4 stands in for that function in the
// port; this is its gradient.
//
// What bounds it on Hopper: operations.  Per visible (row, key) pair the
// algebra is 10 D flops against q, k, v, o, dO, dq, dk and dv read or
// written once, far above the card's ~295 bf16 flops per byte, so only the
// tensor cores can come near the bound.  This design runs 22 D a pair
// there: S in all three passes, dP in two, and every product with P or dS
// twice (below).
//
// Design (FlashAttention-2's backward on mma.sync; no atomics, every sum in
// a fixed order, so every call gives the same bits):
// - Every product is `mma.sync.aligned.m16n8k16` with bf16 operands and
//   float32 accumulators; fragments come from shared memory by `ldmatrix`
//   (`.trans` where the product runs over rows or keys).  Operands stay bf16
//   in shared memory, rows padded by 16 bytes so that the 8 rows of every
//   `ldmatrix` hit distinct banks; the head dim is zero-padded to DP = 16,
//   32, 64, 128 or 256.  Copies are 16-byte `cp.async`, or plain loads for
//   views whose rows are not 16-byte aligned (odd head dims).
// - P and dS are split into a bf16 high part and a bf16 low part (x - hi),
//   and each product with them runs once for each, as K4's forward does for
//   P.V.  A single bf16 rounding of P (of dS) takes dV (dQ and dK) up to
//   1.45x (1.54x) past K4b's bf16 tolerance at the train shapes cut to
//   batch 1 and on a ragged shape; with both split every gradient stays
//   within 0.65 of it (`tools/k4b_rounding.py`, the plain algebra on the
//   CPU; `flash_attention_bwd_mma_plain` is this route's rounding).
// 1. `bwd_mma_lse`: one block per (batch, KV head, 16 rows a warp; 4 warps,
//    8 at DP = 256): S = Q K^T against 32-key tiles of the band (2-stage
//    `cp.async` ring), the running max and sum in registers, then lse (in
//    log2 units of scale * S) and D = dO . O to float32 scratch, whose rows
//    are padded to 128 (the padding gets zeros).
// 2. `bwd_mma_dkv`: one block per (batch, KV head, 64 keys).  A warp owns 16
//    keys and keeps their dK and dV in float32 registers (DP / 4 a thread
//    each: 253 registers at DP = 128, 2 blocks an SM; 167 and 3 blocks at
//    DP = 64).  The block walks the rows of its band in tiles of 32 with a
//    2-stage `cp.async` ring of Q, dO, lse and D; per tile a warp recomputes
//    S^T = K Q^T and dP^T = V dO^T (K and V fragments from shared memory),
//    forms P and dS in registers and packs them into A fragments for dV +=
//    P^T dO and dK += dS^T Q.  At DP = 256 dK + dV of 16 keys would take 256
//    registers a thread, so two warps share 16 keys and each holds 128 of
//    the head dims (8 warps, 248 registers, one block an SM); the pair's
//    first warp computes S^T and its second dP^T, and they hand the tiles
//    over through shared memory at a named barrier of the two.  Every block
//    keeps 64 keys, since each streams its whole band of Q and dO from L2.
//    Tiles are skipped for a warp when wholly outside its keys' band and
//    masked only where they straddle an edge.  Key tiles run in ascending
//    order, so under the causal mask the heaviest blocks (the first keys
//    see the most rows) are scheduled first.
// 3. `bwd_mma_dq`: one block per (batch, KV head, 16 rows a warp; 4 warps
//    and 3 blocks an SM up to DP = 128, 8 warps and one block at 256), dQ in
//    registers (DP / 4 a thread); it walks the key tiles of its band (32
//    keys, 16 at DP = 256) with a 2-stage ring of K and V, recomputes S and
//    dP, and runs dQ += dS K.  Row blocks run last first (the heaviest under
//    the causal mask).
// No kernel spills (`-Xptxas -v`, which chip_smoke.py logs at build time).
// `tools/k4b_variants.py` times alternatives to these choices, set by the
// K4B_* macros below: both warps of a pair recomputing S^T and dP^T, the
// DP = 128 warps split the same way, 4-warp blocks at DP = 256, row tiles
// of 64 at DP <= 64, pass 3 at 2 blocks an SM.
// Q, K, V, O, dO, dQ, dK and dV take batch, row and head strides (the last
// axis is contiguous), so views and a transposed dO are read in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PAD = 128; // lse and D scratch rows: a multiple of this
constexpr int BK1 = 32;       // keys per tile of pass 1
constexpr int DMAX = 256;
constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

// The choices `tools/k4b_variants.py` sets by -D to time alternatives; the
// defaults are this design's, in terms of the padded head dim DP.
#ifndef K4B_DQ_BLOCKS         // pass 3's blocks an SM
#define K4B_DQ_BLOCKS (DP > 128 ? 1 : 3)
#endif
#ifndef K4B_DKV_WARPS         // pass 2's warps a block
#define K4B_DKV_WARPS (DP > 128 ? 8 : 4)
#endif
#ifndef K4B_DKV_MIN_BLOCKS    // pass 2's blocks an SM
#define K4B_DKV_MIN_BLOCKS (DP > 128 ? 1 : DP > 64 ? 2 : 3)
#endif
#ifndef K4B_DKV_SPLIT         // pass 2's warps sharing 16 keys
#define K4B_DKV_SPLIT (DP > 128 ? 2 : 1)
#endif
#ifndef K4B_DKV_HAND_OVER     // 1: a pair of warps hands S^T, dP^T over;
#define K4B_DKV_HAND_OVER 1   // 0: both warps compute both
#endif
#ifndef K4B_DKV_BR            // pass 2's rows a tile
#define K4B_DKV_BR 32
#endif

template <int DP>
struct Rows {                                    // passes 1 and 3's blocks
    static constexpr int WARPS = DP > 128 ? 8 : 4;   // 16 rows each
    static constexpr int LSE_BLOCKS = DP > 128 ? 2 : 3;  // an SM, pass 1
    static constexpr int DQ_BLOCKS = K4B_DQ_BLOCKS;      // an SM, pass 3
};

template <int DP>
struct Dkv {                                     // pass 2's blocks and tiles
    static constexpr int WARPS = K4B_DKV_WARPS;
    static constexpr int MIN_BLOCKS = K4B_DKV_MIN_BLOCKS;  // an SM
    static constexpr int SPLIT = K4B_DKV_SPLIT;      // warps sharing 16 keys
    static constexpr bool HAND_OVER = SPLIT == 2 && K4B_DKV_HAND_OVER;
    static constexpr int DA = DP / SPLIT;            // dK, dV dims a warp holds
    static constexpr int KEYS = 16 * WARPS / SPLIT;  // keys per block
    static constexpr int BR = K4B_DKV_BR;            // rows per tile
};

template <int DP>
struct Dq {                                      // pass 3's key tile
    static constexpr int BK = DP > 128 ? 16 : 32;
};

struct Geo {                  // one call's problem
    int lq, lk, lk_valid, g, d, causal, window, hkv, nrows, nrows_pad;
    float scale, scale_log2;
};

struct Strides {              // element strides (batch, row, head) of each
    long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
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

// the 64 threads of warps 2 (id - 1) and 2 (id - 1) + 1 meet (named barrier)
__device__ __forceinline__ void pair_sync(int id) {
    asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
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

// the A fragments (hi and lo) of k16 step kc from the accumulators of n8
// tiles 2 kc and 2 kc + 1: rows of the accumulator, its columns as k
__device__ __forceinline__ void pack_a(const float (*c)[4], int kc, uint32_t* hi,
                                       uint32_t* lo) {
    split_bf16(c[2 * kc][0], c[2 * kc][1], hi[0], lo[0]);
    split_bf16(c[2 * kc][2], c[2 * kc][3], hi[1], lo[1]);
    split_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1], hi[2], lo[2]);
    split_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3], hi[3], lo[3]);
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

__device__ __forceinline__ long long row_off(const long long* st, long long b,
                                             int hk, int r, int g) {
    return b * st[0] + static_cast<long long>(r / g) * st[1]
           + static_cast<long long>(hk * g + r % g) * st[2];
}

// rows r0 .. r0 + R - 1 of a query-side tensor (q or dO) into dst [R][DP + 8],
// zeros past nrows and d
template <int R, int DP, int NTH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          const long long* st, long long b, int hk,
                                          int r0, const Geo& geo, bool vec) {
    constexpr int PITCH = DP + 8, CH = DP / 8;
    for (int e = threadIdx.x; e < R * CH; e += NTH) {
        const int r = e / CH, c = e % CH, gr = r0 + r;
        const int n = gr < geo.nrows ? max(0, min(8, geo.d - 8 * c)) : 0;
        copy_chunk(dst + r * PITCH + 8 * c,
                   n ? src + row_off(st, b, hk, gr, geo.g) + 8 * c : src, n, vec);
    }
}

// keys k0 .. k0 + R - 1 of K or V into dst [R][DP + 8], zeros from kend and
// past d
template <int R, int DP, int NTH>
__device__ __forceinline__ void load_keys(bf16* dst, const bf16* src,
                                          const long long* st, long long b, int hk,
                                          int k0, int kend, const Geo& geo, bool vec) {
    constexpr int PITCH = DP + 8, CH = DP / 8;
    const bf16* base = src + b * st[0] + hk * st[2];
    for (int e = threadIdx.x; e < R * CH; e += NTH) {
        const int j = e / CH, c = e % CH, gj = k0 + j;
        const int n = gj < kend ? max(0, min(8, geo.d - 8 * c)) : 0;
        copy_chunk(dst + j * PITCH + 8 * c, n ? base + gj * st[1] + 8 * c : src, n,
                   vec);
    }
}

__device__ __forceinline__ bool visible(int kp, int qpos, const Geo& geo) {
    return kp < geo.lk_valid && (!geo.causal || kp <= qpos)
           && (geo.window <= 0 || kp > qpos - geo.window);
}

// c[2 np + e] += A . B^T over DP: A 16 rows of `a` (pitch DP + 8), B the NB
// rows of `bt`, both row-major over the head dim (S = Q K^T and its kin)
template <int NB, int DP>
__device__ __forceinline__ void dot_rows(float (*c)[4], const bf16* a,
                                         const bf16* bt, int lane) {
    constexpr int PITCH = DP + 8;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
        uint32_t fa[4];
        ldsm_x4(fa, a + (lane % 16) * PITCH + kc * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NB / 16; ++np) {
            uint32_t fb[4];
            ldsm_x4(fb, bt + (np * 16 + (lane / 16) * 8 + lane % 8) * PITCH + kc * 16
                            + ((lane / 8) & 1) * 8);
            mma_bf16(c[2 * np], fa, fb[0], fb[1]);
            mma_bf16(c[2 * np + 1], fa, fb[2], fb[3]);
        }
    }
}

// acc[2 dp + e] += (hi + lo) . B for one k16 step: B the 16 rows at `b`
// (pitch DP + 8), its NA * 8 columns from `b`'s column 0 (dV += P^T dO and
// its kin: the product runs over B's rows, so `.trans`)
template <int NA, int DP>
__device__ __forceinline__ void acc_split(float (*acc)[4], const uint32_t* hi,
                                          const uint32_t* lo, const bf16* b,
                                          int lane) {
    constexpr int PITCH = DP + 8;
#pragma unroll
    for (int dp = 0; dp < NA / 2; ++dp) {
        uint32_t fb[4];
        ldsm_x4_trans(fb, b + (lane % 16) * PITCH + dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], hi, fb[0], fb[1]);
        mma_bf16(acc[2 * dp], lo, fb[0], fb[1]);
        mma_bf16(acc[2 * dp + 1], hi, fb[2], fb[3]);
        mma_bf16(acc[2 * dp + 1], lo, fb[2], fb[3]);
    }
}

// the key tiles [t0, t1) of width bk the rows r_lo .. r_hi - 1 see, and the
// end of the keys they see
__device__ __forceinline__ void key_band(int r_lo, int r_hi, const Geo& geo,
                                         int bk, int& t0, int& t1, int& kend) {
    const int off = geo.lk_valid - geo.lq;
    kend = geo.lk_valid;
    if (geo.causal) kend = min(kend, (r_hi - 1) / geo.g + off + 1);
    t1 = kend > 0 ? (kend + bk - 1) / bk : 0;
    t0 = geo.window > 0 ? max(0, r_lo / geo.g + off - geo.window + 1) / bk : 0;
}

// ---------------------------------------------------------------------------
// 1. each row's lse (log2 units) and D = dO . O
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(32 * Rows<DP>::WARPS, Rows<DP>::LSE_BLOCKS)
bwd_mma_lse(float* lse, float* dsum, const bf16* __restrict__ q,
            const bf16* __restrict__ k, const bf16* __restrict__ o,
            const bf16* __restrict__ dout, Geo geo, Strides st, int nrb, int vec) {
    constexpr int PITCH = DP + 8, BK = BK1;
    constexpr int ROWS = 16 * Rows<DP>::WARPS, NTH = 32 * Rows<DP>::WARPS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][PITCH]
    bf16* ks = qs + ROWS * PITCH;                  // [2][BK][PITCH]
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int hk = blockIdx.x % geo.hkv;
    const long long b = blockIdx.x / geo.hkv;
    const int r0 = (nrb - 1 - static_cast<int>(blockIdx.y)) * ROWS;
    const int offset = geo.lk_valid - geo.lq;
    const long long rowbase = (b * geo.hkv + hk) * geo.nrows_pad;

    // D of the warp's 16 rows, its lanes over the head dim (fixed order)
    for (int i = 0; i < 16; ++i) {
        const int gr = r0 + warp * 16 + i;
        float part = 0.0f;
        if (gr < geo.nrows) {
            const bf16* orow = o + row_off(st.o, b, hk, gr, geo.g);
            const bf16* drow = dout + row_off(st.dout, b, hk, gr, geo.g);
            for (int dd = lane; dd < geo.d; dd += 32)
                part = fmaf(__bfloat162float(drow[dd]), __bfloat162float(orow[dd]), part);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
        if (lane == 0) dsum[rowbase + gr] = part;
    }

    int t0, ntiles, kend;
    key_band(r0, min(r0 + ROWS, geo.nrows), geo, BK, t0, ntiles, kend);
    const int wr0 = r0 + warp * 16;
    const int ra = wr0 + lane / 4, rb = ra + 8;
    if (t0 >= ntiles || r0 >= geo.nrows) {  // no row of the block sees a key
        if (lane % 4 == 0) {
            lse[rowbase + ra] = 0.0f;
            lse[rowbase + rb] = 0.0f;
        }
        return;
    }
    load_rows<ROWS, DP, NTH>(qs, q, st.q, b, hk, r0, geo, vec);
    load_keys<BK, DP, NTH>(ks + (t0 & 1) * BK * PITCH, k, st.k, b, hk, t0 * BK, kend,
                           geo, vec);
    cp_async_commit();

    const bool warp_active = wr0 < geo.nrows;
    const int qpos_a = ra / geo.g + offset, qpos_b = rb / geo.g + offset;
    const int qpos_first = wr0 / geo.g + offset;
    const int qpos_last = min(wr0 + 15, geo.nrows - 1) / geo.g + offset;
    float m_a = NEG, m_b = NEG, l_a = 0.0f, l_b = 0.0f;

    for (int t = t0; t < ntiles; ++t) {
        if (t + 1 < ntiles) {
            load_keys<BK, DP, NTH>(ks + ((t + 1) & 1) * BK * PITCH, k, st.k, b, hk,
                                   (t + 1) * BK, kend, geo, vec);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int k0 = t * BK;
        if (warp_active && !(geo.causal && k0 > qpos_last)
            && !(geo.window > 0 && k0 + BK - 1 <= qpos_first - geo.window)) {
            float s[BK / 8][4];
#pragma unroll
            for (int i = 0; i < BK / 8; ++i)
#pragma unroll
                for (int u = 0; u < 4; ++u) s[i][u] = 0.0f;
            dot_rows<BK, DP>(s, qs + warp * 16 * PITCH, ks + (t & 1) * BK * PITCH, lane);
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
                    sum_a += exp2f(s[nt][u] - base_a);
                    sum_b += exp2f(s[nt][2 + u] - base_b);
                }
            }
            // per-thread partial sums; the quad's four are added at the end
            l_a = l_a * exp2f(m_a - base_a) + sum_a;
            l_b = l_b * exp2f(m_b - base_b) + sum_b;
            m_a = mn_a;
            m_b = mn_b;
        }
        __syncthreads();  // this tile's stage is refilled next iteration
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(FULL, l_a, off);
        l_b += __shfl_xor_sync(FULL, l_b, off);
    }
    if (lane % 4 == 0) {
        lse[rowbase + ra] = l_a > 0.0f ? m_a + log2f(l_a) : 0.0f;
        lse[rowbase + rb] = l_b > 0.0f ? m_b + log2f(l_b) : 0.0f;
    }
}

// ---------------------------------------------------------------------------
// 2. dK and dV of a key tile, over the rows of its band
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(32 * Dkv<DP>::WARPS, Dkv<DP>::MIN_BLOCKS)
bwd_mma_dkv(bf16* dk, bf16* dv, const float* __restrict__ lse,
            const float* __restrict__ dsum, const bf16* __restrict__ q,
            const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, Geo geo, Strides st, int vec) {
    using C = Dkv<DP>;
    constexpr int PITCH = DP + 8, SPLIT = C::SPLIT, DA = C::DA, KEYS = C::KEYS;
    constexpr int BR = C::BR, NA = DA / 8, XF = BR / 2, NTH = 32 * C::WARPS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [KEYS][PITCH]
    bf16* vs = ks + KEYS * PITCH;                  // [KEYS][PITCH]
    bf16* qs = vs + KEYS * PITCH;                  // [2][BR][PITCH]
    bf16* dos = qs + 2 * BR * PITCH;               // [2][BR][PITCH]
    float* ls = reinterpret_cast<float*>(dos + 2 * BR * PITCH);  // [2][BR]
    float* dl = ls + 2 * BR;                                     // [2][BR]
    float* xs = dl + 2 * BR;   // HAND_OVER: [WARPS][XF][32] handed over
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int hk = blockIdx.x % geo.hkv;
    const long long b = blockIdx.x / geo.hkv;
    const int k0 = blockIdx.y * KEYS;
    const int kg = warp / SPLIT, da0 = (warp % SPLIT) * DA;
    const int wk0 = k0 + kg * 16;          // the warp's 16 keys
    const int kpa = wk0 + lane / 4, kpb = kpa + 8;  // this thread's two
    const int offset = geo.lk_valid - geo.lq;
    const long long rowbase = (b * geo.hkv + hk) * geo.nrows_pad;

    // the rows of the band, from a multiple of BR: query position i sees a
    // key >= k0 only if i + offset >= k0 (causal), and one <= kmax only if
    // i + offset - window < kmax (window)
    int r_lo = 0, r_hi = 0;
    if (k0 < geo.lk_valid) {
        const int kmax = min(k0 + KEYS, geo.lk_valid) - 1;
        const int i_lo = geo.causal ? max(0, k0 - offset) : 0;
        const int i_hi = geo.window > 0 ? min(geo.lq, kmax - offset + geo.window)
                                        : geo.lq;
        if (i_hi > i_lo) {
            r_lo = i_lo * geo.g / BR * BR;
            r_hi = i_hi * geo.g;
        }
    }
    const int ntile = r_hi > r_lo ? (r_hi - r_lo + BR - 1) / BR : 0;

    float acc_k[NA][4], acc_v[NA][4];
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            acc_k[i][u] = 0.0f;
            acc_v[i][u] = 0.0f;
        }

    auto load_tile = [&](int i) {   // row tile i into stage i & 1
        const int s = i & 1, r0 = r_lo + i * BR;
        load_rows<BR, DP, NTH>(qs + s * BR * PITCH, q, st.q, b, hk, r0, geo, vec);
        load_rows<BR, DP, NTH>(dos + s * BR * PITCH, dout, st.dout, b, hk, r0, geo,
                               vec);
        // lse and D rows r0 .. r0 + BR - 1 lie inside the padded scratch
        if (tid < BR / 4)
            cp_async16(ls + s * BR + 4 * tid, lse + rowbase + r0 + 4 * tid, 16);
        else if (tid < BR / 2)
            cp_async16(dl + s * BR + 4 * (tid - BR / 4),
                       dsum + rowbase + r0 + 4 * (tid - BR / 4), 16);
    };

    if (ntile > 0) {
        load_keys<KEYS, DP, NTH>(ks, k, st.k, b, hk, k0, geo.lk_valid, geo, vec);
        load_keys<KEYS, DP, NTH>(vs, v, st.v, b, hk, k0, geo.lk_valid, geo, vec);
        load_tile(0);
        cp_async_commit();
    }
    for (int i = 0; i < ntile; ++i) {
        if (i + 1 < ntile) {
            load_tile(i + 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int r0 = r_lo + i * BR;
        const int qlo = r0 / geo.g + offset;
        const int qhi = (min(r0 + BR, geo.nrows) - 1) / geo.g + offset;
        if (!(wk0 >= geo.lk_valid || (geo.causal && qhi < wk0)
              || (geo.window > 0 && wk0 + 15 <= qlo - geo.window))) {
            const bf16* qt = qs + (i & 1) * BR * PITCH;
            const bf16* dot = dos + (i & 1) * BR * PITCH;
            const float* lt = ls + (i & 1) * BR;
            const float* dt = dl + (i & 1) * BR;
            // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BR rows;
            // at SPLIT = 2 the pair's first warp computes S^T, its second
            // dP^T, and each hands its tile to the other (HAND_OVER)
            float sp[BR / 8][4], ds[BR / 8][4];
#pragma unroll
            for (int j = 0; j < BR / 8; ++j)
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    sp[j][u] = 0.0f;
                    ds[j][u] = 0.0f;
                }
            if (!C::HAND_OVER || da0 == 0)
                dot_rows<BR, DP>(sp, ks + kg * 16 * PITCH, qt, lane);
            if (!C::HAND_OVER || da0 != 0)
                dot_rows<BR, DP>(ds, vs + kg * 16 * PITCH, dot, lane);
            if constexpr (C::HAND_OVER) {
                float* mine = xs + warp * XF * 32;
                const float* theirs = xs + (warp ^ 1) * XF * 32;
#pragma unroll
                for (int j = 0; j < BR / 8; ++j)
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        mine[(4 * j + u) * 32 + lane] = da0 == 0 ? sp[j][u] : ds[j][u];
                pair_sync(1 + kg);
#pragma unroll
                for (int j = 0; j < BR / 8; ++j)
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const float x = theirs[(4 * j + u) * 32 + lane];
                        if (da0 == 0) ds[j][u] = x;
                        else sp[j][u] = x;
                    }
            }
            const bool edge = wk0 + 15 >= geo.lk_valid
                              || (geo.causal && wk0 + 15 > qlo)
                              || (geo.window > 0 && wk0 <= qhi - geo.window)
                              || r0 + BR > geo.nrows;
            // P and dS in place: element u of n8 tile nt is key kpa (u < 2)
            // or kpb, row r0 + col
#pragma unroll
            for (int nt = 0; nt < BR / 8; ++nt) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int col = nt * 8 + (lane % 4) * 2 + (u & 1);
                    bool ok = true;
                    if (edge) {
                        const int row = r0 + col;
                        ok = row < geo.nrows
                             && visible(u < 2 ? kpa : kpb, row / geo.g + offset, geo);
                    }
                    const float p = ok ? exp2f(sp[nt][u] * geo.scale_log2 - lt[col])
                                       : 0.0f;
                    sp[nt][u] = p;
                    ds[nt][u] = p * (ds[nt][u] - dt[col]);
                }
            }
            // dV += P^T dO, dK += dS^T Q over the warp's DA head dims
#pragma unroll
            for (int kc = 0; kc < BR / 16; ++kc) {
                uint32_t hi[4], lo[4];
                pack_a(sp, kc, hi, lo);
                acc_split<NA, DP>(acc_v, hi, lo, dot + kc * 16 * PITCH + da0, lane);
                pack_a(ds, kc, hi, lo);
                acc_split<NA, DP>(acc_k, hi, lo, qt + kc * 16 * PITCH + da0, lane);
            }
        }
        __syncthreads();  // this tile's stage is refilled next iteration
    }

    // dK (times scale) and dV of keys kpa, kpb; zeros for keys no row sees
    const bool pk = ((st.dk[0] | st.dk[1] | st.dk[2]) & 1) == 0;
    const bool pv = ((st.dv[0] | st.dv[1] | st.dv[2]) & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int kp = half ? kpb : kpa;
        if (kp >= geo.lk) continue;
        bf16* krow = dk + b * st.dk[0] + kp * st.dk[1] + hk * st.dk[2];
        bf16* vrow = dv + b * st.dv[0] + kp * st.dv[1] + hk * st.dv[2];
#pragma unroll
        for (int nt = 0; nt < NA; ++nt) {
            const int col = da0 + nt * 8 + (lane % 4) * 2;
            const float k0v = acc_k[nt][2 * half] * geo.scale;
            const float k1v = acc_k[nt][2 * half + 1] * geo.scale;
            const float v0 = acc_v[nt][2 * half], v1 = acc_v[nt][2 * half + 1];
            if (col + 1 < geo.d && pk) {
                *reinterpret_cast<__nv_bfloat162*>(krow + col) = __floats2bfloat162_rn(k0v, k1v);
            } else {
                if (col < geo.d) krow[col] = __float2bfloat16(k0v);
                if (col + 1 < geo.d) krow[col + 1] = __float2bfloat16(k1v);
            }
            if (col + 1 < geo.d && pv) {
                *reinterpret_cast<__nv_bfloat162*>(vrow + col) = __floats2bfloat162_rn(v0, v1);
            } else {
                if (col < geo.d) vrow[col] = __float2bfloat16(v0);
                if (col + 1 < geo.d) vrow[col + 1] = __float2bfloat16(v1);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// 3. dQ of a row block, over the key tiles of its band
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(32 * Rows<DP>::WARPS, Rows<DP>::DQ_BLOCKS)
bwd_mma_dq(bf16* dq, const float* __restrict__ lse, const float* __restrict__ dsum,
           const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout, Geo geo,
           Strides st, int nrb, int vec) {
    constexpr int PITCH = DP + 8, NT = DP / 8, BK = Dq<DP>::BK;
    constexpr int ROWS = 16 * Rows<DP>::WARPS, NTH = 32 * Rows<DP>::WARPS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][PITCH]
    bf16* dos = qs + ROWS * PITCH;                 // [ROWS][PITCH]
    bf16* ks = dos + ROWS * PITCH;                 // [2][BK][PITCH]
    bf16* vs = ks + 2 * BK * PITCH;                // [2][BK][PITCH]
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int hk = blockIdx.x % geo.hkv;
    const long long b = blockIdx.x / geo.hkv;
    const int r0 = (nrb - 1 - static_cast<int>(blockIdx.y)) * ROWS;
    const int offset = geo.lk_valid - geo.lq;
    const long long rowbase = (b * geo.hkv + hk) * geo.nrows_pad;
    const int wr0 = r0 + warp * 16;
    const int ra = wr0 + lane / 4, rb = ra + 8;

    int t0, ntiles, kend;
    key_band(r0, min(r0 + ROWS, geo.nrows), geo, BK, t0, ntiles, kend);
    if (t0 < ntiles) {
        load_rows<ROWS, DP, NTH>(qs, q, st.q, b, hk, r0, geo, vec);
        load_rows<ROWS, DP, NTH>(dos, dout, st.dout, b, hk, r0, geo, vec);
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
    const float lse_a = lse[rowbase + ra], lse_b = lse[rowbase + rb];
    const float d_a = dsum[rowbase + ra], d_b = dsum[rowbase + rb];
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
        const int k0 = t * BK;
        if (warp_active && !(geo.causal && k0 > qpos_last)
            && !(geo.window > 0 && k0 + BK - 1 <= qpos_first - geo.window)) {
            const bf16* kt = ks + (t & 1) * BK * PITCH;
            const bf16* vt = vs + (t & 1) * BK * PITCH;
            // S = Q K^T and dP = dO V^T: the warp's 16 rows x BK keys
            float sp[BK / 8][4], ds[BK / 8][4];
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    sp[j][u] = 0.0f;
                    ds[j][u] = 0.0f;
                }
            dot_rows<BK, DP>(sp, qs + warp * 16 * PITCH, kt, lane);
            dot_rows<BK, DP>(ds, dos + warp * 16 * PITCH, vt, lane);
            const bool edge = k0 + BK > geo.lk_valid
                              || (geo.causal && k0 + BK - 1 > qpos_first)
                              || (geo.window > 0 && k0 <= qpos_last - geo.window);
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const bool row_b = u >= 2;
                    bool ok = true;
                    if (edge)
                        ok = visible(k0 + nt * 8 + (lane % 4) * 2 + (u & 1),
                                     row_b ? qpos_b : qpos_a, geo);
                    const float p = ok ? exp2f(sp[nt][u] * geo.scale_log2
                                               - (row_b ? lse_b : lse_a))
                                       : 0.0f;
                    ds[nt][u] = p * (ds[nt][u] - (row_b ? d_b : d_a));
                }
            }
            // dQ += dS K
#pragma unroll
            for (int kc = 0; kc < BK / 16; ++kc) {
                uint32_t hi[4], lo[4];
                pack_a(ds, kc, hi, lo);
                acc_split<NT, DP>(acc, hi, lo, kt + kc * 16 * PITCH, lane);
            }
        }
        __syncthreads();  // this tile's stage is refilled next iteration
    }

    if (!warp_active) return;
    const bool pairs = ((st.dq[0] | st.dq[1] | st.dq[2]) & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int gr = half ? rb : ra;
        if (gr >= geo.nrows) continue;
        bf16* row = dq + row_off(st.dq, b, hk, gr, geo.g);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int col = nt * 8 + (lane % 4) * 2;
            const float x0 = acc[nt][2 * half] * geo.scale;
            const float x1 = acc[nt][2 * half + 1] * geo.scale;
            if (pairs && col + 1 < geo.d) {
                *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x0, x1);
            } else {
                if (col < geo.d) row[col] = __float2bfloat16(x0);
                if (col + 1 < geo.d) row[col + 1] = __float2bfloat16(x1);
            }
        }
    }
}

template <typename K>
cudaError_t allow(K kernel, int smem) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

template <int DP>
int launch(void* dq, void* dk, void* dv, const void* q, const void* k,
           const void* v, const void* o, const void* dout, float* lse,
           float* dsum, int batch, const Geo& geo, const Strides& st, int vec,
           cudaStream_t stream) {
    using C = Dkv<DP>;
    constexpr int PITCH = DP + 8, E = static_cast<int>(sizeof(bf16));
    constexpr int ROWS = 16 * Rows<DP>::WARPS, NTH = 32 * Rows<DP>::WARPS;
    const int s_lse = (ROWS + 2 * BK1) * PITCH * E;
    const int s_dkv = (2 * C::KEYS + 4 * C::BR) * PITCH * E
                      + (4 * C::BR + (C::HAND_OVER ? C::WARPS * C::BR / 2 * 32 : 0))
                            * static_cast<int>(sizeof(float));
    const int s_dq = (2 * ROWS + 4 * Dq<DP>::BK) * PITCH * E;
    cudaError_t err;
    if ((err = allow(bwd_mma_lse<DP>, s_lse)) != cudaSuccess) return err;
    if ((err = allow(bwd_mma_dkv<DP>, s_dkv)) != cudaSuccess) return err;
    if ((err = allow(bwd_mma_dq<DP>, s_dq)) != cudaSuccess) return err;
    const bf16* tq = static_cast<const bf16*>(q);
    const bf16* tk = static_cast<const bf16*>(k);
    const bf16* tv = static_cast<const bf16*>(v);
    const bf16* td = static_cast<const bf16*>(dout);
    // pass 1 covers the padded rows (their lse and D are 0), pass 3 the rows
    const int nrb1 = geo.nrows_pad / ROWS, nrb3 = (geo.nrows + ROWS - 1) / ROWS;
    const dim3 keys(batch * geo.hkv, (geo.lk + C::KEYS - 1) / C::KEYS);
    bwd_mma_lse<DP><<<dim3(batch * geo.hkv, nrb1), NTH, s_lse, stream>>>(
        lse, dsum, tq, tk, static_cast<const bf16*>(o), td, geo, st, nrb1, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_mma_dkv<DP><<<keys, 32 * C::WARPS, s_dkv, stream>>>(
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, dsum, tq, tk, tv, td,
        geo, st, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_mma_dq<DP><<<dim3(batch * geo.hkv, nrb3), NTH, s_dq, stream>>>(
        static_cast<bf16*>(dq), lse, dsum, tq, tk, tv, td, geo, st, nrb3, vec);
    return cudaGetLastError();
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// bf16 only, head dim <= 256; window 0 means none.  st: 24 element strides,
// (batch, row, head) of q, k, v, o, dout, dq, dk, dv in that order (the
// head-dim axis contiguous).  lse and dsum: float32 scratch of batch * hkv *
// ceil(lq * hq / hkv / 128) * 128 each (rows padded to 128).  dk and dv are
// written for all lk keys (zeros past lk_valid).
extern "C" int flash_attention_bwd_mma(void* dq, void* dk, void* dv, const void* q,
                                       const void* k, const void* v, const void* o,
                                       const void* dout, float* lse, float* dsum,
                                       int batch, int lq, int lk, int lk_valid,
                                       int hq, int hkv, int d, int causal,
                                       int window, float scale,
                                       const long long* st, void* stream) {
    if (d > DMAX || d <= 0 || hkv <= 0 || hq % hkv != 0 || window < 0
        || lk_valid < 0 || lk_valid > lk)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch <= 0 || lq <= 0 || lk <= 0) return static_cast<int>(cudaGetLastError());
    const int g = hq / hkv;
    const long long nrows = static_cast<long long>(lq) * g;
    const long long npad = (nrows + ROWS_PAD - 1) / ROWS_PAD * ROWS_PAD;
    if (npad / 64 > 65535 || (lk + 15) / 16 > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    Strides s;
    long long* dst[8] = {s.q, s.k, s.v, s.o, s.dout, s.dq, s.dk, s.dv};
    for (int t = 0; t < 8; ++t)
        for (int i = 0; i < 3; ++i) dst[t][i] = st[3 * t + i];
    // cp.async needs every row chunk 16-byte aligned: base pointers and the
    // strides of q, k, v and dout in multiples of 8 elements
    int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
    for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
    for (int i = 12; i < 15; ++i) vec = vec && st[i] % 8 == 0;
    const Geo geo{lq, lk, lk_valid, g, d, causal, window, hkv,
                  static_cast<int>(nrows), static_cast<int>(npad), scale,
                  scale * LOG2E};
    cudaStream_t cs = static_cast<cudaStream_t>(stream);
    if (d <= 16)
        return launch<16>(dq, dk, dv, q, k, v, o, dout, lse, dsum, batch, geo, s, vec, cs);
    if (d <= 32)
        return launch<32>(dq, dk, dv, q, k, v, o, dout, lse, dsum, batch, geo, s, vec, cs);
    if (d <= 64)
        return launch<64>(dq, dk, dv, q, k, v, o, dout, lse, dsum, batch, geo, s, vec, cs);
    if (d <= 128)
        return launch<128>(dq, dk, dv, q, k, v, o, dout, lse, dsum, batch, geo, s, vec, cs);
    return launch<256>(dq, dk, dv, q, k, v, o, dout, lse, dsum, batch, geo, s, vec, cs);
}
