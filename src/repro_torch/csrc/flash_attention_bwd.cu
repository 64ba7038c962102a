// K4b flash_attention_bwd, route "f32": the backward of K4 in float32 on the
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
// gets zeros.  Inputs, outputs and every sum are float32.  bf16 takes route
// "mma" (flash_attention_bwd_mma.cu), whose three passes this route keeps.
//
// Replaces no TPU kernel: the reference's models differentiate their jnp
// blockwise attention (repro/models/layers.py `attention`, `_attention_banded`
// for the window) through XLA, and K4 stands in for that function in the
// port; this is its gradient.
//
// What bounds it on Hopper: operations.  Per visible (row, key) pair the
// algebra is 10 D flops against q, k, v, o, dO, dq, dk and dv read or
// written once, far above the card's flops per byte.  On the CUDA cores
// float32 peaks at 67 TFLOP/s; the TF32 tensor cores give 495, but TF32
// keeps 10 mantissa bits.  One TF32 rounding of the operands of any one of
// the five products misses K4b's float32 tolerance (1e-4 of the scale +
// 1e-4 |x|) by 1.3-7.9x at the train shapes; with every product as 3xTF32
// all stay within 0.014 of it (`tools/k4b_rounding.py --float32`, the plain
// algebra on the CPU; `flash_attention_bwd_tf32_plain` is this route's
// rounding).  So each product runs three times: 48 D tensor-core flops a
// pair (S in all three passes, dP in two, the three products once, each
// x3).
//
// Design (route "mma"'s passes; no atomics, every sum in a fixed order, so
// every call gives the same bits):
// - Every product is `mma.sync.aligned.m16n8k8` with tf32 operands and
//   float32 accumulators, as 3xTF32: each operand x is split when its
//   fragment is loaded into big = rna(x) (round to nearest, ties away: the
//   bits of `cvt.rna.tf32.f32`, by an integer add and mask, which is
//   faster) and small = x - big (exact), whose 13 low bits the tensor cores
//   do not read; small . big, big . small and big . big are issued in that
//   order.
// - The tensor cores truncate what they add to an accumulator, a drift
//   that grows with the length of a sum.  Pass 2's sums run over up to Lq g
//   rows (30,000 at recurrentgemma-2b's train shape), where it takes dK and
//   dV to 1.13x the float32 tolerance; so pass 2 sums segments of at most
//   SEG_ROWS = 4096 rows (0.22x at 3,072), each block one segment of its
//   band (grid z), and `bwd_tf32_dkv_sum` adds the segments' partial sums
//   in segment order by rounding adds (scratch the wrapper allocates when
//   Lq g > 4096).  A fresh accumulator for each k8 step would do the same
//   at no scratch, but costs pass 2 registers it does not have (it spills).
//   Pass 3's sums over keys stay well inside the tolerance.
// - Operands stay float32 in shared memory, rows padded by 4 floats (pitch
//   DP + 4, = 4 mod 16 words).  Fragments read along a row (Q, K, V, dO as
//   the operands of S and dP) come by `ldmatrix` on b16 pairs: one 8 x 8
//   b16 matrix is 8 rows of 4 floats, the tf32 fragment layout, and the 8
//   rows land on distinct banks.  Fragments read across rows (dO and Q as B
//   of dV += P^T dO and dK += dS^T Q, K as B of dQ += dS K) have no 32-bit
//   `ldmatrix.trans`, so they are scalar loads.  Their A operand is an
//   accumulator (P^T, dS^T, dS), whose thread holds columns 2t and 2t + 1,
//   not the A fragment's t and t + 4; the product runs over the k8 step in
//   that permuted order (k = t at row 2t, k = t + 4 at row 2t + 1), so the
//   accumulators become A fragments without a shuffle and a warp's scalar
//   loads of rows 2t (2t + 1), columns g hit 32 distinct banks at that pitch.
// - The head dim is zero-padded to DP = 16, 32, 64, 128 or 256.  Copies are
//   16-byte `cp.async`, or plain loads for views whose rows are not 16-byte
//   aligned.
// 1. `bwd_tf32_lse`: one block per (batch, KV head, 64 rows; 4 warps of 16):
//    S = Q K^T against key tiles of the band (32 keys, 16 at DP = 256;
//    2-stage `cp.async` ring), the running max and sum in registers, then
//    lse (log2 units of scale * S) and D = dO . O to float32 scratch, rows
//    padded to 128.
// 2. `bwd_tf32_dkv`: one block per (batch, KV head, 64 keys).  A warp owns
//    16 keys and holds their dK and dV in float32 registers (DP / 4 a
//    thread each; 4 warps, 2 blocks an SM up to DP = 128); at DP = 256 two
//    warps share 16 keys, each holding 128 of the head dims (8 warps, one
//    block an SM), the first computing S^T and the second dP^T and handing
//    them over through shared memory at a named barrier of the pair.  The block walks the rows of its band in tiles (16 rows at DP >=
//    128, 32 below; a 2-stage `cp.async` ring of Q, dO, lse and D),
//    recomputing S^T = K Q^T and dP^T = V dO^T, forming P and dS in
//    registers and accumulating dV += P^T dO and dK += dS^T Q.  Tiles
//    wholly outside a warp's band are skipped and masked only where they
//    straddle an edge.
// 3. `bwd_tf32_dq`: one block per (batch, KV head, 64 rows; 4 warps of 16)
//    with dQ in registers (DP / 2 a thread); it walks the key tiles of its
//    band (16 keys at DP >= 128, 32 below) with a 2-stage ring of K and V,
//    recomputes S and dP and runs dQ += dS K.  Row blocks run last first
//    (the heaviest under the causal mask).
// No kernel spills (`-Xptxas -v`, which chip_smoke.py logs at build time).
// `tools/k4b_k5b_variants.py` times this design against the CUDA-core
// design it replaced and against the choices set by the K4B_* macros below.
// Q, K, V, O, dO, dQ, dK and dV take batch, row and head strides (the last
// axis is contiguous), so views and a transposed dO are read in place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PAD = 128; // lse and D scratch rows: a multiple of this
constexpr int WARPS_ROWS = 4; // warps of passes 1 and 3 (16 rows each)
constexpr int DMAX = 256;
constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// The choices `tools/k4b_k5b_variants.py` sets by -D to time alternatives;
// the defaults are this design's, in terms of the padded head dim DP.
#ifndef K4B_DKV_SPLIT          // pass 2's warps sharing 16 keys
#define K4B_DKV_SPLIT (DP > 128 ? 2 : 1)
#endif
#ifndef K4B_TF32_CVT           // 1: rna by `cvt.rna.tf32.f32`; 0: by integer ops
#define K4B_TF32_CVT 0
#endif
#ifndef K4B_SMALL_RNA          // 1: the small part rounded by rna too
#define K4B_SMALL_RNA 0
#endif
#ifndef K4B_SEG_ROWS           // pass 2's rows a segment (a multiple of 32)
#define K4B_SEG_ROWS 4096
#endif
constexpr int SEG_ROWS = K4B_SEG_ROWS;
#ifndef K4B_DKV_BLOCKS         // pass 2's blocks an SM
#define K4B_DKV_BLOCKS (DP > 128 ? 1 : 2)
#endif

template <int DP>
struct Lse {                                     // pass 1
    static constexpr int BK = DP > 128 ? 16 : 32;    // keys a tile
    static constexpr int BLOCKS = DP > 128 ? 2 : 3;  // an SM
};

template <int DP>
struct Dkv {                                     // pass 2's blocks and tiles
    static constexpr int SPLIT = K4B_DKV_SPLIT;      // warps sharing 16 keys
    static constexpr int WARPS = 4 * SPLIT;
    static constexpr int DA = DP / SPLIT;            // dK, dV dims a warp holds
    static constexpr int KEYS = 64;                  // keys per block
    static constexpr int BR = DP > 64 ? 16 : 32;     // rows per tile
    static constexpr int BLOCKS = K4B_DKV_BLOCKS;    // an SM
};

template <int DP>
struct Dq {                                      // pass 3
    static constexpr int BK = DP > 64 ? 16 : 32;     // keys a tile
    static constexpr int BLOCKS = DP > 128 ? 1 : DP > 64 ? 2 : 3;  // an SM
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

// four 8 x 8 b16 matrices = four 8-row x 4-float tiles; lane l's register i
// is float l % 4 of row l / 4 of tile i, whose row addresses lanes 8 i .. 8 i
// + 7 give
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// the 64 threads of warps 2 (id - 1) and 2 (id - 1) + 1 meet (named barrier)
__device__ __forceinline__ void pair_sync(int id) {
    asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
}

// x rounded to tf32, to nearest, ties away from zero; the 13 low bits zero
__device__ __forceinline__ uint32_t rna(float x) {
#if K4B_TF32_CVT
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r & 0xffffe000u;
#else
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
#endif
}

// x as tf32 big + small: big = rna(x), small the remainder x - big (exact),
// whose 13 low bits the tensor cores do not read
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    big = rna(x);
    const float rest = x - __uint_as_float(big);
#if K4B_SMALL_RNA
    small = rna(rest);
#else
    small = __float_as_uint(rest);
#endif
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
    mma_tf32(c, as, bb0, bb1);
    mma_tf32(c, ab, bs0, bs1);
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

// rows r0 .. r0 + R - 1 of a query-side tensor (q or dO) into dst [R][DP + 4],
// zeros past nrows and d
template <int R, int DP, int NTH>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          const long long* st, long long b, int hk,
                                          int r0, const Geo& geo, bool vec) {
    constexpr int PITCH = DP + 4, CH = DP / 4;
    for (int e = threadIdx.x; e < R * CH; e += NTH) {
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

__device__ __forceinline__ bool visible(int kp, int qpos, const Geo& geo) {
    return kp < geo.lk_valid && (!geo.causal || kp <= qpos)
           && (geo.window <= 0 || kp > qpos - geo.window);
}

// c[n] += A . B^T over DP: A the 16 rows at `a`, B the NB rows at `bt`, both
// row-major over the head dim (pitch DP + 4): S = Q K^T and its kin
template <int NB, int DP>
__device__ __forceinline__ void dot_rows(float (*c)[4], const float* a,
                                         const float* bt, int lane) {
    constexpr int PITCH = DP + 4;
    const int mi = lane / 8, lr = lane % 8;
    // tile i of the A fragment: rows (i & 1) * 8, columns (i >> 1) * 4
    const float* pa = a + ((mi & 1) * 8 + lr) * PITCH + (mi >> 1) * 4;
    // tile i of B (16 rows): rows (i >> 1) * 8, columns (i & 1) * 4
    const float* pb = bt + ((mi >> 1) * 8 + lr) * PITCH + (mi & 1) * 4;
#pragma unroll 2
    for (int kc = 0; kc < DP / 8; ++kc) {
        uint32_t fa[4], ab[4], as[4];
        ldsm_x4(fa, pa + kc * 8);
        split_n<4>(fa, ab, as);
#pragma unroll
        for (int np = 0; np < NB / 16; ++np) {
            uint32_t fb[4], bb[4], bs[4];
            ldsm_x4(fb, pb + np * 16 * PITCH + kc * 8);
            split_n<4>(fb, bb, bs);
            mma3(c[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
            mma3(c[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
        }
    }
}

// acc[n] += A . B for the k8 step of accumulator tile `c` (A its big and
// small fragments): B the 8 rows at `b` (pitch DP + 4) read across rows in
// the permuted order, its NA * 8 columns from `b`'s column 0 (dV += P^T dO
// and its kin)
template <int NA, int DP>
__device__ __forceinline__ void acc_rows(float (*acc)[4], const uint32_t* ab,
                                         const uint32_t* as, const float* b,
                                         int lane) {
    constexpr int PITCH = DP + 4;
    const float* p0 = b + (2 * (lane % 4)) * PITCH + lane / 4;
    const float* p1 = p0 + PITCH;
#pragma unroll
    for (int dn = 0; dn < NA; ++dn) {
        uint32_t bb0, bs0, bb1, bs1;
        split(p0[dn * 8], bb0, bs0);
        split(p1[dn * 8], bb1, bs1);
        mma3(acc[dn], ab, as, bb0, bb1, bs0, bs1);
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
__global__ void __launch_bounds__(32 * WARPS_ROWS, Lse<DP>::BLOCKS)
bwd_tf32_lse(float* lse, float* dsum, const float* __restrict__ q,
             const float* __restrict__ k, const float* __restrict__ o,
             const float* __restrict__ dout, Geo geo, Strides st, int nrb, int vec) {
    constexpr int PITCH = DP + 4, BK = Lse<DP>::BK;
    constexpr int ROWS = 16 * WARPS_ROWS, NTH = 32 * WARPS_ROWS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qs = reinterpret_cast<float*>(smem_raw);  // [ROWS][PITCH]
    float* ks = qs + ROWS * PITCH;                   // [2][BK][PITCH]
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
            const float* orow = o + row_off(st.o, b, hk, gr, geo.g);
            const float* drow = dout + row_off(st.dout, b, hk, gr, geo.g);
            for (int dd = lane; dd < geo.d; dd += 32) part = fmaf(drow[dd], orow[dd], part);
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
// 2. dK and dV of a key block, over the rows of its band
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(32 * Dkv<DP>::WARPS, Dkv<DP>::BLOCKS)
bwd_tf32_dkv(float* dk, float* dv, float* part, const float* __restrict__ lse,
             const float* __restrict__ dsum, const float* __restrict__ q,
             const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ dout, Geo geo, Strides st, int vec) {
    using C = Dkv<DP>;
    constexpr int PITCH = DP + 4, SPLIT = C::SPLIT, DA = C::DA, KEYS = C::KEYS;
    constexpr int BR = C::BR, NA = DA / 8, XF = BR / 2, NTH = 32 * C::WARPS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* ks = reinterpret_cast<float*>(smem_raw);  // [KEYS][PITCH]
    float* vs = ks + KEYS * PITCH;                   // [KEYS][PITCH]
    float* qs = vs + KEYS * PITCH;                   // [2][BR][PITCH]
    float* dos = qs + 2 * BR * PITCH;                // [2][BR][PITCH]
    float* ls = dos + 2 * BR * PITCH;                // [2][BR]
    float* dl = ls + 2 * BR;                         // [2][BR]
    float* xs = dl + 2 * BR;   // SPLIT = 2: [WARPS][XF][32] handed over
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
    // this block's segment of them (rows SEG_ROWS z .. SEG_ROWS (z + 1) - 1)
    r_lo = max(r_lo, static_cast<int>(blockIdx.z) * SEG_ROWS);
    r_hi = min(r_hi, static_cast<int>(blockIdx.z + 1) * SEG_ROWS);
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
            const float* qt = qs + (i & 1) * BR * PITCH;
            const float* dot = dos + (i & 1) * BR * PITCH;
            const float* lt = ls + (i & 1) * BR;
            const float* dt = dl + (i & 1) * BR;
            // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BR rows;
            // at SPLIT = 2 the pair's first warp computes S^T, its second
            // dP^T, and each hands its tile to the other
            float sp[BR / 8][4], ds[BR / 8][4];
#pragma unroll
            for (int j = 0; j < BR / 8; ++j)
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    sp[j][u] = 0.0f;
                    ds[j][u] = 0.0f;
                }
            if (SPLIT == 1 || da0 == 0)
                dot_rows<BR, DP>(sp, ks + kg * 16 * PITCH, qt, lane);
            if (SPLIT == 1 || da0 != 0)
                dot_rows<BR, DP>(ds, vs + kg * 16 * PITCH, dot, lane);
            if constexpr (SPLIT == 2) {
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
            // dV += P^T dO, dK += dS^T Q over the warp's DA head dims, one k8
            // step (8 rows) per n8 tile of P^T and dS^T
#pragma unroll
            for (int kc = 0; kc < BR / 8; ++kc) {
                uint32_t ab[4], as[4];
                acc_to_a(sp[kc], ab, as);
                acc_rows<NA, DP>(acc_v, ab, as, dot + kc * 8 * PITCH + da0, lane);
                acc_to_a(ds[kc], ab, as);
                acc_rows<NA, DP>(acc_k, ab, as, qt + kc * 8 * PITCH + da0, lane);
            }
        }
        __syncthreads();  // this tile's stage is refilled next iteration
    }

    // dK (times scale) and dV of keys kpa, kpb; zeros for keys no row sees.
    // With more than one segment, the segment's sums unscaled to `part`
    // ([segments][2][batch * hkv][lk][d]), which `bwd_tf32_dkv_sum` adds
    const bool whole = part == nullptr;
    const long long bh = blockIdx.x, nbh = gridDim.x;
    const long long pk_off = (static_cast<long long>(blockIdx.z) * 2 * nbh + bh) * geo.lk;
    const long long pv_off = pk_off + nbh * geo.lk;
    const float sk = whole ? geo.scale : 1.0f;
    // float2 stores where every row starts at an even element
    const bool pk = (((whole ? st.dk[0] | st.dk[1] | st.dk[2] : 0) | geo.d) & 1) == 0;
    const bool pv = (((whole ? st.dv[0] | st.dv[1] | st.dv[2] : 0) | geo.d) & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int kp = half ? kpb : kpa;
        if (kp >= geo.lk) continue;
        float* krow = whole ? dk + b * st.dk[0] + kp * st.dk[1] + hk * st.dk[2]
                            : part + (pk_off + kp) * geo.d;
        float* vrow = whole ? dv + b * st.dv[0] + kp * st.dv[1] + hk * st.dv[2]
                            : part + (pv_off + kp) * geo.d;
#pragma unroll
        for (int nt = 0; nt < NA; ++nt) {
            const int col = da0 + nt * 8 + (lane % 4) * 2;
            const float k0v = acc_k[nt][2 * half] * sk;
            const float k1v = acc_k[nt][2 * half + 1] * sk;
            const float v0 = acc_v[nt][2 * half], v1 = acc_v[nt][2 * half + 1];
            if (col + 1 < geo.d && pk) {
                *reinterpret_cast<float2*>(krow + col) = make_float2(k0v, k1v);
            } else {
                if (col < geo.d) krow[col] = k0v;
                if (col + 1 < geo.d) krow[col + 1] = k1v;
            }
            if (col + 1 < geo.d && pv) {
                *reinterpret_cast<float2*>(vrow + col) = make_float2(v0, v1);
            } else {
                if (col < geo.d) vrow[col] = v0;
                if (col + 1 < geo.d) vrow[col + 1] = v1;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// 3. dQ of a row block, over the key tiles of its band
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(32 * WARPS_ROWS, Dq<DP>::BLOCKS)
bwd_tf32_dq(float* dq, const float* __restrict__ lse, const float* __restrict__ dsum,
            const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout, Geo geo,
            Strides st, int nrb, int vec) {
    constexpr int PITCH = DP + 4, NT = DP / 8, BK = Dq<DP>::BK;
    constexpr int ROWS = 16 * WARPS_ROWS, NTH = 32 * WARPS_ROWS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qs = reinterpret_cast<float*>(smem_raw);  // [ROWS][PITCH]
    float* dos = qs + ROWS * PITCH;                  // [ROWS][PITCH]
    float* ks = dos + ROWS * PITCH;                  // [2][BK][PITCH]
    float* vs = ks + 2 * BK * PITCH;                 // [2][BK][PITCH]
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
            const float* kt = ks + (t & 1) * BK * PITCH;
            const float* vt = vs + (t & 1) * BK * PITCH;
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
            // dQ += dS K, one k8 step (8 keys) per n8 tile of dS
#pragma unroll
            for (int kc = 0; kc < BK / 8; ++kc) {
                uint32_t ab[4], as[4];
                acc_to_a(ds[kc], ab, as);
                acc_rows<NT, DP>(acc, ab, as, kt + kc * 8 * PITCH, lane);
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
        float* row = dq + row_off(st.dq, b, hk, gr, geo.g);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int col = nt * 8 + (lane % 4) * 2;
            const float x0 = acc[nt][2 * half] * geo.scale;
            const float x1 = acc[nt][2 * half + 1] * geo.scale;
            if (pairs && col + 1 < geo.d) {
                *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
            } else {
                if (col < geo.d) row[col] = x0;
                if (col + 1 < geo.d) row[col + 1] = x1;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// 2b. dK (times scale) and dV: pass 2's segment sums added in segment order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
bwd_tf32_dkv_sum(float* dk, float* dv, const float* __restrict__ part, int nseg,
                 long long nbh, Geo geo, Strides st) {
    const long long row = static_cast<long long>(blockIdx.x) * 4 + threadIdx.x / 64;
    if (row >= nbh * geo.lk) return;
    const long long bh = row / geo.lk;
    const int kp = static_cast<int>(row % geo.lk);
    const long long b = bh / geo.hkv;
    const int hk = static_cast<int>(bh % geo.hkv);
    float* krow = dk + b * st.dk[0] + kp * st.dk[1] + hk * st.dk[2];
    float* vrow = dv + b * st.dv[0] + kp * st.dv[1] + hk * st.dv[2];
    const long long seg = 2 * nbh * geo.lk * geo.d;   // floats a segment
    const float* pk = part + row * geo.d;
    const float* pv = pk + nbh * geo.lk * geo.d;
    for (int col = threadIdx.x % 64; col < geo.d; col += 64) {
        float xk = 0.0f, xv = 0.0f;
        for (int z = 0; z < nseg; ++z) {
            xk += pk[z * seg + col];
            xv += pv[z * seg + col];
        }
        krow[col] = xk * geo.scale;
        vrow[col] = xv;
    }
}

template <typename K>
cudaError_t allow(K kernel, int smem) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

template <int DP>
int launch(float* dq, float* dk, float* dv, const float* q, const float* k,
           const float* v, const float* o, const float* dout, float* lse,
           float* dsum, float* part, int nseg, int batch, const Geo& geo,
           const Strides& st, int vec, cudaStream_t stream) {
    using C = Dkv<DP>;
    constexpr int PITCH = DP + 4, E = static_cast<int>(sizeof(float));
    constexpr int ROWS = 16 * WARPS_ROWS, NTH = 32 * WARPS_ROWS;
    const int s_lse = (ROWS + 2 * Lse<DP>::BK) * PITCH * E;
    const int s_dkv = ((2 * C::KEYS + 4 * C::BR) * PITCH + 4 * C::BR
                       + (C::SPLIT == 2 ? C::WARPS * C::BR / 2 * 32 : 0)) * E;
    const int s_dq = (2 * ROWS + 4 * Dq<DP>::BK) * PITCH * E;
    cudaError_t err;
    if ((err = allow(bwd_tf32_lse<DP>, s_lse)) != cudaSuccess) return err;
    if ((err = allow(bwd_tf32_dkv<DP>, s_dkv)) != cudaSuccess) return err;
    if ((err = allow(bwd_tf32_dq<DP>, s_dq)) != cudaSuccess) return err;
    // pass 1 covers the padded rows (their lse and D are 0), pass 3 the rows
    const int nrb1 = geo.nrows_pad / ROWS, nrb3 = (geo.nrows + ROWS - 1) / ROWS;
    const dim3 keys(batch * geo.hkv, (geo.lk + C::KEYS - 1) / C::KEYS, nseg);
    bwd_tf32_lse<DP><<<dim3(batch * geo.hkv, nrb1), NTH, s_lse, stream>>>(
        lse, dsum, q, k, o, dout, geo, st, nrb1, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_tf32_dkv<DP><<<keys, 32 * C::WARPS, s_dkv, stream>>>(
        dk, dv, nseg > 1 ? part : nullptr, lse, dsum, q, k, v, dout, geo, st, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (nseg > 1) {
        const long long nbh = static_cast<long long>(batch) * geo.hkv;
        bwd_tf32_dkv_sum<<<static_cast<unsigned>((nbh * geo.lk + 3) / 4), 256, 0,
                           stream>>>(dk, dv, part, nseg, nbh, geo, st);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    bwd_tf32_dq<DP><<<dim3(batch * geo.hkv, nrb3), NTH, s_dq, stream>>>(
        dq, lse, dsum, q, k, v, dout, geo, st, nrb3, vec);
    return cudaGetLastError();
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// float32 only, head dim <= 256; window 0 means none.  st: 24 element
// strides, (batch, row, head) of q, k, v, o, dout, dq, dk, dv in that order
// (the head-dim axis contiguous).  lse and dsum: float32 scratch of batch *
// hkv * ceil(lq * hq / hkv / 128) * 128 each (rows padded to 128).  nseg:
// ceil(lq * hq / hkv / SEG_ROWS); when it is over 1, part: float32 scratch of
// nseg * 2 * batch * hkv * lk * d.  dk and dv are written for all lk keys
// (zeros past lk_valid).
extern "C" int flash_attention_bwd(void* dq, void* dk, void* dv, const void* q,
                                   const void* k, const void* v, const void* o,
                                   const void* dout, float* lse, float* dsum,
                                   float* part, int batch, int lq, int lk,
                                   int lk_valid, int hq, int hkv, int d,
                                   int causal, int window, int nseg, float scale,
                                   const long long* st, void* stream) {
    if (d > DMAX || d <= 0 || hkv <= 0 || hq % hkv != 0 || window < 0
        || lk_valid < 0 || lk_valid > lk)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch <= 0 || lq <= 0 || lk <= 0) return static_cast<int>(cudaGetLastError());
    const int g = hq / hkv;
    const long long nrows = static_cast<long long>(lq) * g;
    const long long npad = (nrows + ROWS_PAD - 1) / ROWS_PAD * ROWS_PAD;
    if (npad / 64 > 65535 || (lk + 63) / 64 > 65535
        || nseg != (nrows + SEG_ROWS - 1) / SEG_ROWS || nseg > 65535
        || (nseg > 1 && part == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    Strides s;
    long long* dst[8] = {s.q, s.k, s.v, s.o, s.dout, s.dq, s.dk, s.dv};
    for (int t = 0; t < 8; ++t)
        for (int i = 0; i < 3; ++i) dst[t][i] = st[3 * t + i];
    // cp.async needs every row chunk 16-byte aligned: base pointers and the
    // strides of q, k, v and dout in multiples of 4 elements
    int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
    for (int i = 0; i < 9; ++i) vec = vec && st[i] % 4 == 0;
    for (int i = 12; i < 15; ++i) vec = vec && st[i] % 4 == 0;
    const Geo geo{lq, lk, lk_valid, g, d, causal, window, hkv,
                  static_cast<int>(nrows), static_cast<int>(npad), scale,
                  scale * LOG2E};
    cudaStream_t cs = static_cast<cudaStream_t>(stream);
    float* fq = static_cast<float*>(dq);
    float* fk = static_cast<float*>(dk);
    float* fv = static_cast<float*>(dv);
    const float* tq = static_cast<const float*>(q);
    const float* tk = static_cast<const float*>(k);
    const float* tv = static_cast<const float*>(v);
    const float* to = static_cast<const float*>(o);
    const float* td = static_cast<const float*>(dout);
    if (d <= 16)
        return launch<16>(fq, fk, fv, tq, tk, tv, to, td, lse, dsum, part, nseg, batch, geo, s,
                           vec, cs);
    if (d <= 32)
        return launch<32>(fq, fk, fv, tq, tk, tv, to, td, lse, dsum, part, nseg, batch, geo, s,
                           vec, cs);
    if (d <= 64)
        return launch<64>(fq, fk, fv, tq, tk, tv, to, td, lse, dsum, part, nseg, batch, geo, s,
                           vec, cs);
    if (d <= 128)
        return launch<128>(fq, fk, fv, tq, tk, tv, to, td, lse, dsum, part, nseg, batch, geo, s,
                           vec, cs);
    return launch<256>(fq, fk, fv, tq, tk, tv, to, td, lse, dsum, part, nseg, batch, geo, s,
                           vec, cs);
}
