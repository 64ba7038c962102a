// K1 minplus_acc: batched tropical (min,+) product with an accumulator.
//
//     C[b] = min(C0[b], A[b] (min,+) B[b]),   C[b][i][j] = min_k A[b][i][k] + B[b][k][j]
//
// Replaces the TPU kernels `_minplus_kernel` (repro/kernels/minplus.py, via
// `minplus_matmul_pallas`) and the blocked Floyd-Warshall panel kernels
// `_row_panel_kernel`, `_col_panel_kernel` and `_outer_kernel`
// (repro/kernels/fw.py), which all compute this product on 128x128 tiles.
//
// What bounds it on Hopper: operations.  The tropical semiring has no
// tensor-core path (wgmma multiplies and adds; DPX min-plus is integer
// only), so each term is one fp32 add and one fp32 min on the CUDA cores,
// 2*M*N*K instructions against (M*K + K*N + 2*M*N) floats of traffic.  At
// M=N=K=512 that is ~170 instructions per byte, far above the card's
// ~10 fp32 instructions per byte of HBM bandwidth.  The bound is
// instruction throughput, so every instruction that is not an add or a min
// comes out of it.
//
// Design: one block of 256 threads per (128x128 output tile, lane), in two
// instantiations that the wrapper picks by shape: at most 128 registers, so
// 2 blocks share an SM, where the grid has more blocks than the card has
// SMs (the square product: 320); up to 255 registers at 1 block an SM where
// every block has an SM to itself (the narrow Floyd-Warshall panels: 80).
// ptxas fits the first in 128 registers with 8 bytes spilled and gives the
// second 178 and no spill, which makes the panels 6-9% faster.  A 64x64
// tile for the panels was slower than either (tools/k1_k5_variants.py).  Each thread keeps an 8x8 register micro-tile
// of fminf(acc, a + b) as 2x2 sub-tiles of 4x4, so one k step is four
// conflict-free float4 shared loads for 64 adds and 64 mins.  A and B
// tiles of depth 16 are double-buffered in shared memory: the next k tile
// is loaded into registers before this one is computed and stored into the
// other buffer after it, one barrier a k step.  A is stored transposed
// (k-major) with an XOR swizzle of its float4 columns by k (no padding), so
// both the transposing stores and the float4 reads hit distinct banks.
// Global loads are float4 where the operand is 16-byte aligned with row
// and lane strides of whole float4s and the float4 lies inside the matrix;
// elsewhere scalar.  Ragged edges load the 3e38 sentinel (a + b then
// overflows to +inf and never wins the min), so no shape needs padding.
// The accumulator starts at 3e38 like the TPU kernel's output block, and C0
// (optional) is folded in at the store, so C may alias C0 (each element is
// read and written by the same thread; C and C0 are therefore not
// __restrict__).  C must not overlap A or B.  A, B, C and C0 take a row
// stride and a lane stride (the last axis is contiguous), so Floyd-Warshall
// panels are passed as strided views.  Every output is a min over the same
// set of fl(a + b), which no tiling or order changes: the result is bit-equal
// to the plain version.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BK = 16;
constexpr float SENTINEL = 3.0e38f;

struct Args {
    float* c;
    const float* c0;
    const float* a;
    const float* b;
    int m, n, k;
    long long sa_b, sa_r, sb_b, sb_r, sc_b, sc_r, sc0_b, sc0_r;
    bool vec_a, vec_b, vec_c;   // float4 global access allowed
};

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// the float4 column of A's transposed tile that holds rows 4q..4q+3 at depth kk
__device__ __forceinline__ int swz(int q, int kk) {
    return q ^ (((kk >> 2) & 3) << 1);
}

// 4 consecutive elements of row `row` from column `col`: float4 when allowed
// and inside, else scalar with the sentinel past the edge
__device__ __forceinline__ float4 load4(const float* base, long long stride,
                                        int row, int rows, int col, int cols,
                                        bool vec) {
    if (row >= rows) return make_float4(SENTINEL, SENTINEL, SENTINEL, SENTINEL);
    const float* p = base + row * stride + col;
    if (vec && col + 3 < cols) return ld4(p);
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = col + i < cols ? p[i] : SENTINEL;
    return make_float4(x[0], x[1], x[2], x[3]);
}

template <int BM, int BN>
__host__ __device__ constexpr int threads_of() { return (BM / 8) * (BN / 8); }

template <int BM, int BN, int MIN_BLOCKS>
__global__ void __launch_bounds__(threads_of<BM, BN>(), MIN_BLOCKS)
minplus_acc_kernel(const Args p) {
    constexpr int THREADS = threads_of<BM, BN>();
    constexpr int A_ITEMS = BM * BK / 4 / THREADS;   // float4s per thread
    constexpr int B_ITEMS = BK * BN / 4 / THREADS;
    static_assert(A_ITEMS * THREADS * 4 == BM * BK, "A tile split");
    static_assert(B_ITEMS * THREADS * 4 == BK * BN, "B tile split");
    __shared__ __align__(16) float as[2][BK][BM];    // transposed, swizzled
    __shared__ __align__(16) float bs[2][BK][BN];

    const long long lane = blockIdx.z;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    const float* al = p.a + lane * p.sa_b;
    const float* bl = p.b + lane * p.sb_b;
    const int tid = threadIdx.x;
    const int tx = tid % (BN / 8);
    const int ty = tid / (BN / 8);

    float4 ra[A_ITEMS], rb[B_ITEMS];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int e = 0; e < A_ITEMS; ++e) {
            const int idx = tid + e * THREADS;      // row idx / 4, k quad idx % 4
            ra[e] = load4(al, p.sa_r, row0 + idx / 4, p.m, k0 + (idx % 4) * 4,
                          p.k, p.vec_a);
        }
#pragma unroll
        for (int e = 0; e < B_ITEMS; ++e) {
            const int idx = tid + e * THREADS;      // k row idx / (BN/4)
            rb[e] = load4(bl, p.sb_r, k0 + idx / (BN / 4), p.k,
                          col0 + (idx % (BN / 4)) * 4, p.n, p.vec_b);
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int e = 0; e < A_ITEMS; ++e) {
            const int idx = tid + e * THREADS;
            const int i = idx / 4, kq = idx % 4;
            const int col = swz(i >> 2, kq * 4) * 4 + (i & 3);
            as[buf][kq * 4 + 0][col] = ra[e].x;
            as[buf][kq * 4 + 1][col] = ra[e].y;
            as[buf][kq * 4 + 2][col] = ra[e].z;
            as[buf][kq * 4 + 3][col] = ra[e].w;
        }
#pragma unroll
        for (int e = 0; e < B_ITEMS; ++e) {
            const int idx = tid + e * THREADS;
            *reinterpret_cast<float4*>(
                &bs[buf][idx / (BN / 4)][(idx % (BN / 4)) * 4]) = rb[e];
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = SENTINEL;

    const int nk = (p.k + BK - 1) / BK;
    if (nk > 0) {
        fetch(0);
        stash(0);
    }
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
        const int cur = kt & 1;
        if (kt + 1 < nk) fetch((kt + 1) * BK);   // in flight while we compute
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a0 = ld4(&as[cur][kk][swz(ty, kk) * 4]);
            const float4 a1 = ld4(&as[cur][kk][swz(BM / 8 + ty, kk) * 4]);
            const float4 b0 = ld4(&bs[cur][kk][tx * 4]);
            const float4 b1 = ld4(&bs[cur][kk][BN / 2 + tx * 4]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fminf(acc[i][j], av[i] + bv[j]);
        }
        if (kt + 1 < nk) stash(cur ^ 1);
        __syncthreads();
    }

    float* cl = p.c + lane * p.sc_b;
    const float* c0l = p.c0 ? p.c0 + lane * p.sc0_b : nullptr;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int gi = row0 + (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
        if (gi >= p.m) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int gj = col0 + h * (BN / 2) + tx * 4;
            if (gj >= p.n) continue;
            float4 v = make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                                   acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
            float* dst = cl + gi * p.sc_r + gj;
            if (p.vec_c && gj + 3 < p.n) {
                if (c0l) {
                    const float4 o = ld4(c0l + gi * p.sc0_r + gj);
                    v = make_float4(fminf(o.x, v.x), fminf(o.y, v.y),
                                    fminf(o.z, v.z), fminf(o.w, v.w));
                }
                *reinterpret_cast<float4*>(dst) = v;
            } else {
                const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    if (gj + e >= p.n) break;
                    float y = x[e];
                    if (c0l) y = fminf(c0l[gi * p.sc0_r + gj + e], y);
                    dst[e] = y;
                }
            }
        }
    }
}

template <int BM, int BN, int MIN_BLOCKS>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
    dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM, batch);
    minplus_acc_kernel<BM, BN, MIN_BLOCKS>
        <<<grid, threads_of<BM, BN>(), 0, stream>>>(a);
    return cudaGetLastError();
}

bool aligned(const void* ptr) {
    return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// tile: 0 for 128x128 output tiles at 2 blocks an SM (<= 128 registers), 1
// for the same tile at 1 block an SM (<= 255 registers); the wrapper picks
// by shape
extern "C" int minplus_acc(float* c, const float* c0, const float* a,
                           const float* b, int batch, int m, int n, int k,
                           long long sa_b, long long sa_r,
                           long long sb_b, long long sb_r,
                           long long sc_b, long long sc_r,
                           long long sc0_b, long long sc0_r, int tile,
                           void* stream) {
    if (tile != 0 && tile != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
    const bool vec_a = aligned(a) && sa_b % 4 == 0 && sa_r % 4 == 0;
    const bool vec_b = aligned(b) && sb_b % 4 == 0 && sb_r % 4 == 0;
    const bool vec_c = aligned(c) && sc_b % 4 == 0 && sc_r % 4 == 0
                       && (!c0 || (aligned(c0) && sc0_b % 4 == 0 && sc0_r % 4 == 0));
    const Args args{c, c0, a, b, m, n, k, sa_b, sa_r, sb_b, sb_r, sc_b, sc_r,
                    sc0_b, sc0_r, vec_a, vec_b, vec_c};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t err = tile == 0 ? launch<128, 128, 2>(args, batch, st)
                                      : launch<128, 128, 1>(args, batch, st);
    return static_cast<int>(err);
}
