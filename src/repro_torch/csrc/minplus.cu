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
// ~10 fp32 instructions per byte of HBM bandwidth.
//
// Design: one block per (64x64 output tile, lane); A and B tiles of depth
// 16 are staged in shared memory, and each of the 256 threads keeps a 4x4
// register micro-tile of fminf(acc, a + b), so every shared-memory load
// feeds four terms.  Micro-tile rows/columns are strided by 16 so that
// neighbouring threads read neighbouring shared-memory words (no bank
// conflicts) and write neighbouring output columns.  Ragged edges load the
// 3e38 sentinel (a + b then overflows to +inf and never wins the min), so
// no shape needs padding.  The accumulator starts at 3e38 like the TPU
// kernel's output block, and C0 (optional) is folded in at the store, so C
// may alias C0 (each element is read and written by the same thread; C and
// C0 are therefore not __restrict__).  C must not overlap A or B.
// A, B, C and C0 take a row stride and a lane stride (the last axis is
// contiguous), so Floyd-Warshall panels are passed as strided views.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr float SENTINEL = 3.0e38f;

__global__ void __launch_bounds__(THREADS)
minplus_acc_kernel(float* c, const float* c0,
                   const float* __restrict__ a, const float* __restrict__ b,
                   int m, int n, int k,
                   long long sa_b, long long sa_r,
                   long long sb_b, long long sb_r,
                   long long sc_b, long long sc_r,
                   long long sc0_b, long long sc0_r) {
    __shared__ float as[BK][BM];
    __shared__ float bs[BK][BN];
    const long long lane = blockIdx.z;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    const float* al = a + lane * sa_b;
    const float* bl = b + lane * sb_b;
    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = SENTINEL;

    for (int k0 = 0; k0 < k; k0 += BK) {
        // A tile (BM x BK): consecutive threads walk k, the contiguous axis
#pragma unroll
        for (int e = tid; e < BM * BK; e += THREADS) {
            const int i = e / BK, kk = e % BK;
            const int gi = row0 + i, gk = k0 + kk;
            as[kk][i] = (gi < m && gk < k) ? al[gi * sa_r + gk] : SENTINEL;
        }
        // B tile (BK x BN): consecutive threads walk the output columns
#pragma unroll
        for (int e = tid; e < BK * BN; e += THREADS) {
            const int kk = e / BN, j = e % BN;
            const int gk = k0 + kk, gj = col0 + j;
            bs[kk][j] = (gk < k && gj < n) ? bl[gk * sb_r + gj] : SENTINEL;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float av[TM], bv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + i * (BM / TM)];
#pragma unroll
            for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * (BN / TN)];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fminf(acc[i][j], av[i] + bv[j]);
        }
        __syncthreads();
    }

    float* cl = c + lane * sc_b;
    const float* c0l = c0 ? c0 + lane * sc0_b : nullptr;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gi = row0 + ty + i * (BM / TM);
        if (gi >= m) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gj = col0 + tx + j * (BN / TN);
            if (gj >= n) continue;
            float v = acc[i][j];
            if (c0l) v = fminf(c0l[gi * sc0_r + gj], v);
            cl[gi * sc_r + gj] = v;
        }
    }
}

}  // namespace

extern "C" int minplus_acc(float* c, const float* c0, const float* a,
                           const float* b, int batch, int m, int n, int k,
                           long long sa_b, long long sa_r,
                           long long sb_b, long long sb_r,
                           long long sc_b, long long sc_r,
                           long long sc0_b, long long sc0_r, void* stream) {
    if (batch <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
    minplus_acc_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        c, c0, a, b, m, n, k, sa_b, sa_r, sb_b, sb_r, sc_b, sc_r, sc0_b, sc0_r);
    return static_cast<int>(cudaGetLastError());
}
