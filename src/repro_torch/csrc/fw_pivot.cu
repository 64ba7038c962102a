// K2 fw_pivot: in-tile Floyd-Warshall closure of one (t x t) pivot tile per lane.
//
//     for k in 0..t-1:  D[i][j] = min(D[i][j], D[i][k] + D[k][j])
//
// Replaces the TPU kernel `_pivot_kernel` = `fw_tile_closure`
// (repro/kernels/fw.py), the pivot phase of blocked Floyd-Warshall.
//
// What bounds it on Hopper: latency.  The t relaxations are sequential, the
// tile is tiny (t*t*4 bytes in and out) and there is one tile per lane, so
// one SM serves a lane: 2*t^3 fp32 instructions at one SM's 128 a clock
// (16.5 us at t = 128) is the floor of this design, and every pivot also
// pays a barrier and the latency of its shared loads.
//
// Design: one block per lane keeps the whole tile in registers: each thread
// owns a MICRO x MICRO micro-tile (rows ty*4 + {0..3} of each of MICRO/4
// row groups T/(MICRO/4) apart, columns likewise), read once from device
// memory at the start and written once at the end through the row and lane
// strides, so the tile is closed in place inside the distance matrix.  Row
// k and column k of step k live in shared memory as two 128-float vectors;
// each thread reads its slice of both with float4 loads and does its
// MICRO*MICRO adds and mins in registers.  The vectors are double-buffered:
// right after its own step-k update, the warp that owns row k + 1 and the
// threads that own column k + 1 write them into the other buffer, so one
// __syncthreads() per pivot separates the steps.  The values written are
// row and column k + 1 after step k, i.e. what the plain version reads at
// step k + 1, and every element takes fminf(d, d[i][k] + d[k][j]) on the
// same operands as the plain version: the result is bit-equal.  The pivot
// loop is unrolled by 4 through templates, so the owner's register row and
// column are static indices and no index is divided at run time.  t < 128
// runs the same kernel: elements outside the t x t tile are computed but
// never read back or stored, and only pivots k < t run.  MICRO = 8 (256
// threads, 167 registers) is built: it was 7% faster than MICRO = 4 (1024
// threads) at [20,128,128] on an NVIDIA H100 80GB HBM3 at 700 W, 0.039
// against 0.042 ms (tools/k2_k3_variants.py).
#include <cuda_runtime.h>

namespace {

constexpr int T = 128;     // the largest tile (FW_TILE in kernels/fw.py)
constexpr int MICRO = 8;   // a thread's micro-tile is MICRO x MICRO

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

// Row and column number L of the micro-tile (pivot k + 1) into the next
// buffers: the threads with ty == owner hold the row, those with
// tx == owner the column.
template <int M, int L>
__device__ __forceinline__ void publish(const float (&x)[M][M], float* rn,
                                        float* cn, int owner, int tx,
                                        int ty) {
    constexpr int NG = M / 4, GS = T / NG;
    if (ty == owner) {
#pragma unroll
        for (int q = 0; q < NG; ++q)
            st4(rn + q * GS + tx * 4, make_float4(x[L][q * 4], x[L][q * 4 + 1],
                                                  x[L][q * 4 + 2], x[L][q * 4 + 3]));
    }
    if (tx == owner) {
#pragma unroll
        for (int q = 0; q < NG; ++q)
            st4(cn + q * GS + ty * 4, make_float4(x[q * 4][L], x[q * 4 + 1][L],
                                                  x[q * 4 + 2][L], x[q * 4 + 3][L]));
    }
}

// Pivot k = kb + KK of row group G: relax the micro-tile, publish pivot
// k + 1, one barrier.
template <int M, int G, int KK>
__device__ __forceinline__ void step(float (&x)[M][M], float (*rowk)[T],
                                     float (*colk)[T], int kb, int tx,
                                     int ty) {
    constexpr int NG = M / 4, GS = T / NG;
    const float* rk = rowk[KK & 1];
    const float* ck = colk[KK & 1];
    float rv[M], cv[M];
#pragma unroll
    for (int q = 0; q < NG; ++q) {
        const float4 a = ld4(rk + q * GS + tx * 4);
        const float4 b = ld4(ck + q * GS + ty * 4);
        rv[q * 4] = a.x; rv[q * 4 + 1] = a.y; rv[q * 4 + 2] = a.z; rv[q * 4 + 3] = a.w;
        cv[q * 4] = b.x; cv[q * 4 + 1] = b.y; cv[q * 4 + 2] = b.z; cv[q * 4 + 3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j)
            x[i][j] = fminf(x[i][j], cv[i] + rv[j]);
    float* rn = rowk[(KK + 1) & 1];
    float* cn = colk[(KK + 1) & 1];
    if constexpr (KK < 3) {
        publish<M, G * 4 + KK + 1>(x, rn, cn, (kb - G * GS) / 4, tx, ty);
    } else {
        const int nk = kb + 4;
        if (nk < (G + 1) * GS) {
            publish<M, G * 4>(x, rn, cn, (nk - G * GS) / 4, tx, ty);
        } else if constexpr (G + 1 < NG) {
            publish<M, (G + 1) * 4>(x, rn, cn, 0, tx, ty);
        }
    }
    __syncthreads();
}

template <int M, int G>
__device__ __forceinline__ void run_group(float (&x)[M][M], float (*rowk)[T],
                                          float (*colk)[T], int t, int tx,
                                          int ty) {
    constexpr int GS = T / (M / 4);
    for (int kb = G * GS; kb < (G + 1) * GS && kb < t; kb += 4) {
        step<M, G, 0>(x, rowk, colk, kb, tx, ty);
        if (kb + 1 >= t) break;
        step<M, G, 1>(x, rowk, colk, kb, tx, ty);
        if (kb + 2 >= t) break;
        step<M, G, 2>(x, rowk, colk, kb, tx, ty);
        if (kb + 3 >= t) break;
        step<M, G, 3>(x, rowk, colk, kb, tx, ty);
    }
}

template <int M>
__global__ void __launch_bounds__((T / M) * (T / M))
fw_pivot_kernel(float* d, int t, long long s_b, long long s_r) {
    constexpr int NG = M / 4, GS = T / NG, SIDE = GS / 4;
    __shared__ __align__(16) float rowk[2][T];
    __shared__ __align__(16) float colk[2][T];
    const int tx = threadIdx.x % SIDE, ty = threadIdx.x / SIDE;
    float* dl = d + static_cast<long long>(blockIdx.x) * s_b;
    float x[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
        const int r = (i / 4) * GS + ty * 4 + i % 4;
#pragma unroll
        for (int j = 0; j < M; ++j) {
            const int c = (j / 4) * GS + tx * 4 + j % 4;
            x[i][j] = r < t && c < t ? dl[r * s_r + c] : 0.0f;
        }
    }
    publish<M, 0>(x, rowk[0], colk[0], 0, tx, ty);
    __syncthreads();
    run_group<M, 0>(x, rowk, colk, t, tx, ty);
    if constexpr (NG > 1) run_group<M, 1>(x, rowk, colk, t, tx, ty);
#pragma unroll
    for (int i = 0; i < M; ++i) {
        const int r = (i / 4) * GS + ty * 4 + i % 4;
#pragma unroll
        for (int j = 0; j < M; ++j) {
            const int c = (j / 4) * GS + tx * 4 + j % 4;
            if (r < t && c < t) dl[r * s_r + c] = x[i][j];
        }
    }
}

}  // namespace

// Tiles up to T x T; a larger t returns cudaErrorInvalidValue unlaunched.
extern "C" int fw_pivot(float* d, int batch, int t, long long s_b,
                        long long s_r, void* stream) {
    if (t > T) return static_cast<int>(cudaErrorInvalidValue);
    if (batch <= 0 || t <= 0) return static_cast<int>(cudaGetLastError());
    constexpr int threads = (T / MICRO) * (T / MICRO);
    fw_pivot_kernel<MICRO><<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        d, t, s_b, s_r);
    return static_cast<int>(cudaGetLastError());
}
