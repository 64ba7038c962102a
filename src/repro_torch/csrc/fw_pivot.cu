// K2 fw_pivot: in-tile Floyd-Warshall closure of one (t x t) pivot tile per lane.
//
//     for k in 0..t-1:  D[i][j] = min(D[i][j], D[i][k] + D[k][j])
//
// Replaces the TPU kernel `_pivot_kernel` = `fw_tile_closure`
// (repro/kernels/fw.py), the pivot phase of blocked Floyd-Warshall.
//
// What bounds it on Hopper: latency.  The t relaxations are sequential, the
// tile is tiny (t*t*4 bytes in and out) and there is one tile per lane, so
// neither the operation rate nor the memory rate is reached; the cost is t
// shared-memory passes separated by barriers.
//
// Design: one block per lane holds the whole tile in shared memory (64 KB at
// t=128, requested as dynamic shared memory), reads it once, runs the t
// relaxations with a __syncthreads() between them and writes it once.  Row k
// and column k cannot improve in step k (the pivot's diagonal entry is 0,
// or the 1e18 non-edge sentinel on padded rows), so a thread stores only a
// strictly smaller value: nothing in row or column k is written while other
// threads read it.  The tile is addressed through a row stride and a lane
// stride, so it is read and written in place inside the distance matrix.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
fw_pivot_kernel(float* d, int t, long long s_b, long long s_r) {
    extern __shared__ float tile[];
    float* dl = d + static_cast<long long>(blockIdx.x) * s_b;
    const int tt = t * t;
    for (int e = threadIdx.x; e < tt; e += blockDim.x)
        tile[e] = dl[(e / t) * s_r + (e % t)];
    __syncthreads();
    for (int k = 0; k < t; ++k) {
        for (int e = threadIdx.x; e < tt; e += blockDim.x) {
            const int i = e / t, j = e % t;
            const float v = tile[i * t + k] + tile[k * t + j];
            if (v < tile[e]) tile[e] = v;
        }
        __syncthreads();
    }
    for (int e = threadIdx.x; e < tt; e += blockDim.x)
        dl[(e / t) * s_r + (e % t)] = tile[e];
}

}  // namespace

extern "C" int fw_pivot(float* d, int batch, int t, long long s_b,
                        long long s_r, void* stream) {
    const size_t smem = static_cast<size_t>(t) * t * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fw_pivot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || t <= 0) return static_cast<int>(cudaGetLastError());
    const int threads = t * t < THREADS ? ((t * t + 31) / 32) * 32 : THREADS;
    fw_pivot_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        d, t, s_b, s_r);
    return static_cast<int>(cudaGetLastError());
}
