// K3 ell_relax_round: one Jacobi Bellman-Ford round over padded-ELL tables.
//
//     out[b][t][s] = min(m[b][t][s], min_j wgt[b][t][j] + m[b][idx[b][t][j]][s])
//     flags[b][tile][span] = any element of the block's (tile x span) patch decreased
//
// on the transposed carry m[t][s] = dist(s -> t), whose row t is pulled from
// the rows of t's predecessors idx[t][:].  Replaces the TPU kernel
// `_relax_round_kernel` (repro/kernels/ell.py, via `ell_relax_round_pallas`).
//
// What bounds it on Hopper: memory.  Each slot is one add and one min per
// carry element, 2*d_max instructions against one 4-byte read and one 4-byte
// write of the carry, so at d_max=16 the work is ~4 instructions per byte,
// below the card's ~10 fp32 instructions per byte of HBM bandwidth.
//
// Design: unlike the TPU kernel, which holds the whole (N, S) carry in one
// VMEM block, the carry stays in device memory; at N=512 it is 1 MB per lane,
// so the d_max predecessor rows a block gathers are mostly L2 hits.  One
// block covers (lane, a tile of TT targets, a span of SPAN sources): the
// tile's idx/wgt rows are staged in shared memory, and each thread owns one
// source column, so every predecessor-row read is coalesced along the
// source axis.  The result goes to a separate buffer (a Jacobi round: every
// block reads the pre-round carry), and the block writes one changed flag
// from __syncthreads_or, so no atomics are needed.
#include <cuda_runtime.h>

namespace {

constexpr int TT = 8;      // targets per block
constexpr int SPAN = 128;  // sources per block (= threads)

__global__ void __launch_bounds__(SPAN)
ell_relax_round_kernel(float* __restrict__ out, int* __restrict__ flags,
                       const float* __restrict__ m,
                       const int* __restrict__ idx,
                       const float* __restrict__ wgt,
                       int n, int s, int d) {
    extern __shared__ unsigned char smem[];
    int* sidx = reinterpret_cast<int*>(smem);
    float* swgt = reinterpret_cast<float*>(smem + sizeof(int) * TT * d);
    const long long lane = blockIdx.z;
    const int t0 = blockIdx.y * TT;
    const int sc = blockIdx.x * SPAN + threadIdx.x;
    const float* ml = m + lane * n * static_cast<long long>(s);
    float* ol = out + lane * n * static_cast<long long>(s);
    for (int e = threadIdx.x; e < TT * d; e += SPAN) {
        const int t = t0 + e / d;
        const long long off = (lane * n + t) * static_cast<long long>(d) + e % d;
        sidx[e] = t < n ? idx[off] : 0;
        swgt[e] = t < n ? wgt[off] : 0.0f;
    }
    __syncthreads();
    int changed = 0;
    if (sc < s) {
        for (int tt = 0; tt < TT; ++tt) {
            const int t = t0 + tt;
            if (t >= n) break;
            const float cur = ml[t * static_cast<long long>(s) + sc];
            float acc = cur;
            for (int j = 0; j < d; ++j)
                acc = fminf(acc, swgt[tt * d + j]
                                     + ml[sidx[tt * d + j] * static_cast<long long>(s) + sc]);
            ol[t * static_cast<long long>(s) + sc] = acc;
            changed |= acc < cur;
        }
    }
    changed = __syncthreads_or(changed);
    if (threadIdx.x == 0)
        flags[(lane * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = changed;
}

}  // namespace

// `tile` and `span` are the caller's idea of the flag patch (TT x SPAN); the
// entry returns -1 without launching when they differ from this build's.
extern "C" int ell_relax_round(float* out, int* flags, const float* m,
                               const int* idx, const float* wgt, int batch,
                               int n, int s, int d, int tile, int span,
                               void* stream) {
    if (tile != TT || span != SPAN) return -1;
    if (batch <= 0 || n <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
    const size_t smem = static_cast<size_t>(TT) * d * (sizeof(int) + sizeof(float));
    dim3 grid((s + SPAN - 1) / SPAN, (n + TT - 1) / TT, batch);
    ell_relax_round_kernel<<<grid, SPAN, smem, static_cast<cudaStream_t>(stream)>>>(
        out, flags, m, idx, wgt, n, s, d);
    return static_cast<int>(cudaGetLastError());
}
