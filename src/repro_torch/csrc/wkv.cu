// K5 wkv_chunked: RWKV-6 WKV with data-dependent decay, in chunks of 32.
//
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//     o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
//
// per lane (batch x head), with log w_t given, S starting at S0 (or 0),
// returning o [BH, T, n] and the final state S_T [BH, n, n].
//
// Replaces the TPU kernel `_wkv_kernel` (repro/kernels/wkv.py, via
// `wkv_chunked_pallas`), whose chunked algebra the model's prefill runs as
// jnp (repro/models/rwkv6.py `_wkv_chunked`, which also carries S0 in and
// S_T out).
//
// What bounds it on Hopper: bytes.  Per chunk of C tokens a lane reads 4 C n
// floats and writes C n, against ~(2 C^2 n + 4 C n^2) flops of chunked
// algebra: at n = 64 that is ~16 flops per byte, below the card's ~20 fp32
// flops per byte of device memory, and the serial form needs fewer.
//
// Design (right and simple first): the TPU kernel's sequential chunk axis
// with its (n, n) VMEM scratch becomes a loop over chunks inside one block,
// one block per lane (512 at the rwkv6-7b prefill), with the state in
// shared memory for the whole sequence.  Per chunk, as `_wkv_kernel` does:
// stage r, k, v and log w (4 x 32 x n floats), take the bonus term
// diag_t = sum(r u k), run the cumulative log decay per channel (one thread
// a channel) giving r e^{lcw - log w}, k e^{-lcw} and k e^{total - lcw},
// form the strictly lower C x C matrix A = (r e^{..}) (k e^{-lcw})^T, write
// o = A v + diag v + (r e^{..}) S, and update S = e^{total} S + (k e^{..})^T v.
// Every product is a plain FMA loop over shared memory; rows are padded to
// n + 1 floats so threads that walk a column hit distinct banks.  Steps past
// T load as r = k = v = 0 and log w = 0, which leaves S unchanged, so a
// ragged T needs no padded copy.  exp is the accurate expf (no fast math):
// the decay clamp lets exponents reach +-80 within a chunk.
#include <cuda_runtime.h>

namespace {

constexpr int C = 32;          // chunk length (CHUNK in the reference)
constexpr int THREADS = 256;
constexpr int NMAX = 64;       // largest head size

__host__ __device__ constexpr int smem_floats(int n) {
    // S (n x (n+1)), r/k/k_t/v/lcw (C x (n+1) each), A (C x (C+1)), diag, total
    return n * (n + 1) + 5 * C * (n + 1) + C * (C + 1) + C + n;
}

__global__ void __launch_bounds__(THREADS)
wkv_chunked_kernel(float* __restrict__ o, float* __restrict__ s_out,
                   const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, long long su,
                   const float* __restrict__ s0, int t_len, int n) {
    extern __shared__ float sm[];
    const int P = n + 1;
    float* S = sm;                // [n][P]   carried state
    float* R = S + n * P;         // [C][P]   r, then r e^{lcw - log w}
    float* K = R + C * P;         // [C][P]   k, then k e^{total - lcw}
    float* Kt = K + C * P;        // [C][P]   k e^{-lcw}
    float* V = Kt + C * P;        // [C][P]
    float* L = V + C * P;         // [C][P]   log w, then its inclusive cumsum
    float* A = L + C * P;         // [C][C+1] strictly lower
    float* D = A + C * (C + 1);   // [C]      sum_n r u k
    float* TOT = D + C;           // [n]      the chunk's total log decay

    const int tid = threadIdx.x;
    const long long lane = blockIdx.x;
    const long long base = lane * t_len * n;
    const float* ul = u + lane * su;

    for (int e = tid; e < n * n; e += THREADS)
        S[(e / n) * P + e % n] = s0 ? s0[lane * n * n + e] : 0.0f;

    for (int c0 = 0; c0 < t_len; c0 += C) {
        __syncthreads();          // the previous chunk's readers are done
        for (int e = tid; e < C * n; e += THREADS) {
            const int t = e / n, ch = e % n;
            const bool ok = c0 + t < t_len;
            const long long gi = base + static_cast<long long>(c0 + t) * n + ch;
            R[t * P + ch] = ok ? r[gi] : 0.0f;
            K[t * P + ch] = ok ? k[gi] : 0.0f;
            V[t * P + ch] = ok ? v[gi] : 0.0f;
            L[t * P + ch] = ok ? w[gi] : 0.0f;
        }
        __syncthreads();
        for (int t = tid; t < C; t += THREADS) {
            float acc = 0.0f;
            for (int ch = 0; ch < n; ++ch)
                acc = fmaf(R[t * P + ch] * ul[ch], K[t * P + ch], acc);
            D[t] = acc;
        }
        __syncthreads();
        for (int ch = tid; ch < n; ch += THREADS) {
            float lcw = 0.0f;
            for (int t = 0; t < C; ++t) {
                const float lw = L[t * P + ch];
                lcw += lw;
                L[t * P + ch] = lcw;
                R[t * P + ch] *= expf(lcw - lw);
                Kt[t * P + ch] = K[t * P + ch] * expf(-lcw);
            }
            TOT[ch] = lcw;
            for (int t = 0; t < C; ++t)
                K[t * P + ch] *= expf(lcw - L[t * P + ch]);
        }
        __syncthreads();
        for (int e = tid; e < C * C; e += THREADS) {
            const int t = e / C, i = e % C;
            float acc = 0.0f;
            if (i < t)
                for (int ch = 0; ch < n; ++ch)
                    acc = fmaf(R[t * P + ch], Kt[i * P + ch], acc);
            A[t * (C + 1) + i] = acc;
        }
        __syncthreads();
        for (int e = tid; e < C * n; e += THREADS) {
            const int t = e / n, m = e % n;
            float intra = 0.0f;
            for (int i = 0; i < t; ++i)
                intra = fmaf(A[t * (C + 1) + i], V[i * P + m], intra);
            intra = fmaf(D[t], V[t * P + m], intra);
            float inter = 0.0f;
            for (int ch = 0; ch < n; ++ch)
                inter = fmaf(R[t * P + ch], S[ch * P + m], inter);
            if (c0 + t < t_len)
                o[base + static_cast<long long>(c0 + t) * n + m] = intra + inter;
        }
        __syncthreads();          // S is read above and rewritten below
        for (int e = tid; e < n * n; e += THREADS) {
            const int ch = e / n, m = e % n;
            float acc = S[ch * P + m] * expf(TOT[ch]);
            for (int t = 0; t < C; ++t)
                acc = fmaf(K[t * P + ch], V[t * P + m], acc);
            S[ch * P + m] = acc;
        }
    }
    __syncthreads();
    for (int e = tid; e < n * n; e += THREADS)
        s_out[lane * n * n + e] = S[(e / n) * P + e % n];
}

}  // namespace

// r, k, v, w (log decay), o: [bh, t, n] contiguous float32; u: n floats per
// lane, lane stride su (0 to share one u); s0: [bh, n, n] or null; s_out:
// [bh, n, n].
extern "C" int wkv_chunked(float* o, float* s_out, const float* r,
                           const float* k, const float* v, const float* w,
                           const float* u, long long su, const float* s0,
                           int bh, int t, int n, void* stream) {
    if (n <= 0 || n > NMAX) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_floats(n) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats(NMAX) * sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (bh <= 0) return static_cast<int>(cudaGetLastError());
    wkv_chunked_kernel<<<bh, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        o, s_out, r, k, v, w, u, su, s0, t, n);
    return static_cast<int>(cudaGetLastError());
}
