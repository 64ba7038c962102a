// K4 flash_attention: grouped-query attention with an online softmax.
//
//     O[b, i, h] = softmax_j(scale * Q[b, i, h] . K[b, j, h / g]) V[b, j, h / g]
//
// over the keys j < lk_valid that row i may see: with causal masking, j <=
// i + (lk_valid - Lq), i.e. the diagonal is aligned to the end of the valid
// keys, and with a local window > 0 also j > i + (lk_valid - Lq) - window.  A
// row that sees no key gives 0.  Inputs are float32 or bf16; the
// math is float32 throughout and O is written in the input type.
//
// Replaces the TPU kernel `_flash_kernel` (repro/kernels/flash_attention.py,
// via `flash_attention_pallas`), which the model's blockwise jnp attention
// (repro/models/layers.py `attention`) and the decode attention
// (repro/models/transformer.py `_attention_decode`) stand in for.
//
// What bounds it on Hopper: at prefill (Lq = Lk = 1000, D = 128) operations,
// 4 * Lq * Lk * D / 2 flops per head against 2 * (Lq + Lk) * D bytes per
// head, far above the card's ~295 bf16 flops per byte; at decode (Lq = 1)
// bytes, since every cached key and value is read once for g query rows.
//
// Design (right and simple first; tensor cores come later): the TPU kernel's
// sequential k grid axis with its acc/m/l scratch becomes a loop over key
// tiles inside one block, because Hopper runs blocks in no order.  One block
// takes (batch, KV head, 64 rows), where the rows are (query position, query
// head of the group) pairs flattened as i * g + h, so every K/V tile a block
// stages serves all g query heads of its KV head (at decode, Lq = 1, that is
// g rows in one block).  Q rows, a 64-key K tile and V tile are converted to
// float32 in shared memory (~113 KB, dynamic).  Each of the 256 threads owns
// 4 rows: it computes a 4 x 4 micro-tile of the scores by FMA on the CUDA
// cores, keeps the running max and sum of its rows in registers (reduced
// across the 16 threads that share the rows with warp shuffles), writes its
// probabilities to shared memory and accumulates a 4 x 8 micro-tile of O.
// Key tiles wholly past lk_valid or past the causal diagonal of the block's
// last row are never loaded; warps whose rows are all past Lq * g skip the
// arithmetic.  Masked scores are -1e30 and their probabilities are set to 0,
// as in the TPU kernel, so a fully masked row ends with l = 0 and O = 0.
// Q, K, V and O take batch, row and head strides (the last axis is
// contiguous), so a layer's slice of the KV cache is read in place.  The
// tiles are built for DM = 128 head dims, or 256 (recurrentgemma-2b: ~214 KB
// of shared memory).  A local window starts the key loop at the tile of the
// first key the block's first row sees, so a banded prefill does O(L *
// (window + tile)) work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;      // (query position, group head) rows per block
constexpr int BK = 64;        // keys per tile
constexpr int DMAX = 256;     // largest head dim
constexpr int THREADS = 256;
constexpr int PP = ROWS + 1;  // padded pitch of the probability tile
constexpr float NEG = -1.0e30f;

// floats of shared memory for head dims up to DM (Q and K rows padded by one)
constexpr int smem_floats(int dm) {
    return ROWS * (dm + 1) + BK * (dm + 1) + BK * dm + BK * PP;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int DM>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(T* o, const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, int lq, int lk_valid, int g,
                       int d, int causal, int window, float scale,
                       long long sq_b, long long sq_l, long long sq_h,
                       long long sk_b, long long sk_l, long long sk_h,
                       long long sv_b, long long sv_l, long long sv_h,
                       long long so_b, long long so_l, long long so_h) {
    constexpr int QP = DM + 1;        // padded row pitch of the Q and K tiles
    extern __shared__ float smem[];
    float* qs = smem;                 // [ROWS][QP]
    float* ks = qs + ROWS * QP;       // [BK][QP]
    float* vs = ks + BK * QP;         // [BK][DM]
    float* ps = vs + BK * DM;         // [BK][PP]

    const int tid = threadIdx.x;
    const int tx = tid % 16;          // score columns / output dims
    const int ty = tid / 16;          // rows 4 * ty .. 4 * ty + 3
    const int hkv = blockIdx.y;
    const long long b = blockIdx.z;
    const int nrows = lq * g;
    const int r0 = blockIdx.x * ROWS;
    const int offset = lk_valid - lq; // query i sits at key position i + offset

    // stage the block's Q rows (zeros past the last row or past d)
    for (int e = tid; e < ROWS * DM; e += THREADS) {
        const int r = e / DM, dd = e % DM;
        const int gr = r0 + r;
        float x = 0.0f;
        if (gr < nrows && dd < d) {
            const int i = gr / g, h = hkv * g + gr % g;
            x = to_f(q[b * sq_b + i * sq_l + h * sq_h + dd]);
        }
        qs[r * QP + dd] = x;
    }

    int qpos[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qpos[i] = (r0 + 4 * ty + i) / g + offset;
    const bool active = r0 + 4 * ty < nrows;

    // keys the block needs: below lk_valid, if causal up to the diagonal of
    // its last row, and with a window from the band of its first row
    const int last_row = min(r0 + ROWS, nrows) - 1;
    int kend = lk_valid;
    if (causal) kend = min(kend, last_row / g + offset + 1);
    const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;
    const int t0 = window > 0 ? max(0, r0 / g + offset - window + 1) / BK : 0;

    float m[4], l[4], acc[4][DM / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG;
        l[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < DM / 16; ++j) acc[i][j] = 0.0f;
    }

    for (int kt = t0; kt < ntiles; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();              // the previous tile's readers are done
        for (int e = tid; e < BK * DM; e += THREADS) {
            const int j = e / DM, dd = e % DM;
            const int gj = k0 + j;
            float kx = 0.0f, vx = 0.0f;
            if (gj < kend && dd < d) {
                kx = to_f(k[b * sk_b + gj * sk_l + hkv * sk_h + dd]);
                vx = to_f(v[b * sv_b + gj * sv_l + hkv * sv_h + dd]);
            }
            ks[j * QP + dd] = kx;
            vs[j * DM + dd] = vx;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
        if (active) {
#pragma unroll 8
            for (int dd = 0; dd < DM; ++dd) {
                float qv[4], kv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * QP + dd];
#pragma unroll
                for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * QP + dd];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            }
        }

        // mask, running max and sum; the 16 threads of a half-warp share rows
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            bool ok[4];
            float mx = NEG;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kp = k0 + tx + 16 * j;
                ok[j] = kp < lk_valid && (!causal || kp <= qpos[i])
                        && (window <= 0 || kp > qpos[i] - window);
                s[i][j] = ok[j] ? s[i][j] * scale : NEG;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
                ps[(tx + 16 * j) * PP + 4 * ty + i] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < DM / 16; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();

        if (active) {
            const int cend = min(BK, kend - k0);
            for (int c = 0; c < cend; ++c) {
                float pv[4], vv[DM / 16];
#pragma unroll
                for (int i = 0; i < 4; ++i) pv[i] = ps[c * PP + 4 * ty + i];
#pragma unroll
                for (int j = 0; j < DM / 16; ++j) vv[j] = vs[c * DM + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < DM / 16; ++j)
                        acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gr = r0 + 4 * ty + i;
        if (gr >= nrows) continue;
        const float inv = 1.0f / (l[i] > 0.0f ? l[i] : 1.0f);
        const int qi = gr / g, h = hkv * g + gr % g;
        T* orow = o + b * so_b + qi * so_l + h * so_h;
#pragma unroll
        for (int j = 0; j < DM / 16; ++j) {
            const int dd = tx + 16 * j;
            if (dd < d) from_f(orow + dd, acc[i][j] * inv);
        }
    }
}

template <typename T, int DM>
int launch(void* o, const void* q, const void* k, const void* v, int batch,
           int lq, int lk_valid, int hq, int hkv, int d, int causal, int window,
           float scale, const long long* st, cudaStream_t stream) {
    const size_t smem = smem_floats(DM) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int g = hq / hkv;
    dim3 grid((lq * g + ROWS - 1) / ROWS, hkv, batch);
    flash_attention_kernel<T, DM><<<grid, THREADS, smem, stream>>>(
        static_cast<T*>(o), static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lq, lk_valid, g, d, causal, window, scale,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11]);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; head dim <= 256; window 0 means none.
// Strides are in elements: (batch, row, head) for q, k, v and o in that
// order; the head-dim axis is contiguous.
extern "C" int flash_attention(void* o, const void* q, const void* k,
                               const void* v, int dtype, int batch, int lq,
                               int lk_valid, int hq, int hkv, int d, int causal,
                               int window, float scale,
                               long long sq_b, long long sq_l, long long sq_h,
                               long long sk_b, long long sk_l, long long sk_h,
                               long long sv_b, long long sv_l, long long sv_h,
                               long long so_b, long long so_l, long long so_h,
                               void* stream) {
    if (d > DMAX || hkv <= 0 || hq % hkv != 0 || window < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch <= 0 || lq <= 0) return static_cast<int>(cudaGetLastError());
    const long long st[12] = {sq_b, sq_l, sq_h, sk_b, sk_l, sk_h,
                              sv_b, sv_l, sv_h, so_b, so_l, so_h};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (d > 128) {
        if (dtype == 0)
            return launch<float, DMAX>(o, q, k, v, batch, lq, lk_valid, hq, hkv,
                                       d, causal, window, scale, st, s);
        return launch<__nv_bfloat16, DMAX>(o, q, k, v, batch, lq, lk_valid, hq,
                                           hkv, d, causal, window, scale, st, s);
    }
    if (dtype == 0)
        return launch<float, 128>(o, q, k, v, batch, lq, lk_valid, hq, hkv, d,
                                  causal, window, scale, st, s);
    return launch<__nv_bfloat16, 128>(o, q, k, v, batch, lq, lk_valid, hq, hkv,
                                      d, causal, window, scale, st, s);
}
