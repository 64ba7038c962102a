// K4 flash_attention, route B: attention of at most 16 rows per (batch, KV
// head) over a long KV cache, with the keys split across blocks
// (flash-decoding).  Every decode step takes it (Lq = 1, g query heads per KV
// head), and so does a short prefill of Lq * g <= 16 rows.
//
//     O[b, i, h] = softmax_j(scale * Q[b, i, h] . K[b, j, h / g]) V[b, j, h / g]
//
// over the keys j < lk_valid that row i may see (with causal masking j <=
// i + (lk_valid - Lq), with a local window > 0 also j > i + (lk_valid - Lq) -
// window); a row that sees no key gives 0.  float32 or bf16 in and out,
// float32 math throughout.
//
// Replaces the TPU kernel `_flash_kernel` (repro/kernels/flash_attention.py,
// via `flash_attention_pallas`) on its decode calls, where the reference's
// wrapper falls back to the jnp `transformer._attention_decode`.
//
// What bounds it on Hopper: bytes.  Every valid cached key and value is read
// once for g rows, ~2 flops per byte, far below the card's ~295 bf16 flops
// per byte.  The arithmetic is a few FMAs per loaded value on the CUDA cores.
//
// Design: one (batch, KV head) has only g rows, so a block per head would
// leave most of the 132 SMs idle and walk the keys in one serial chain.
// Instead the keys are cut into splits of SPLIT = 64 (a constant, so the
// result never depends on the machine) and the grid is (batch x KV head,
// split): 8 x 8 x 16 = 1024 blocks for minitron-4b's cache of 1016.
// - The split kernel copies its 64 K and V rows into shared memory with
//   16-byte `cp.async` copies, all in flight at once (rows of one head are
//   contiguous in the cache, read in place from its strided slice), then
//   computes each row's scores, its max m, its sum l of exp(s - m) and the
//   unnormalised acc = sum_j exp(s_j - m) v_j, written to float32 scratch
//   that the wrapper allocates.  A split wholly past the keys the rows may
//   see, or wholly left of the window's band, writes m = -1e30, l = 0 and
//   loads nothing.  Each row applies the lk_valid, causal and window mask
//   itself.
// - The block has one thread per head-dim lane of the widest head it takes:
//   DM = 128 threads up to D = 128, 256 for D = 256 (recurrentgemma-2b).
// - The combine kernel, one block per (batch x KV head, row) and one thread
//   per dim, merges the splits in ascending split order: M = max m_s over
//   splits with l_s > 0, O = sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s,
//   O = 0 where no split saw a key.  Its loops over the splits are unrolled
//   so that their loads are in flight together.  No atomics, so the result
//   is the same on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPLIT = 64;     // keys per split (one block)
constexpr int RMAX = 16;      // rows (query position x group head) per head
constexpr int DMAX = 256;     // largest head dim
static_assert(SPLIT % 32 == 0 && 128 % SPLIT == 0, "split of whole warps");
constexpr float NEG = -1.0e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) { *p = __float2bfloat16(x); }

// one 16-byte chunk of shared memory as floats
__device__ __forceinline__ void load_f(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
}

__device__ __forceinline__ void load_f(const bf16* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

// one 16-byte chunk of a row into shared memory: the first n values from
// src, zeros after; `vec` when src is 16-byte aligned
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int n, bool vec) {
    constexpr int E = 16 / sizeof(T);
    if (vec) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                        "l"(src), "r"(n * static_cast<int>(sizeof(T)))
                     : "memory");
    } else {
#pragma unroll
        for (int u = 0; u < E; ++u) dst[u] = u < n ? src[u] : T(0.0f);
    }
}

// DM: the head dims the block is built for, one thread each
template <typename T, int DM>
__host__ __device__ constexpr int kv_pitch() {
    return DM + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int DM>
__host__ __device__ constexpr int split_smem() {
    return 2 * SPLIT * kv_pitch<T, DM>() * static_cast<int>(sizeof(T))
           + (RMAX * DM + RMAX * SPLIT) * static_cast<int>(sizeof(float));
}

template <typename T, int DM>
__global__ void __launch_bounds__(DM)
flash_decode_split_kernel(float* part, const T* __restrict__ q,
                          const T* __restrict__ k, const T* __restrict__ v,
                          int lq, int lk_valid, int g, int d, int causal,
                          int window, float scale, int hkv, int nsplit, int vec,
                          long long sq_b, long long sq_l, long long sq_h,
                          long long sk_b, long long sk_l, long long sk_h,
                          long long sv_b, long long sv_l, long long sv_h) {
    constexpr int THREADS = DM;
    constexpr int RG = THREADS / SPLIT;    // row groups of the score pass
    constexpr int E = 16 / sizeof(T);      // values per 16-byte chunk
    constexpr int KP = kv_pitch<T, DM>();  // padded pitch of the K and V rows
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* ks = reinterpret_cast<T*>(smem_raw);               // [SPLIT][KP]
    T* vs = ks + SPLIT * KP;                              // [SPLIT][KP]
    float* qs = reinterpret_cast<float*>(vs + SPLIT * KP);  // [RMAX][DM]
    float* ps = qs + RMAX * DM;                           // [RMAX][SPLIT]

    const int tid = threadIdx.x;
    const int bh = blockIdx.x, s = blockIdx.y;
    const long long b = bh / hkv;
    const int hk = bh % hkv;
    const int nrows = lq * g, offset = lk_valid - lq;
    int kend = lk_valid;
    if (causal) kend = min(kend, (nrows - 1) / g + offset + 1);
    const int j0 = s * SPLIT;
    // the window's band of row 0 (the earliest query) starts at kstart
    const int kstart = window > 0 ? offset - window + 1 : 0;
    const int nkeys = j0 + SPLIT <= kstart ? 0 : min(SPLIT, kend - j0);

    // scratch: acc [BH][nsplit][rows][d], then m and l [BH][nsplit][rows]
    const long long parts = static_cast<long long>(gridDim.x) * nsplit;
    const long long slot = static_cast<long long>(bh) * nsplit + s;
    float* acc_out = part + slot * nrows * d;
    float* m_out = part + parts * nrows * d + slot * nrows;
    float* l_out = m_out + parts * nrows;
    if (nkeys <= 0) {
        for (int r = tid; r < nrows; r += THREADS) {
            m_out[r] = NEG;
            l_out[r] = 0.0f;
        }
        return;
    }

    const int nch = (d + E - 1) / E;
    const T* kb = k + b * sk_b + hk * sk_h + static_cast<long long>(j0) * sk_l;
    const T* vb = v + b * sv_b + hk * sv_h + static_cast<long long>(j0) * sv_l;
    {
        // thread (row slot, chunk): CPR chunks cover DM, RPP rows a pass
        constexpr int CPR = DM / E, RPP = THREADS / CPR;
        const int c = tid % CPR;
        const int n = min(E, d - c * E);
        if (n > 0) {
            for (int j = tid / CPR; j < nkeys; j += RPP) {
                copy_chunk(ks + j * KP + c * E, kb + j * sk_l + c * E, n, vec);
                copy_chunk(vs + j * KP + c * E, vb + j * sv_l + c * E, n, vec);
            }
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // Q rows as float, zeros past d (THREADS == DM: one value a thread)
    for (int r = 0; r < nrows; ++r) {
        const int qi = r / g, h = hk * g + r % g;
        qs[r * DM + tid] =
            tid < d ? to_f(q[b * sq_b + qi * sq_l + h * sq_h + tid]) : 0.0f;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // scores: thread (j, rg) takes key j against rows rg, rg + RG, ...
    {
        const int j = tid % SPLIT, rg = tid / SPLIT;
        float dot[RMAX / RG];
#pragma unroll
        for (int i = 0; i < RMAX / RG; ++i) dot[i] = 0.0f;
        if (j < nkeys) {
            for (int c = 0; c < nch; ++c) {
                float kv[E];
                load_f(ks + j * KP + c * E, kv);
#pragma unroll
                for (int i = 0; i < RMAX / RG; ++i) {
                    const int r = rg + RG * i;
                    if (r < nrows) {
                        const float* qr = qs + r * DM + c * E;
#pragma unroll
                        for (int u = 0; u < E; ++u) dot[i] = fmaf(qr[u], kv[u], dot[i]);
                    }
                }
            }
        }
        const int kp = j0 + j;
#pragma unroll
        for (int i = 0; i < RMAX / RG; ++i) {
            const int r = rg + RG * i;
            if (r < nrows) {
                const bool ok = j < nkeys && kp < lk_valid
                                && (!causal || kp <= r / g + offset)
                                && (window <= 0 || kp > r / g + offset - window);
                ps[r * SPLIT + j] = ok ? dot[i] * scale : NEG;
            }
        }
    }
    __syncthreads();

    // each row's max and sum over the split; p replaces the score
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < nrows; r += THREADS / 32) {
        float* pr = ps + r * SPLIT;
        float x[SPLIT / 32];
        float mx = NEG;
#pragma unroll
        for (int i = 0; i < SPLIT / 32; ++i) {
            x[i] = pr[lane + 32 * i];
            mx = fmaxf(mx, x[i]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        // masked scores are -1e30: exp(-1e30 - base) = 0 unless base is -1e30
        const float base = mx == NEG ? 0.0f : mx;
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < SPLIT / 32; ++i) {
            const float p = expf(x[i] - base);
            pr[lane + 32 * i] = p;
            sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
            m_out[r] = mx;
            l_out[r] = sum;
        }
    }
    __syncthreads();

    // acc[r][dd] = sum_j p[r][j] v[j][dd], keys in ascending order
    for (int e = tid; e < nrows * d; e += THREADS) {
        const int r = e / d, dd = e % d;
        const float* pr = ps + r * SPLIT;
        float a = 0.0f;
        for (int j = 0; j < nkeys; ++j) a = fmaf(pr[j], to_f(vs[j * KP + dd]), a);
        acc_out[e] = a;
    }
}

// one block per (batch x KV head, row), one thread per dim; the m and l of
// a split are the same address for every thread (one broadcast load)
template <typename T, int DM>
__global__ void __launch_bounds__(DM)
flash_decode_combine_kernel(T* o, const float* __restrict__ part, int lq,
                            int g, int d, int hkv, int nsplit,
                            long long so_b, long long so_l, long long so_h) {
    const int bh = blockIdx.x, r = blockIdx.y, dd = threadIdx.x;
    const long long b = bh / hkv;
    const int hk = bh % hkv;
    const int nrows = lq * g;
    const long long parts = static_cast<long long>(gridDim.x) * nsplit;
    const float* acc = part + static_cast<long long>(bh) * nsplit * nrows * d;
    const float* mv = part + parts * nrows * d
                      + static_cast<long long>(bh) * nsplit * nrows;
    const float* lv = mv + parts * nrows;
    if (dd >= d) return;
    // the loads do not wait on l: a split with l = 0 is read (its acc may
    // be stale scratch) and then left out by a select
    float mmax = NEG;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) {
        const float m = mv[s * nrows + r];
        mmax = lv[s * nrows + r] > 0.0f ? fmaxf(mmax, m) : mmax;
    }
    float num = 0.0f, den = 0.0f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) {
        const float l = lv[s * nrows + r];
        const float a = acc[(static_cast<long long>(s) * nrows + r) * d + dd];
        const float w = expf(mv[s * nrows + r] - mmax);
        num = l > 0.0f ? fmaf(w, a, num) : num;
        den = l > 0.0f ? fmaf(w, l, den) : den;
    }
    const int qi = r / g, h = hk * g + r % g;
    from_f(o + b * so_b + qi * so_l + h * so_h + dd, den > 0.0f ? num / den : 0.0f);
}

template <typename T, int DM>
int launch(void* o, const void* q, const void* k, const void* v, void* part,
           int batch, int lq, int lk, int lk_valid, int g, int hkv, int d,
           int causal, int window, float scale, const long long* st,
           cudaStream_t stream) {
    constexpr int smem = split_smem<T, DM>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_split_kernel<T, DM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nsplit = lk > 0 ? (lk + SPLIT - 1) / SPLIT : 1;
    // cp.async needs 16-byte aligned rows: base pointers and k, v strides
    constexpr int E = 16 / sizeof(T);
    int vec = (reinterpret_cast<uintptr_t>(k) & 15) == 0
              && (reinterpret_cast<uintptr_t>(v) & 15) == 0;
    for (int i = 3; i < 9; ++i) vec = vec && st[i] % E == 0;
    dim3 grid(batch * hkv, nsplit);
    flash_decode_split_kernel<T, DM><<<grid, DM, smem, stream>>>(
        static_cast<float*>(part), static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v), lq, lk_valid, g, d,
        causal, window, scale, hkv, nsplit, vec, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_decode_combine_kernel<T, DM><<<dim3(batch * hkv, lq * g), DM, 0,
                                         stream>>>(
        static_cast<T*>(o), static_cast<const float*>(part), lq, g, d, hkv,
        nsplit, st[9], st[10], st[11]);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; window 0 means none.  Needs Lq * (Hq / Hkv)
// <= 16 rows and a head dim <= 256.  `part`
// is float32 scratch of B * Hkv * nsplit * rows * (d + 2) values, nsplit =
// ceil(Lk / 64) (1 when Lk = 0).  Strides are in elements: (batch, row, head)
// for q, k, v and o in that order; the head-dim axis is contiguous.
extern "C" int flash_decode(void* o, const void* q, const void* k,
                            const void* v, void* part, int dtype, int batch,
                            int lq, int lk, int lk_valid, int hq, int hkv,
                            int d, int causal, int window, float scale,
                            long long sq_b, long long sq_l, long long sq_h,
                            long long sk_b, long long sk_l, long long sk_h,
                            long long sv_b, long long sv_l, long long sv_h,
                            long long so_b, long long so_l, long long so_h,
                            void* stream) {
    if (d <= 0 || d > DMAX || hkv <= 0 || hq % hkv != 0 || lk < 0
        || window < 0 || (lk + SPLIT - 1) / SPLIT > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch <= 0 || lq <= 0) return static_cast<int>(cudaGetLastError());
    const int g = hq / hkv;
    if (lq * g > RMAX) return static_cast<int>(cudaErrorInvalidValue);
    const long long st[12] = {sq_b, sq_l, sq_h, sk_b, sk_l, sk_h,
                              sv_b, sv_l, sv_h, so_b, so_l, so_h};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (d > 128) {
        if (dtype == 0)
            return launch<float, DMAX>(o, q, k, v, part, batch, lq, lk, lk_valid,
                                       g, hkv, d, causal, window, scale, st, s);
        return launch<bf16, DMAX>(o, q, k, v, part, batch, lq, lk, lk_valid, g,
                                  hkv, d, causal, window, scale, st, s);
    }
    if (dtype == 0)
        return launch<float, 128>(o, q, k, v, part, batch, lq, lk, lk_valid, g,
                                  hkv, d, causal, window, scale, st, s);
    return launch<bf16, 128>(o, q, k, v, part, batch, lq, lk, lk_valid, g, hkv,
                             d, causal, window, scale, st, s);
}
