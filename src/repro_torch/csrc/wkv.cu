// K5 wkv_chunked: RWKV-6 WKV with data-dependent decay, in chunks of 32.
//
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//     o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
//
// per lane (batch x head), with log w_t given, S starting at S0 (or 0),
// returning o [B, H, T, n] and the final state S_T [B, H, n, n].
//
// Replaces the TPU kernel `_wkv_kernel` (repro/kernels/wkv.py, via
// `wkv_chunked_pallas`), whose chunked algebra the model's prefill runs as
// jnp (repro/models/rwkv6.py `_wkv_chunked`, which also carries S0 in and
// S_T out).
//
// What bounds it on Hopper: bytes.  Per chunk of C tokens a lane reads 4 C n
// floats and writes C n, against ~(2 C^2 n + 4 C n^2) flops of chunked
// algebra: at n = 64 that is ~16 flops per byte, below the card's ~20 fp32
// flops per byte of device memory.
//
// Design.  One block of 256 threads per lane (512 at the rwkv6-7b
// prefill), 2 blocks an SM, each walking its lane's chunks with the n x n
// state in registers and shared memory.  Each chunk's work is cut into
// tiles across all threads rather than across blocks: splitting a lane's
// value columns over blocks gives more blocks but repeats the decay and A
// in each, and was slower (tools/k1_k5_variants.py).  What
// bounds the design is shared-memory bandwidth: every product reads its
// operands from shared memory, so each is tiled to make one float4 read
// feed as many FMAs as registers allow.  Per chunk, 5 barriers:
//   - loads: r, k, log w and v (C x n each) go into one of two
//     shared-memory stages by cp.async, chunk c + 2 while chunks c and
//     c + 1 are in hand, so the next chunk's loads overlap this one's
//     compute; steps past T and channels past n are zero-filled by the copy
//     (log w = 0 leaves S unchanged), so a ragged T needs no padded copy.
//     Rows are n + 4 floats apart, so a warp that walks a column with
//     float4 reads hits every bank once.
//   - the cumulative log decay lcw runs one thread a channel in token
//     order (32 dependent adds), so it is bit-equal to the plain version's
//     cumsum; a warp-wide shuffle scan, which adds in another order, moved
//     some outputs by 2e-4 through exponents of +-80 and broke the
//     tolerance.  Then r e^{lcw - log w}, k e^{-lcw} and k e^{total - lcw}
//     are formed in place on every thread, lane = token and 4 channels a
//     float4; exp is the accurate expf (no fast math), since exponents reach
//     +-80 within a chunk; the bonus term sum(r u k) is summed per warp on
//     the way.
//   - A = (r e^{..}) (k e^{-lcw})^T, strictly lower: only the 36 4x4 tiles
//     on and below the diagonal, each summed by 4 threads over interleaved
//     quarters of the channels and reduced by warp shuffles.  In the same
//     phase S' = e^{total} S + (k e^{..})^T v: each thread owns 4 rows by 4
//     columns of S in registers (a float4 of k and one of v feed 16 FMAs).
//   - o = A v + diag v + (r e^{..}) S from the state before the chunk: 4x4
//     tiles, each summed by 2 threads over interleaved halves of the steps
//     i < t and of the channels (8 float4 reads feed 64 FMAs), reduced by a
//     shuffle.  Then S' is stored for the next chunk (one shared copy of S
//     fits 2 blocks an SM; two copies, which would save that barrier, fit
//     only one).
// Plain float32 FMA on the CUDA cores: TF32 tensor cores would break the
// 1e-4 tolerance.  The inputs are strided views (lane strides over batch
// and head, a token stride, contiguous channels), so the model's [B, T, H, n]
// projections are read in place and o is written in the same layout.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int C = 32;          // chunk length (CHUNK in the reference) = warp size
constexpr int NMAX = 64;       // largest head size

struct Lanes {                 // element strides: batch, head, token
    long long b, h, t;
};

struct Args {
    float* o;
    float* s_out;
    const float* r;
    const float* k;
    const float* v;
    const float* w;
    const float* u;
    const float* s0;
    int nh, t_len, n;
    bool vec;                  // 16-byte copies (aligned, n % 4 == 0)
    Lanes sr, sk, sv, sw, so;
    long long su_b, su_h;
};

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float4 axpy(float a, float4 x, float4 y) {
    return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y),
                       fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

// threads of a block: 256, at most 8 per value column
template <int NP>
__host__ __device__ constexpr int threads_for() { return NP < 32 ? 8 * NP : 256; }

template <int NP>
struct Layout {
    static constexpr int THREADS = threads_for<NP>();
    static constexpr int WARPS = THREADS / 32;
    static constexpr int RS = NP + 4;     // row stride of r, k, log w, v, S
    static constexpr int AS = C + 4;      // row stride of A
    static constexpr int STAGE = 4 * C * RS;
    static constexpr int FLOATS = 2 * STAGE + C * RS + C * AS
                                  + NP * RS + WARPS * C + 2 * NP + C;
};

template <int NP>
__global__ void __launch_bounds__(threads_for<NP>())
wkv_chunked_kernel(const Args p) {
    using L = Layout<NP>;
    constexpr int THREADS = L::THREADS, WARPS = L::WARPS;
    constexpr int RS = L::RS, AS = L::AS;
    extern __shared__ __align__(16) float sm[];
    float* LC = sm + 2 * L::STAGE;         // [C][RS]   cumulative log decay
    float* A = LC + C * RS;                // [C][AS]   strictly lower
    float* Sb = A + C * AS;                // [NP][RS]  state
    float* Dp = Sb + NP * RS;              // [WARPS][C] bonus term partials
    float* ET = Dp + WARPS * C;            // [NP]      e^{total}
    float* U = ET + NP;                    // [NP]      bonus u
    float* D = U + NP;                     // [C]       sum(r u k) per step

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = p.n, T = p.t_len;
    const long long lid = blockIdx.x;
    const long long bi = lid / p.nh, hi = lid % p.nh;
    const float* rl = p.r + bi * p.sr.b + hi * p.sr.h;
    const float* kl = p.k + bi * p.sk.b + hi * p.sk.h;
    const float* wl = p.w + bi * p.sw.b + hi * p.sw.h;
    const float* vl = p.v + bi * p.sv.b + hi * p.sv.h;
    float* ol = p.o + bi * p.so.b + hi * p.so.h;
    const int nc = (T + C - 1) / C;

    auto load_chunk = [&](int c, float* st) {
        const int t0 = c * C;
        float* R = st;
        float* K = st + C * RS;
        float* W = st + 2 * C * RS;
        float* V = st + 3 * C * RS;
        if (p.vec) {
            for (int e = tid; e < C * (NP / 4); e += THREADS) {
                const int t = e / (NP / 4), q = (e % (NP / 4)) * 4;
                const bool ok = t0 + t < T && q < n;
                const long long tt = ok ? t0 + t : 0;
                const int qq = ok ? q : 0;
                cp16(R + t * RS + q, rl + tt * p.sr.t + qq, ok);
                cp16(K + t * RS + q, kl + tt * p.sk.t + qq, ok);
                cp16(W + t * RS + q, wl + tt * p.sw.t + qq, ok);
                cp16(V + t * RS + q, vl + tt * p.sv.t + qq, ok);
            }
        } else {
            for (int e = tid; e < C * NP; e += THREADS) {
                const int t = e / NP, q = e % NP;
                const bool ok = t0 + t < T && q < n;
                const long long tt = ok ? t0 + t : 0;
                const int qq = ok ? q : 0;
                cp4(R + t * RS + q, rl + tt * p.sr.t + qq, ok);
                cp4(K + t * RS + q, kl + tt * p.sk.t + qq, ok);
                cp4(W + t * RS + q, wl + tt * p.sw.t + qq, ok);
                cp4(V + t * RS + q, vl + tt * p.sv.t + qq, ok);
            }
        }
    };

    if (nc > 0) load_chunk(0, sm);
    cp_commit();
    if (nc > 1) load_chunk(1, sm + L::STAGE);
    cp_commit();

    const float* ul = p.u + bi * p.su_b + hi * p.su_h;
    for (int ch = tid; ch < NP; ch += THREADS) U[ch] = ch < n ? ul[ch] : 0.0f;

    // this thread's state columns sx*4 .. +3, rows sy*SR .. +SR-1
    constexpr int SG = NP / 4, SY = THREADS / SG, SR = (NP + SY - 1) / SY;
    const int sx = tid % SG, sy = tid / SG;
    float4 sreg[SR];
    const float* s0l = p.s0 ? p.s0 + lid * n * n : nullptr;
#pragma unroll
    for (int j = 0; j < SR; ++j) {
        const int ch = sy * SR + j;
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = sx * 4 + i;
            x[i] = (s0l && ch < n && m < n) ? s0l[ch * n + m] : 0.0f;
        }
        sreg[j] = make_float4(x[0], x[1], x[2], x[3]);
        if (ch < NP) st4(Sb + ch * RS + sx * 4, sreg[j]);
    }

    // A: the 36 4x4 tiles on and below the diagonal, each summed by 4
    // threads over interleaved quarters of the channels; o: 4x4 tiles of the
    // C x n output, each summed by 2 threads over interleaved halves of
    // the steps and channels.  Partial sums meet by warp shuffles.
    constexpr int ATILES = (C / 4) * (C / 4 + 1) / 2;
    constexpr int ATASKS = (ATILES * 4 + 31) / 32 * 32;   // whole warps
    constexpr int AT = (ATASKS + THREADS - 1) / THREADS;
    constexpr int OTASKS = 2 * (C / 4) * (NP / 4);
    static_assert(OTASKS <= THREADS && OTASKS % 32 == 0, "o tiles");
    int a_tr[AT], a_tc[AT];
#pragma unroll
    for (int j = 0; j < AT; ++j) {
        int k = min((tid + j * THREADS) / 4, ATILES - 1), tr = 0;
        while ((tr + 1) * (tr + 2) / 2 <= k) ++tr;
        a_tr[j] = tr;
        a_tc[j] = k - tr * (tr + 1) / 2;
    }
    const int o_kh = tid & 1, o_tr = (tid >> 1) / (NP / 4),
              o_tc = (tid >> 1) % (NP / 4);

    for (int c = 0; c < nc; ++c) {
        float* st = sm + (c & 1) * L::STAGE;
        float* R = st;                 // r, then r e^{lcw - log w}
        float* K = st + C * RS;        // k, then k e^{total - lcw}
        float* W = st + 2 * C * RS;    // log w, then k e^{-lcw}
        const float* V = st + 3 * C * RS;
        cp_wait<1>();                  // chunk c landed (c + 1 may be in flight)
        __syncthreads();

        // cumulative log decay, one thread a channel, in token order: the
        // plain version's cumsum adds in this order, so lcw is bit-equal
        for (int ch = tid; ch < NP; ch += THREADS) {
            float l = 0.0f;
#pragma unroll 8
            for (int t = 0; t < C; ++t) {
                l += W[t * RS + ch];
                LC[t * RS + ch] = l;
            }
            ET[ch] = expf(l);
        }
        __syncthreads();

        // decay weights and bonus term: lane = token, 4 channels at a time
        float dpart = 0.0f;
        for (int q = warp * 4; q < NP; q += WARPS * 4) {
            const float4 rr = ld4(R + lane * RS + q);
            const float4 kk = ld4(K + lane * RS + q);
            const float4 ww = ld4(W + lane * RS + q);
            const float4 l = ld4(LC + lane * RS + q);
            const float4 tot = ld4(LC + (C - 1) * RS + q);
            const float4 uu = ld4(U + q);
            dpart = fmaf(rr.x * uu.x, kk.x, dpart);
            dpart = fmaf(rr.y * uu.y, kk.y, dpart);
            dpart = fmaf(rr.z * uu.z, kk.z, dpart);
            dpart = fmaf(rr.w * uu.w, kk.w, dpart);
            st4(R + lane * RS + q, make_float4(
                rr.x * expf(l.x - ww.x), rr.y * expf(l.y - ww.y),
                rr.z * expf(l.z - ww.z), rr.w * expf(l.w - ww.w)));
            st4(W + lane * RS + q, make_float4(
                kk.x * expf(-l.x), kk.y * expf(-l.y),
                kk.z * expf(-l.z), kk.w * expf(-l.w)));
            st4(K + lane * RS + q, make_float4(
                kk.x * expf(tot.x - l.x), kk.y * expf(tot.y - l.y),
                kk.z * expf(tot.z - l.z), kk.w * expf(tot.w - l.w)));
        }
        Dp[warp * C + lane] = dpart;
        __syncthreads();

        // A = (r e^{lcw - log w}) (k e^{-lcw})^T, strictly lower, then S'
#pragma unroll
        for (int j = 0; j < AT; ++j) {
            const int task = tid + j * THREADS;
            if (task >= ATASKS) break;         // whole warps
            const int kq = task & 3, tr = a_tr[j], tc = a_tc[j];
            float acc[4][4] = {};
            for (int q = kq * 4; q < NP; q += 16) {
                float4 rv[4], kv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    rv[i] = ld4(R + (tr * 4 + i) * RS + q);
                    kv[i] = ld4(W + (tc * 4 + i) * RS + q);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        acc[i][e] = fmaf(rv[i].x, kv[e].x, acc[i][e]);
                        acc[i][e] = fmaf(rv[i].y, kv[e].y, acc[i][e]);
                        acc[i][e] = fmaf(rv[i].z, kv[e].z, acc[i][e]);
                        acc[i][e] = fmaf(rv[i].w, kv[e].w, acc[i][e]);
                    }
            }
            // reduce-scatter over the 4 threads: each ends with one row
            const bool b1 = kq & 1, b2 = kq & 2;
            float half[2][4], row[4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float lo = acc[i][e], hi = acc[2 + i][e];
                    half[i][e] = (b1 ? hi : lo)
                        + __shfl_xor_sync(0xffffffffu, b1 ? lo : hi, 1);
                }
#pragma unroll
            for (int e = 0; e < 4; ++e)
                row[e] = (b2 ? half[1][e] : half[0][e])
                    + __shfl_xor_sync(0xffffffffu, b2 ? half[0][e] : half[1][e], 2);
            if (task / 4 < ATILES) {
                const int t = tr * 4 + (b1 ? 2 : 0) + (b2 ? 1 : 0);
                const int i0 = tc * 4;
                st4(A + t * AS + i0, make_float4(
                    i0 < t ? row[0] : 0.0f, i0 + 1 < t ? row[1] : 0.0f,
                    i0 + 2 < t ? row[2] : 0.0f, i0 + 3 < t ? row[3] : 0.0f));
            }
        }
        if (warp == WARPS - 1) {               // the bonus term of each step
            float d = 0.0f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) d += Dp[w * C + lane];
            D[lane] = d;
        }

        // S' = e^{total} S + (k e^{total - lcw})^T v into this thread's
        // registers; it is stored after o has read S
        {
            float4 acc[SR];
#pragma unroll
            for (int j = 0; j < SR; ++j) {
                const int ch = sy * SR + j;
                const float e = ch < NP ? ET[ch] : 0.0f;
                acc[j] = make_float4(sreg[j].x * e, sreg[j].y * e,
                                     sreg[j].z * e, sreg[j].w * e);
            }
#pragma unroll 4
            for (int t = 0; t < C; ++t) {
                const float4 vt = ld4(V + t * RS + sx * 4);
                if constexpr (SR % 4 == 0) {      // 4 rows a float4 of k
#pragma unroll
                    for (int g = 0; g < SR; g += 4) {
                        const float4 kq = ld4(K + t * RS + sy * SR + g);
                        acc[g] = axpy(kq.x, vt, acc[g]);
                        acc[g + 1] = axpy(kq.y, vt, acc[g + 1]);
                        acc[g + 2] = axpy(kq.z, vt, acc[g + 2]);
                        acc[g + 3] = axpy(kq.w, vt, acc[g + 3]);
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < SR; ++j) {
                        const int ch = sy * SR + j;
                        if (ch < NP) acc[j] = axpy(K[t * RS + ch], vt, acc[j]);
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < SR; ++j) sreg[j] = acc[j];
        }
        __syncthreads();

        // o = A v + diag v + (r e^{..}) S, from the state before this chunk
        if (tid < OTASKS) {
            float4 acc[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int t = o_tr * 4 + i;
                const float d = o_kh ? 0.0f : D[t];
                const float4 vt = ld4(V + t * RS + o_tc * 4);
                acc[i] = make_float4(d * vt.x, d * vt.y, d * vt.z, d * vt.w);
            }
            // A is strictly lower: rows o_tr*4.. need the steps of groups <= o_tr
            for (int g = o_kh; g <= o_tr; g += 2) {
                float4 av[4], vv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    av[i] = ld4(A + (o_tr * 4 + i) * AS + g * 4);
                    vv[i] = ld4(V + (g * 4 + i) * RS + o_tc * 4);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[i] = axpy(av[i].x, vv[0], acc[i]);
                    acc[i] = axpy(av[i].y, vv[1], acc[i]);
                    acc[i] = axpy(av[i].z, vv[2], acc[i]);
                    acc[i] = axpy(av[i].w, vv[3], acc[i]);
                }
            }
#pragma unroll 2
            for (int q = o_kh * 4; q < NP; q += 8) {
                float4 rv[4], sv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    rv[i] = ld4(R + (o_tr * 4 + i) * RS + q);
                    sv[i] = ld4(Sb + (q + i) * RS + o_tc * 4);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[i] = axpy(rv[i].x, sv[0], acc[i]);
                    acc[i] = axpy(rv[i].y, sv[1], acc[i]);
                    acc[i] = axpy(rv[i].z, sv[2], acc[i]);
                    acc[i] = axpy(rv[i].w, sv[3], acc[i]);
                }
            }
            // reduce-scatter over the 2 threads: each ends with two rows
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float4 lo = acc[i], hi = acc[2 + i];
                const float4 send = o_kh ? lo : hi;
                float4 res = o_kh ? hi : lo;
                res.x += __shfl_xor_sync(0xffffffffu, send.x, 1);
                res.y += __shfl_xor_sync(0xffffffffu, send.y, 1);
                res.z += __shfl_xor_sync(0xffffffffu, send.z, 1);
                res.w += __shfl_xor_sync(0xffffffffu, send.w, 1);
                const int t = c * C + o_tr * 4 + 2 * o_kh + i;
                if (t >= T) continue;
                float* dst = ol + t * p.so.t + o_tc * 4;
                const int m = o_tc * 4;
                if (p.vec) {
                    if (m < n) st4(dst, res);
                } else {
                    const float x[4] = {res.x, res.y, res.z, res.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (m + e < n) dst[e] = x[e];
                }
            }
        }
        __syncthreads();              // o has read S and this stage
#pragma unroll
        for (int j = 0; j < SR; ++j)
            if (sy * SR + j < NP) st4(Sb + (sy * SR + j) * RS + sx * 4, sreg[j]);
        if (c + 2 < nc) load_chunk(c + 2, st);
        cp_commit();
    }
    cp_wait<0>();

    float* sol = p.s_out + lid * n * n;
#pragma unroll
    for (int j = 0; j < SR; ++j) {
        const int ch = sy * SR + j;
        if (ch >= n) continue;
        const float x[4] = {sreg[j].x, sreg[j].y, sreg[j].z, sreg[j].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = sx * 4 + i;
            if (m < n) sol[ch * n + m] = x[i];
        }
    }
}

template <int NP>
cudaError_t launch(const Args& a, long long lanes, cudaStream_t stream) {
    const size_t smem = Layout<NP>::FLOATS * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_chunked_kernel<NP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        wkv_chunked_kernel<NP>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    wkv_chunked_kernel<NP><<<static_cast<unsigned>(lanes), Layout<NP>::THREADS,
                             smem, stream>>>(a);
    return cudaGetLastError();
}

bool aligned(const void* ptr) {
    return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// r, k, v, w (log decay): [nb, nh, t, n] float32 views, element strides
// (batch, head, token) each, channels contiguous; o written through its own
// strides; u: n floats at u + b*su_b + h*su_h; s0: [nb*nh, n, n] contiguous
// or null; s_out: [nb*nh, n, n] contiguous.
extern "C" int wkv_chunked(float* o, float* s_out, const float* r,
                           const float* k, const float* v, const float* w,
                           const float* u, const float* s0,
                           int nb, int nh, int t, int n,
                           long long r_b, long long r_h, long long r_t,
                           long long k_b, long long k_h, long long k_t,
                           long long v_b, long long v_h, long long v_t,
                           long long w_b, long long w_h, long long w_t,
                           long long o_b, long long o_h, long long o_t,
                           long long su_b, long long su_h, void* stream) {
    if (n <= 0 || n > NMAX || nh <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (nb <= 0) return static_cast<int>(cudaGetLastError());
    Args a{o, s_out, r, k, v, w, u, s0, nh, t, n, false,
           {r_b, r_h, r_t}, {k_b, k_h, k_t}, {v_b, v_h, v_t}, {w_b, w_h, w_t},
           {o_b, o_h, o_t}, su_b, su_h};
    bool vec = n % 4 == 0;
    for (const void* ptr : {static_cast<const void*>(o), static_cast<const void*>(r),
                            static_cast<const void*>(k), static_cast<const void*>(v),
                            static_cast<const void*>(w)})
        vec = vec && aligned(ptr);
    for (long long s : {r_b, r_h, r_t, k_b, k_h, k_t, v_b, v_h, v_t, w_b, w_h,
                        w_t, o_b, o_h, o_t})
        vec = vec && s % 4 == 0;
    a.vec = vec;
    const long long lanes = static_cast<long long>(nb) * nh;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (n <= 16)
        err = launch<16>(a, lanes, st);
    else if (n <= 32)
        err = launch<32>(a, lanes, st);
    else
        err = launch<64>(a, lanes, st);
    return static_cast<int>(err);
}
