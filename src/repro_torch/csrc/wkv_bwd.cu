// K5b wkv_chunked_bwd: the backward of K5 (RWKV-6 WKV with data-dependent
// decay, in chunks of 32).  Per lane (batch x head), given the cotangents
// dO of o and dS_T of the final state, it returns dr, dk, dv, d(log w), the
// lane's du and dS0.  With L the inclusive cumsum of log w in a chunk, E =
// L - log w, Λ = L at the chunk's last step, r~ = r e^E, k~ = k e^-L, k^ =
// k e^(Λ-L), A = r~ k~^T strictly lower, S_c the chunk-start state and dS
// the cotangent of the chunk's end state:
//
//     dA  = (dO V^T) strictly lower      dv  = A^T dO + diag dO + k^ dS
//     dr~ = dA k~ + dO S_c^T             dk~ = dA^T r~        dk^ = V dS^T
//     dr  = dr~ e^E + (dO.v) u k         dk  = dk~ e^-L + dk^ e^(Λ-L) + (dO.v) u r
//     dlog_w_j = sum_{t>j} dr~ r~ - sum_{t>=j} dk~ k~ + sum_{t<j} dk^ k^
//                + e^Λ rowsum(S_c o dS)
//     du += sum_t (dO_t.v_t) r_t k_t     dS <- diag(e^Λ) dS + r~^T dO
//
// (diag_t = sum(r_t u k_t); kernels/wkv.py `wkv_chunked_bwd_plain` is the
// same algebra in torch, held to autograd and to the reference).
//
// Replaces no TPU kernel: the reference's rwkv6 model differentiates its jnp
// chunked WKV (repro/models/rwkv6.py `_wkv_chunked`) through XLA, and K5
// stands in for that function in the port; this is its gradient.
//
// What bounds it on Hopper: operations, narrowly.  Per chunk of C tokens a
// lane reads 5 C n floats and writes 4 C n, against 5 C(C-1)/2 n + 5 C n^2
// multiply-adds (A, dA, A^T dO, dA k~, dA^T r~, each strictly lower; k^ dS,
// dO S^T, V dS^T, the dS carry and the forward sweep's state): at n = 64,
// C = 32 that is ~22 flops per byte of the tensors, just above the card's
// ~20 fp32 flops per byte.
// The chunk-start states it writes and reads back add 8 n^2 bytes a chunk.
//
// Design (simple and right first; no atomics, every sum in a fixed order):
// one block of 256 threads per lane walks its chunks twice.  The forward
// sweep recomputes the state chunk by chunk and writes each chunk-start
// state to scratch the wrapper allocates ([lanes, ceil(T / 32), n, n]
// float32).  The reverse sweep, from the last chunk to the first, loads the
// chunk's r, k, v, log w and dO and its start state (and that state's
// transpose) into shared memory, runs the cumsum one thread a channel in
// token order (as K5 and the plain version add it), forms r~, k~, k^, A and
// dA, then the C x n products with a float4 of 4 output columns a thread,
// the suffix and prefix sums of dlog w one thread a channel, and carries dS
// (kept in shared memory with its transpose, so every product reads rows).
// Channels past n and steps past T are zero-filled, so a ragged T needs no
// padded copy and the padded steps add nothing.  ~185 KB of shared memory:
// one block an SM.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int C = 32;          // chunk length
constexpr int NP = 64;         // largest head size (channels are padded to it)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RS = NP + 4;     // row stride of the C x n and n x n tiles
constexpr int AS = C + 4;      // row stride of A and dA
constexpr int CT = C * RS;     // floats of a C x n tile
constexpr int ST = NP * RS;    // floats of an n x n tile
constexpr int FLOATS = 12 * CT + 2 * C * AS + 4 * ST + 4 * NP + 2 * C;

struct Lanes {                 // element strides: batch, head, token
    long long b, h, t;
};

struct Args {
    float* dr;
    float* dk;
    float* dv;
    float* dw;
    float* du;                 // [lanes, n]
    float* ds0;                // [lanes, n, n] or null
    const float* r;
    const float* k;
    const float* v;
    const float* w;
    const float* dout;
    const float* u;
    const float* s0;           // [lanes, n, n] or null
    const float* ds;           // [lanes, n, n] or null
    float* scratch;            // [lanes, nc, n, n]
    int nh, t_len, n;
    Lanes sr, sk, sv, sw, sd, odr, odk, odv, odw;
    long long su_b, su_h;
};

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 axpy(float a, float4 x, float4 y) {
    return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y),
                       fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// one chunk of a [T, n] operand of this lane into dst [C][RS], zeros past T/n
__device__ void load_tile(float* dst, const float* src, const Lanes& s,
                          long long bi, long long hi, int t0, int T, int n) {
    const float* base = src + bi * s.b + hi * s.h;
    for (int e = threadIdx.x; e < C * NP; e += THREADS) {
        const int t = e / NP, ch = e % NP;
        dst[t * RS + ch] = (t0 + t < T && ch < n) ? base[(t0 + t) * s.t + ch] : 0.0f;
    }
}

// a [C][RS] tile of this lane into dst through its strides, t < T, ch < n
__device__ __forceinline__ void store(float* dst, const Lanes& s, long long bi,
                                      long long hi, int t, int ch, float x, int T,
                                      int n) {
    if (t < T && ch < n) dst[bi * s.b + hi * s.h + t * s.t + ch] = x;
}

// inclusive cumsum of log w one thread a channel, in token order, and e^Λ
__device__ __forceinline__ void cumsum(float* LC, float* ET, const float* W) {
    for (int ch = threadIdx.x; ch < NP; ch += THREADS) {
        float l = 0.0f;
#pragma unroll 8
        for (int t = 0; t < C; ++t) {
            l += W[t * RS + ch];
            LC[t * RS + ch] = l;
        }
        ET[ch] = expf(l);
    }
}

__global__ void __launch_bounds__(THREADS) wkv_bwd_kernel(const Args p) {
    extern __shared__ __align__(16) float sm[];
    float* R = sm;                 // r
    float* K = R + CT;             // k
    float* V = K + CT;             // v
    float* W = V + CT;             // log w
    float* DO = W + CT;            // dO
    float* LC = DO + CT;           // L (inclusive cumsum)
    float* RT = LC + CT;           // r~ = r e^E
    float* KT = RT + CT;           // k~ = k e^-L
    float* KS = KT + CT;           // k^ = k e^(Λ-L)
    float* GR = KS + CT;           // dr~ r~
    float* GK = GR + CT;           // dk~ k~
    float* GS = GK + CT;           // dk^ k^
    float* A = GS + CT;            // [C][AS] strictly lower
    float* DA = A + C * AS;        // [C][AS] strictly lower
    float* S = DA + C * AS;        // [NP][RS] chunk-start state
    float* STR = S + ST;           // its transpose
    float* DS = STR + ST;          // cotangent of the chunk's end state
    float* DST = DS + ST;          // its transpose
    float* ET = DST + ST;          // [NP] e^Λ
    float* U = ET + NP;            // [NP] bonus u
    float* STATE = U + NP;         // [NP] e^Λ rowsum(S o dS)
    float* DU = STATE + NP;        // [NP] the lane's du
    float* DIAG = DU + NP;         // [C] sum(r u k)
    float* DDIAG = DIAG + C;       // [C] dO . v

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = p.n, T = p.t_len;
    const long long lid = blockIdx.x;
    const long long bi = lid / p.nh, hi = lid % p.nh;
    const int nc = (T + C - 1) / C;
    float* scr = p.scratch + lid * nc * n * n;
    // this thread's outputs: C x n tiles rows tr + 16 j, columns c4 .. c4 + 3;
    // n x n tiles rows tr + 16 j (j < 4), the same columns
    const int tr = tid / 16, c4 = 4 * (tid % 16);

    const float* ul = p.u + bi * p.su_b + hi * p.su_h;
    for (int ch = tid; ch < NP; ch += THREADS) {
        U[ch] = ch < n ? ul[ch] : 0.0f;
        DU[ch] = 0.0f;
    }
    const float* s0l = p.s0 ? p.s0 + lid * n * n : nullptr;
    const float* dsl = p.ds ? p.ds + lid * n * n : nullptr;
    for (int e = tid; e < NP * NP; e += THREADS) {
        const int a = e / NP, m = e % NP;
        const bool ok = a < n && m < n;
        S[a * RS + m] = (ok && s0l) ? s0l[a * n + m] : 0.0f;
        const float d = (ok && dsl) ? dsl[a * n + m] : 0.0f;
        DS[a * RS + m] = d;
        DST[m * RS + a] = d;
    }

    // forward sweep: the chunk-start states to scratch
    for (int c = 0; c < nc; ++c) {
        load_tile(K, p.k, p.sk, bi, hi, c * C, T, n);
        load_tile(V, p.v, p.sv, bi, hi, c * C, T, n);
        load_tile(W, p.w, p.sw, bi, hi, c * C, T, n);
        __syncthreads();
        for (int e = tid; e < n * n; e += THREADS) scr[c * n * n + e] = S[(e / n) * RS + e % n];
        cumsum(LC, ET, W);
        __syncthreads();
        for (int e = tid; e < C * NP; e += THREADS) {
            const int t = e / NP, ch = e % NP;
            KS[t * RS + ch] = K[t * RS + ch] * expf(LC[(C - 1) * RS + ch] - LC[t * RS + ch]);
        }
        __syncthreads();
        float4 acc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int a = tr + 16 * j;
            const float e = ET[a];
            const float4 s = ld4(S + a * RS + c4);
            acc[j] = make_float4(s.x * e, s.y * e, s.z * e, s.w * e);
        }
        for (int t = 0; t < C; ++t) {
            const float4 vt = ld4(V + t * RS + c4);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = axpy(KS[t * RS + tr + 16 * j], vt, acc[j]);
        }
        __syncthreads();               // every reader of S, K, V, W is done
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(S + (tr + 16 * j) * RS + c4) = acc[j];
    }

    // reverse sweep
    for (int c = nc - 1; c >= 0; --c) {
        const int t0 = c * C;
        __syncthreads();               // the previous chunk's readers are done
        load_tile(R, p.r, p.sr, bi, hi, t0, T, n);
        load_tile(K, p.k, p.sk, bi, hi, t0, T, n);
        load_tile(V, p.v, p.sv, bi, hi, t0, T, n);
        load_tile(W, p.w, p.sw, bi, hi, t0, T, n);
        load_tile(DO, p.dout, p.sd, bi, hi, t0, T, n);
        for (int e = tid; e < NP * NP; e += THREADS) {
            const int a = e / NP, m = e % NP;
            const float x = (a < n && m < n) ? scr[c * n * n + a * n + m] : 0.0f;
            S[a * RS + m] = x;
            STR[m * RS + a] = x;
        }
        __syncthreads();
        cumsum(LC, ET, W);
        __syncthreads();

        // r~, k~, k^; the bonus term, dO . v and the state term
        for (int e = tid; e < C * NP; e += THREADS) {
            const int t = e / NP, ch = e % NP;
            const float l = LC[t * RS + ch], tot = LC[(C - 1) * RS + ch];
            RT[t * RS + ch] = R[t * RS + ch] * expf(l - W[t * RS + ch]);
            KT[t * RS + ch] = K[t * RS + ch] * expf(-l);
            KS[t * RS + ch] = K[t * RS + ch] * expf(tot - l);
        }
        for (int t = warp; t < C; t += WARPS) {
            float d = 0.0f, dd = 0.0f;
            for (int ch = lane; ch < NP; ch += 32) {
                d = fmaf(R[t * RS + ch] * U[ch], K[t * RS + ch], d);
                dd = fmaf(DO[t * RS + ch], V[t * RS + ch], dd);
            }
            d = warp_sum(d);
            dd = warp_sum(dd);
            if (lane == 0) {
                DIAG[t] = d;
                DDIAG[t] = dd;
            }
        }
        for (int a = warp; a < NP; a += WARPS) {
            float x = 0.0f;
            for (int m = lane; m < NP; m += 32) x = fmaf(S[a * RS + m], DS[a * RS + m], x);
            x = warp_sum(x);
            if (lane == 0) STATE[a] = ET[a] * x;
        }
        __syncthreads();

        // A and dA (strictly lower), 4 entries of each a thread; du
        {
            const int t = tid / 8, i0 = 4 * (tid % 8);
            float av[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dav[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (i0 < t) {
                for (int q = 0; q < NP; q += 4) {
                    const float4 rt = ld4(RT + t * RS + q);
                    const float4 dd = ld4(DO + t * RS + q);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        av[e] = dot4(rt, ld4(KT + (i0 + e) * RS + q), av[e]);
                        dav[e] = dot4(dd, ld4(V + (i0 + e) * RS + q), dav[e]);
                    }
                }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool ok = i0 + e < t;
                A[t * AS + i0 + e] = ok ? av[e] : 0.0f;
                DA[t * AS + i0 + e] = ok ? dav[e] : 0.0f;
            }
        }
        for (int ch = tid; ch < NP; ch += THREADS) {
            float x = 0.0f;
            for (int t = 0; t < C; ++t)
                x = fmaf(DDIAG[t], R[t * RS + ch] * K[t * RS + ch], x);
            DU[ch] += x;
        }
        __syncthreads();

        // dv, dr~, dk~, dk^ (rows tr + 16 j, columns c4 .. c4 + 3); dr, dk
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int t = tr + 16 * j;
            const float4 dot = ld4(DO + t * RS + c4);
            const float dg = DIAG[t];
            float4 dv = make_float4(dg * dot.x, dg * dot.y, dg * dot.z, dg * dot.w);
            float4 drt = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            float4 dkt = drt, dks = drt;
            for (int i = t + 1; i < C; ++i) {
                dv = axpy(A[i * AS + t], ld4(DO + i * RS + c4), dv);
                dkt = axpy(DA[i * AS + t], ld4(RT + i * RS + c4), dkt);
            }
            for (int i = 0; i < t; ++i) drt = axpy(DA[t * AS + i], ld4(KT + i * RS + c4), drt);
            for (int a = 0; a < NP; ++a) {
                dv = axpy(KS[t * RS + a], ld4(DS + a * RS + c4), dv);
                drt = axpy(DO[t * RS + a], ld4(STR + a * RS + c4), drt);
                dks = axpy(V[t * RS + a], ld4(DST + a * RS + c4), dks);
            }
            const float x_drt[4] = {drt.x, drt.y, drt.z, drt.w};
            const float x_dkt[4] = {dkt.x, dkt.y, dkt.z, dkt.w};
            const float x_dks[4] = {dks.x, dks.y, dks.z, dks.w};
            const float x_dv[4] = {dv.x, dv.y, dv.z, dv.w};
            const float ddg = DDIAG[t];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int ch = c4 + e, o = t * RS + ch;
                const float l = LC[o], tot = LC[(C - 1) * RS + ch];
                GR[o] = x_drt[e] * RT[o];
                GK[o] = x_dkt[e] * KT[o];
                GS[o] = x_dks[e] * KS[o];
                const float dr = x_drt[e] * expf(l - W[o]) + ddg * U[ch] * K[o];
                const float dk = x_dkt[e] * expf(-l) + x_dks[e] * expf(tot - l)
                                 + ddg * U[ch] * R[o];
                store(p.dr, p.odr, bi, hi, t0 + t, ch, dr, T, n);
                store(p.dk, p.odk, bi, hi, t0 + t, ch, dk, T, n);
                store(p.dv, p.odv, bi, hi, t0 + t, ch, x_dv[e], T, n);
            }
        }
        __syncthreads();

        // dlog w, one thread a channel: suffix sums of dr~ r~ (exclusive)
        // and dk~ k~ (inclusive), prefix sums of dk^ k^ (exclusive)
        for (int ch = tid; ch < NP; ch += THREADS) {
            float pre[C];
            float x = 0.0f;
#pragma unroll
            for (int t = 0; t < C; ++t) {
                pre[t] = x;
                x += GS[t * RS + ch];
            }
            float suf_r = 0.0f, suf_k = 0.0f;
            const float st = STATE[ch];
#pragma unroll
            for (int t = C - 1; t >= 0; --t) {
                suf_k += GK[t * RS + ch];
                store(p.dw, p.odw, bi, hi, t0 + t, ch, suf_r - suf_k + pre[t] + st, T, n);
                suf_r += GR[t * RS + ch];
            }
        }
        // dS <- diag(e^Λ) dS + r~^T dO, into registers
        float4 acc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int a = tr + 16 * j;
            const float e = ET[a];
            const float4 d = ld4(DS + a * RS + c4);
            acc[j] = make_float4(d.x * e, d.y * e, d.z * e, d.w * e);
        }
        for (int t = 0; t < C; ++t) {
            const float4 dot = ld4(DO + t * RS + c4);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = axpy(RT[t * RS + tr + 16 * j], dot, acc[j]);
        }
        __syncthreads();               // every reader of DS and DST is done
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int a = tr + 16 * j;
            *reinterpret_cast<float4*>(DS + a * RS + c4) = acc[j];
            DST[(c4 + 0) * RS + a] = acc[j].x;
            DST[(c4 + 1) * RS + a] = acc[j].y;
            DST[(c4 + 2) * RS + a] = acc[j].z;
            DST[(c4 + 3) * RS + a] = acc[j].w;
        }
    }
    __syncthreads();

    for (int ch = tid; ch < n; ch += THREADS) p.du[lid * n + ch] = DU[ch];
    if (p.ds0)
        for (int e = tid; e < n * n; e += THREADS)
            p.ds0[lid * n * n + e] = DS[(e / n) * RS + e % n];
}

}  // namespace

// r, k, v, w (log decay), dout: [nb, nh, t, n] float32 views, element strides
// (batch, head, token) each, channels contiguous; dr, dk, dv, dw written
// through their own strides.  st: 29 strides, (batch, head, token) of r, k,
// v, w, dout, dr, dk, dv, dw in that order, then u's (batch, head).  u: n
// floats a lane; s0, ds (the final state's cotangent) and ds0: [nb*nh, n,
// n] contiguous or null; du: [nb*nh, n]; scratch: nb*nh*ceil(t/32)*n*n floats.
extern "C" int wkv_chunked_bwd(float* dr, float* dk, float* dv, float* dw,
                               float* du, float* ds0, const float* r,
                               const float* k, const float* v, const float* w,
                               const float* dout, const float* u,
                               const float* s0, const float* ds, float* scratch,
                               int nb, int nh, int t, int n,
                               const long long* st, void* stream) {
    if (n <= 0 || n > NP || nh <= 0 || t < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (nb <= 0) return static_cast<int>(cudaGetLastError());
    Args a{dr, dk, dv, dw, du, ds0, r, k, v, w, dout, u, s0, ds, scratch, nh, t, n,
           {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
           {st[9], st[10], st[11]}, {st[12], st[13], st[14]},
           {st[15], st[16], st[17]}, {st[18], st[19], st[20]},
           {st[21], st[22], st[23]}, {st[24], st[25], st[26]}, st[27], st[28]};
    const size_t smem = FLOATS * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long lanes = static_cast<long long>(nb) * nh;
    wkv_bwd_kernel<<<static_cast<unsigned>(lanes), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
