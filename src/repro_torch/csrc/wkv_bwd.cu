// K5b wkv_chunked_bwd: the backward of K5 (RWKV-6 WKV with data-dependent
// decay, in chunks of 32).  Per lane (batch x head), given the cotangents
// dO of o and dS_T of the final state, it returns dr, dk, dv, d(log w), the
// lane's du and dS0.  With L the inclusive cumsum of log w in a chunk, E =
// L - log w, Λ = L at the chunk's last step, r~ = r e^E, k~ = k e^-L, k^ =
// k e^(Λ-L), A = r~ k~^T strictly lower, S_c the chunk-start state and dS_c
// the cotangent of the chunk's end state:
//
//     dA  = (dO V^T) strictly lower      dv  = A^T dO + diag dO + k^ dS_c
//     dr~ = dA k~ + dO S_c^T             dk~ = dA^T r~        dk^ = V dS_c^T
//     dr  = dr~ e^E + (dO.v) u k         dk  = dk~ e^-L + dk^ e^(Λ-L) + (dO.v) u r
//     dlog_w_j = sum_{t>j} dr~ r~ - sum_{t>=j} dk~ k~ + sum_{t<j} dk^ k^
//                + e^Λ rowsum(S_c o dS_c)
//     du += sum_t (dO_t.v_t) r_t k_t
//     S_{c+1} = diag(e^Λ) S_c + k^^T v      dS_{c-1} = diag(e^Λ) dS_c + r~^T dO
//
// (diag_t = sum(r_t u k_t); kernels/wkv.py `wkv_chunked_bwd_plain` is the
// same algebra in the same three passes in torch, held to autograd and to
// the reference).
//
// Replaces no TPU kernel: the reference's rwkv6 model differentiates its jnp
// chunked WKV (repro/models/rwkv6.py `_wkv_chunked`) through XLA, and K5
// stands in for that function in the port; this is its gradient.
//
// What bounds it on Hopper: operations, narrowly.  Per chunk of C tokens a
// lane reads 5 C n floats and writes 4 C n, against 5 C(C-1)/2 n + 5 C n^2
// multiply-adds (A, dA, A^T dO, dA k~, dA^T r~, each strictly lower; k^ dS,
// dO S^T, V dS^T and the two sweeps' carries): at n = 64, C = 32 that is
// ~22 flops per byte of the tensors, just above the card's ~20 fp32 flops
// per byte.  The chunk-start states and end cotangents it writes and reads
// back add 16 n^2 bytes a chunk.
//
// Design (no atomics, every sum in a fixed order, so two calls give the same
// bits).  Only two of the products carry a dependence from chunk to chunk,
// the state S and the cotangent dS; given both at a chunk's edges,
// everything else is the chunk's own.  So three kernels:
// 1. `wkv_bwd_sweep`, 2 x lanes blocks of 256 threads: the first lanes
//    blocks walk their lane's chunks forward carrying S, the others walk
//    backward carrying dS, both at once; each writes the carried matrix at
//    every chunk edge to scratch the wrapper allocates ([lanes, ceil(T / 32),
//    n, n] float32 each, rows padded to a multiple of 4), and the backward
//    walk writes dS0.  The matrix lives in registers (a thread 4 rows x 4
//    columns); each chunk's 3 operand tiles arrive by `cp.async` into one of
//    two stages while the previous chunk is computed.
// 2. `wkv_bwd_chunk`, one block of 256 threads per (lane, chunk): 16,384
//    blocks at rwkv6-7b's [8, 1024, 64, 64].  Lane t of every warp owns
//    token t and warp w channels 8 w .. 8 w + 7 of each C x n output, so
//    every product reads its C x n operand rows as one float4 a lane (rows
//    n + 4 floats apart: a quarter warp hits 32 distinct banks) and its
//    n x n and C x C operand rows as warp-wide broadcasts: no transposed
//    copy is kept.  The exponentials a thread's outputs need stay in its
//    registers, and k^ overwrites log w in shared memory (~106 KB: two
//    blocks an SM).  dlog w's prefix and suffix sums over the
//    chunk's tokens are warp shuffle scans (fixed order); the chunk's du
//    partial is a warp sum, written to scratch.
// 3. `wkv_bwd_du`: the du partials added over the chunks in order.
// The cumsum of log w runs one thread a channel in token order in both
// kernels, as in K5 and the plain version, so L is bit-equal across them (a
// shuffle scan moved K5's outputs by 2e-4 through exponents of +-80); exp is
// the accurate expf.  Float32 FMA on the CUDA cores (a TF32 product breaks
// K5's 1e-4 tolerance).  Channels past n and steps past T are zero-filled,
// so a ragged T needs no padded copy and the padded steps add nothing.
// `tools/k4b_k5b_variants.py` times this design against the one-block-a-lane
// design it replaced, and the sweeps launched apart (K5B_SWEEPS_APART).
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int C = 32;          // chunk length = warp size
constexpr int NP = 64;         // largest head size (channels are padded to it)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = NP / WARPS;   // channels a warp owns in the chunk pass
constexpr int RS = NP + 4;     // row stride of the C x n and n x n tiles
constexpr int AS = C + 4;      // row stride of A and dA
constexpr int CT = C * RS;     // floats of a C x n tile
constexpr int ST = NP * RS;    // floats of an n x n tile
// sweep: two stages of 3 C x n tiles, L, e^Λ
constexpr int SWEEP_FLOATS = 7 * CT + NP;
// chunk pass: r, k, log w, v, dO, r~, k~, S, dS, L (then A and dA), u, e^Λ,
// the state term, the two diagonal terms
constexpr int CHUNK_FLOATS = 7 * CT + 2 * ST + 2 * C * AS + 3 * NP + 2 * C;
static_assert(CT <= 2 * C * AS, "L shares A and dA's space");

#ifndef K5B_SWEEPS_APART       // 1: the two sweeps as two launches in turn
#define K5B_SWEEPS_APART 0
#endif

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
    float* states;             // [lanes, nc, n, n4] chunk-start states
    float* cots;               // [lanes, nc, n, n4] chunk-end cotangents
    float* dup;                // [lanes, nc, NP] du partials
    int nh, t_len, n, n4, nc;
    bool vec;                  // 16-byte copies (aligned, n % 4 == 0)
    Lanes sr, sk, sv, sw, sd, odr, odk, odv, odw;
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

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ float get(float4 x, int i) {
    return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// one chunk of a [T, n] operand of this lane into dst [C][RS] by cp.async,
// zeros past T and n
__device__ void load_tile(float* dst, const float* src, const Lanes& s,
                          long long bi, long long hi, int t0, int T, int n,
                          bool vec) {
    const float* base = src + bi * s.b + hi * s.h;
    if (vec) {
        for (int e = threadIdx.x; e < C * (NP / 4); e += THREADS) {
            const int t = e / (NP / 4), q = 4 * (e % (NP / 4));
            const bool ok = t0 + t < T && q < n;
            cp16(dst + t * RS + q, ok ? base + (t0 + t) * s.t + q : base, ok);
        }
    } else {
        for (int e = threadIdx.x; e < C * NP; e += THREADS) {
            const int t = e / NP, q = e % NP;
            const bool ok = t0 + t < T && q < n;
            cp4(dst + t * RS + q, ok ? base + (t0 + t) * s.t + q : base, ok);
        }
    }
}

// an n x n4 matrix of scratch into dst [NP][RS] by cp.async, zeros past it
__device__ void load_square(float* dst, const float* src, int n, int n4) {
    for (int e = threadIdx.x; e < NP * (NP / 4); e += THREADS) {
        const int a = e / (NP / 4), q = 4 * (e % (NP / 4));
        const bool ok = a < n && q < n4;
        cp16(dst + a * RS + q, ok ? src + a * n4 + q : src, ok);
    }
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

// x at token t, channels ch .. ch + 7 of a [T, n] output of this lane
__device__ __forceinline__ void store8(float* dst, const Lanes& s, long long bi,
                                      long long hi, int t, int ch, const float* x,
                                      int T, int n, bool vec) {
    if (t >= T) return;
    float* row = dst + bi * s.b + hi * s.h + t * s.t;
    if (vec) {
        if (ch < n) st4(row + ch, make_float4(x[0], x[1], x[2], x[3]));
        if (ch + 4 < n) st4(row + ch + 4, make_float4(x[4], x[5], x[6], x[7]));
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
            if (ch + e < n) row[ch + e] = x[e];
    }
}

// ---------------------------------------------------------------------------
// 1. the two sweeps: chunk-start states forward, chunk-end cotangents backward
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 2) wkv_bwd_sweep(const Args p, int lane0,
                                                            int lanes) {
    extern __shared__ __align__(16) float sm[];
    float* LC = sm + 6 * CT;       // [C][RS] L
    float* ET = LC + CT;           // [NP]    e^Λ
    const int blk = lane0 + static_cast<int>(blockIdx.x);
    // the state sweep carries S forward with x = k (times e^(Λ-L)), y = v;
    // the cotangent sweep carries dS backward with x = r (times e^E), y = dO
    const bool cot = blk >= lanes;
    const long long lid = cot ? blk - lanes : blk;
    const long long bi = lid / p.nh, hi = lid % p.nh;
    const int n = p.n, n4 = p.n4, T = p.t_len, nc = p.nc;
    const float* xsrc = cot ? p.r : p.k;
    const float* ysrc = cot ? p.dout : p.v;
    const Lanes xst = cot ? p.sr : p.sk;
    const Lanes yst = cot ? p.sd : p.sv;
    float* out = (cot ? p.cots : p.states) + lid * nc * n * n4;
    const int tid = threadIdx.x, tr = tid / 16, c4 = 4 * (tid % 16);

    auto issue = [&](int i) {      // the walk's i-th chunk into stage i & 1
        const int c = cot ? nc - 1 - i : i;
        float* stage = sm + (i & 1) * 3 * CT;
        load_tile(stage, xsrc, xst, bi, hi, c * C, T, n, p.vec);
        load_tile(stage + CT, ysrc, yst, bi, hi, c * C, T, n, p.vec);
        load_tile(stage + 2 * CT, p.w, p.sw, bi, hi, c * C, T, n, p.vec);
        cp_commit();
    };
    if (nc > 0) issue(0);

    // the carried matrix: rows tr + 16 j, columns c4 .. c4 + 3
    const float* init = cot ? p.ds : p.s0;
    if (init) init += lid * n * n;
    float4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int a = tr + 16 * j;
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            e[i] = (init && a < n && c4 + i < n) ? init[a * n + c4 + i] : 0.0f;
        x[j] = make_float4(e[0], e[1], e[2], e[3]);
    }

    for (int i = 0; i < nc; ++i) {
        const int c = cot ? nc - 1 - i : i;
        cp_wait_all();
        __syncthreads();           // chunk i landed; chunk i - 1's readers done
        if (i + 1 < nc) issue(i + 1);
        float* X = sm + (i & 1) * 3 * CT;
        const float* Y = X + CT;
        const float* W = X + 2 * CT;
        float* o = out + static_cast<long long>(c) * n * n4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int a = tr + 16 * j;
            if (a < n && c4 < n4) st4(o + a * n4 + c4, x[j]);
        }
        cumsum(LC, ET, W);
        __syncthreads();
        for (int e = tid; e < C * NP; e += THREADS) {
            const int t = e / NP, ch = e % NP, q = t * RS + ch;
            const float l = LC[q];
            X[q] *= cot ? expf(l - W[q]) : expf(LC[(C - 1) * RS + ch] - l);
        }
        __syncthreads();
        // x <- diag(e^Λ) x + X^T Y
        float4 acc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float e = ET[tr + 16 * j];
            acc[j] = make_float4(x[j].x * e, x[j].y * e, x[j].z * e, x[j].w * e);
        }
#pragma unroll 4
        for (int t = 0; t < C; ++t) {
            const float4 yt = ld4(Y + t * RS + c4);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = axpy(X[t * RS + tr + 16 * j], yt, acc[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = acc[j];
    }

    if (cot && p.ds0) {
        float* d0 = p.ds0 + lid * n * n;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int a = tr + 16 * j;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (a < n && c4 + i < n) d0[a * n + c4 + i] = get(x[j], i);
        }
    }
}

// ---------------------------------------------------------------------------
// 2. one chunk of one lane, from its start state and end cotangent
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 2) wkv_bwd_chunk(const Args p) {
    extern __shared__ __align__(16) float sm[];
    float* R = sm;                 // r
    float* K = R + CT;             // k
    float* W = K + CT;             // log w, then k^ = k e^(Λ-L)
    float* V = W + CT;             // v
    float* DO = V + CT;            // dO
    float* RT = DO + CT;           // r~ = r e^E
    float* KT = RT + CT;           // k~ = k e^-L
    float* S = KT + CT;            // [NP][RS] chunk-start state
    float* DS = S + ST;            // [NP][RS] chunk-end cotangent
    float* LC = DS + ST;           // [C][RS] L, until r~, k~, k^ are formed
    float* A = LC;                 // [C][AS] A (strictly lower), afterwards
    float* DA = A + C * AS;        // [C][AS] dA (strictly lower)
    float* U = DA + C * AS;        // [NP] bonus u
    float* ET = U + NP;            // [NP] e^Λ
    float* STATE = ET + NP;        // [NP] rowsum(S o dS)
    float* DIAG = STATE + NP;      // [C] sum(r u k)
    float* DDIAG = DIAG + C;       // [C] dO . v

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = p.n, n4 = p.n4, T = p.t_len, nc = p.nc;
    const long long lid = blockIdx.x / nc;
    const int c = static_cast<int>(blockIdx.x % nc), t0 = c * C;
    const long long bi = lid / p.nh, hi = lid % p.nh;
    const long long sq = (lid * nc + c) * n * n4;

    load_tile(R, p.r, p.sr, bi, hi, t0, T, n, p.vec);
    load_tile(K, p.k, p.sk, bi, hi, t0, T, n, p.vec);
    load_tile(W, p.w, p.sw, bi, hi, t0, T, n, p.vec);
    load_tile(V, p.v, p.sv, bi, hi, t0, T, n, p.vec);
    load_tile(DO, p.dout, p.sd, bi, hi, t0, T, n, p.vec);
    load_square(S, p.states + sq, n, n4);
    load_square(DS, p.cots + sq, n, n4);
    cp_commit();
    const float* ul = p.u + bi * p.su_b + hi * p.su_h;
    for (int ch = tid; ch < NP; ch += THREADS) U[ch] = ch < n ? ul[ch] : 0.0f;
    cp_wait_all();
    __syncthreads();

    // L and e^Λ (warps 0-1); sum(r u k), dO . v (warps 2, 3, lane = token);
    // rowsum(S o dS) (warps 4-7, 16 rows each)
    if (warp < 2) {
        cumsum(LC, ET, W);
    } else if (warp < 4) {
        const float* a = warp == 2 ? R : DO;
        const float* b = warp == 2 ? K : V;
        float x = 0.0f;
#pragma unroll 4
        for (int q = 0; q < NP; q += 4) {
            const float4 av = ld4(a + lane * RS + q), bv = ld4(b + lane * RS + q);
            if (warp == 2) {
                const float4 uv = ld4(U + q);
                x = fmaf(av.x * uv.x, bv.x, x);
                x = fmaf(av.y * uv.y, bv.y, x);
                x = fmaf(av.z * uv.z, bv.z, x);
                x = fmaf(av.w * uv.w, bv.w, x);
            } else {
                x = dot4(av, bv, x);
            }
        }
        (warp == 2 ? DIAG : DDIAG)[lane] = x;
    } else {
        for (int a = (warp - 4) * 16; a < (warp - 3) * 16; ++a) {
            const float x = fmaf(S[a * RS + lane], DS[a * RS + lane],
                                 S[a * RS + lane + 32] * DS[a * RS + lane + 32]);
            const float s = warp_sum(x);
            if (lane == 0) STATE[a] = s;
        }
    }
    __syncthreads();

    // this thread's outputs: token t = lane, channels c0 .. c0 + 7.  Their
    // exponentials stay in registers; k^ replaces log w; the chunk's du
    // partial by warp sums
    const int t = lane, c0 = COLS * warp;
    float er[COLS], ek[COLS], es[COLS];
    {
        const float ddg = DDIAG[t];
#pragma unroll
        for (int h = 0; h < COLS; h += 4) {
            const int q = t * RS + c0 + h;
            const float4 l = ld4(LC + q), lw = ld4(W + q), tot = ld4(LC + (C - 1) * RS + c0 + h);
            const float4 r4 = ld4(R + q), k4 = ld4(K + q);
            float rt[4], kt[4], ks[4], rk[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float le = get(l, e);
                er[h + e] = expf(le - get(lw, e));
                ek[h + e] = expf(-le);
                es[h + e] = expf(get(tot, e) - le);
                rt[e] = get(r4, e) * er[h + e];
                kt[e] = get(k4, e) * ek[h + e];
                ks[e] = get(k4, e) * es[h + e];
                rk[e] = get(r4, e) * get(k4, e);
            }
            st4(RT + q, make_float4(rt[0], rt[1], rt[2], rt[3]));
            st4(KT + q, make_float4(kt[0], kt[1], kt[2], kt[3]));
            st4(W + q, make_float4(ks[0], ks[1], ks[2], ks[3]));
            float* dup = p.dup + (lid * nc + c) * NP + c0 + h;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float s = warp_sum(ddg * rk[e]);
                if (lane == 0) dup[e] = s;
            }
        }
    }
    __syncthreads();               // r~, k~, k^ formed; L is no longer read

    // A = r~ k~^T and dA = dO V^T, strictly lower: lane t, columns 4 w .. 4 w
    // + 3; and the three n x n products into registers
    float dv[COLS], drt[COLS], dks[COLS], dkt[COLS];
#pragma unroll
    for (int e = 0; e < COLS; ++e) {
        dv[e] = 0.0f;
        drt[e] = 0.0f;
        dks[e] = 0.0f;
        dkt[e] = 0.0f;
    }
    {
        const int i0 = 4 * warp;
        float a4[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
        for (int q = 0; q < NP; q += 4) {
            const float4 rt = ld4(RT + t * RS + q), dd = ld4(DO + t * RS + q);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                a4[j] = dot4(rt, ld4(KT + (i0 + j) * RS + q), a4[j]);
                d4[j] = dot4(dd, ld4(V + (i0 + j) * RS + q), d4[j]);
            }
        }
        st4(A + t * AS + i0, make_float4(i0 < t ? a4[0] : 0.0f, i0 + 1 < t ? a4[1] : 0.0f,
                                         i0 + 2 < t ? a4[2] : 0.0f, i0 + 3 < t ? a4[3] : 0.0f));
        st4(DA + t * AS + i0, make_float4(i0 < t ? d4[0] : 0.0f, i0 + 1 < t ? d4[1] : 0.0f,
                                          i0 + 2 < t ? d4[2] : 0.0f, i0 + 3 < t ? d4[3] : 0.0f));
    }
    // dv += k^ dS (over the state's rows a), dr~ += dO S^T and dk^ = V dS^T
    // (over its columns m), one product a loop
#pragma unroll 1
    for (int q = 0; q < NP; q += 4) {
        const float4 ks4 = ld4(W + t * RS + q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float kv = get(ks4, j);
            const float4 lo = ld4(DS + (q + j) * RS + c0);
            const float4 hi4 = ld4(DS + (q + j) * RS + c0 + 4);
            dv[0] = fmaf(kv, lo.x, dv[0]);
            dv[1] = fmaf(kv, lo.y, dv[1]);
            dv[2] = fmaf(kv, lo.z, dv[2]);
            dv[3] = fmaf(kv, lo.w, dv[3]);
            dv[4] = fmaf(kv, hi4.x, dv[4]);
            dv[5] = fmaf(kv, hi4.y, dv[5]);
            dv[6] = fmaf(kv, hi4.z, dv[6]);
            dv[7] = fmaf(kv, hi4.w, dv[7]);
        }
    }
#pragma unroll 1
    for (int q = 0; q < NP; q += 4) {
        const float4 do4 = ld4(DO + t * RS + q);
#pragma unroll
        for (int e = 0; e < COLS; ++e) drt[e] = dot4(do4, ld4(S + (c0 + e) * RS + q), drt[e]);
    }
#pragma unroll 1
    for (int q = 0; q < NP; q += 4) {
        const float4 v4 = ld4(V + t * RS + q);
#pragma unroll
        for (int e = 0; e < COLS; ++e) dks[e] = dot4(v4, ld4(DS + (c0 + e) * RS + q), dks[e]);
    }
    __syncthreads();               // A and dA formed

    // dv += A^T dO, dk~ = dA^T r~ (over rows i > t), dr~ += dA k~ (i < t);
    // the zeros of the strict triangles keep every lane on one loop
#pragma unroll 1
    for (int i = 0; i < C; ++i) {
        const float ait = A[i * AS + t], dait = DA[i * AS + t];
        const float4 dlo = ld4(DO + i * RS + c0), dhi = ld4(DO + i * RS + c0 + 4);
        const float4 rlo = ld4(RT + i * RS + c0), rhi = ld4(RT + i * RS + c0 + 4);
        const float dov[8] = {dlo.x, dlo.y, dlo.z, dlo.w, dhi.x, dhi.y, dhi.z, dhi.w};
        const float rtv[8] = {rlo.x, rlo.y, rlo.z, rlo.w, rhi.x, rhi.y, rhi.z, rhi.w};
#pragma unroll
        for (int e = 0; e < COLS; ++e) {
            dv[e] = fmaf(ait, dov[e], dv[e]);
            dkt[e] = fmaf(dait, rtv[e], dkt[e]);
        }
    }
#pragma unroll 1
    for (int i = 0; i < C; i += 4) {
        const float4 da4 = ld4(DA + t * AS + i);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float dv_ = get(da4, j);
            const float4 lo = ld4(KT + (i + j) * RS + c0), hi4 = ld4(KT + (i + j) * RS + c0 + 4);
            drt[0] = fmaf(dv_, lo.x, drt[0]);
            drt[1] = fmaf(dv_, lo.y, drt[1]);
            drt[2] = fmaf(dv_, lo.z, drt[2]);
            drt[3] = fmaf(dv_, lo.w, drt[3]);
            drt[4] = fmaf(dv_, hi4.x, drt[4]);
            drt[5] = fmaf(dv_, hi4.y, drt[5]);
            drt[6] = fmaf(dv_, hi4.z, drt[6]);
            drt[7] = fmaf(dv_, hi4.w, drt[7]);
        }
    }

    // dlog w from a suffix scan of dr~ r~ - dk~ k~ (exclusive) and a prefix
    // scan of dk^ k^ (exclusive) over the warp's tokens; then dr, dk, dv
    float o[COLS];
#pragma unroll
    for (int e = 0; e < COLS; ++e) {
        const int q = t * RS + c0 + e;
        const float gk = dkt[e] * KT[q];
        const float y = drt[e] * RT[q] - gk;
        float suf = y, pre = dks[e] * W[q];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float s_ = __shfl_down_sync(0xffffffffu, suf, off);
            const float p_ = __shfl_up_sync(0xffffffffu, pre, off);
            if (lane + off < 32) suf += s_;
            if (lane >= off) pre += p_;
        }
        float suf_x = __shfl_down_sync(0xffffffffu, suf, 1);
        float pre_x = __shfl_up_sync(0xffffffffu, pre, 1);
        if (lane == 31) suf_x = 0.0f;
        if (lane == 0) pre_x = 0.0f;
        o[e] = suf_x - gk + pre_x + ET[c0 + e] * STATE[c0 + e];
    }
    store8(p.dw, p.odw, bi, hi, t0 + t, c0, o, T, n, p.vec);
    const float ddg = DDIAG[t];
#pragma unroll
    for (int e = 0; e < COLS; ++e)
        o[e] = fmaf(drt[e], er[e], ddg * U[c0 + e] * K[t * RS + c0 + e]);
    store8(p.dr, p.odr, bi, hi, t0 + t, c0, o, T, n, p.vec);
#pragma unroll
    for (int e = 0; e < COLS; ++e)
        o[e] = fmaf(dkt[e], ek[e],
                    fmaf(dks[e], es[e], ddg * U[c0 + e] * R[t * RS + c0 + e]));
    store8(p.dk, p.odk, bi, hi, t0 + t, c0, o, T, n, p.vec);
    const float dg = DIAG[t];
#pragma unroll
    for (int e = 0; e < COLS; ++e) o[e] = fmaf(dg, DO[t * RS + c0 + e], dv[e]);
    store8(p.dv, p.odv, bi, hi, t0 + t, c0, o, T, n, p.vec);
}

// ---------------------------------------------------------------------------
// 3. du: the chunks' partials in chunk order
// ---------------------------------------------------------------------------
__global__ void wkv_bwd_du(const Args p) {
    const long long lid = blockIdx.x;
    const int ch = threadIdx.x;
    if (ch >= p.n) return;
    float x = 0.0f;
    for (int c = 0; c < p.nc; ++c) x += p.dup[(lid * p.nc + c) * NP + ch];
    p.du[lid * p.n + ch] = x;
}

template <typename K>
cudaError_t allow(K kernel, int smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
}

bool aligned(const void* ptr) {
    return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// r, k, v, w (log decay), dout: [nb, nh, t, n] float32 views, element strides
// (batch, head, token) each, channels contiguous; dr, dk, dv, dw written
// through their own strides.  st: 29 strides, (batch, head, token) of r, k,
// v, w, dout, dr, dk, dv, dw in that order, then u's (batch, head).  u: n
// floats a lane; s0, ds (the final state's cotangent) and ds0: [nb*nh, n,
// n] contiguous or null; du: [nb*nh, n]; scratch: nb*nh*ceil(t/32)*(2*n*n4
// + 64) floats, n4 = n rounded up to a multiple of 4, 16-byte aligned.
extern "C" int wkv_chunked_bwd(float* dr, float* dk, float* dv, float* dw,
                               float* du, float* ds0, const float* r,
                               const float* k, const float* v, const float* w,
                               const float* dout, const float* u,
                               const float* s0, const float* ds, float* scratch,
                               int nb, int nh, int t, int n,
                               const long long* st, void* stream) {
    if (n <= 0 || n > NP || nh <= 0 || t < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (nb <= 0) return static_cast<int>(cudaGetLastError());
    const long long lanes = static_cast<long long>(nb) * nh;
    const int nc = (t + C - 1) / C, n4 = (n + 3) / 4 * 4;
    if (2 * lanes > 0x7fffffffLL || lanes * nc > 0x7fffffffLL || !aligned(scratch))
        return static_cast<int>(cudaErrorInvalidValue);
    float* states = scratch;
    float* cots = states + lanes * nc * n * n4;
    float* dup = cots + lanes * nc * n * n4;
    Args a{dr, dk, dv, dw, du, ds0, r, k, v, w, dout, u, s0, ds, states, cots, dup,
           nh, t, n, n4, nc, false,
           {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
           {st[9], st[10], st[11]}, {st[12], st[13], st[14]},
           {st[15], st[16], st[17]}, {st[18], st[19], st[20]},
           {st[21], st[22], st[23]}, {st[24], st[25], st[26]}, st[27], st[28]};
    bool vec = n % 4 == 0;
    for (const void* ptr : {static_cast<const void*>(r), static_cast<const void*>(k),
                            static_cast<const void*>(v), static_cast<const void*>(w),
                            static_cast<const void*>(dout), static_cast<const void*>(dr),
                            static_cast<const void*>(dk), static_cast<const void*>(dv),
                            static_cast<const void*>(dw)})
        vec = vec && aligned(ptr);
    for (int i = 0; i < 27; ++i) vec = vec && st[i] % 4 == 0;
    a.vec = vec;
    const cudaStream_t cs = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    const int s_sweep = SWEEP_FLOATS * static_cast<int>(sizeof(float));
    const int s_chunk = CHUNK_FLOATS * static_cast<int>(sizeof(float));
    if ((err = allow(wkv_bwd_sweep, s_sweep)) != cudaSuccess) return static_cast<int>(err);
    if ((err = allow(wkv_bwd_chunk, s_chunk)) != cudaSuccess) return static_cast<int>(err);
    const int L = static_cast<int>(lanes);
    if (K5B_SWEEPS_APART) {
        wkv_bwd_sweep<<<L, THREADS, s_sweep, cs>>>(a, 0, L);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
        wkv_bwd_sweep<<<L, THREADS, s_sweep, cs>>>(a, L, L);
    } else {
        wkv_bwd_sweep<<<2 * L, THREADS, s_sweep, cs>>>(a, 0, L);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (nc > 0) {
        wkv_bwd_chunk<<<static_cast<unsigned>(lanes * nc), THREADS, s_chunk, cs>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    wkv_bwd_du<<<L, NP, 0, cs>>>(a);
    return static_cast<int>(cudaGetLastError());
}
