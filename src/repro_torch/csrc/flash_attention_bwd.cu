// K4b flash_attention_bwd: the backward of K4 (grouped-query attention with
// an online softmax), by the FlashAttention-2 algebra:
//
//     P_ij = exp(scale * q_i . k_j - lse_i)   over the keys row i sees
//     D_i  = dO_i . O_i
//     dV_j = sum_i P_ij dO_i        dP_ij = dO_i . V_j
//     dS_ij = P_ij (dP_ij - D_i)
//     dQ_i = scale sum_j dS_ij K_j  dK_j = scale sum_i dS_ij Q_i
//
// with the rows i = (query position, query head of the group) flattened as
// i * g + h, so dK and dV of a KV head sum over its g query heads.  The
// visibility rule is K4's: key j is seen by query position i iff j <
// lk_valid, j <= i + (lk_valid - Lq) if causal, and j > i + (lk_valid - Lq)
// - window if window > 0.  A row that sees no key, and a key no row sees,
// gets zeros.  This is route "f32": inputs, math and outputs are float32.
// bf16 takes route "mma" (flash_attention_bwd_mma.cu).
//
// Replaces no TPU kernel: the reference's models differentiate their jnp
// blockwise attention (repro/models/layers.py `attention`, `_attention_banded`
// for the window) through XLA, and K4 stands in for that function in the
// port; this is its gradient.
//
// What bounds it on Hopper: operations.  Per visible (row, key) pair and
// head the algebra is 10 D flops (S, dP, dV, dK, dQ) against q, k, v, o, dO,
// dq, dk and dv read or written once, far above the card's flops per byte;
// this design recomputes S in all three passes (16 D flops a pair) and runs
// on the CUDA cores in float32 FMA, so its floor is ~1/15 of the tensor-core
// bound (a wgmma/TMA redesign is later work).
//
// Design (simple and right first; no atomics, every sum in a fixed order):
//   1. `bwd_lse`: one block per (batch, KV head, 64 rows), as K4's route
//      "f32": the rows' scores against each key tile of the band by 4 x 4
//      FMA micro-tiles, the running max and sum by half-warp shuffles, then
//      lse = m + log(l) and D = dO . O written to float32 scratch.
//   2. `bwd_dkv`: one block per (batch, KV head, BK keys) holding the key
//      tile's dK and dV in registers (BK x D over 256 threads); it walks the
//      rows of the band in tiles of 64, in order (query position, then group
//      head), recomputing S and dP per tile, writing P and dS to shared
//      memory and accumulating dV += P^T dO and dK += dS^T Q.
//   3. `bwd_dq`: one block per (batch, KV head, 64 rows) holding dQ in
//      registers; it walks the key tiles of the band, recomputing S and dP
//      and accumulating dQ += dS K.
// Every operand tile is staged in shared memory with rows padded by one
// float (Q, dO, K, V at pitch D + 1), so the micro-tile loads are free of
// bank conflicts.  BK = 64 keys for head dims up to 128 and 32
// at D = 256, which keeps the register accumulators at 64 a thread and the
// shared memory under 215 KB.  A local window bounds both walks to the band.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;      // (query position, group head) rows per tile
constexpr int THREADS = 256;
constexpr int DMAX = 256;
constexpr float NEG = -1.0e30f;

template <int DM>
struct Cfg {
    static constexpr int BK = DM > 128 ? 32 : 64;   // keys per tile
    static constexpr int QP = DM + 1;               // pitch of operand rows
    static constexpr int SC = BK / 16;              // score columns a thread
    static constexpr int DC = DM / 16;              // head dims a thread
};

struct Geo {                  // one (batch, KV head)'s problem
    int lq, lk, lk_valid, g, d, causal, window;
    float scale;
};

struct Strides {              // element strides (batch, row, head) of each
    long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

// stage rows r0 .. r0 + ROWS - 1 of a query-side tensor (q, o or dO) of KV
// head hkv into dst [ROWS][QP], zeros past nrows or d
template <int DM>
__device__ void stage_rows(float* dst, const float* src, const long long* st,
                           long long b, int hkv, int r0, int nrows,
                           const Geo& geo) {
    constexpr int QP = Cfg<DM>::QP;
    for (int e = threadIdx.x; e < ROWS * DM; e += THREADS) {
        const int r = e / DM, dd = e % DM;
        const int gr = r0 + r;
        float x = 0.0f;
        if (gr < nrows && dd < geo.d) {
            const int i = gr / geo.g, h = hkv * geo.g + gr % geo.g;
            x = src[b * st[0] + i * st[1] + h * st[2] + dd];
        }
        dst[r * QP + dd] = x;
    }
}

// stage keys k0 .. k0 + BK - 1 of K (and V) into [BK][QP], zeros from kend
template <int DM>
__device__ void stage_keys(float* dst, const float* src, const long long* st,
                           long long b, int hkv, int k0, int kend,
                           const Geo& geo) {
    constexpr int QP = Cfg<DM>::QP, BK = Cfg<DM>::BK;
    for (int e = threadIdx.x; e < BK * DM; e += THREADS) {
        const int j = e / DM, dd = e % DM;
        const int gj = k0 + j;
        float x = 0.0f;
        if (gj < kend && dd < geo.d) x = src[b * st[0] + gj * st[1] + hkv * st[2] + dd];
        dst[j * QP + dd] = x;
    }
}

__device__ __forceinline__ bool visible(int kp, int qpos, const Geo& geo) {
    return kp < geo.lk_valid && (!geo.causal || kp <= qpos)
           && (geo.window <= 0 || kp > qpos - geo.window);
}

// s[i][j] = sum_d a[4 ty + i][d] b[tx + 16 j][d] over [ROWS][QP] x [BK][QP]
template <int DM>
__device__ __forceinline__ void micro(float (&s)[4][Cfg<DM>::SC], const float* a,
                                      const float* bt, int ty, int tx) {
    constexpr int QP = Cfg<DM>::QP, SC = Cfg<DM>::SC;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < DM; ++dd) {
        float av[4], bv[SC];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a[(4 * ty + i) * QP + dd];
#pragma unroll
        for (int j = 0; j < SC; ++j) bv[j] = bt[(tx + 16 * j) * QP + dd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < SC; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
}

// the key tiles [t0, t1) the rows r_lo .. r_hi - 1 of a block see
__device__ __forceinline__ void key_band(int r_lo, int r_hi, const Geo& geo,
                                         int bk, int& t0, int& t1, int& kend) {
    const int off = geo.lk_valid - geo.lq;
    kend = geo.lk_valid;
    if (geo.causal) kend = min(kend, (r_hi - 1) / geo.g + off + 1);
    t1 = kend > 0 ? (kend + bk - 1) / bk : 0;
    t0 = geo.window > 0 ? max(0, r_lo / geo.g + off - geo.window + 1) / bk : 0;
}

// ---------------------------------------------------------------------------
// 1. each row's log-sum-exp and D = dO . O
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(THREADS)
bwd_lse(float* lse, float* dsum, const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ o, const float* __restrict__ dout, Geo geo, Strides st) {
    using CF = Cfg<DM>;
    constexpr int QP = CF::QP, BK = CF::BK, SC = CF::SC, DC = CF::DC;
    extern __shared__ float smem[];
    float* qs = smem;                 // [ROWS][QP]
    float* ks = qs + ROWS * QP;       // [BK][QP]
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int hkv = blockIdx.y;
    const long long b = blockIdx.z;
    const int nrows = geo.lq * geo.g, r0 = blockIdx.x * ROWS;
    const int off = geo.lk_valid - geo.lq;
    const long long rowbase = (b * gridDim.y + hkv) * (long long)nrows;

    stage_rows<DM>(qs, q, st.q, b, hkv, r0, nrows, geo);

    // D of the thread's rows: 16 threads of a half-warp share a row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gr = r0 + 4 * ty + i;
        float part = 0.0f;
        if (gr < nrows) {
            const int qi = gr / geo.g, h = hkv * geo.g + gr % geo.g;
            const float* orow = o + b * st.o[0] + qi * st.o[1] + h * st.o[2];
            const float* drow = dout + b * st.dout[0] + qi * st.dout[1] + h * st.dout[2];
#pragma unroll
            for (int j = 0; j < DC; ++j) {
                const int dd = tx + 16 * j;
                if (dd < geo.d) part = fmaf(drow[dd], orow[dd], part);
            }
        }
#pragma unroll
        for (int sh = 8; sh > 0; sh >>= 1) part += __shfl_xor_sync(0xffffffffu, part, sh);
        if (gr < nrows && tx == 0) dsum[rowbase + gr] = part;
    }

    int qpos[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qpos[i] = (r0 + 4 * ty + i) / geo.g + off;
    const int r_hi = min(r0 + ROWS, nrows);
    int t0, t1, kend;
    key_band(r0, r_hi, geo, BK, t0, t1, kend);
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) { m[i] = NEG; l[i] = 0.0f; }

    for (int kt = t0; kt < t1; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();
        stage_keys<DM>(ks, k, st.k, b, hkv, k0, kend, geo);
        __syncthreads();
        float s[4][SC];
        micro<DM>(s, qs, ks, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = NEG;
            bool ok[SC];
#pragma unroll
            for (int j = 0; j < SC; ++j) {
                ok[j] = r0 + 4 * ty + i < nrows && visible(k0 + tx + 16 * j, qpos[i], geo);
                s[i][j] = ok[j] ? s[i][j] * geo.scale : NEG;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int sh = 8; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < SC; ++j) sum += ok[j] ? expf(s[i][j] - m_new) : 0.0f;
#pragma unroll
            for (int sh = 8; sh > 0; sh >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
            l[i] = l[i] * expf(m[i] - m_new) + sum;
            m[i] = m_new;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gr = r0 + 4 * ty + i;
        if (gr < nrows && tx == 0) lse[rowbase + gr] = l[i] > 0.0f ? m[i] + logf(l[i]) : 0.0f;
    }
}

// ---------------------------------------------------------------------------
// shared by passes 2 and 3: P and dS of a (64-row, BK-key) tile pair
// ---------------------------------------------------------------------------
template <int DM>
__device__ __forceinline__ void p_ds(float (&p)[4][Cfg<DM>::SC], float (&ds)[4][Cfg<DM>::SC],
                                     const float* qs, const float* dos, const float* ks,
                                     const float* vs, const float* lse_s, const float* d_s,
                                     int r0, int nrows, int k0, const Geo& geo,
                                     int ty, int tx) {
    constexpr int SC = Cfg<DM>::SC;
    const int off = geo.lk_valid - geo.lq;
    float dp[4][SC];
    micro<DM>(p, qs, ks, ty, tx);
    micro<DM>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
        const int qpos = (r0 + r) / geo.g + off;
        const bool row_ok = r0 + r < nrows;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
            const bool ok = row_ok && visible(k0 + tx + 16 * j, qpos, geo);
            p[i][j] = ok ? expf(p[i][j] * geo.scale - lse_s[r]) : 0.0f;
            ds[i][j] = p[i][j] * (dp[i][j] - d_s[r]);
        }
    }
}

// ---------------------------------------------------------------------------
// 2. dK and dV of a key tile, over the rows of its band
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(THREADS)
bwd_dkv(float* dk, float* dv, const float* __restrict__ lse, const float* __restrict__ dsum,
        const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        const float* __restrict__ dout, Geo geo, Strides st) {
    using CF = Cfg<DM>;
    constexpr int QP = CF::QP, BK = CF::BK, SC = CF::SC, DC = CF::DC;
    constexpr int KPT = BK / 16;      // keys a thread accumulates
    constexpr int BP = BK + 1;        // pitch of the P and dS tiles
    extern __shared__ float smem[];
    float* ks = smem;                 // [BK][QP]
    float* vs = ks + BK * QP;         // [BK][QP]
    float* qs = vs + BK * QP;         // [ROWS][QP]
    float* dos = qs + ROWS * QP;      // [ROWS][QP]
    float* ps = dos + ROWS * QP;      // [ROWS][BP]
    float* dss = ps + ROWS * BP;      // [ROWS][BP]
    float* lse_s = dss + ROWS * BP;   // [ROWS]
    float* d_s = lse_s + ROWS;        // [ROWS]
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int hkv = blockIdx.y;
    const long long b = blockIdx.z;
    const int nrows = geo.lq * geo.g, k0 = blockIdx.x * BK;
    const int off = geo.lk_valid - geo.lq;
    const long long rowbase = (b * gridDim.y + hkv) * (long long)nrows;

    stage_keys<DM>(ks, k, st.k, b, hkv, k0, geo.lk_valid, geo);
    stage_keys<DM>(vs, v, st.v, b, hkv, k0, geo.lk_valid, geo);

    // the query positions of the band: i + off >= k0 if causal, and
    // i + off - window < the tile's last visible key
    int i_lo = 0, i_hi = 0;
    if (k0 < geo.lk_valid) {
        const int kmax = min(k0 + BK, geo.lk_valid) - 1;
        i_lo = geo.causal ? max(0, k0 - off) : 0;
        i_hi = geo.window > 0 ? min(geo.lq, kmax - off + geo.window) : geo.lq;
    }
    const int r_lo = i_lo * geo.g, r_hi = max(r_lo, i_hi * geo.g);

    float akk[KPT][DC], avv[KPT][DC];
#pragma unroll
    for (int a = 0; a < KPT; ++a)
#pragma unroll
        for (int j = 0; j < DC; ++j) { akk[a][j] = 0.0f; avv[a][j] = 0.0f; }

    for (int r0 = r_lo; r0 < r_hi; r0 += ROWS) {
        __syncthreads();              // the previous tile's readers are done
        stage_rows<DM>(qs, q, st.q, b, hkv, r0, r_hi, geo);
        stage_rows<DM>(dos, dout, st.dout, b, hkv, r0, r_hi, geo);
        for (int r = tid; r < ROWS; r += THREADS) {
            const bool ok = r0 + r < r_hi;
            lse_s[r] = ok ? lse[rowbase + r0 + r] : 0.0f;
            d_s[r] = ok ? dsum[rowbase + r0 + r] : 0.0f;
        }
        __syncthreads();
        float p[4][SC], ds[4][SC];
        p_ds<DM>(p, ds, qs, dos, ks, vs, lse_s, d_s, r0, r_hi, k0, geo, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < SC; ++j) {
                ps[(4 * ty + i) * BP + tx + 16 * j] = p[i][j];
                dss[(4 * ty + i) * BP + tx + 16 * j] = ds[i][j];
            }
        __syncthreads();
        const int rend = min(ROWS, r_hi - r0);
        for (int r = 0; r < rend; ++r) {
            float pv[KPT], dsv[KPT], dov[DC], qv[DC];
#pragma unroll
            for (int a = 0; a < KPT; ++a) {
                pv[a] = ps[r * BP + ty * KPT + a];
                dsv[a] = dss[r * BP + ty * KPT + a];
            }
#pragma unroll
            for (int j = 0; j < DC; ++j) {
                dov[j] = dos[r * QP + tx + 16 * j];
                qv[j] = qs[r * QP + tx + 16 * j];
            }
#pragma unroll
            for (int a = 0; a < KPT; ++a)
#pragma unroll
                for (int j = 0; j < DC; ++j) {
                    avv[a][j] = fmaf(pv[a], dov[j], avv[a][j]);
                    akk[a][j] = fmaf(dsv[a], qv[j], akk[a][j]);
                }
        }
    }

#pragma unroll
    for (int a = 0; a < KPT; ++a) {
        const int kj = k0 + ty * KPT + a;
        if (kj >= geo.lk) continue;
        float* krow = dk + b * st.dk[0] + kj * st.dk[1] + hkv * st.dk[2];
        float* vrow = dv + b * st.dv[0] + kj * st.dv[1] + hkv * st.dv[2];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
            const int dd = tx + 16 * j;
            if (dd < geo.d) {
                krow[dd] = akk[a][j] * geo.scale;
                vrow[dd] = avv[a][j];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// 3. dQ of a row tile, over the key tiles of its band
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(THREADS)
bwd_dq(float* dq, const float* __restrict__ lse, const float* __restrict__ dsum,
       const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ dout, Geo geo, Strides st) {
    using CF = Cfg<DM>;
    constexpr int QP = CF::QP, BK = CF::BK, SC = CF::SC, DC = CF::DC;
    constexpr int PP = ROWS + 1;      // pitch of the dS tile, stored [key][row]
    extern __shared__ float smem[];
    float* qs = smem;                 // [ROWS][QP]
    float* dos = qs + ROWS * QP;      // [ROWS][QP]
    float* ks = dos + ROWS * QP;      // [BK][QP]
    float* vs = ks + BK * QP;         // [BK][QP]
    float* dss = vs + BK * QP;        // [BK][PP]
    float* lse_s = dss + BK * PP;     // [ROWS]
    float* d_s = lse_s + ROWS;        // [ROWS]
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int hkv = blockIdx.y;
    const long long b = blockIdx.z;
    const int nrows = geo.lq * geo.g, r0 = blockIdx.x * ROWS;
    const long long rowbase = (b * gridDim.y + hkv) * (long long)nrows;

    stage_rows<DM>(qs, q, st.q, b, hkv, r0, nrows, geo);
    stage_rows<DM>(dos, dout, st.dout, b, hkv, r0, nrows, geo);
    for (int r = tid; r < ROWS; r += THREADS) {
        const bool ok = r0 + r < nrows;
        lse_s[r] = ok ? lse[rowbase + r0 + r] : 0.0f;
        d_s[r] = ok ? dsum[rowbase + r0 + r] : 0.0f;
    }
    int t0, t1, kend;
    key_band(r0, min(r0 + ROWS, nrows), geo, BK, t0, t1, kend);

    float acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;

    for (int kt = t0; kt < t1; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();
        stage_keys<DM>(ks, k, st.k, b, hkv, k0, kend, geo);
        stage_keys<DM>(vs, v, st.v, b, hkv, k0, kend, geo);
        __syncthreads();
        float p[4][SC], ds[4][SC];
        p_ds<DM>(p, ds, qs, dos, ks, vs, lse_s, d_s, r0, nrows, k0, geo, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < SC; ++j) dss[(tx + 16 * j) * PP + 4 * ty + i] = ds[i][j];
        __syncthreads();
        const int cend = min(BK, kend - k0);
        for (int c = 0; c < cend; ++c) {
            float dsv[4], kv[DC];
#pragma unroll
            for (int i = 0; i < 4; ++i) dsv[i] = dss[c * PP + 4 * ty + i];
#pragma unroll
            for (int j = 0; j < DC; ++j) kv[j] = ks[c * QP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gr = r0 + 4 * ty + i;
        if (gr >= nrows) continue;
        const int qi = gr / geo.g, h = hkv * geo.g + gr % geo.g;
        float* row = dq + b * st.dq[0] + qi * st.dq[1] + h * st.dq[2];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
            const int dd = tx + 16 * j;
            if (dd < geo.d) row[dd] = acc[i][j] * geo.scale;
        }
    }
}

template <typename K>
cudaError_t allow(K kernel, size_t smem) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

template <int DM>
int launch(void* dq, void* dk, void* dv, const void* q, const void* k,
           const void* v, const void* o, const void* dout, float* lse,
           float* dsum, int batch, int hkv, const Geo& geo, const Strides& st,
           cudaStream_t stream) {
    using CF = Cfg<DM>;
    constexpr int QP = CF::QP, BK = CF::BK;
    const size_t s_lse = (ROWS + BK) * QP * sizeof(float);
    const size_t s_dkv = ((2 * BK + 2 * ROWS) * QP + 2 * ROWS * (BK + 1) + 2 * ROWS)
                         * sizeof(float);
    const size_t s_dq = ((2 * ROWS + 2 * BK) * QP + BK * (ROWS + 1) + 2 * ROWS)
                        * sizeof(float);
    cudaError_t err;
    if ((err = allow(bwd_lse<DM>, s_lse)) != cudaSuccess) return err;
    if ((err = allow(bwd_dkv<DM>, s_dkv)) != cudaSuccess) return err;
    if ((err = allow(bwd_dq<DM>, s_dq)) != cudaSuccess) return err;
    const float* tq = static_cast<const float*>(q);
    const float* tk = static_cast<const float*>(k);
    const float* tv = static_cast<const float*>(v);
    const float* td = static_cast<const float*>(dout);
    const int nrows = geo.lq * geo.g;
    const dim3 rows((nrows + ROWS - 1) / ROWS, hkv, batch);
    const dim3 keys((geo.lk + BK - 1) / BK, hkv, batch);
    bwd_lse<DM><<<rows, THREADS, s_lse, stream>>>(
        lse, dsum, tq, tk, static_cast<const float*>(o), td, geo, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dkv<DM><<<keys, THREADS, s_dkv, stream>>>(
        static_cast<float*>(dk), static_cast<float*>(dv), lse, dsum, tq, tk, tv, td, geo, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dq<DM><<<rows, THREADS, s_dq, stream>>>(
        static_cast<float*>(dq), lse, dsum, tq, tk, tv, td, geo, st);
    return cudaGetLastError();
}

int dispatch(int d, void* dq, void* dk, void* dv, const void* q, const void* k,
             const void* v, const void* o, const void* dout, float* lse,
             float* dsum, int batch, int hkv, const Geo& geo, const Strides& st,
             cudaStream_t s) {
    if (d > 128)
        return launch<DMAX>(dq, dk, dv, q, k, v, o, dout, lse, dsum, batch, hkv, geo, st, s);
    if (d > 64)
        return launch<128>(dq, dk, dv, q, k, v, o, dout, lse, dsum, batch, hkv, geo, st, s);
    return launch<64>(dq, dk, dv, q, k, v, o, dout, lse, dsum, batch, hkv, geo, st, s);
}

}  // namespace

// float32 throughout; head dim <= 256; window 0 means none.
// st: 24 element strides, (batch, row, head) of q, k, v, o, dout, dq, dk, dv
// in that order (the head-dim axis contiguous).  lse and dsum: float32
// scratch of batch * hq * lq each.  dk and dv are written for all lk keys
// (zeros past lk_valid).
extern "C" int flash_attention_bwd(void* dq, void* dk, void* dv, const void* q,
                                   const void* k, const void* v, const void* o,
                                   const void* dout, float* lse, float* dsum,
                                   int batch, int lq, int lk,
                                   int lk_valid, int hq, int hkv, int d,
                                   int causal, int window, float scale,
                                   const long long* st, void* stream) {
    if (d > DMAX || d <= 0 || hkv <= 0 || hq % hkv != 0 || window < 0
        || lk_valid < 0 || lk_valid > lk)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch <= 0 || lq <= 0 || lk <= 0) return static_cast<int>(cudaGetLastError());
    Strides s;
    long long* dst[8] = {s.q, s.k, s.v, s.o, s.dout, s.dq, s.dk, s.dv};
    for (int t = 0; t < 8; ++t)
        for (int i = 0; i < 3; ++i) dst[t][i] = st[3 * t + i];
    const Geo geo{lq, lk, lk_valid, hq / hkv, d, causal, window, scale};
    cudaStream_t cs = static_cast<cudaStream_t>(stream);
    return dispatch(d, dq, dk, dv, q, k, v, o, dout, lse, dsum, batch, hkv, geo, s, cs);
}
