// K3 ell_relax_round: one Jacobi Bellman-Ford round over padded-ELL tables.
//
//     out[b][t][s] = min(m[b][t][s], min_j wgt[b][t][j] + m[b][idx[b][t][j]][s])
//     flags[b][tile][span] = any element of the (TT targets x SPAN sources)
//                            patch decreased
//
// on the transposed carry m[t][s] = dist(s -> t), whose row t is pulled from
// the rows of t's predecessors idx[t][:].  Replaces the TPU kernel
// `_relax_round_kernel` (repro/kernels/ell.py, via `ell_relax_round_pallas`).
//
// What bounds it on Hopper: memory, by the roofline: each slot is one add
// and one min per carry element, 2*d_max instructions against one 4-byte
// read and one 4-byte write of the carry (~4 instructions per byte at
// d_max=16, below the card's ~10 fp32 instructions per byte of HBM
// bandwidth).  The gathers are the catch: every element reads d_max
// predecessor rows, 16x the carry.  From L2 that traffic sets the time
// (route l2); from shared memory (route slab) the shared-memory pipe does,
// with the table loads, and the SMs that hold 3 of the 320 blocks of
// [20,512,512] against 2 on the others (tools/k2_k3_variants.py).
//
// Design: the TPU kernel holds the whole (N, S) carry in VMEM; an SM holds
// an (N x SPAN) slab of one lane, so two routes, picked by the wrapper from
// the shared memory the slab needs (`ell_route` in kernels/ell.py):
//
// * route slab (d_max <= 64 and N*128 bytes + 3 KB of table stages fit a
//   block: N <= 1,792): one block of 8 warps per (lane, span of 32 sources)
//   copies m[lane, :, s0:s0+32] into shared memory with cp.async (64 KB at
//   N = 512, 3 blocks an SM), so every gather is a conflict-free shared
//   load: lane l of a warp is source s0 + l, and one target row reads 32
//   consecutive floats of a predecessor row.  Warp w takes the target tiles
//   w, w + 8, ... of TT = 8 targets, in stages of 64 table slots: the next
//   stage's idx/wgt rows are loaded into registers (coalesced) while this
//   one is computed, then stored in the warp's shared stage with each row
//   index as a 16-bit offset into the slab and each row padded to a
//   multiple of 8 with (row 0, +inf).  The table is read with warp-uniform
//   16-byte loads, which cost the shared-memory pipe more than the gathers
//   (ablations in tools/k2_k3_variants.py), so the 16-bit offsets take 6
//   bytes a slot where int32 rows would take 8.  Each target is one
//   coalesced 128-byte store; the warp ORs its 8 x 32 patch with
//   __any_sync and writes its flag.  Device memory sees one read and one
//   write of the carry plus the tables.
// * route l2 (larger N): the carry stays in device memory and the gathers
//   go to L2.  One block of 128 threads covers (lane, TT targets, 128
//   sources), stages the tile's idx/wgt rows in shared memory, and each
//   thread owns one source column; each warp's 8 x 32 patch gets its flag
//   from __any_sync, 4 flags a block.
//
// Both are Jacobi rounds: every target reads the pre-round carry and the
// result goes to a separate buffer, with no atomics.  Every output is the
// min over the same fl(w + m) terms as the plain version (+inf pads never
// win), so the result is bit-equal.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TT = 8;          // targets per flag (TILE in kernels/ell.py)
constexpr int SPAN = 32;       // sources per flag (SPAN in kernels/ell.py)
constexpr int SLAB_WARPS = 8;  // warps per block of route slab
constexpr int SLAB_MAX_D = 64;   // longest table row route slab takes
constexpr int L2_SOURCES = 128;  // sources (= threads) per block of route l2
constexpr int SMEM_MAX = 232448;  // shared memory a block may take on sm_90
constexpr int ERR_ROUTE = -2;    // the slab does not fit, or no such route

// A table row in shared memory: d slots padded to a multiple of 8 (one
// 16-byte load of 8 row offsets, two of 8 weights).
__host__ __device__ constexpr int padded(int d) { return d <= 8 ? 8 : (d + 7) & ~7; }

// Table slots a warp stages at once: 64 per 32 target columns a warp row
// covers, as g target rows (g divides TT).
template <int SP>
__host__ __device__ constexpr int stage_targets(int dp) {
    return 64 * (32 / SP) / dp < TT ? 64 * (32 / SP) / dp : TT;
}

template <int SP>
size_t slab_smem(int n, int d) {
    const int dp = padded(d);
    return static_cast<size_t>(n) * SP * sizeof(float)
           + static_cast<size_t>(SLAB_WARPS) * stage_targets<SP>(dp) * dp
                 * (sizeof(float) + sizeof(unsigned short));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(a), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(a), "l"(src), "r"(ok ? 4 : 0));
}

// Route slab, SP sources a block (32 ships; 16, two target rows a warp at
// once, is a variant of tools/k2_k3_variants.py).  vec: the carry's rows
// are 16-byte aligned (S % 4 == 0 and an aligned base), so the slab comes
// in 16-byte copies.
template <int SP>
__global__ void __launch_bounds__(SLAB_WARPS * 32, 3)
ell_slab_kernel(float* __restrict__ out, unsigned char* __restrict__ flags,
                const float* __restrict__ m, const int* __restrict__ idx,
                const float* __restrict__ wgt, int n, int s, int d, int vec) {
    constexpr int THREADS = SLAB_WARPS * 32, RPW = 32 / SP;
    constexpr int K = 64 * RPW / 32;   // table slots a lane stages
    extern __shared__ __align__(16) float smem[];
    const int dp = padded(d), g = stage_targets<SP>(dp), spt = TT / g;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int l = lane % SP;
    float* slab = smem;                                           // [n][SP]
    float* sw = smem + n * SP + warp * g * dp;                    // [g][dp]
    unsigned short* si = reinterpret_cast<unsigned short*>(
        smem + n * SP + SLAB_WARPS * g * dp) + warp * g * dp;     // [g][dp]
    const long long b = blockIdx.y;
    const int s0 = blockIdx.x * SP;
    const float* ml = m + b * n * static_cast<long long>(s);
    const int* il = idx + b * n * static_cast<long long>(d);
    const float* wl = wgt + b * n * static_cast<long long>(d);

    if (vec) {
        for (int e = tid; e < n * (SP / 4); e += THREADS) {
            const int r = e / (SP / 4), q = (e % (SP / 4)) * 4;
            const bool ok = s0 + q < s;
            cp16(slab + r * SP + q, ok ? ml + r * static_cast<long long>(s) + s0 + q : ml, ok);
        }
    } else {
        for (int e = tid; e < n * SP; e += THREADS) {
            const int r = e / SP, q = e % SP;
            const bool ok = s0 + q < s;
            cp4(slab + r * SP + q, ok ? ml + r * static_cast<long long>(s) + s0 + q : ml, ok);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // pad slots: row 0 and +inf, never overwritten
    for (int e = lane; e < g * dp; e += 32) {
        if (e % dp >= d) {
            si[e] = 0;
            sw[e] = __int_as_float(0x7f800000);
        }
    }
    // slot e = lane + 32k of a stage is (target e / d, slot e % d): the same
    // place in every stage, so it is worked out once
    int soff[K], pi[K];
    float pw[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int e = lane + 32 * k;
        soff[k] = e < g * d ? (e / d) * dp + e % d : -1;
    }
    // registers <- the g table rows from target ta on (coalesced loads)
    auto fetch = [&](int ta) {
        const long long off = ta * static_cast<long long>(d);
        const int lim = (n - ta < g ? n - ta : g) * d;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int e = lane + 32 * k;
            pi[k] = e < lim ? __ldg(il + off + e) : 0;
            pw[k] = e < lim ? __ldg(wl + off + e) : 0.0f;
        }
    };
    const int nt = (n + TT - 1) / TT;
    if (warp < nt) fetch(warp * TT);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // the slab has landed for every thread

    float* ob = out + b * n * static_cast<long long>(s) + s0 + l;
    const float* sl = slab + l;
    int changed = 0;
    for (int tile = warp; tile < nt; tile += SLAB_WARPS) {
        for (int sub = 0; sub < spt; ++sub) {
            const int ta = tile * TT + sub * g;
            // the stage into shared memory, rows as offsets into the slab
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (soff[k] >= 0) {
                    si[soff[k]] = static_cast<unsigned short>(pi[k] * SP);
                    sw[soff[k]] = pw[k];
                }
            }
            __syncwarp();
            const int nta = sub + 1 < spt ? ta + g : (tile + SLAB_WARPS) * TT;
            if (nta < n) fetch(nta);   // lands while this stage is computed
            const int cnt = n - ta < g ? n - ta : g;
            for (int tt = lane / SP; tt < cnt; tt += RPW) {
                const int t = ta + tt;
                const float cur = sl[t * SP];
                float acc0 = cur, acc1 = cur;
                const uint4* ri = reinterpret_cast<const uint4*>(si + tt * dp);
                const float4* rw = reinterpret_cast<const float4*>(sw + tt * dp);
                for (int p = 0; p < dp / 8; ++p) {
                    const uint4 iv = ri[p];
                    const float4 wa = rw[2 * p], wb = rw[2 * p + 1];
                    acc0 = fminf(acc0, wa.x + sl[iv.x & 0xffff]);
                    acc1 = fminf(acc1, wa.y + sl[iv.x >> 16]);
                    acc0 = fminf(acc0, wa.z + sl[iv.y & 0xffff]);
                    acc1 = fminf(acc1, wa.w + sl[iv.y >> 16]);
                    acc0 = fminf(acc0, wb.x + sl[iv.z & 0xffff]);
                    acc1 = fminf(acc1, wb.y + sl[iv.z >> 16]);
                    acc0 = fminf(acc0, wb.z + sl[iv.w & 0xffff]);
                    acc1 = fminf(acc1, wb.w + sl[iv.w >> 16]);
                }
                const float acc = fminf(acc0, acc1);
                if (s0 + l < s) {
                    ob[t * static_cast<long long>(s)] = acc;
                    changed |= acc < cur;
                }
            }
            __syncwarp();  // the stage is read before the next one is stored
        }
        const int any = __any_sync(0xffffffffu, changed);
        if (lane == 0) flags[(b * nt + tile) * gridDim.x + blockIdx.x] = any != 0;
        changed = 0;
    }
}

// Route l2: the gathers go to device memory (L2); a flag per warp.
__global__ void __launch_bounds__(L2_SOURCES)
ell_l2_kernel(float* __restrict__ out, unsigned char* __restrict__ flags,
              const float* __restrict__ m, const int* __restrict__ idx,
              const float* __restrict__ wgt, int n, int s, int d) {
    extern __shared__ unsigned char smem_l2[];
    int* sidx = reinterpret_cast<int*>(smem_l2);
    float* swgt = reinterpret_cast<float*>(smem_l2 + sizeof(int) * TT * d);
    const long long lane = blockIdx.z;
    const int t0 = blockIdx.y * TT;
    const int sc = blockIdx.x * L2_SOURCES + threadIdx.x;
    const float* ml = m + lane * n * static_cast<long long>(s);
    float* ol = out + lane * n * static_cast<long long>(s);
    for (int e = threadIdx.x; e < TT * d; e += L2_SOURCES) {
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
    const int any = __any_sync(0xffffffffu, changed);
    const int ns = (s + SPAN - 1) / SPAN;
    const int span = blockIdx.x * (L2_SOURCES / SPAN) + (threadIdx.x >> 5);
    if ((threadIdx.x & 31) == 0 && span < ns)
        flags[(lane * gridDim.y + blockIdx.y) * ns + span] = any != 0;
}

template <int SP>
int launch_slab(float* out, unsigned char* flags, const float* m, const int* idx,
                const float* wgt, int batch, int n, int s, int d,
                cudaStream_t stream) {
    const size_t smem = slab_smem<SP>(n, d);
    if (d > SLAB_MAX_D || smem > static_cast<size_t>(SMEM_MAX)) return ERR_ROUTE;
    cudaError_t err = cudaFuncSetAttribute(
        ell_slab_kernel<SP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int vec = s % 4 == 0 && reinterpret_cast<std::uintptr_t>(m) % 16 == 0;
    dim3 grid((s + SP - 1) / SP, batch);
    ell_slab_kernel<SP><<<grid, SLAB_WARPS * 32, smem, stream>>>(
        out, flags, m, idx, wgt, n, s, d, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flags: one byte (0 or 1) per patch, a torch.bool tensor's storage.
// `tile` and `span` are the caller's idea of the flag patch (TT x SPAN); the
// entry returns -1 without launching when they differ from this build's.
// `route`: 0 slab, 1 l2 (ROUTES in kernels/ell.py); -2 without launching
// when the slab does not fit or the route is unknown.
extern "C" int ell_relax_round(float* out, unsigned char* flags,
                               const float* m,
                               const int* idx, const float* wgt, int batch,
                               int n, int s, int d, int tile, int span,
                               int route, void* stream) {
    if (tile != TT || span != SPAN) return -1;
    if (route != 0 && route != 1) return ERR_ROUTE;
    if (batch <= 0 || n <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (route == 0) return launch_slab<SPAN>(out, flags, m, idx, wgt, batch, n, s, d, st);
    const size_t smem = static_cast<size_t>(TT) * d * (sizeof(int) + sizeof(float));
    dim3 grid((s + L2_SOURCES - 1) / L2_SOURCES, (n + TT - 1) / TT, batch);
    ell_l2_kernel<<<grid, L2_SOURCES, smem, st>>>(out, flags, m, idx, wgt, n, s, d);
    return static_cast<int>(cudaGetLastError());
}
