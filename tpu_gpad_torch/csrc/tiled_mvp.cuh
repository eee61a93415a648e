// The paired mvp GPAD loop with both operands read from device memory on
// every iteration, a whole fixed-budget solve per launch: the body of the
// flat tiled kernel (csrc/gpad_flat_tiled.cu: the flat paired loop, and the
// full paired loop at n_s = m_h). Per scenario, for each iteration
// k < iterations, the state y+-, w+- of (B, 2, m_h):
//
//   w+-  = y+- + beta_k (y+- - y+-_prev),  wd = w+ - w-
//   zhat = -MG_T' wd - g_P                        MG_T (m_h, n_z)
//   z    = (1 - theta_k) z + theta_k zhat         z starts at 0
//   q    = [ GL_T[:, :n_s]' zhat ; zhat / L ]     box rows need no product
//   y+   = relu(w+ od + q + p_D+),  y- = relu(w- od - q + p_D-)
//
// The dual rows are in [struct | box] order (dualize puts the identity rows
// last). With n_s = m_h there are no box rows: the paired loop with the
// full GL_T. od (m_h,) is 1 - soft_damp in the same row order, the soft
// rows' damp of their extrapolated dual, as _gpad_kernel_paired_flat and
// _gpad_kernel_paired carry it; w and wd keep the undamped w. Only the
// kSoft instances read od (a hard launch passes null and runs instances
// compiled as they were without it: the damp in their epilogue, inlined at
// every fragment of the one-scenario tier product, spilled 24-88 bytes).
// Fixed mode only: no restart, as in tpu_gpad.
//
// Design: a thread-block cluster of C blocks (512 threads each) owns a
// tile of T scenarios (T a power of two <= 16) for the whole launch, as
// the tiled dual kernel's clusters do (csrc/gpad_dual_tiled.cu). Block r
// of the cluster owns about n_s / C structural rows and (m_h - n_s) / C
// box rows of the dual state, and about n_z / C primal columns: it
// computes zhat and z for its columns, reading only its m_h x n_z / C slice
// of MG_T, and q, the projection and the next w and wd for its rows,
// reading only its n_z x n_s / C slice of GL_T. wd and zhat, laid out
// [row][scenario], are whole in every block's shared memory: each block
// pushes the entries it formed to every peer (distributed shared memory),
// and a cluster barrier follows each push, so an iteration is (1) the zhat
// product of the block's columns, its zhat pushed, barrier; (2) the q
// product of its structural rows and the projection of all its rows, fused
// with the next iteration's w and wd, its wd pushed, barrier. A product
// (tiled_product.cuh) splits the rows of A over groups of threads, each
// thread holding 2 columns x T scenarios of sums; the groups' sums meet in
// shared memory in two rounds (the upper half's into a scratch, added to
// the lower half's in place, then the halves in order), one fixed order.
// Where even that scratch does not fit (shapes near the guard, one
// scenario), a single group keeps each column's sums in its thread. The
// state (y, w, z) lives in device memory in the output tensors: a block
// touches only its own rows and columns of it.
//
// Precision: the tier is a template parameter of the kernel. "highest" runs
// both products in fp32 FMA (tiled_product.cuh's product_rows); "high",
// "default" and "bfloat16" run them on the tensor cores (tiled_product.
// cuh's mma_strip), as the Pallas kernels run _kdot at their tier: a warp
// of a group takes a strip of 64 columns x the T scenarios over the
// group's rows, its fragments read from L2, and hands its sums to the same
// two rounds of the groups' scratch (a grouped product keeps at least two
// groups under a tier), or, in the one-scenario plan without that scratch,
// straight from the fragments to the epilogue, so a tier needs no shared
// memory that "highest" does not. The box rows' division, the projection
// and the pushes stay fp32 and as they are at every tier.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tiled_product.cuh"

namespace gpad_tiled_mvp {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;
// Columns of a product per thread and the A rows a thread keeps in flight
// (the tiled dual kernel's choices).
constexpr int kCols = 2;
template <int T>
__host__ __device__ constexpr int rows_in_flight() {
    return T >= 8 ? 4 : 8;
}
// The groups' scratch: the upper half's sums, kThreads / 2 threads x kCols
// columns per scenario.
constexpr int kRedCols = kCols * kThreads / 2;

// Floats of shared memory a block needs (mirrored by kernels.py::
// _flat_tiled_smem_bytes): wd and zhat of T scenarios and, with grouped
// products, the groups' scratch. m_h is the dual rows of one side.
__host__ __device__ inline long long smem_floats(int m_h, int n_z, int T,
                                                 bool grouped) {
    return (long long)T * (m_h + n_z + (grouped ? kRedCols : 0));
}

// The block's share of its cluster's tile: structural rows [slo, shi), box
// rows [blo, bhi) and primal columns [zlo, zhi).
struct Slice {
    int rank, C, slo, shi, blo, bhi, zlo, zhi;
};

__device__ inline Slice make_slice(int m_h, int n_z, int n_s,
                                   const cg::cluster_group& cl) {
    Slice s;
    s.rank = (int)cl.block_rank();
    s.C = (int)cl.num_blocks();
    const int nb = m_h - n_s;
    const int Ws = (n_s + s.C - 1) / s.C, Wb = (nb + s.C - 1) / s.C;
    const int Wz = (n_z + s.C - 1) / s.C;
    s.slo = min(n_s, s.rank * Ws);
    s.shi = min(n_s, s.slo + Ws);
    s.blo = n_s + min(nb, s.rank * Wb);
    s.bhi = n_s + min(nb, s.rank * Wb + Wb);
    s.zlo = min(n_z, s.rank * Wz);
    s.zhi = min(n_z, s.zlo + Wz);
    return s;
}

// Floats [a, b) of the block's shared memory `smem` (16-byte aligned) into
// every peer's: 16-byte stores where aligned, single words at the ends.
__device__ inline void push(const cg::cluster_group& cl, const Slice& sl,
                            float* smem, int a, int b) {
    if (sl.C == 1 || a >= b) return;
    const int a4 = min(b, (a + 3) & ~3), b4 = max(a4, b & ~3);
    const int n4 = (b4 - a4) >> 2, head = a4 - a, n1 = head + b - b4;
    float4* src4 = reinterpret_cast<float4*>(smem + a4);
    for (int e = threadIdx.x; e < (sl.C - 1) * n4; e += kThreads) {
        const int q = e / n4, x = e - q * n4;
        cl.map_shared_rank(src4, (sl.rank + 1 + q) % sl.C)[x] = src4[x];
    }
    for (int e = threadIdx.x; e < (sl.C - 1) * n1; e += kThreads) {
        const int q = e / n1, x = e - q * n1;
        const int f = x < head ? a + x : b4 + x - head;
        *cl.map_shared_rank(smem + f, (sl.rank + 1 + q) % sl.C) = smem[f];
    }
}

// The block's columns [lo, hi) of X' A (A row-major (K, lda), X [j][t] in
// shared memory): epi(c, t, sum) once for each column c and scenario t,
// each sum taken in one fixed order, its products at kTier. Threads form G
// groups of tpg (the fewest threads whose kCols columns cover the columns
// in one pass, G = 1 without `grouped`); group g sums its K / G rows of A,
// at "highest" each thread kCols columns, under a tier each warp a strip
// of 64 (the group's pass has as many columns either way). Under a tier a
// grouped product keeps at least two groups (their two rounds fit the same
// scratch), so only the one-scenario product without it (T = 1) hands its
// sums from the fragments to the epilogue: inlined at every fragment
// element of a wider tile, the epilogue spilled.
template <int T, int kTier, typename Epi>
__device__ __forceinline__ void product(
    const float* __restrict__ A, int lda, int K, int lo, int hi,
    const float* X, float* red, bool grouped, Epi&& epi)
{
    const int W = hi - lo;
    if (W <= 0) return;  // the block's slice is empty (uniform)
    const int tid = threadIdx.x;
    int tpg = grouped ? 32 : kThreads;
    const int most = kTier == gpad_mma::kHighest || !grouped ? kThreads
                                                              : kThreads / 2;
    while (tpg < most && kCols * tpg < W) tpg <<= 1;
    const int G = kThreads / tpg, H = G / 2, g = tid / tpg, lt = tid - g * tpg;
    const int jr = (K + G - 1) / G;
    const int j_lo = min(K, g * jr), j_hi = min(K, j_lo + jr);
    const int cpp = kCols * tpg;  // columns per pass
    for (int p0 = lo; p0 < hi; p0 += cpp) {
        const int pend = min(hi, p0 + cpp);
        if constexpr (kTier == gpad_mma::kHighest) {
            const int c0 = p0 + kCols * lt;
            float acc[kCols][T];
            gpad_tiled::product_rows<T, kCols, rows_in_flight<T>()>(
                A, lda, j_lo, j_hi, c0, pend, X, acc);
            if (G == 1) {  // each column's sums are whole in its thread
#pragma unroll
                for (int q = 0; q < kCols; ++q)
                    if (c0 + q < pend)
#pragma unroll
                        for (int t = 0; t < T; ++t) epi(c0 + q, t, acc[q][t]);
                continue;
            }
            // group g >= H stores, then group g - H adds its own: slot h
            // holds group h + group h + H, and the slots are added in order
            float* slot = red + (long long)(g % H) * T * cpp + kCols * lt;
            if (g >= H)
#pragma unroll
                for (int t = 0; t < T; ++t)
#pragma unroll
                    for (int q = 0; q < kCols; ++q) slot[t * cpp + q] = acc[q][t];
            __syncthreads();
            if (g < H)
#pragma unroll
                for (int t = 0; t < T; ++t)
#pragma unroll
                    for (int q = 0; q < kCols; ++q)
                        slot[t * cpp + q] = acc[q][t] + slot[t * cpp + q];
        } else {
            const int c0 = p0 + gpad_tiled::kStripCols * (lt >> 5);
            float d[gpad_tiled::kStripTiles][gpad_tiled::kScenarioTiles<T>][4];
            gpad_tiled::mma_strip<kTier, T>(A, lda, j_lo, j_hi, c0, pend, X, d);
            constexpr int NC = gpad_tiled::kStripTiles;
            if constexpr (T == 1) {
                if (G == 1) {  // each sum is whole in its fragment
                    gpad_tiled::for_each_sum<T, NC>(d, c0, pend, epi);
                    continue;
                }
            }
            // the same two rounds, from the fragments
            float* slot = red + (long long)(g % H) * T * cpp;
            if (g >= H)
                gpad_tiled::for_each_sum<T, NC>(
                    d, c0, pend,
                    [&](int c, int t, float v) { slot[t * cpp + c - p0] = v; });
            __syncthreads();
            if (g < H)
                gpad_tiled::for_each_sum<T, NC>(
                    d, c0, pend, [&](int c, int t, float v) {
                        slot[t * cpp + c - p0] = v + slot[t * cpp + c - p0];
                    });
        }
        __syncthreads();
        const int Wp = pend - p0;
        for (int e = tid; e < Wp * T; e += kThreads) {
            const int t = e / Wp, x = e - t * Wp;
            float s = 0.0f;
            for (int h = 0; h < H; ++h) s += red[((long long)h * T + t) * cpp + x];
            epi(p0 + x, t, s);
        }
        __syncthreads();  // the scratch is rewritten by the next pass
    }
}

// The whole solve of the cluster's tile: the body of a kernel of 512
// threads on clusters. MG (m_h, n_z) and GL (n_z, m_h) row-major, GL's
// columns [:n_s] used; gP, z and zhat (B, n_z); pD, y and w (B, 2, m_h); y0
// null (cold start) or rows of y0_stride floats (0: one y0 for all); theta
// and beta at least `iterations` long; L the Lipschitz constant (the box
// rows' division); od (m_h,) the soft rows' damp, read by the kSoft
// instances alone, which keep the hard instances as they were. `w` is the state (the last w on
// return), `zhat` may be null.
template <int T, int kTier, bool kSoft = false>
__device__ __forceinline__ void mvp_loop(
    const float* __restrict__ MG, const float* __restrict__ GL,
    const float* __restrict__ gP, const float* __restrict__ pD,
    const float* __restrict__ y0, long long y0_stride,
    const float* __restrict__ od,
    const float* __restrict__ theta, const float* __restrict__ beta,
    const float* __restrict__ L, int B, int m_h, int n_z, int n_s,
    int iterations, int grouped, float* z, float* y, float* w, float* zhat)
{
    extern __shared__ float4 smem4[];
    float* wd = reinterpret_cast<float*>(smem4);  // [i][t], m_h * T
    float* zh = wd + (long long)m_h * T;          // [c][t], n_z * T
    float* red = zh + (long long)n_z * T;         // the groups' scratch
    const cg::cluster_group cl = cg::this_cluster();
    const Slice sl = make_slice(m_h, n_z, n_s, cl);
    const float inv_L = 1.0f / L[0];  // IEEE division, as torch's 1 / L
    const int tid = threadIdx.x;
    const long long b0 = (long long)(blockIdx.x / sl.C) * T;
    const int nv = (int)min((long long)T, B - b0);
    const long long h = 2LL * m_h;  // a scenario's dual floats
    const int ns = sl.shi - sl.slo, nb = sl.bhi - sl.blo, nz = sl.zhi - sl.zlo;
    // the block's dual rows: e < ns structural, the rest box
    auto row_of = [&](int e) { return e < ns ? sl.slo + e : sl.blo + e - ns; };

    // y = y0 and w_0 = y0 (zeros for an empty loop), wd of the block's rows
    // (zeros past B); z = 0 and zhat = 0 of its columns
    for (int e = tid; e < (ns + nb) * T; e += kThreads) {
        const int t = e / (ns + nb), i = row_of(e - t * (ns + nb));
        float vp = 0.0f, vm = 0.0f;
        if (t < nv) {
            const long long o = (b0 + t) * h;
            if (y0) {
                vp = y0[(b0 + t) * y0_stride + i];
                vm = y0[(b0 + t) * y0_stride + m_h + i];
            }
            y[o + i] = vp;
            y[o + m_h + i] = vm;
            w[o + i] = iterations > 0 ? vp : 0.0f;
            w[o + m_h + i] = iterations > 0 ? vm : 0.0f;
        }
        wd[i * T + t] = vp - vm;
    }
    for (int e = tid; e < nz * nv; e += kThreads) {
        const int t = e / nz;
        const long long o = (b0 + t) * n_z + sl.zlo + e - t * nz;
        z[o] = 0.0f;
        if (zhat) zhat[o] = 0.0f;
    }
    cl.sync();  // every block of the cluster has started
    __syncthreads();
    push(cl, sl, wd, sl.slo * T, sl.shi * T);
    push(cl, sl, wd, sl.blo * T, sl.bhi * T);
    cl.sync();
    const int zoff = m_h * T;  // zhat's offset in shared memory

    for (int k = 0; k < iterations; ++k) {
        const float th = theta[k];
        const bool more = k + 1 < iterations;
        const float bn = more ? beta[k + 1] : 0.0f;
        // (1) zhat = -(wd MG_T) - g_P and z for the block's columns
        product<T, kTier>(MG, n_z, m_h, sl.zlo, sl.zhi, wd, red,
                          grouped != 0, [&](int c, int t, float acc) {
                              float v = 0.0f;
                              if (t < nv) {
                                  const long long o = (b0 + t) * n_z + c;
                                  v = -acc - gP[o];
                                  z[o] = (1.0f - th) * z[o] + th * v;
                                  if (!more && zhat) zhat[o] = v;
                              }
                              zh[c * T + t] = v;
                          });
        __syncthreads();
        push(cl, sl, wd, zoff + sl.zlo * T, zoff + sl.zhi * T);
        cl.sync();
        // (2) q = zhat GL_T[:, :n_s] on the structural rows, zhat / L on the
        // box rows; projection, and the next iteration's w and wd
        auto project = [&](int i, int t, float q) {
            if (t >= nv) return;
            const long long o = (b0 + t) * h;
            const float yp = y[o + i];
            float wp = w[o + i], wm = w[o + m_h + i];
            if constexpr (kSoft) {
                // a soft row damps its extrapolated dual on both halves, a
                // rounded product apart from the sums (od = 1: the hard
                // rows' results, bit for bit)
                const float damp = od[i];
                wp = __fmul_rn(wp, damp);
                wm = __fmul_rn(wm, damp);
            }
            const float ypn = fmaxf(wp + q + pD[o + i], 0.0f);
            const float ym = y[o + m_h + i];
            const float ymn = fmaxf(wm - q + pD[o + m_h + i], 0.0f);
            y[o + i] = ypn;
            y[o + m_h + i] = ymn;
            if (more) {
                const float wpn = ypn + bn * (ypn - yp);
                const float wmn = ymn + bn * (ymn - ym);
                w[o + i] = wpn;
                w[o + m_h + i] = wmn;
                wd[i * T + t] = wpn - wmn;
            }
        };
        product<T, kTier>(GL, m_h, n_z, sl.slo, sl.shi, zh, red,
                          grouped != 0, project);
        for (int e = tid; e < nb * T; e += kThreads) {
            const int t = e / nb, i = sl.blo + e - t * nb;
            project(i, t, zh[(i - n_s) * T + t] * inv_L);
        }
        __syncthreads();
        if (more) {
            push(cl, sl, wd, sl.slo * T, sl.shi * T);
            push(cl, sl, wd, sl.blo * T, sl.bhi * T);
        }
        cl.sync();
    }
}

// The instance K::of<T, kTier, kSoft>() of one .cu file's __global__
// wrapper at T = 2**log2_tile scenarios per cluster (0..4), gpad_mma::Tier
// `tier` (plan_ok has refused any other tile or tier) and, where
// K::kHasSoft, with soft rows or without. K holds the wrapper's pointer
// type Fn and the template `of`.
template <class K, int kTier, bool kSoft>
typename K::Fn kernel_at(int log2_tile) {
    switch (log2_tile) {
        case 0: return K::template of<1, kTier, kSoft>();
        case 1: return K::template of<2, kTier, kSoft>();
        case 2: return K::template of<4, kTier, kSoft>();
        case 3: return K::template of<8, kTier, kSoft>();
        default: return K::template of<16, kTier, kSoft>();
    }
}

template <class K, int kTier>
typename K::Fn kernel_at(int log2_tile, bool soft) {
    if constexpr (K::kHasSoft)
        if (soft) return kernel_at<K, kTier, true>(log2_tile);
    return kernel_at<K, kTier, false>(log2_tile);
}

template <class K>
typename K::Fn kernel_of(int log2_tile, int tier, bool soft = false) {
    using namespace gpad_mma;
    switch (tier) {
        case kHighest: return kernel_at<K, kHighest>(log2_tile, soft);
        case kHigh: return kernel_at<K, kHigh>(log2_tile, soft);
        case kDefault: return kernel_at<K, kDefault>(log2_tile, soft);
        default: return kernel_at<K, kBfloat16>(log2_tile, soft);
    }
}

// Launch `kernel` on clusters of `cluster` blocks, one cluster a tile of T
// of the B scenarios, with `smem` bytes of dynamic shared memory a block;
// a cudaError_t (0 on success).
template <typename... P, typename... A>
int launch(void (*kernel)(P...), int B, int T, int cluster, int smem,
           cudaStream_t stream, A... args)
{
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && cluster > 8)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(((B + T - 1) / T) * cluster));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Clusters of `cluster` blocks of `kernel` at `smem` bytes a block that
// the card holds at once, or a negative cudaError_t.
template <typename... P>
int max_clusters(void (*kernel)(P...), int cluster, int smem)
{
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && cluster > 8)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return err == cudaSuccess ? n : -(int)err;
}

// Is (log2_tile, cluster, grouped, smem, tier) a plan the kernels take (a
// tile in [0, 4], a cluster a power of two up to 16, a known tier, under a
// tier no tile wider than one scenario without the groups' scratch, and
// `smem` at least the carve-up's need)?
inline bool plan_ok(int B, int m_h, int n_z, int log2_tile, int cluster,
                    int grouped, int smem, int tier)
{
    return B >= 1 && log2_tile >= 0 && log2_tile <= 4 && cluster >= 1
        && cluster <= kMaxCluster && !(cluster & (cluster - 1))
        && tier >= gpad_mma::kHighest && tier <= gpad_mma::kBfloat16
        && !(tier != gpad_mma::kHighest && log2_tile > 0 && !grouped)
        && 4 * smem_floats(m_h, n_z, 1 << log2_tile, grouped != 0) <= smem;
}

}  // namespace gpad_tiled_mvp
