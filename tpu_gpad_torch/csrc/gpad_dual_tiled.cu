// Dual-form GPAD with the dual Hessian read from device memory on every
// iteration: a whole fixed-budget solve, or one eps check window, per launch.
//
// Replaces tpu_gpad/solver/kernels.py::_gpad_kernel_dual_tiled (the Pallas
// TPU kernel behind _dual_tiled_call, gpad_pallas_fixed_dual_tiled and the
// streamed branch of gpad_pallas_eps_dual). It computes what the resident
// kernels of csrc/gpad_dual.cu compute, for duals whose D does not fit one
// block's shared memory (the reference's battery 30x30: m_h = 1830, D is
// 13.4 MB). Per scenario, for each iteration k:
//
//   w+-  = y+- + beta_k (y+- - y+-_prev)
//   wd   = w+ - w-
//   s    = s + theta_k (wd - s)
//   d    = -(wd D)                               D (m_h, m_h)
//   y+   = relu(w+ od + d + c+),  y- = relu(w- od - d + c-)
//
// c+- = p_D+- -+ g_P GL_T is folded by the caller; od is 1 - soft_damp, as
// in the resident kernels (csrc/gpad_dual.cu) and tpu_gpad's
// _gpad_kernel_dual and _gpad_kernel_dual_chunk, which carry soft rows up
// to their 12 MB VMEM budget, past the resident kernels' 227 KB (tpu_gpad's
// tiled kernel declines them). Instances of their own read it (a hard
// launch passes null and runs the hard ones, compiled as they were). The
// damp enters y_next only: w, wd, s and the restart test keep the undamped
// w. Without
// restart theta_k/beta_k are the schedule's entries k0 + k; with restart
// they come from each scenario's own recursion (th, th_prev), and when
// r = sum (w - y_next)(y_next - y) over both halves is > 0 the recursion
// resets and y_prev = y_next; the schedule is then never read.
//
// What bounds it: at the flagship an iteration is 2 m_h^2 = 6.7 MFLOP per
// scenario, so B = 256 x 100 iterations is 171.5 GFLOP, 2.56 ms at the
// card's FP32 rate (0.35 ms at TF32's, 1.04 ms for "high"'s three
// products, 0.17 ms at bf16's). Every D word read from L2 feeds T FMAs per
// scenario tile, so the L2-to-SM traffic is 4 m_h^2 B/T bytes per
// iteration: with few scenarios per D word L2 bounds it, with many the FMA
// rate; under a tier, whose products the tensor cores run, L2 and latency.
//
// Design: a thread-block cluster of C blocks (512 threads each) owns a tile
// of T scenarios (T a power of two <= 16) for the whole launch. Block r of
// the cluster owns a slice of about m_h / C of the state's columns: it forms
// w, wd and s for those rows, and computes d and the projection for those
// columns, so it reads only its m_h x m_h / C slice of D per iteration.
// Each block pushes its wd rows into every peer's shared memory (distributed
// shared memory); after a cluster barrier every block holds the whole wd,
// [row][scenario], and runs its product: the block's threads form groups
// that split the rows j, each thread holding kCols columns x T scenarios
// of accumulators, so one coalesced D load feeds T FMAs and one broadcast
// shared-memory read of wd feeds kCols; the next rows' D words are in
// flight meanwhile. The groups' partial sums meet in shared memory, in one order,
// and the epilogue projects each column. Restart: each block's partials go
// to every peer; after the second cluster barrier of the iteration every
// thread adds the C block partials in the same order and every block
// reaches the same decision. The state (y, y_prev, w, s) lives in device
// memory (L2), updated in place in the output tensors; a block touches only
// its own columns. Two cluster barriers per iteration: wd complete before
// the products, wd consumed (and the restart partials in) before the next
// iteration writes them.
//
// Precision: the tier is a template parameter of both kernels, as in the
// resident ones (csrc/gpad_dual.cu). "highest" runs the fp32 FMA product
// above (tiled_product.cuh's product_rows); "high", "default" and
// "bfloat16" run each pass's product on the tensor cores
// (tiled_product.cuh's mma_strip): a warp of a group takes a strip of 64
// columns x the T scenarios over the group's rows, reading D's fragments
// from L2, and writes its sums into the same slots of the groups' partial
// sums, which the epilogue adds in the same order, as
// _gpad_kernel_dual_tiled runs _kdot at its tier. The epilogue, the restart
// test, s and the cluster barriers stay fp32 and as they are at every
// tier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tiled_product.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
// Columns of the product per thread and pass, and the D rows a thread
// keeps in flight in registers. Neither 4 columns at 8 scenarios nor 8
// rows at 16 was faster on an H100 80GB HBM3 at 700 W (PERF.md, the
// tiled dual kernel's probes).
constexpr int kCols = 2;
template <int T>
__host__ __device__ constexpr int rows_in_flight() {
    return T >= 8 ? 4 : 8;
}
// the row groups' partial sums of one pass: groups x threads x kCols x T
constexpr int kRedCols = kCols * kThreads;

__host__ __device__ constexpr int up4(int x) { return (x + 3) & ~3; }

// Floats of shared memory a block needs (mirrored by dual_kernels.py::
// _dual_tiled_smem_bytes): the whole wd [row][t] (rows padded to 4), the
// groups' partial sums, the cluster's restart partials [rank][t] and one
// partial per warp.
__host__ __device__ inline long long smem_floats(int m_h, int T) {
    return (long long)T * (up4(m_h) + kRedCols + kMaxCluster) + kWarps;
}

// The block's view of the state: per-scenario arrays in device memory, the
// (B, 2, m_h) pairs and (B, m_h) s, updated in place.
struct State {
    const float* c;  // (B, 2, m_h) relu offsets
    float* y;
    float* yprev;
    float* w;
    float* s;
};

// The block's share of its cluster's tile: rows [plo, phi) of wd, which it
// writes and pushes (multiples of 4 up to m_h rounded to 4, so every
// block's rows are whole float4s of wd), and of them the rows and columns
// [lo, hi) of the state, those below m_h.
struct Slice {
    int rank, C, plo, phi, lo, hi;
};

__device__ Slice make_slice(int m_h, const cg::cluster_group& cl) {
    Slice s;
    s.rank = (int)cl.block_rank();
    s.C = (int)cl.num_blocks();
    const int m4 = up4(m_h);
    const int W = up4((m4 + s.C - 1) / s.C);
    s.plo = min(m4, s.rank * W);
    s.phi = min(m4, s.plo + W);
    s.lo = min(m_h, s.plo);
    s.hi = min(m_h, s.phi);
    return s;
}

// `n` iterations from schedule index k0 on the cluster's T scenarios (the
// body shared by both kernels). Thread tid works on scenario t = tid /
// (512 / T) in the elementwise phases; th/thp are that scenario's restart
// recursion, held alike by every block of the cluster. On return the state
// holds the state after iteration n - 1 with its restart decision applied,
// and w that iteration's extrapolated point. The products run at kTier
// (gpad_mma::Tier); kSoft instances damp the soft rows by od (1 -
// soft_damp, read by them alone, so the hard instances are as they were).
template <int T, int kTier, bool kSoft>
__device__ void dual_tiled_iterations(
    const float* __restrict__ D, const float* __restrict__ od,
    const State& st, int B, int m_h, long long b0,
    int k0, int n, const float* __restrict__ theta,
    const float* __restrict__ beta, bool restart, float& th, float& thp,
    float* smem, const Slice& sl, const cg::cluster_group& cl)
{
    constexpr int tps = kThreads / T;  // threads per scenario
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int t = tid / tps, lc = tid - t * tps;
    float* wd = smem;                                 // [row][t]
    float* red = wd + (long long)up4(m_h) * T;        // [group][t][column]
    float* rcl = red + kRedCols * T;                  // [rank][t]
    float* rpart = rcl + kMaxCluster * T;             // [warp]
    const long long h = 2LL * m_h;
    const bool valid = b0 + t < B;
    const long long o = (b0 + t) * h, os = (b0 + t) * m_h;
    // the product's groups: the fewest threads whose kCols columns each
    // cover the block's columns in one pass, the rest split the rows j
    const int W = sl.hi - sl.lo;
    int tpg = 32;
    while (tpg < kThreads && kCols * tpg < W) tpg <<= 1;
    const int groups = kThreads / tpg, g = tid / tpg, lt = tid - g * tpg;
    const int jr = (m_h + groups - 1) / groups;
    const int j_lo = min(m_h, g * jr), j_hi = min(m_h, j_lo + jr);
    for (int k = 0; k <= n; ++k) {
        // (A) iteration k - 1's restart decision, then w, wd and s
        bool reset = false;
        if (restart && k > 0) {
            float r = 0.0f;
            for (int q = 0; q < sl.C; ++q) r += rcl[q * T + t];
            reset = r > 0.0f;
            if (reset) {
                th = 1.0f;
                thp = 1.0f;
            } else {
                const float nx = th * (sqrtf(th * th + 4.0f) - th) * 0.5f;
                thp = th;
                th = nx;
            }
        }
        if (k == n) {  // the last decision: restarted scenarios take y_prev = y
            if (valid && reset)
                for (int i = sl.lo + lc; i < sl.hi; i += tps) {
                    st.yprev[o + i] = st.y[o + i];
                    st.yprev[o + m_h + i] = st.y[o + m_h + i];
                }
            break;
        }
        float theta_k, beta_k;
        if (restart) {
            theta_k = th;
            beta_k = th * (1.0f / thp - 1.0f);
        } else {
            theta_k = theta[k0 + k];
            beta_k = beta[k0 + k];
        }
        for (int i = sl.plo + lc; i < sl.phi; i += tps) {
            if (!valid || i >= m_h) {
                wd[i * T + t] = 0.0f;
                continue;
            }
            const float yp = st.y[o + i], ym = st.y[o + m_h + i];
            const float ypp = reset ? yp : st.yprev[o + i];
            const float ymp = reset ? ym : st.yprev[o + m_h + i];
            const float wp = yp + beta_k * (yp - ypp);
            const float wm = ym + beta_k * (ym - ymp);
            st.w[o + i] = wp;
            st.w[o + m_h + i] = wm;
            const float d = wp - wm;
            wd[i * T + t] = d;
            const float sv = st.s[os + i];
            st.s[os + i] = sv + theta_k * (d - sv);
        }
        __syncthreads();
        {  // push the block's wd rows to every peer
            const int n4 = (sl.phi - sl.plo) * T / 4;
            float4* src = reinterpret_cast<float4*>(wd + (long long)sl.plo * T);
            for (int e = tid; e < (sl.C - 1) * n4; e += kThreads) {
                const int q = e / n4, x = e - q * n4;
                const int peer = (sl.rank + 1 + q) % sl.C;
                cl.map_shared_rank(src, peer)[x] = src[x];
            }
        }
        cl.sync();
        // (B) d = -(wd D) for the block's columns, projection, y_prev = y,
        // restart partials
        float rsum = 0.0f;
        const int cpp = kCols * tpg;  // columns per pass
        for (int p0 = sl.lo; p0 < sl.hi; p0 += cpp) {
            const int pend = min(sl.hi, p0 + cpp);
            if constexpr (kTier == gpad_mma::kHighest) {
                float acc[kCols][T];
                gpad_tiled::product_rows<T, kCols, rows_in_flight<T>()>(
                    D, m_h, j_lo, j_hi, p0 + kCols * lt, pend, wd, acc);
#pragma unroll
                for (int tt = 0; tt < T; ++tt)
#pragma unroll
                    for (int q = 0; q < kCols; ++q)
                        red[(g * T + tt) * cpp + kCols * lt + q] = acc[q][tt];
            } else {
                // the group's warps take its pass's columns in strips
                gpad_tiled::mma_strip<kTier, T>(
                    D, m_h, j_lo, j_hi, p0 + gpad_tiled::kStripCols * (lt >> 5),
                    pend, wd, [&](int col, int s, float v) {
                        red[(g * T + s) * cpp + col - p0] = v;
                    });
            }
            __syncthreads();
            if (valid)
                for (int i = p0 + lc; i < pend; i += tps) {
                    const int x = i - p0;
                    float a = 0.0f;
                    for (int gg = 0; gg < groups; ++gg)
                        a += red[(gg * T + t) * cpp + x];
                    const float wp = st.w[o + i], wm = st.w[o + m_h + i];
                    const float yp = st.y[o + i], ym = st.y[o + m_h + i];
                    float wps = wp, wms = wm;
                    if constexpr (kSoft) {
                        // damped apart from the sums (od = 1: the hard
                        // rows' results, bit for bit)
                        wps = __fmul_rn(wp, od[i]);
                        wms = __fmul_rn(wm, od[i]);
                    }
                    const float ypn = fmaxf(wps - a + st.c[o + i], 0.0f);
                    const float ymn = fmaxf(wms + a + st.c[o + m_h + i], 0.0f);
                    // the restart test keeps the undamped w
                    rsum += (wp - ypn) * (ypn - yp) + (wm - ymn) * (ymn - ym);
                    st.yprev[o + i] = yp;
                    st.yprev[o + m_h + i] = ym;
                    st.y[o + i] = ypn;
                    st.y[o + m_h + i] = ymn;
                }
            __syncthreads();  // red is rewritten by the next pass
        }
        if (restart) {  // the block's partial per scenario, then to every peer
            for (int off = 16; off > 0; off >>= 1)
                rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
            if (lane == 0) rpart[warp] = rsum;
            __syncthreads();
            if (tid < T) {
                constexpr int wps = kWarps / T;  // warps per scenario
                float bp = 0.0f;
                for (int q = 0; q < wps; ++q) bp += rpart[tid * wps + q];
                for (int q = 0; q < sl.C; ++q)
                    *cl.map_shared_rank(rcl + sl.rank * T + tid, q) = bp;
            }
        }
        cl.sync();
    }
}

// Copy the block's columns of the tile's (B, 2, m_h) rows from src (stride
// 0: one row shared by every scenario; null: zeros) into dst.
__device__ void fill_pairs(float* dst, const float* __restrict__ src,
                           long long stride, int m_h, long long b0, int nv,
                           const Slice& sl)
{
    const int W = sl.hi - sl.lo;
    const long long h = 2LL * m_h;
    for (int idx = threadIdx.x; idx < nv * 2 * W; idx += kThreads) {
        const int t = idx / (2 * W), r = idx - t * 2 * W;
        const int half = r / W, i = sl.lo + r - half * W;
        const long long off = half * (long long)m_h + i;
        dst[(b0 + t) * h + off] = src ? src[(b0 + t) * stride + off] : 0.0f;
    }
}

__device__ void fill_rows(float* dst, const float* __restrict__ src, int m_h,
                          long long b0, int nv, const Slice& sl)
{
    const int W = sl.hi - sl.lo;
    for (int idx = threadIdx.x; idx < nv * W; idx += kThreads) {
        const int t = idx / W, i = sl.lo + idx - t * W;
        const long long off = (b0 + t) * m_h + i;
        dst[off] = src ? src[off] : 0.0f;
    }
}

template <int T, int kTier, bool kSoft>
__global__ void __launch_bounds__(kThreads, 1)
gpad_dual_tiled_kernel(
    const float* __restrict__ D,      // (m_h, m_h)
    const float* __restrict__ od,     // (m_h,) or null (no soft rows)
    const float* __restrict__ c,      // (B, 2, m_h) relu offsets c+-
    const float* __restrict__ y0,     // (., 2, m_h) or null (cold start)
    long long y0_stride,              // 0 (one y0 for all) or 2 m_h
    const float* __restrict__ theta,  // (>= iterations,) unless restart
    const float* __restrict__ beta,
    int B, int m_h, int iterations, int restart,
    float* s_out,                     // (B, m_h)
    float* y_out,                     // (B, 2, m_h)
    float* yprev_buf,                 // (B, 2, m_h) scratch
    float* w_out)                     // (B, 2, m_h): the last w (or scratch)
{
    extern __shared__ float4 smem4[];
    const cg::cluster_group cl = cg::this_cluster();
    const Slice sl = make_slice(m_h, cl);
    const long long b0 = (long long)(blockIdx.x / sl.C) * T;
    const int nv = (int)min((long long)T, B - b0);
    fill_pairs(y_out, y0, y0_stride, m_h, b0, nv, sl);
    fill_pairs(yprev_buf, y0, y0_stride, m_h, b0, nv, sl);  // y_prev = y0
    fill_pairs(w_out, nullptr, 0, m_h, b0, nv, sl);          // an empty loop's w
    fill_rows(s_out, nullptr, m_h, b0, nv, sl);
    cl.sync();  // every block of the cluster has started (its wd exists)
    float th = 1.0f, thp = 1.0f;
    const State st{c, y_out, yprev_buf, w_out, s_out};
    dual_tiled_iterations<T, kTier, kSoft>(
        D, od, st, B, m_h, b0, 0, iterations, theta, beta, restart != 0, th,
        thp, reinterpret_cast<float*>(smem4), sl, cl);
}

template <int T, int kTier, bool kSoft>
__global__ void __launch_bounds__(kThreads, 1)
gpad_dual_tiled_chunk_kernel(
    const float* __restrict__ D, const float* __restrict__ od,
    const float* __restrict__ c,
    const float* __restrict__ y_in,      // (B, 2, m_h)
    const float* __restrict__ yprev_in,  // (B, 2, m_h)
    const float* __restrict__ s_in,      // (B, m_h)
    const float* __restrict__ mom_in,    // (B, 2): (th, th_prev)
    const float* __restrict__ theta,     // (>= k0 + chunk,) unless restart
    const float* __restrict__ beta,
    int B, int m_h, int k0, int chunk, int restart,
    float* y_out, float* yprev_out, float* s_out,
    float* __restrict__ mom_out,         // (B, 2)
    float* w_out)                        // (B, 2, m_h)
{
    extern __shared__ float4 smem4[];
    const cg::cluster_group cl = cg::this_cluster();
    const Slice sl = make_slice(m_h, cl);
    const long long b0 = (long long)(blockIdx.x / sl.C) * T;
    const int nv = (int)min((long long)T, B - b0);
    fill_pairs(y_out, y_in, 2LL * m_h, m_h, b0, nv, sl);
    fill_pairs(yprev_out, yprev_in, 2LL * m_h, m_h, b0, nv, sl);
    fill_pairs(w_out, nullptr, 0, m_h, b0, nv, sl);
    fill_rows(s_out, s_in, m_h, b0, nv, sl);
    cl.sync();
    const int t = threadIdx.x / (kThreads / T);
    const bool valid = t < nv;
    float th = valid ? mom_in[2 * (b0 + t)] : 1.0f;
    float thp = valid ? mom_in[2 * (b0 + t) + 1] : 1.0f;
    const State st{c, y_out, yprev_out, w_out, s_out};
    dual_tiled_iterations<T, kTier, kSoft>(
        D, od, st, B, m_h, b0, k0, chunk, theta, beta, restart != 0, th, thp,
        reinterpret_cast<float*>(smem4), sl, cl);
    if (sl.rank == 0 && valid && threadIdx.x % (kThreads / T) == 0) {
        mom_out[2 * (b0 + t)] = th;
        mom_out[2 * (b0 + t) + 1] = thp;
    }
}

// Launch `kernel` on clusters of `cluster` blocks, one cluster per tile of
// T scenarios.
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

bool bad_launch(int B, int m_h, int log2_tile, int cluster, int smem)
{
    if (B < 1 || m_h < 1 || log2_tile < 0 || log2_tile > 4) return true;
    if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
        return true;
    return 4 * smem_floats(m_h, 1 << log2_tile) > smem;
}

using FixedKernel =
    decltype(&gpad_dual_tiled_kernel<1, gpad_mma::kHighest, false>);
using ChunkKernel =
    decltype(&gpad_dual_tiled_chunk_kernel<1, gpad_mma::kHighest, false>);

// The instances of a tier, with soft rows or without, at 2**log2_tile
// scenarios per cluster (0..4)
template <int kTier, bool kSoft>
FixedKernel fixed_at(int log2_tile) {
    switch (log2_tile) {
        case 0: return gpad_dual_tiled_kernel<1, kTier, kSoft>;
        case 1: return gpad_dual_tiled_kernel<2, kTier, kSoft>;
        case 2: return gpad_dual_tiled_kernel<4, kTier, kSoft>;
        case 3: return gpad_dual_tiled_kernel<8, kTier, kSoft>;
        default: return gpad_dual_tiled_kernel<16, kTier, kSoft>;
    }
}

template <int kTier, bool kSoft>
ChunkKernel chunk_at(int log2_tile) {
    switch (log2_tile) {
        case 0: return gpad_dual_tiled_chunk_kernel<1, kTier, kSoft>;
        case 1: return gpad_dual_tiled_chunk_kernel<2, kTier, kSoft>;
        case 2: return gpad_dual_tiled_chunk_kernel<4, kTier, kSoft>;
        case 3: return gpad_dual_tiled_chunk_kernel<8, kTier, kSoft>;
        default: return gpad_dual_tiled_chunk_kernel<16, kTier, kSoft>;
    }
}

// gpad_mma::Tier's instances (soft: od given), or null for an unknown tier
template <bool kSoft>
FixedKernel fixed_of(int log2_tile, int tier) {
    using namespace gpad_mma;
    switch (tier) {
        case kHighest: return fixed_at<kHighest, kSoft>(log2_tile);
        case kHigh: return fixed_at<kHigh, kSoft>(log2_tile);
        case kDefault: return fixed_at<kDefault, kSoft>(log2_tile);
        case kBfloat16: return fixed_at<kBfloat16, kSoft>(log2_tile);
        default: return nullptr;
    }
}

template <bool kSoft>
ChunkKernel chunk_of(int log2_tile, int tier) {
    using namespace gpad_mma;
    switch (tier) {
        case kHighest: return chunk_at<kHighest, kSoft>(log2_tile);
        case kHigh: return chunk_at<kHigh, kSoft>(log2_tile);
        case kDefault: return chunk_at<kDefault, kSoft>(log2_tile);
        case kBfloat16: return chunk_at<kBfloat16, kSoft>(log2_tile);
        default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return a cudaError_t (0 on success):
// cudaErrorInvalidValue for a tile outside [0, 4], a cluster that is not a
// power of two up to 16, `smem` below the carve-up's need or an unknown
// tier, else the launch's error. `smem` is the block's dynamic shared
// memory in bytes, computed by the caller (dual_kernels.py::
// _dual_tiled_smem_bytes) so the routing guard and the launch agree. A
// cluster of `cluster` blocks owns 2**log2_tile scenarios. `od` (m_h,) is
// 1 - soft_damp, or null for hard rows. `tier` is the products' precision
// (gpad_mma::Tier: 0 "highest", 1 "high", 2 "default", 3 "bfloat16").

int gpad_dual_tiled_launch(
    const float* D, const float* od, const float* c, const float* y0,
    long long y0_stride, const float* theta, const float* beta, int B,
    int m_h, int iterations, int restart, int log2_tile, int cluster,
    float* s_out, float* y_out, float* yprev_buf, float* w_out, int smem,
    int tier, void* stream)
{
    const FixedKernel kernel = od ? fixed_of<true>(log2_tile, tier)
                                  : fixed_of<false>(log2_tile, tier);
    if (bad_launch(B, m_h, log2_tile, cluster, smem) || !kernel)
        return (int)cudaErrorInvalidValue;
    return launch(kernel, B, 1 << log2_tile, cluster, smem,
                  (cudaStream_t)stream, D, od, c, y0, y0_stride, theta, beta,
                  B, m_h, iterations, restart, s_out, y_out, yprev_buf,
                  w_out);
}

int gpad_dual_tiled_chunk_launch(
    const float* D, const float* od, const float* c, const float* y_in,
    const float* yprev_in, const float* s_in, const float* mom_in,
    const float* theta, const float* beta, int B, int m_h, int k0, int chunk,
    int restart,
    int log2_tile, int cluster, float* y_out, float* yprev_out, float* s_out,
    float* mom_out, float* w_out, int smem, int tier, void* stream)
{
    const ChunkKernel kernel = od ? chunk_of<true>(log2_tile, tier)
                                  : chunk_of<false>(log2_tile, tier);
    if (bad_launch(B, m_h, log2_tile, cluster, smem) || !kernel)
        return (int)cudaErrorInvalidValue;
    return launch(kernel, B, 1 << log2_tile, cluster, smem,
                  (cudaStream_t)stream, D, od, c, y_in, yprev_in, s_in, mom_in,
                  theta, beta, B, m_h, k0, chunk, restart, y_out, yprev_out,
                  s_out, mom_out, w_out);
}

}  // extern "C"
