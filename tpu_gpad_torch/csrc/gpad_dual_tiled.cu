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
//   y+   = relu(w+ + d + c+),  y- = relu(w- - d + c-)
//
// c+- = p_D+- -+ g_P GL_T is folded by the caller. There are no soft rows
// (the wrappers refuse them, as tpu_gpad's tiled kernel does). Without
// restart theta_k/beta_k are the schedule's entries k0 + k; with restart
// they come from each scenario's own recursion (th, th_prev), and when
// r = sum (w - y_next)(y_next - y) over both halves is > 0 the recursion
// resets and y_prev = y_next; the schedule is then never read.
//
// What bounds it: at the flagship an iteration is 2 m_h^2 = 6.7 MFLOP per
// scenario, so B = 256 x 100 iterations is 171.5 GFLOP, 2.56 ms at the
// card's FP32 rate. Each block reads all of D once per iteration, 13.4 MB
// from L2 (D and the state fit the 50 MB L2), and does 2 T FLOP per D word
// read: at small T the L2-to-SM traffic bounds it, at large T the FMA rate
// of the few SMs that have a block.
//
// Design: one block of 512 threads owns T scenarios (T a power of two
// <= 8) for the whole launch, so the restart test, a sum over all of a
// scenario's rows, stays inside the block and no grid-wide sync is needed.
// The state (y, y_prev, w, s) lives in device memory, updated in place in
// the output tensors; column i of every per-scenario array belongs to
// thread i mod 512 in both phases, so a thread rereads only what it wrote.
// Only wd, laid out [row][scenario], sits in shared memory. Phase A forms
// w, wd and s; phase B runs the product with each thread holding up to 4
// columns x T scenarios of accumulators in registers, so one coalesced D
// load feeds T FMAs and one shared-memory read of wd feeds up to 4, then
// projects its columns and sums its restart partials. The partials go
// through a warp shuffle and one word per warp and scenario in shared
// memory; after the barrier that ends the iteration every thread adds the
// same 16 partials in the same order and reaches the same decision.
// Products are plain fp32 FMA (precision "highest"). Staging D chunks with
// TMA, clusters that share one D stream, and tensor cores are later work.

#include <cuda_runtime.h>

#include "tiled_product.cuh"

namespace {

using gpad_tiled::kThreads;
using gpad_tiled::kWarps;
using gpad_tiled::product;

// The block's view of the state: per-scenario arrays in device memory, the
// (B, 2, m_h) pairs and (B, m_h) s, updated in place.
struct State {
    const float* c;  // (B, 2, m_h) relu offsets
    float* y;
    float* yprev;
    float* w;
    float* s;
};

// `n` iterations from schedule index k0 on the block's T scenarios (the
// body shared by both kernels). th/thp are the scenarios' restart
// recursions, held by every thread alike; on return the state holds the
// state after iteration n - 1 with its restart decision applied, and w that
// iteration's extrapolated point.
template <int T>
__device__ void dual_tiled_iterations(
    const float* __restrict__ D, const State& st, int B, int m_h, long long b0,
    int k0, int n, const float* __restrict__ theta,
    const float* __restrict__ beta, bool restart, float (&th)[T],
    float (&thp)[T], float* wd, float* rpart)
{
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long h = 2LL * m_h;
    int nv = (int)(B - b0);  // valid scenarios of the tile
    if (nv > T) nv = T;
    for (int k = 0; k <= n; ++k) {
        // (A) iteration k - 1's restart decisions, then w, wd and s
        bool reset[T];
#pragma unroll
        for (int t = 0; t < T; ++t) {
            reset[t] = false;
            if (restart && k > 0) {
                float r = 0.0f;
                for (int wp = 0; wp < kWarps; ++wp) r += rpart[wp * T + t];
                reset[t] = r > 0.0f;
                if (reset[t]) {
                    th[t] = 1.0f;
                    thp[t] = 1.0f;
                } else {
                    const float next = th[t] * (sqrtf(th[t] * th[t] + 4.0f) - th[t]) * 0.5f;
                    thp[t] = th[t];
                    th[t] = next;
                }
            }
        }
        if (k == n) {  // the last decision: restarted scenarios take y_prev = y
#pragma unroll
            for (int t = 0; t < T; ++t) {
                if (t >= nv || !reset[t]) continue;
                const long long o = (b0 + t) * h;
                for (int i = tid; i < m_h; i += kThreads) {
                    st.yprev[o + i] = st.y[o + i];
                    st.yprev[o + m_h + i] = st.y[o + m_h + i];
                }
            }
            break;
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
            float theta_k, beta_k;
            if (restart) {
                theta_k = th[t];
                beta_k = th[t] * (1.0f / thp[t] - 1.0f);
            } else {
                theta_k = theta[k0 + k];
                beta_k = beta[k0 + k];
            }
            const long long o = (b0 + t) * h, os = (b0 + t) * m_h;
            for (int i = tid; i < m_h; i += kThreads) {
                if (t >= nv) {
                    wd[i * T + t] = 0.0f;
                    continue;
                }
                const float yp = st.y[o + i], ym = st.y[o + m_h + i];
                const float ypp = reset[t] ? yp : st.yprev[o + i];
                const float ymp = reset[t] ? ym : st.yprev[o + m_h + i];
                const float wp = yp + beta_k * (yp - ypp);
                const float wm = ym + beta_k * (ym - ymp);
                st.w[o + i] = wp;
                st.w[o + m_h + i] = wm;
                const float d = wp - wm;
                wd[i * T + t] = d;
                const float sv = st.s[os + i];
                st.s[os + i] = sv + theta_k * (d - sv);
            }
        }
        __syncthreads();
        // (B) d = -(wd D), projection, y_prev = y, restart partials
        float rsum[T];
#pragma unroll
        for (int t = 0; t < T; ++t) rsum[t] = 0.0f;
        auto project = [&](int i, const float (&acc)[T]) {
#pragma unroll
            for (int t = 0; t < T; ++t) {
                if (t >= nv) continue;
                const long long o = (b0 + t) * h;
                const float wp = st.w[o + i], wm = st.w[o + m_h + i];
                const float yp = st.y[o + i], ym = st.y[o + m_h + i];
                const float ypn = fmaxf(wp - acc[t] + st.c[o + i], 0.0f);
                const float ymn = fmaxf(wm + acc[t] + st.c[o + m_h + i], 0.0f);
                rsum[t] += (wp - ypn) * (ypn - yp) + (wm - ymn) * (ymn - ym);
                st.yprev[o + i] = yp;
                st.yprev[o + m_h + i] = ym;
                st.y[o + i] = ypn;
                st.y[o + m_h + i] = ymn;
            }
        };
        product<T>(D, m_h, m_h, m_h, wd, project);
        if (restart) {  // uniform over the block: every lane shuffles
#pragma unroll
            for (int t = 0; t < T; ++t) {
                float r = rsum[t];
                for (int off = 16; off > 0; off >>= 1)
                    r += __shfl_xor_sync(0xffffffffu, r, off);
                if (lane == 0) rpart[warp * T + t] = r;
            }
        }
        __syncthreads();
    }
    __syncthreads();
}

// Copy (B, 2, m_h) rows of the tile from src (stride 0: one row shared by
// every scenario; null: zeros) into dst.
__device__ void fill_pairs(float* dst, const float* __restrict__ src,
                           long long stride, int m_h, long long b0, int nv)
{
    const long long h = 2LL * m_h;
    for (int idx = threadIdx.x; idx < nv * 2 * m_h; idx += kThreads) {
        const int t = idx / (2 * m_h), r = idx - t * 2 * m_h;
        dst[(b0 + t) * h + r] = src ? src[(b0 + t) * stride + r] : 0.0f;
    }
}

__device__ void fill_rows(float* dst, const float* __restrict__ src, int m_h,
                          long long b0, int nv)
{
    for (int idx = threadIdx.x; idx < nv * m_h; idx += kThreads)
        dst[b0 * m_h + idx] = src ? src[b0 * m_h + idx] : 0.0f;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
gpad_dual_tiled_kernel(
    const float* __restrict__ D,      // (m_h, m_h)
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
    extern __shared__ float smem[];
    float* wd = smem;                  // [i][t], m_h * T
    float* rpart = wd + m_h * T;       // [warp][t], kWarps * T
    const long long b0 = (long long)blockIdx.x * T;
    const int nv = (int)min((long long)T, B - b0);
    fill_pairs(y_out, y0, y0_stride, m_h, b0, nv);
    fill_pairs(yprev_buf, y0, y0_stride, m_h, b0, nv);  // y_prev = y0
    fill_pairs(w_out, nullptr, 0, m_h, b0, nv);          // an empty loop's w
    fill_rows(s_out, nullptr, m_h, b0, nv);
    __syncthreads();
    float th[T], thp[T];
#pragma unroll
    for (int t = 0; t < T; ++t) th[t] = thp[t] = 1.0f;
    const State st{c, y_out, yprev_buf, w_out, s_out};
    dual_tiled_iterations<T>(D, st, B, m_h, b0, 0, iterations, theta, beta,
                             restart != 0, th, thp, wd, rpart);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
gpad_dual_tiled_chunk_kernel(
    const float* __restrict__ D, const float* __restrict__ c,
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
    extern __shared__ float smem[];
    float* wd = smem;
    float* rpart = wd + m_h * T;
    const long long b0 = (long long)blockIdx.x * T;
    const int nv = (int)min((long long)T, B - b0);
    fill_pairs(y_out, y_in, 2LL * m_h, m_h, b0, nv);
    fill_pairs(yprev_out, yprev_in, 2LL * m_h, m_h, b0, nv);
    fill_pairs(w_out, nullptr, 0, m_h, b0, nv);
    fill_rows(s_out, s_in, m_h, b0, nv);
    __syncthreads();
    float th[T], thp[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
        th[t] = t < nv ? mom_in[2 * (b0 + t)] : 1.0f;
        thp[t] = t < nv ? mom_in[2 * (b0 + t) + 1] : 1.0f;
    }
    const State st{c, y_out, yprev_out, w_out, s_out};
    dual_tiled_iterations<T>(D, st, B, m_h, b0, k0, chunk, theta, beta,
                             restart != 0, th, thp, wd, rpart);
    if (threadIdx.x == 0)
        for (int t = 0; t < nv; ++t) {
            mom_out[2 * (b0 + t)] = th[t];
            mom_out[2 * (b0 + t) + 1] = thp[t];
        }
}

template <int T>
int launch_fixed(const float* D, const float* c, const float* y0,
                 long long y0_stride, const float* theta, const float* beta,
                 int B, int m_h, int iterations, int restart, float* s_out,
                 float* y_out, float* yprev_buf, float* w_out, int smem,
                 cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        gpad_dual_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    gpad_dual_tiled_kernel<T><<<(B + T - 1) / T, kThreads, (size_t)smem,
                                stream>>>(
        D, c, y0, y0_stride, theta, beta, B, m_h, iterations, restart, s_out,
        y_out, yprev_buf, w_out);
    return (int)cudaGetLastError();
}

template <int T>
int launch_chunk(const float* D, const float* c, const float* y_in,
                 const float* yprev_in, const float* s_in, const float* mom_in,
                 const float* theta, const float* beta, int B, int m_h, int k0,
                 int chunk, int restart, float* y_out, float* yprev_out,
                 float* s_out, float* mom_out, float* w_out, int smem,
                 cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        gpad_dual_tiled_chunk_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gpad_dual_tiled_chunk_kernel<T><<<(B + T - 1) / T, kThreads, (size_t)smem,
                                      stream>>>(
        D, c, y_in, yprev_in, s_in, mom_in, theta, beta, B, m_h, k0, chunk,
        restart, y_out, yprev_out, s_out, mom_out, w_out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return cudaGetLastError() (0 on
// success). `smem` is the block's dynamic shared memory in bytes, computed
// by the caller (dual_kernels.py::_dual_tiled_smem_bytes) so the routing
// guard and the launch agree; log2_tile must be in [0, 3].

int gpad_dual_tiled_launch(
    const float* D, const float* c, const float* y0, long long y0_stride,
    const float* theta, const float* beta, int B, int m_h, int iterations,
    int restart, int log2_tile, float* s_out, float* y_out, float* yprev_buf,
    float* w_out, int smem, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
#define GPAD_FIXED(T)                                                         \
    return launch_fixed<T>(D, c, y0, y0_stride, theta, beta, B, m_h,          \
                           iterations, restart, s_out, y_out, yprev_buf,      \
                           w_out, smem, st)
    switch (log2_tile) {
        case 0: GPAD_FIXED(1);
        case 1: GPAD_FIXED(2);
        case 2: GPAD_FIXED(4);
        case 3: GPAD_FIXED(8);
        default: return (int)cudaErrorInvalidValue;
    }
#undef GPAD_FIXED
}

int gpad_dual_tiled_chunk_launch(
    const float* D, const float* c, const float* y_in, const float* yprev_in,
    const float* s_in, const float* mom_in, const float* theta,
    const float* beta, int B, int m_h, int k0, int chunk, int restart,
    int log2_tile, float* y_out, float* yprev_out, float* s_out,
    float* mom_out, float* w_out, int smem, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
#define GPAD_CHUNK(T)                                                         \
    return launch_chunk<T>(D, c, y_in, yprev_in, s_in, mom_in, theta, beta,   \
                           B, m_h, k0, chunk, restart, y_out, yprev_out,      \
                           s_out, mom_out, w_out, smem, st)
    switch (log2_tile) {
        case 0: GPAD_CHUNK(1);
        case 1: GPAD_CHUNK(2);
        case 2: GPAD_CHUNK(4);
        case 3: GPAD_CHUNK(8);
        default: return (int)cudaErrorInvalidValue;
    }
#undef GPAD_CHUNK
}

}  // extern "C"
