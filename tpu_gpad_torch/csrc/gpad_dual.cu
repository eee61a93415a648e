// Dual-form GPAD: a whole fixed-budget solve, or one eps check window, per
// launch.
//
// Replaces tpu_gpad/solver/kernels.py::_gpad_kernel_dual (the Pallas TPU
// kernel behind gpad_pallas_fixed_dual) and ::_gpad_kernel_dual_chunk
// (behind _dual_chunk_call and the eps loop gpad_pallas_eps_dual). Both
// TPU kernels run one iteration body, _make_dual_body; here both kernels run
// dual_iterations(). Per scenario, for each iteration k:
//
//   w+-  = y+- + beta_k (y+- - y+-_prev)
//   wd   = w+ - w-
//   d    = -(wd D)                               D (m_h, m_h)
//   y+   = relu(w+ od + d + c+),  y- = relu(w- od - d + c-)
//   s    = s + theta_k (wd - s)
//
// c+- = p_D+- -+ g_P GL_T is folded by the caller; od is 1 - soft_damp (1
// without soft rows). Without restart theta_k/beta_k are the schedule's
// entries k0 + k. With restart they come from the scenario's own recursion
// (th, th_prev), and when r = sum (w - y_next)(y_next - y) over both halves
// is > 0 the recursion resets (th = th_prev = 1) and y_prev = y_next; the
// schedule arrays are then never read, so the budget may exceed them.
//
// What bounds it: at the headline shape (battery n3 N10, m_h = 70) an
// iteration is 2 m_h^2 = 9.8 kFLOP per scenario, so a B = 4096,
// 100-iteration solve is 4 GFLOP, a few hundredths of a millisecond at the
// card's FP32 rate; D is 19.6 KB. Each multiply-add reads two shared-memory
// words (a D entry and a wd entry), so the kernel is bounded by
// shared-memory traffic, the latency of the m_h-long dependent FMA chains
// and the two barriers per iteration, not by the FP32 rate or device memory.
//
// Design: one block of 256 threads per tile of T scenarios (T a power of two
// <= 32; the wrapper takes at most 8, as for the flat kernel). D and od are
// staged once into dynamic shared memory, and every per-scenario array lives
// there too, laid out [row][scenario] so a warp reads neighbouring scenarios
// of a few rows while the D words are broadcasts; c+- is staged once since
// it is constant over the loop. Because 256 is a multiple of T, a thread
// always works on the same scenario (tid mod T), so it keeps that scenario's
// restart recursion (th, th_prev) in registers. The restart test is a
// reduction over the scenario's 2 m_h rows that every row needs before the
// next step 1: each thread sums its rows, the warp's lanes of one scenario
// combine with shuffles, and one partial per warp goes to shared memory
// before the barrier that ends the iteration. After it, every thread of the
// scenario adds the same 8 partials in the same order, so all reach the
// same decision without a third barrier. An iteration is two phases, each
// ending in a barrier: (A) the previous iteration's restart decision and
// w; (B) the product, projection, s update and restart partials. Products
// are plain fp32 FMA (precision "highest"); TF32, tensor cores and register
// blocking are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One block's shared memory: 4 (m_h^2 + m_h + 10 m_h T + kWarps T) bytes,
// mirrored by dual_kernels.py::_dual_smem_bytes.
struct Tile {
    float *D, *od, *cp, *cm, *yp, *ym, *ypp, *ymp, *wp, *wm, *wd, *s, *rpart;
};

__device__ Tile carve(float* smem, int m_h, int T) {
    const int hT = m_h * T;
    Tile t;
    t.D = smem;                 // [j][i], m_h * m_h
    t.od = t.D + m_h * m_h;     // m_h
    t.cp = t.od + m_h;          // each dual array: [i][s], m_h * T
    t.cm = t.cp + hT;
    t.yp = t.cm + hT;
    t.ym = t.yp + hT;
    t.ypp = t.ym + hT;          // y_prev
    t.ymp = t.ypp + hT;
    t.wp = t.ymp + hT;
    t.wm = t.wp + hT;
    t.wd = t.wm + hT;
    t.s = t.wd + hT;
    t.rpart = t.s + hT;         // restart partials: [warp][s], kWarps * T
    return t;
}

// (B, 2, m_h) rows into [i][s] arrays (+ half into p, - half into m).
// `stride` is 2 m_h, or 0 for one row shared by every scenario; a null
// source and scenarios past B (the ragged last tile) read as zero.
__device__ void load_pair(float* p, float* m, const float* __restrict__ src,
                          long long stride, int B, int m_h, int log2T,
                          long long b0) {
    const int T = 1 << log2T;
    for (int idx = threadIdx.x; idx < 2 * m_h * T; idx += kThreads) {
        const int s = idx / (2 * m_h), r = idx - s * 2 * m_h;
        const int side = r >= m_h, i = r - side * m_h;
        const long long b = b0 + s;
        const float v = (src && b < B) ? src[b * stride + r] : 0.0f;
        (side ? m : p)[i * T + s] = v;
    }
}

__device__ void store_pair(float* __restrict__ dst, const float* p,
                           const float* m, int B, int m_h, int log2T,
                           long long b0) {
    const int T = 1 << log2T;
    for (int idx = threadIdx.x; idx < 2 * m_h * T; idx += kThreads) {
        const int s = idx / (2 * m_h), r = idx - s * 2 * m_h;
        const int side = r >= m_h, i = r - side * m_h;
        const long long b = b0 + s;
        if (b < B) dst[b * 2 * m_h + r] = (side ? m : p)[i * T + s];
    }
}

// (B, m_h) rows into an [i][s] array and back.
__device__ void load_rows(float* a, const float* __restrict__ src, int B,
                          int m_h, int log2T, long long b0) {
    const int T = 1 << log2T;
    for (int idx = threadIdx.x; idx < m_h * T; idx += kThreads) {
        const int s = idx / m_h, i = idx - s * m_h;
        const long long b = b0 + s;
        a[i * T + s] = (src && b < B) ? src[b * m_h + i] : 0.0f;
    }
}

__device__ void store_rows(float* __restrict__ dst, const float* a, int B,
                           int m_h, int log2T, long long b0) {
    const int T = 1 << log2T;
    for (int idx = threadIdx.x; idx < m_h * T; idx += kThreads) {
        const int s = idx / m_h, i = idx - s * m_h;
        const long long b = b0 + s;
        if (b < B) dst[b * m_h + i] = a[i * T + s];
    }
}

// D, od and c+- of the block's scenarios; w starts at zero (it is what an
// empty loop returns).
__device__ void stage_constants(const Tile& t, const float* __restrict__ D,
                                const float* __restrict__ od,
                                const float* __restrict__ c, int B, int m_h,
                                int log2T, long long b0) {
    for (int idx = threadIdx.x; idx < m_h * m_h; idx += kThreads)
        t.D[idx] = D[idx];
    for (int i = threadIdx.x; i < m_h; i += kThreads)
        t.od[i] = od ? od[i] : 1.0f;
    load_pair(t.cp, t.cm, c, 2LL * m_h, B, m_h, log2T, b0);
    for (int idx = threadIdx.x; idx < m_h << log2T; idx += kThreads) {
        t.wp[idx] = 0.0f;
        t.wm[idx] = 0.0f;
    }
}

// The restart decision of scenario `me` from the partials of the iteration
// that just ended, then the momentum recursion's step.
__device__ __forceinline__ bool restart_step(const Tile& t, int T, int me,
                                             float& th, float& thp) {
    float r = 0.0f;
    for (int w = 0; w < kWarps; ++w) r += t.rpart[w * T + me];
    const bool reset = r > 0.0f;
    if (reset) {
        th = 1.0f;
        thp = 1.0f;
    } else {
        const float next = th * (sqrtf(th * th + 4.0f) - th) * 0.5f;
        thp = th;
        th = next;
    }
    return reset;
}

// `n` iterations from schedule index k0 on the block's tile (the body shared
// by both kernels). (th, thp) is this thread's scenario's restart
// recursion; on return the state arrays, th and thp hold the state after
// iteration n - 1 with its restart decision applied, and w that iteration's
// extrapolated point. Ends with a barrier.
__device__ void dual_iterations(const Tile& t, int m_h, int log2T, int k0,
                                int n, const float* __restrict__ theta,
                                const float* __restrict__ beta, bool restart,
                                float& th, float& thp) {
    const int T = 1 << log2T, tmask = T - 1, hT = m_h * T;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int me = tid & tmask;  // every row this thread touches is scenario me
    for (int k = 0; k <= n; ++k) {
        // (A) iteration k - 1's restart decision: y_prev = y where it fired
        const bool reset = restart && k > 0 && restart_step(t, T, me, th, thp);
        if (k == n) {
            if (reset)
                for (int idx = tid; idx < hT; idx += kThreads) {
                    t.ypp[idx] = t.yp[idx];
                    t.ymp[idx] = t.ym[idx];
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
        for (int idx = tid; idx < hT; idx += kThreads) {
            const float yp = t.yp[idx], ym = t.ym[idx];
            const float ypp = reset ? yp : t.ypp[idx];
            const float ymp = reset ? ym : t.ymp[idx];
            const float wp = yp + beta_k * (yp - ypp);
            const float wm = ym + beta_k * (ym - ymp);
            t.wp[idx] = wp;
            t.wm[idx] = wm;
            t.wd[idx] = wp - wm;
        }
        __syncthreads();
        // (B) d = -(wd D), projection, s, and the restart partials
        float rsum = 0.0f;
        for (int idx = tid; idx < hT; idx += kThreads) {
            const int i = idx >> log2T, s = idx & tmask;
            float acc = 0.0f;
            for (int j = 0; j < m_h; ++j)
                acc = fmaf(t.wd[j * T + s], t.D[j * m_h + i], acc);
            const float o = t.od[i];
            const float wp = t.wp[idx], wm = t.wm[idx];
            const float yp = t.yp[idx], ym = t.ym[idx];
            const float ypn = fmaxf(wp * o - acc + t.cp[idx], 0.0f);
            const float ymn = fmaxf(wm * o + acc + t.cm[idx], 0.0f);
            const float sv = t.s[idx];
            t.s[idx] = sv + theta_k * (t.wd[idx] - sv);
            // the restart test keeps the undamped w
            rsum += (wp - ypn) * (ypn - yp) + (wm - ymn) * (ymn - ym);
            t.ypp[idx] = yp;
            t.ymp[idx] = ym;
            t.yp[idx] = ypn;
            t.ym[idx] = ymn;
        }
        if (restart) {  // uniform over the block: every lane shuffles
            for (int off = T; off < 32; off <<= 1)
                rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
            if (lane < T) t.rpart[warp * T + lane] = rsum;
        }
        __syncthreads();
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
gpad_dual_kernel(
    const float* __restrict__ D,      // (m_h, m_h)
    const float* __restrict__ od,     // (m_h,) or null (no soft rows)
    const float* __restrict__ c,      // (B, 2, m_h) relu offsets c+-
    const float* __restrict__ y0,     // (., 2, m_h) or null (cold start)
    long long y0_stride,              // 0 (one y0 for all) or 2 m_h
    const float* __restrict__ theta,  // (>= iterations,) unless restart
    const float* __restrict__ beta,
    int B, int m_h, int iterations, int restart, int log2T,
    float* __restrict__ s_out,        // (B, m_h)
    float* __restrict__ y_out,        // (B, 2, m_h)
    float* __restrict__ w_out)        // (B, 2, m_h) or null (no diagnostics)
{
    extern __shared__ float smem[];
    const long long b0 = (long long)blockIdx.x << log2T;
    const Tile t = carve(smem, m_h, 1 << log2T);
    stage_constants(t, D, od, c, B, m_h, log2T, b0);
    load_pair(t.yp, t.ym, y0, y0_stride, B, m_h, log2T, b0);
    load_pair(t.ypp, t.ymp, y0, y0_stride, B, m_h, log2T, b0);  // y_prev = y0
    load_rows(t.s, nullptr, B, m_h, log2T, b0);
    __syncthreads();
    float th = 1.0f, thp = 1.0f;
    dual_iterations(t, m_h, log2T, 0, iterations, theta, beta, restart != 0,
                    th, thp);
    store_rows(s_out, t.s, B, m_h, log2T, b0);
    store_pair(y_out, t.yp, t.ym, B, m_h, log2T, b0);
    if (w_out) store_pair(w_out, t.wp, t.wm, B, m_h, log2T, b0);
}

__global__ void __launch_bounds__(kThreads)
gpad_dual_chunk_kernel(
    const float* __restrict__ D, const float* __restrict__ od,
    const float* __restrict__ c,
    const float* __restrict__ y_in,      // (B, 2, m_h)
    const float* __restrict__ yprev_in,  // (B, 2, m_h)
    const float* __restrict__ s_in,      // (B, m_h)
    const float* __restrict__ mom_in,    // (B, 2): (th, th_prev)
    const float* __restrict__ theta,     // (>= k0 + chunk,) unless restart
    const float* __restrict__ beta,
    int B, int m_h, int k0, int chunk, int restart, int log2T,
    float* __restrict__ y_out, float* __restrict__ yprev_out,
    float* __restrict__ s_out, float* __restrict__ mom_out,
    float* __restrict__ w_out)           // (B, 2, m_h)
{
    extern __shared__ float smem[];
    const int T = 1 << log2T;
    const long long b0 = (long long)blockIdx.x << log2T;
    const Tile t = carve(smem, m_h, T);
    stage_constants(t, D, od, c, B, m_h, log2T, b0);
    load_pair(t.yp, t.ym, y_in, 2LL * m_h, B, m_h, log2T, b0);
    load_pair(t.ypp, t.ymp, yprev_in, 2LL * m_h, B, m_h, log2T, b0);
    load_rows(t.s, s_in, B, m_h, log2T, b0);
    __syncthreads();
    const int tid = threadIdx.x;
    const long long b = b0 + (tid & (T - 1));
    float th = b < B ? mom_in[2 * b] : 1.0f;
    float thp = b < B ? mom_in[2 * b + 1] : 1.0f;
    dual_iterations(t, m_h, log2T, k0, chunk, theta, beta, restart != 0, th,
                    thp);
    store_pair(y_out, t.yp, t.ym, B, m_h, log2T, b0);
    store_pair(yprev_out, t.ypp, t.ymp, B, m_h, log2T, b0);
    store_rows(s_out, t.s, B, m_h, log2T, b0);
    store_pair(w_out, t.wp, t.wm, B, m_h, log2T, b0);
    if (tid < T && b < B) {  // thread s holds scenario s's recursion
        mom_out[2 * b] = th;
        mom_out[2 * b + 1] = thp;
    }
}

int grid_of(int B, int log2T) { return (B + (1 << log2T) - 1) >> log2T; }

}  // namespace

extern "C" {

// Both launchers run on `stream` and return cudaGetLastError() (0 on
// success). `smem` is the block's dynamic shared memory in bytes, computed
// by the caller (dual_kernels.py::_dual_smem_bytes) so the routing guard
// and the launch agree; log2_tile must be in [0, 5].

int gpad_dual_launch(
    const float* D, const float* od, const float* c, const float* y0,
    long long y0_stride, const float* theta, const float* beta,
    int B, int m_h, int iterations, int restart, int log2_tile,
    float* s_out, float* y_out, float* w_out, int smem, void* stream)
{
    if (log2_tile < 0 || log2_tile > 5) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gpad_dual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gpad_dual_kernel<<<grid_of(B, log2_tile), kThreads, (size_t)smem,
                       (cudaStream_t)stream>>>(
        D, od, c, y0, y0_stride, theta, beta, B, m_h, iterations, restart,
        log2_tile, s_out, y_out, w_out);
    return (int)cudaGetLastError();
}

int gpad_dual_chunk_launch(
    const float* D, const float* od, const float* c, const float* y_in,
    const float* yprev_in, const float* s_in, const float* mom_in,
    const float* theta, const float* beta,
    int B, int m_h, int k0, int chunk, int restart, int log2_tile,
    float* y_out, float* yprev_out, float* s_out, float* mom_out,
    float* w_out, int smem, void* stream)
{
    if (log2_tile < 0 || log2_tile > 5) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gpad_dual_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    gpad_dual_chunk_kernel<<<grid_of(B, log2_tile), kThreads, (size_t)smem,
                             (cudaStream_t)stream>>>(
        D, od, c, y_in, yprev_in, s_in, mom_in, theta, beta, B, m_h, k0,
        chunk, restart, log2_tile, y_out, yprev_out, s_out, mom_out, w_out);
    return (int)cudaGetLastError();
}

}  // extern "C"
