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
// card's FP32 rate; D is 19.6 KB, so device memory does not bound it. The
// first design read two shared-memory words per multiply-add (a D entry
// and a wd entry), kept every state array in shared memory, ran m_h-long
// dependent chains and spent a pass and a barrier on w alone. What bounds
// this one is latency: 16 warps per SM (the register-held state allows two
// blocks), a barrier after the product, the epilogue and, under restart,
// the decision, each phase waiting on its own loads and chains; the
// product reaches about a quarter of the FP32 rate (on an H100, PERF.md:
// 0.39 ms at B = 4096 under restart, 6.4x the bound; 0.13 ms at B = 256).
//
// Design: one block of 256 threads per tile of T scenarios (T a power of
// two <= 32 with m_h T <= kMaxE 256, picked per batch by the wrapper so
// that the grid fills the card: 2 at B = 256, 16 at B = 4096). D, its rows
// padded to a multiple of 4 with zeros, is staged once into dynamic shared
// memory beside wd, the only state the product reads, laid out
// [row][scenario]. The product wd D is a register-tiled block
// product (block_product.cuh): a thread holds 4 rows x min(T, 4)
// scenarios of sums, one 16-byte load of D and of wd feeding up to 16
// multiply-adds, and m_h is split over S parts whose sums meet in shared
// memory and are added in one fixed order. The rest of the state lives in
// registers: thread tid owns the elements idx = tid + q 256 (q < kMaxE) of
// the [row][scenario] layout in every iteration, so it keeps their y+-,
// y_prev+-, s, c+-, od and wd, reads only the product's parts, and writes
// only the next wd to shared memory. w is never stored: the epilogue
// recomputes it from (y, y_prev) and, without restart, forms the next
// iteration's wd itself, so an iteration is the product and the epilogue,
// each ending in a barrier; the last iteration's w goes straight to device
// memory. Because 256 is a multiple of T, a thread's elements are all of
// scenario tid mod T, so it keeps that scenario's restart recursion (th,
// th_prev) in registers. The restart test is a reduction over the
// scenario's 2 m_h rows that every row needs before the next w: each
// thread sums its rows, the warp's lanes of one scenario combine with
// shuffles, one partial per warp goes to shared memory, and after a
// barrier every thread of the scenario adds the same 8 partials in the
// same order, so all reach the same decision; it then forms the next wd (a
// third barrier per iteration under restart).
//
// Precision: the tier is a template parameter of both kernels. "highest"
// runs the plain fp32 FMA product above; "high", "default" and "bfloat16"
// run wd D on the tensor cores (mma_product.cuh: warp tiles of 16 rows x 8
// scenarios over the same D and the same split-K scratch), as
// _make_dual_body runs _kdot at its tier. The epilogue, the restart test and
// s stay fp32 at every tier.

#include <cuda_runtime.h>

#include "block_product.cuh"
#include "mma_product.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Elements a thread owns: the wrapper keeps m_h T <= kMaxE kThreads.
constexpr int kMaxE = 6;
using gpad_block::up4;

// One block's shared memory, with mp = up4(m_h):
// 4 (m_h mp + (1 + S) mp T + kWarps T) bytes, mirrored by
// dual_kernels.py::_dual_smem_bytes.
struct Tile {
    float *D, *wd, *part, *rpart;
};

__device__ Tile carve(float* smem, int m_h, int T, int S) {
    const int mp = up4(m_h);
    Tile t;
    t.D = smem;                     // [j][i], m_h * mp
    t.wd = t.D + m_h * mp;          // w+ - w- about to be multiplied, [i][s]
    t.part = t.wd + mp * T;         // the product's partial sums, S * mp * T
    t.rpart = t.part + S * mp * T;  // restart partials: [warp][s], kWarps * T
    return t;
}

// The extrapolated point's difference, w+ - w-, at momentum b (one
// expression wherever wd is formed, so a window's first wd is the one a
// whole solve forms at the same iteration).
__device__ __forceinline__ float wdiff(float yp, float ypp, float ym,
                                       float ymp, float b) {
    return (yp + b * (yp - ypp)) - (ym + b * (ym - ymp));
}

// The state of the elements a thread owns, in registers.
struct State {
    float yp[kMaxE], ym[kMaxE], ypp[kMaxE], ymp[kMaxE], s[kMaxE],
        cp[kMaxE], cm[kMaxE], od[kMaxE], wd[kMaxE];
};

// Where a thread's element q lives: row i of scenario b0 + (tid mod T).
#define FOR_OWN(q, idx, i, hT, log2T)                                     \
    _Pragma("unroll") for (int q = 0; q < kMaxE; ++q)                    \
        if (const int idx = threadIdx.x + q * kThreads, i = idx >> log2T; \
            idx < hT)

// D (rows padded with zeros) and a zero wd in shared memory; od and c+- of
// the thread's elements; y and y_prev from (., 2, m_h) rows at `stride`
// (0: one row shared by every scenario; null: zero), s from (B, m_h) rows
// (null: zero). Scenarios past B (the ragged last tile) hold zeros.
__device__ __forceinline__ void stage(const Tile& t, State& st, const float* __restrict__ D,
                      const float* __restrict__ od,
                      const float* __restrict__ c,
                      const float* __restrict__ y,
                      const float* __restrict__ yprev, long long stride,
                      const float* __restrict__ s_in, int B, int m_h,
                      int log2T, long long b0) {
    const int mp = up4(m_h), T = 1 << log2T, hT = m_h * T;
    for (int idx = threadIdx.x; idx < m_h * mp; idx += kThreads) {
        const int j = idx / mp, i = idx - j * mp;
        t.D[idx] = i < m_h ? D[j * m_h + i] : 0.0f;
    }
    for (int idx = threadIdx.x; idx < mp * T; idx += kThreads)
        t.wd[idx] = 0.0f;  // padded rows stay zero: inert in the product
    const long long b = b0 + (threadIdx.x & (T - 1));
    const bool live = b < B;
    FOR_OWN(q, idx, i, hT, log2T) {
        st.od[q] = od ? od[i] : 1.0f;
        st.cp[q] = live ? c[b * 2 * m_h + i] : 0.0f;
        st.cm[q] = live ? c[b * 2 * m_h + m_h + i] : 0.0f;
        st.yp[q] = live && y ? y[b * stride + i] : 0.0f;
        st.ym[q] = live && y ? y[b * stride + m_h + i] : 0.0f;
        st.ypp[q] = live && yprev ? yprev[b * stride + i] : 0.0f;
        st.ymp[q] = live && yprev ? yprev[b * stride + m_h + i] : 0.0f;
        st.s[q] = live && s_in ? s_in[b * m_h + i] : 0.0f;
    }
}

// The thread's elements back to (B, 2, m_h) / (B, m_h) rows (null: not
// wanted).
__device__ __forceinline__ void store_state(const State& st, float* __restrict__ y_out,
                            float* __restrict__ yprev_out,
                            float* __restrict__ s_out, int B, int m_h,
                            int log2T, long long b0) {
    const int hT = m_h << log2T;
    const long long b = b0 + (threadIdx.x & ((1 << log2T) - 1));
    if (b >= B) return;
    FOR_OWN(q, idx, i, hT, log2T) {
        y_out[b * 2 * m_h + i] = st.yp[q];
        y_out[b * 2 * m_h + m_h + i] = st.ym[q];
        if (yprev_out) {
            yprev_out[b * 2 * m_h + i] = st.ypp[q];
            yprev_out[b * 2 * m_h + m_h + i] = st.ymp[q];
        }
        s_out[b * m_h + i] = st.s[q];
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
// by both kernels), on the staged state after a barrier. (th, thp) is this
// thread's scenario's restart recursion; on return `st`, th and thp hold
// the state after iteration n - 1 with its restart decision applied, and
// w_out (B, 2, m_h), if given, the extrapolated point of iteration n - 1
// (zeros when n is 0). The product runs at kTier (gpad_mma::Tier).
template <int ST, int kTier>
__device__ __forceinline__ void dual_iterations(const Tile& t, State& st, int m_h, int log2T,
                                int S, int k0, int n,
                                const float* __restrict__ theta,
                                const float* __restrict__ beta, bool restart,
                                float& th, float& thp,
                                float* __restrict__ w_out, int B,
                                long long b0) {
    const int T = 1 << log2T, hT = m_h * T, mp = up4(m_h);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int me = tid & (T - 1);  // every element this thread owns
    const long long b = b0 + me;
    const bool live_w = w_out && b < B;
    const gpad_block::Product P =
        gpad_block::make_product<ST>(m_h, m_h, log2T, S);
    // wd at momentum bm of every element, y_prev = y first where reset
    auto extrapolate = [&](float bm, bool reset) {
        FOR_OWN(q, idx, i, hT, log2T) {
            if (reset) {
                st.ypp[q] = st.yp[q];
                st.ymp[q] = st.ym[q];
            }
            st.wd[q] = wdiff(st.yp[q], st.ypp[q], st.ym[q], st.ymp[q], bm);
            t.wd[idx] = st.wd[q];
        }
    };
    // iteration k0's extrapolated point: a window starts after its
    // predecessor's last decision, so none is taken here
    if (n > 0) {
        extrapolate(restart ? th * (1.0f / thp - 1.0f) : beta[k0], false);
    } else if (live_w) {
        FOR_OWN(q, idx, i, hT, log2T) {
            w_out[b * 2 * m_h + i] = 0.0f;
            w_out[b * 2 * m_h + m_h + i] = 0.0f;
        }
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
        const float theta_k = restart ? th : theta[k0 + k];
        const float beta_k = restart ? th * (1.0f / thp - 1.0f) : beta[k0 + k];
        const bool last = k + 1 == n;
        const float b_next = restart || last ? 0.0f : beta[k0 + k + 1];
        // d = -(wd D): each part's sums into t.part
        if constexpr (kTier == gpad_mma::kHighest)
            gpad_block::block_product<4, ST, kThreads>(
                t.D, mp, t.wd, log2T, P, t.part,
                [](int, int, const float (&)[ST]) {});
        else
            gpad_mma::mma_product<kTier, kThreads>(t.D, mp, t.wd, log2T, m_h,
                                                   m_h, S, t.part);
        __syncthreads();
        // projection, s, the restart partials, and (no restart) next wd
        float rsum = 0.0f;
        FOR_OWN(q, idx, i, hT, log2T) {
            float acc[1];
            gpad_block::sum_parts<1>(t.part, mp * T, S, idx, acc);
            const float yp = st.yp[q], ym = st.ym[q], o = st.od[q];
            const float wp = yp + beta_k * (yp - st.ypp[q]);
            const float wm = ym + beta_k * (ym - st.ymp[q]);
            const float ypn = fmaxf(wp * o - acc[0] + st.cp[q], 0.0f);
            const float ymn = fmaxf(wm * o + acc[0] + st.cm[q], 0.0f);
            st.s[q] += theta_k * (st.wd[q] - st.s[q]);
            // the restart test keeps the undamped w
            rsum += (wp - ypn) * (ypn - yp) + (wm - ymn) * (ymn - ym);
            st.ypp[q] = yp;
            st.ymp[q] = ym;
            st.yp[q] = ypn;
            st.ym[q] = ymn;
            if (last && live_w) {
                w_out[b * 2 * m_h + i] = wp;
                w_out[b * 2 * m_h + m_h + i] = wm;
            }
            if (!restart && !last) {
                st.wd[q] = wdiff(ypn, yp, ymn, ym, b_next);
                t.wd[idx] = st.wd[q];
            }
        }
        if (restart) {  // uniform over the block: every lane shuffles
            for (int off = T; off < 32; off <<= 1)
                rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
            if (lane < T) t.rpart[warp * T + lane] = rsum;
        }
        __syncthreads();
        if (restart) {
            // this iteration's decision: y_prev = y where it fired; then
            // the next iteration's wd
            const bool reset = restart_step(t, T, me, th, thp);
            if (last) {
                FOR_OWN(q, idx, i, hT, log2T) {
                    if (reset) {
                        st.ypp[q] = st.yp[q];
                        st.ymp[q] = st.ym[q];
                    }
                }
            } else {
                extrapolate(th * (1.0f / thp - 1.0f), reset);
            }
            __syncthreads();
        }
    }
}

template <int ST, int kTier>
__global__ void __launch_bounds__(kThreads, 2)
gpad_dual_kernel(
    const float* __restrict__ D,      // (m_h, m_h)
    const float* __restrict__ od,     // (m_h,) or null (no soft rows)
    const float* __restrict__ c,      // (B, 2, m_h) relu offsets c+-
    const float* __restrict__ y0,     // (., 2, m_h) or null (cold start)
    long long y0_stride,              // 0 (one y0 for all) or 2 m_h
    const float* __restrict__ theta,  // (>= iterations,) unless restart
    const float* __restrict__ beta,
    int B, int m_h, int iterations, int restart, int log2T, int S,
    float* __restrict__ s_out,        // (B, m_h)
    float* __restrict__ y_out,        // (B, 2, m_h)
    float* __restrict__ w_out)        // (B, 2, m_h) or null (no diagnostics)
{
    extern __shared__ float4 smem4[];
    const long long b0 = (long long)blockIdx.x << log2T;
    const Tile t = carve(reinterpret_cast<float*>(smem4), m_h, 1 << log2T, S);
    State st;
    // y_prev = y0
    stage(t, st, D, od, c, y0, y0, y0_stride, nullptr, B, m_h, log2T, b0);
    __syncthreads();
    float th = 1.0f, thp = 1.0f;
    dual_iterations<ST, kTier>(t, st, m_h, log2T, S, 0, iterations, theta,
                               beta, restart != 0, th, thp, w_out, B, b0);
    store_state(st, y_out, nullptr, s_out, B, m_h, log2T, b0);
}

template <int ST, int kTier>
__global__ void __launch_bounds__(kThreads, 2)
gpad_dual_chunk_kernel(
    const float* __restrict__ D, const float* __restrict__ od,
    const float* __restrict__ c,
    const float* __restrict__ y_in,      // (B, 2, m_h)
    const float* __restrict__ yprev_in,  // (B, 2, m_h)
    const float* __restrict__ s_in,      // (B, m_h)
    const float* __restrict__ mom_in,    // (B, 2): (th, th_prev)
    const float* __restrict__ theta,     // (>= k0 + chunk,) unless restart
    const float* __restrict__ beta,
    int B, int m_h, int k0, int chunk, int restart, int log2T, int S,
    float* __restrict__ y_out, float* __restrict__ yprev_out,
    float* __restrict__ s_out, float* __restrict__ mom_out,
    float* __restrict__ w_out)           // (B, 2, m_h)
{
    extern __shared__ float4 smem4[];
    const int T = 1 << log2T;
    const long long b0 = (long long)blockIdx.x << log2T;
    const Tile t = carve(reinterpret_cast<float*>(smem4), m_h, T, S);
    State st;
    stage(t, st, D, od, c, y_in, yprev_in, 2LL * m_h, s_in, B, m_h, log2T,
          b0);
    __syncthreads();
    const int tid = threadIdx.x;
    const long long b = b0 + (tid & (T - 1));
    float th = b < B ? mom_in[2 * b] : 1.0f;
    float thp = b < B ? mom_in[2 * b + 1] : 1.0f;
    dual_iterations<ST, kTier>(t, st, m_h, log2T, S, k0, chunk, theta, beta,
                               restart != 0, th, thp, w_out, B, b0);
    store_state(st, y_out, yprev_out, s_out, B, m_h, log2T, b0);
    if (tid < T && b < B) {  // thread s holds scenario s's recursion
        mom_out[2 * b] = th;
        mom_out[2 * b + 1] = thp;
    }
}

int grid_of(int B, int log2T) { return (B + (1 << log2T) - 1) >> log2T; }

using FixedKernel = decltype(&gpad_dual_kernel<1, gpad_mma::kHighest>);
using ChunkKernel = decltype(&gpad_dual_chunk_kernel<1, gpad_mma::kHighest>);

// The instances of a tier (gpad_mma::Tier), or null for an unknown one:
// "highest" by a thread's product tile of min(T, 4) scenarios; the tiers'
// warp tiles take any T.
FixedKernel fixed_of(int log2T, int tier) {
    using namespace gpad_mma;
    switch (tier) {
    case kHighest:
        return log2T == 0 ? gpad_dual_kernel<1, kHighest>
             : log2T == 1 ? gpad_dual_kernel<2, kHighest>
                          : gpad_dual_kernel<4, kHighest>;
    case kHigh: return gpad_dual_kernel<1, kHigh>;
    case kDefault: return gpad_dual_kernel<1, kDefault>;
    case kBfloat16: return gpad_dual_kernel<1, kBfloat16>;
    default: return nullptr;
    }
}

ChunkKernel chunk_of(int log2T, int tier) {
    using namespace gpad_mma;
    switch (tier) {
    case kHighest:
        return log2T == 0 ? gpad_dual_chunk_kernel<1, kHighest>
             : log2T == 1 ? gpad_dual_chunk_kernel<2, kHighest>
                          : gpad_dual_chunk_kernel<4, kHighest>;
    case kHigh: return gpad_dual_chunk_kernel<1, kHigh>;
    case kDefault: return gpad_dual_chunk_kernel<1, kDefault>;
    case kBfloat16: return gpad_dual_chunk_kernel<1, kBfloat16>;
    default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a plan or a tier the kernels do
// not take. `smem` is the block's dynamic shared memory in bytes and
// `split` the product's parts, computed by the caller
// (dual_kernels.py::_dual_plan, _dual_smem_bytes) so the routing guard and
// the launch agree; log2_tile must be in [0, 5], split >= 1, and m_h
// 2**log2_tile <= kMaxE kThreads. `tier` is the product's precision
// (gpad_mma::Tier: 0 "highest", 1 "high", 2 "default", 3 "bfloat16").

static bool takes(int m_h, int log2_tile, int split) {
    return log2_tile >= 0 && log2_tile <= 5 && split >= 1
           && (long long)m_h << log2_tile <= (long long)kMaxE * kThreads;
}

int gpad_dual_launch(
    const float* D, const float* od, const float* c, const float* y0,
    long long y0_stride, const float* theta, const float* beta,
    int B, int m_h, int iterations, int restart, int log2_tile, int split,
    float* s_out, float* y_out, float* w_out, int smem, int tier,
    void* stream)
{
    const auto kernel = fixed_of(log2_tile, tier);
    if (!takes(m_h, log2_tile, split) || !kernel)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid_of(B, log2_tile), kThreads, (size_t)smem,
             (cudaStream_t)stream>>>(
        D, od, c, y0, y0_stride, theta, beta, B, m_h, iterations, restart,
        log2_tile, split, s_out, y_out, w_out);
    return (int)cudaGetLastError();
}

int gpad_dual_chunk_launch(
    const float* D, const float* od, const float* c, const float* y_in,
    const float* yprev_in, const float* s_in, const float* mom_in,
    const float* theta, const float* beta,
    int B, int m_h, int k0, int chunk, int restart, int log2_tile, int split,
    float* y_out, float* yprev_out, float* s_out, float* mom_out,
    float* w_out, int smem, int tier, void* stream)
{
    const auto kernel = chunk_of(log2_tile, tier);
    if (!takes(m_h, log2_tile, split) || !kernel)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid_of(B, log2_tile), kThreads, (size_t)smem,
             (cudaStream_t)stream>>>(
        D, od, c, y_in, yprev_in, s_in, mom_in, theta, beta, B, m_h, k0,
        chunk, restart, log2_tile, split, y_out, yprev_out, s_out, mom_out,
        w_out);
    return (int)cudaGetLastError();
}

}  // extern "C"
