// Fixed-budget GPAD on the paired half stack, one launch per solve: two
// instances of one kernel body.
//
// The flat instance replaces tpu_gpad/solver/kernels.py::_gpad_kernel_paired_flat
// (the Pallas TPU kernel behind gpad_pallas_fixed_paired_flat); the full
// instance replaces _gpad_kernel_paired (behind gpad_pallas_fixed_paired).
// Per scenario, for each iteration k < iterations:
//
//   w+-  = y+- + beta_k (y+- - y+-_prev)
//   zhat = -MG_T' (w+ - w-) - g_P                 MG_T (m_h, n_z): all rows
//   z    = (1 - theta_k) z + theta_k zhat
//   q    = [ GL_T[:, :n_s]' zhat ; zhat / L ]     flat: box rows need no product
//   q    = GL_T' zhat                             full: every row is a product
//   y+   = relu(w+ od + q + p_D+),  y- = relu(w- od - q + p_D-)
//
// od is 1 - soft_damp (1 without soft rows). In the flat instance the dual
// rows are already in [struct | box] order (dualize puts the identity rows
// last), so no layout change happens on either side of the kernel. The full
// instance is the flat body with n_s = m_h, chosen at compile time (kFlat).
//
// What bounds it: at the headline shape (battery n3 N10: n_z = 30,
// m_h = 70, n_s = 40) a flat iteration is 2 m_h n_z + 2 n_z n_s = 6.6 kFLOP
// per scenario (full: 4 m_h n_z = 8.4 kFLOP), so a B = 4096, 100-iteration
// solve is about 2.7 GFLOP, a few hundredths of a millisecond at the card's
// FP32 rate; the operands are 13 KB (full: 17 KB), so device memory does
// not bound it. The first design read two shared-memory words per
// multiply-add, kept every state array in shared memory and ran 8
// scenarios per block (32 blocks at the serving batch B = 256). What
// bounds this one is latency: a barrier after each of four phases, each
// waiting on its own loads and chains, as in the dense and dual kernels.
//
// Design: one block of 256 threads per tile of T scenarios (T a power of
// two <= 16, picked per batch by the wrapper so that the grid fills the
// card: 2 at B = 256, 16 at B = 4096). MG_T and GL_T[:, :n_s] are staged
// once into dynamic shared memory with their rows padded to a multiple of
// 4 (zeros), beside wd and zhat, the two arrays the products read, laid
// out [row][scenario]. Both products are register-tiled block products
// (block_product.cuh): a thread holds 4 rows x min(T, 4) scenarios of
// sums, one 16-byte load of the operand and of the state feeding up to 16
// multiply-adds, and K is split over S parts whose sums meet in shared
// memory and are added in one fixed part order. The rest of the state
// lives in registers: thread tid owns the dual elements idx = tid + q 256
// (q < kMaxE) and the primal elements tid + q 256 (q < kMaxP) of the
// [row][scenario] layouts in every iteration, so it keeps their y+-,
// y_prev+-, p_D+- and od (dual) and z and g_P (primal); elements past
// those (shapes the registers cannot hold at one scenario per block) keep
// the same state in device memory: y in y_out, y_prev in a scratch, z in
// z_out. An iteration: the zhat product; the primal epilogue (zhat, z);
// the q product; the dual epilogue, which recomputes w from (y, y_prev),
// projects, and forms the next iteration's wd; a barrier after each. The
// last iteration's w and zhat go straight to device memory. Where the
// padded carve-up does not fit shared memory (shapes near the guard), V =
// 1 keeps the operands unpadded at one scenario per block, within the
// first design's carve-up, so the guard admits what it did.
//
// Precision: the tier is a template parameter of the kernel. "highest" runs
// the plain fp32 FMA products above; "high", "default" and "bfloat16" run
// both products on the tensor cores (mma_product.cuh: warp tiles of 16 rows
// x 8 scenarios over the same operands and the same split-K scratch), as
// the Pallas kernels run _kdot at their tier. The epilogues, and the 1 / L
// of the flat instance's identity rows, stay fp32 at every tier.

#include <cuda_runtime.h>

#include "block_product.cuh"
#include "mma_product.cuh"

namespace {

constexpr int kThreads = 256;
// Dual and primal elements a thread keeps in registers (mirrored by
// kernels.py::_paired_max_elements and _PAIRED_MAX_PRIMAL): a tier's
// tensor-core product keeps its fragments in registers too, so its
// instances keep one dual element fewer, or they would spill past the 128
// registers of two blocks per SM
__host__ __device__ constexpr int max_elements(int tier) {
    return tier == gpad_mma::kHighest ? 6 : 5;
}
constexpr int kMaxP = 2;
using gpad_block::up4;

// The state of one dual element: both halves of row i of one scenario.
struct Dual {
    float yp, ym, ypp, ymp, pp, pm, od;
};

// The inputs a kernel instance reads, and its outputs.
struct Args {
    const float* __restrict__ MG;     // (m_h, n_z) row-major
    const float* __restrict__ GL;     // (n_z, m_h) row-major; cols [:n_s] used
    const float* __restrict__ gP;     // (B, n_z)
    const float* __restrict__ pD;     // (B, 2, m_h)
    const float* __restrict__ y0;     // (., 2, m_h) or null (cold start)
    long long y0_stride;              // 0 (one y0 for all) or 2 m_h
    const float* __restrict__ od;     // (m_h,) or null (no soft rows)
    const float* __restrict__ theta;  // (>= iterations,)
    const float* __restrict__ beta;
    const float* __restrict__ L;      // () Lipschitz constant
    int B, m_h, n_z, n_s, iterations, log2T, s1, s2;
    float* __restrict__ z_out;        // (B, n_z)
    float* __restrict__ y_out;        // (B, 2, m_h)
    float* __restrict__ w_out;        // (B, 2, m_h) or null (no diagnostics)
    float* __restrict__ zhat_out;     // (B, n_z) or null
    float* __restrict__ yprev;        // (B, 2, m_h) scratch, or null when
                                      // every dual element is in registers
};

// The thread's own elements of an array of `n` [row][scenario] entries:
// those in registers (q < kMax) and those past them (in device memory).
#define FOR_REG(q, idx, n, kMax)                                           \
    _Pragma("unroll") for (int q = 0; q < kMax; ++q)                      \
        if (const int idx = threadIdx.x + q * kThreads; idx < (n))
#define FOR_MEM(idx, n, kMax)                                              \
    for (int idx = threadIdx.x + kMax * kThreads; idx < (n); idx += kThreads)

// The block's share of out = A' X, its parts into `part`: the FFMA block
// product ("highest") or the tier's tensor-core one.
template <int V, int ST, int kTier>
__device__ __forceinline__ void product(const float* __restrict__ A, int lda,
                                        const float* __restrict__ X, int log2T,
                                        const gpad_block::Product& P,
                                        float* part)
{
    if constexpr (kTier == gpad_mma::kHighest)
        gpad_block::block_product<V, ST, kThreads>(
            A, lda, X, log2T, P, part, [](int, int, const float (&)[ST]) {});
    else
        gpad_mma::mma_product<kTier, kThreads>(A, lda, X, log2T, P.R, P.K,
                                               P.S, part);
}

// Two blocks per SM where rows are padded; the unpadded layout (shapes
// near the guard, whose carve-up leaves room for one block) takes the
// registers of one.
template <bool kFlat, int V, int ST, int kTier>
__global__ void __launch_bounds__(kThreads, V == 4 ? 2 : 1)
gpad_paired_kernel(const Args a)
{
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    constexpr int kMaxE = max_elements(kTier);
    const int log2T = a.log2T, T = 1 << log2T;
    const int m_h = a.m_h, n_z = a.n_z, n_s = a.n_s;
    const float inv_L = 1.0f / a.L[0];  // IEEE division, as torch's 1 / L
    const int tid = threadIdx.x;
    const long long b = ((long long)blockIdx.x << log2T) + (tid & (T - 1));
    const bool live = b < a.B;  // the thread's scenario (every element's)
    // operand row strides: padded to 4 for 16-byte loads (V = 4), or not
    const int np = V == 4 ? up4(n_z) : n_z, nsp = V == 4 ? up4(n_s) : n_s;
    const int hT = m_h * T, zT = n_z * T;
    const long long yo = b * 2 * m_h, zo = b * n_z;

    float* sMG = smem;                  // [i][j], m_h * np
    float* sGL = sMG + m_h * np;        // [j][i], n_z * nsp
    float* sWd = sGL + n_z * nsp;       // w+ - w-, [i][s], up4(m_h) * T
    float* sZh = sWd + up4(m_h) * T;    // zhat, [j][s], up4(n_z) * T
    float* part = sZh + up4(n_z) * T;   // the products' parts (shared)

    for (int idx = tid; idx < m_h * np; idx += kThreads) {
        const int i = idx / np, j = idx - i * np;
        sMG[idx] = j < n_z ? a.MG[i * n_z + j] : 0.0f;
    }
    for (int idx = tid; idx < n_z * nsp; idx += kThreads) {
        const int j = idx / nsp, i = idx - j * nsp;
        sGL[idx] = i < n_s ? a.GL[(long long)j * m_h + i] : 0.0f;
    }
    // padded rows stay zero
    for (int idx = tid; idx < (up4(m_h) + up4(n_z)) * T; idx += kThreads)
        sWd[idx] = 0.0f;
    __syncthreads();

    // y = y_prev = y0, so w_0 = y0 whatever beta_0 is; scenarios past B
    // (the ragged last tile) hold zeros
    auto load_dual = [&](int idx, Dual& e) {
        const int i = idx >> log2T;
        const bool warm = live && a.y0;
        e.yp = warm ? a.y0[b * a.y0_stride + i] : 0.0f;
        e.ym = warm ? a.y0[b * a.y0_stride + m_h + i] : 0.0f;
        e.ypp = e.yp;
        e.ymp = e.ym;
        e.pp = live ? a.pD[yo + i] : 0.0f;
        e.pm = live ? a.pD[yo + m_h + i] : 0.0f;
        e.od = a.od ? a.od[i] : 1.0f;
        sWd[idx] = e.yp - e.ym;
    };
    Dual st[kMaxE];
    float z[kMaxP], g[kMaxP];
    FOR_REG(q, idx, hT, kMaxE) load_dual(idx, st[q]);
    FOR_MEM(idx, hT, kMaxE) {
        Dual e;
        load_dual(idx, e);
        if (live) {
            const int i = idx >> log2T;
            a.y_out[yo + i] = a.yprev[yo + i] = e.yp;
            a.y_out[yo + m_h + i] = a.yprev[yo + m_h + i] = e.ym;
        }
    }
    FOR_REG(q, idx, zT, kMaxP) {
        z[q] = 0.0f;
        g[q] = live ? a.gP[zo + (idx >> log2T)] : 0.0f;
    }
    FOR_MEM(idx, zT, kMaxP) if (live) a.z_out[zo + (idx >> log2T)] = 0.0f;
    if (a.iterations == 0 && live) {  // an empty loop's w and zhat are zeros
        for (int idx = tid; a.w_out && idx < hT; idx += kThreads) {
            a.w_out[yo + (idx >> log2T)] = 0.0f;
            a.w_out[yo + m_h + (idx >> log2T)] = 0.0f;
        }
        for (int idx = tid; a.zhat_out && idx < zT; idx += kThreads)
            a.zhat_out[zo + (idx >> log2T)] = 0.0f;
    }
    __syncthreads();

    const gpad_block::Product P1 =
        gpad_block::make_product<ST>(n_z, m_h, log2T, a.s1);
    const gpad_block::Product P2 =
        gpad_block::make_product<ST>(n_s, n_z, log2T, a.s2);
    for (int k = 0; k < a.iterations; ++k) {
        const float th = a.theta[k], bk = a.beta[k];
        const bool last = k + 1 == a.iterations;
        const float bn = last ? 0.0f : a.beta[k + 1];
        // zhat = -MG_T' wd - g_P, its parts into `part`
        product<V, ST, kTier>(sMG, np, sWd, log2T, P1, part);
        __syncthreads();
        // zhat and z of the thread's primal elements
        auto primal = [&](int idx, float& zq, float gq) {
            float acc[1];
            gpad_block::sum_parts<1>(part, up4(n_z) * T, a.s1, idx, acc);
            const float zh = -acc[0] - gq;
            zq = (1.0f - th) * zq + th * zh;
            sZh[idx] = zh;
            if (last && live && a.zhat_out)
                a.zhat_out[zo + (idx >> log2T)] = zh;
        };
        FOR_REG(q, idx, zT, kMaxP) primal(idx, z[q], g[q]);
        FOR_MEM(idx, zT, kMaxP) {
            const int j = idx >> log2T;
            float zq = live ? a.z_out[zo + j] : 0.0f;
            primal(idx, zq, live ? a.gP[zo + j] : 0.0f);
            if (live) a.z_out[zo + j] = zq;
        }
        __syncthreads();
        // q = GL_T[:, :n_s]' zhat, its parts into `part`
        product<V, ST, kTier>(sGL, nsp, sZh, log2T, P2, part);
        __syncthreads();
        // projection, and the next iteration's wd from (y_next, y)
        auto dual = [&](int idx, Dual& e) {
            const int i = idx >> log2T;
            float q;
            if (!kFlat || i < n_s) {
                float acc[1];
                gpad_block::sum_parts<1>(part, up4(n_s) * T, a.s2, idx, acc);
                q = acc[0];
            } else {
                q = sZh[idx - n_s * T] * inv_L;
            }
            const float wp = e.yp + bk * (e.yp - e.ypp);
            const float wm = e.ym + bk * (e.ym - e.ymp);
            const float ypn = fmaxf(wp * e.od + q + e.pp, 0.0f);
            const float ymn = fmaxf(wm * e.od - q + e.pm, 0.0f);
            e.ypp = e.yp;
            e.ymp = e.ym;
            e.yp = ypn;
            e.ym = ymn;
            if (last && live && a.w_out) {  // w of the last iteration
                a.w_out[yo + i] = wp;
                a.w_out[yo + m_h + i] = wm;
            }
            if (!last)
                sWd[idx] = (ypn + bn * (ypn - e.ypp)) - (ymn + bn * (ymn - e.ymp));
        };
        FOR_REG(q, idx, hT, kMaxE) dual(idx, st[q]);
        FOR_MEM(idx, hT, kMaxE) {
            const int i = idx >> log2T;
            Dual e{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, a.od ? a.od[i] : 1.0f};
            if (live) {
                e.yp = a.y_out[yo + i];
                e.ym = a.y_out[yo + m_h + i];
                e.ypp = a.yprev[yo + i];
                e.ymp = a.yprev[yo + m_h + i];
                e.pp = a.pD[yo + i];
                e.pm = a.pD[yo + m_h + i];
            }
            dual(idx, e);
            if (live) {
                a.y_out[yo + i] = e.yp;
                a.y_out[yo + m_h + i] = e.ym;
                a.yprev[yo + i] = e.ypp;
                a.yprev[yo + m_h + i] = e.ymp;
            }
        }
        __syncthreads();
    }

    if (!live) return;
    FOR_REG(q, idx, hT, kMaxE) {
        a.y_out[yo + (idx >> log2T)] = st[q].yp;
        a.y_out[yo + m_h + (idx >> log2T)] = st[q].ym;
    }
    FOR_REG(q, idx, zT, kMaxP) a.z_out[zo + (idx >> log2T)] = z[q];
}

using Kernel = void (*)(const Args);

// The instance of a tier's tensor-core products: padded rows (V = 4) or
// unpadded (the warp tiles take any row stride and any T).
template <bool kFlat, int kTier>
Kernel tier_instance(int vec) {
    return vec == 1 ? gpad_paired_kernel<kFlat, 1, 1, kTier>
                    : gpad_paired_kernel<kFlat, 4, 1, kTier>;
}

// The instance for a plan and a tier (gpad_mma::Tier), or null for an
// unknown tier: "highest" the full or flat body, padded rows (V = 4) with
// a product tile of min(T, 4) scenarios, or unpadded at one scenario.
template <bool kFlat>
Kernel instance(int vec, int log2T, int tier) {
    switch (tier) {
    case gpad_mma::kHighest:
        return vec == 1   ? gpad_paired_kernel<kFlat, 1, 1, gpad_mma::kHighest>
             : log2T == 0 ? gpad_paired_kernel<kFlat, 4, 1, gpad_mma::kHighest>
             : log2T == 1 ? gpad_paired_kernel<kFlat, 4, 2, gpad_mma::kHighest>
                          : gpad_paired_kernel<kFlat, 4, 4, gpad_mma::kHighest>;
    case gpad_mma::kHigh: return tier_instance<kFlat, gpad_mma::kHigh>(vec);
    case gpad_mma::kDefault:
        return tier_instance<kFlat, gpad_mma::kDefault>(vec);
    case gpad_mma::kBfloat16:
        return tier_instance<kFlat, gpad_mma::kBfloat16>(vec);
    default: return nullptr;
    }
}

template <bool kFlat>
int launch(const Args& a, int vec, int smem, int tier, void* stream)
{
    if (a.log2T < 0 || a.log2T > 4 || a.s1 < 1 || a.s2 < 1
        || (vec != 4 && (vec != 1 || a.log2T != 0 || a.s1 != 1 || a.s2 != 1))
        || (a.m_h << a.log2T > max_elements(tier) * kThreads && !a.yprev))
        return (int)cudaErrorInvalidValue;
    const Kernel kernel = instance<kFlat>(vec, a.log2T, tier);
    if (!kernel) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int T = 1 << a.log2T;
    kernel<<<(a.B + T - 1) / T, kThreads, (size_t)smem,
             (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan or a tier the kernel does not take.
// `smem` is the block's dynamic shared memory in bytes and (log2_tile, vec,
// s1, s2) the plan, computed by the caller (kernels.py::_paired_plan,
// _paired_smem_bytes) so the routing guard and the launch agree: vec 4
// (padded rows) or 1 (unpadded, one scenario per block, no split), s1 and
// s2 the parts of the zhat and q products. `yprev` is a (B, 2, m_h)
// scratch, needed only where m_h 2**log2_tile exceeds the dual elements
// the block's registers hold (1536 at "highest", 1280 under a tier).
// `tier` is the products' precision (gpad_mma::Tier: 0 "highest", 1
// "high", 2 "default", 3 "bfloat16").
int gpad_paired_flat_launch(
    const float* MG, const float* GL, const float* gP, const float* pD,
    const float* y0, long long y0_stride, const float* od,
    const float* theta, const float* beta, const float* L,
    int B, int m_h, int n_z, int n_s, int iterations, int log2_tile,
    int vec, int s1, int s2,
    float* z_out, float* y_out, float* w_out, float* zhat_out, float* yprev,
    int smem, int tier, void* stream)
{
    const Args a{MG, GL, gP, pD, y0, y0_stride, od, theta, beta, L,
                 B, m_h, n_z, n_s, iterations, log2_tile, s1, s2,
                 z_out, y_out, w_out, zhat_out, yprev};
    return launch<true>(a, vec, smem, tier, stream);
}

// The full instance: n_s must be m_h.
int gpad_paired_launch(
    const float* MG, const float* GL, const float* gP, const float* pD,
    const float* y0, long long y0_stride, const float* od,
    const float* theta, const float* beta, const float* L,
    int B, int m_h, int n_z, int n_s, int iterations, int log2_tile,
    int vec, int s1, int s2,
    float* z_out, float* y_out, float* w_out, float* zhat_out, float* yprev,
    int smem, int tier, void* stream)
{
    if (n_s != m_h) return (int)cudaErrorInvalidValue;
    const Args a{MG, GL, gP, pD, y0, y0_stride, od, theta, beta, L,
                 B, m_h, n_z, n_s, iterations, log2_tile, s1, s2,
                 z_out, y_out, w_out, zhat_out, yprev};
    return launch<false>(a, vec, smem, tier, stream);
}

}  // extern "C"
