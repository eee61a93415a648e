// Fixed-budget GPAD on the dense (unpaired) constraint stack, one launch per
// solve.
//
// Replaces tpu_gpad/solver/kernels.py::_gpad_kernel (the Pallas TPU kernel
// behind gpad_pallas_fixed). The stack is the reference's own layout
// [S; -S; I; -I; K; -K], m rows with no structure assumed. Per scenario,
// for each iteration k < iterations:
//
//   w    = y + beta_k (y - y_prev)
//   zhat = -MG_T' w - g_P                 MG_T (m, n_z)
//   z    = (1 - theta_k) z + theta_k zhat
//   y    = relu(w + GL_T' zhat + p_D)     GL_T (n_z, m)
//
// There are no soft rows: soft data is paired, and the router never sends
// it here (tpu_gpad's dense kernel refuses it too).
//
// What bounds it: at battery n3 N10 (n_z = 30, m = 140) an iteration is
// 4 m n_z = 16.8 kFLOP per scenario, so a B = 4096, 100-iteration solve is
// 6.9 GFLOP, about 0.1 ms at the card's FP32 rate; the operands are 34 KB,
// so device memory does not bound it. The first design read two
// shared-memory words per multiply-add (an eighth of the FP32 rate at
// best) and ran 140-long dependent chains. This one reads one 16-byte word
// of each operand per 4 x 4 multiply-adds; what bounds it now is latency:
// with 16 warps per SM and a barrier after each of its four phases, each
// phase waits on its own loads and chains, and the products reach about a
// quarter of the FP32 rate (on an H100, PERF.md: 0.45 ms at B = 4096,
// 4.4x the bound; 0.15 ms at B = 256, where the grid has 128 blocks).
//
// Design: one block of 256 threads per tile of T scenarios (T a power of
// two <= 32, picked per batch by the wrapper so that the grid fills the
// card: 2 at the serving batch B = 256, 16 at B = 4096). MG_T and GL_T are
// staged once into dynamic shared memory with their rows padded to a
// multiple of 4 (zeros), and the per-scenario arrays are laid out
// [row][scenario] with zero padded rows. Both products are register-tiled
// block products (block_product.cuh): a thread holds 4 rows x min(T, 4)
// scenarios of sums, and the K of each product is split over S parts so
// that short products fill the block. A phase with S > 1 adds its parts
// in one fixed order after a barrier; with S = 1 its epilogue runs from
// registers. The epilogues read and write min(T, 4) scenarios of a row
// with one vector access each. Step 1 of iteration k+1 is fused into the
// projection of iteration k, so y_prev is never stored. Where the padded
// layout does not fit shared memory (shapes near the guard), V = 1 keeps
// the operands unpadded at one scenario per block: the first design's
// carve-up, so the guard admits what it did.
//
// Precision: the tier is a template parameter, as in the resident dual and
// paired kernels. "highest" runs the fp32 FMA products above; "high",
// "default" and "bfloat16" run both on the tensor cores (mma_product.cuh:
// warp tiles of 16 rows x 8 scenarios over the same operands in shared
// memory), as _gpad_kernel runs _kdot at its tier. A product of S > 1
// parts writes the same split-K scratch and its epilogue adds the parts in
// the same order; a product of one part hands each sum from its fragment to
// the epilogue (mma_product_emit), as "highest"'s hands them from its
// registers, so a tier needs no scratch where "highest" has none and its
// plans fit wherever "highest"'s do. The tiers' instances take one scenario
// per epilogue access (ST = 1). The epilogues stay fp32 at every tier.

#include <cuda_runtime.h>

#include "block_product.cuh"
#include "mma_product.cuh"

namespace {

constexpr int kThreads = 256;
using gpad_block::up4;

template <int V, int ST, int kTier>
__global__ void __launch_bounds__(kThreads, 2)
gpad_dense_kernel(
    const float* __restrict__ MG,     // (m, n_z) row-major
    const float* __restrict__ GL,     // (n_z, m) row-major
    const float* __restrict__ gP,     // (B, n_z)
    const float* __restrict__ pD,     // (B, m)
    const float* __restrict__ y0,     // (., m) or null (cold start)
    long long y0_stride,              // 0 (one y0 for all) or m
    const float* __restrict__ theta,  // (>= iterations,)
    const float* __restrict__ beta,
    int B, int m, int n_z, int iterations, int log2T, int s1, int s2,
    float* __restrict__ z_out,        // (B, n_z)
    float* __restrict__ y_out,        // (B, m)
    float* __restrict__ w_out,        // (B, m) or null (no diagnostics)
    float* __restrict__ zhat_out)     // (B, n_z) or null
{
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int T = 1 << log2T;
    const int tid = threadIdx.x;
    const long long b0 = (long long)blockIdx.x * T;
    // row strides: padded to 4 for 16-byte loads (V = 4), or as given
    const int mp = V == 4 ? up4(m) : m, np = V == 4 ? up4(n_z) : n_z;
    const int mT = mp * T, zT = np * T;

    float* sMG = smem;                 // m * np, [i][j]
    float* sGL = sMG + m * np;         // n_z * mp, [j][i]
    float* sY = sGL + n_z * mp;        // each dual array: [i][s], mp * T
    float* sW = sY + mT;
    float* sP = sW + mT;
    float* sG = sP + mT;               // each primal array: [j][s], np * T
    float* sZ = sG + zT;
    float* sZh = sZ + zT;
    // the phases' partial sums (only where S > 1) share one scratch
    float* part1 = s1 > 1 ? sZh + zT : nullptr;
    float* part2 = s2 > 1 ? sZh + zT : nullptr;

    for (int idx = tid; idx < m * np; idx += kThreads) {
        const int i = idx / np, j = idx - i * np;
        sMG[idx] = j < n_z ? MG[i * n_z + j] : 0.0f;
    }
    for (int idx = tid; idx < n_z * mp; idx += kThreads) {
        const int j = idx / mp, i = idx - j * mp;
        sGL[idx] = i < m ? GL[j * m + i] : 0.0f;
    }
    // padded rows stay zero: inert in every product and projection
    for (int idx = tid; idx < 3 * (mT + zT); idx += kThreads) sY[idx] = 0.0f;
    __syncthreads();
    // Per-scenario inputs, read with consecutive threads on consecutive
    // global addresses; scenarios past B (the ragged last tile) are zero.
    for (int idx = tid; idx < n_z * T; idx += kThreads) {
        const int s = idx / n_z, j = idx - s * n_z;
        const long long b = b0 + s;
        if (b < B) sG[j * T + s] = gP[b * n_z + j];
    }
    for (int idx = tid; idx < m * T; idx += kThreads) {
        const int s = idx / m, i = idx - s * m;
        const long long b = b0 + s;
        if (b >= B) continue;
        const int o = i * T + s;
        const float y = y0 ? y0[b * y0_stride + i] : 0.0f;
        sP[o] = pD[b * m + i];
        sY[o] = y;
        sW[o] = y;  // y_prev = y0, so w_0 = y0 whatever beta_0 is
    }
    __syncthreads();

    static_assert(kTier == gpad_mma::kHighest || ST == 1,
                  "the tiers' epilogues take one scenario an access");
    const gpad_block::Product P1 = gpad_block::make_product<ST>(n_z, m, log2T, s1);
    const gpad_block::Product P2 = gpad_block::make_product<ST>(m, n_z, log2T, s2);
    for (int k = 0; k < iterations; ++k) {
        const float th = theta[k];
        // zhat = -MG_T' w - g_P ; z = (1 - th) z + th zhat, on ST
        // consecutive scenarios of one row at idx
        auto emit1 = [&](int idx, const float (&acc)[ST]) {
            float g[ST], z[ST], zh[ST];
            gpad_block::load_vec<ST>(sG + idx, g);
            gpad_block::load_vec<ST>(sZ + idx, z);
#pragma unroll
            for (int e = 0; e < ST; ++e) {
                zh[e] = -acc[e] - g[e];
                z[e] = (1.0f - th) * z[e] + th * zh[e];
            }
            gpad_block::store_vec<ST>(sZh + idx, zh);
            gpad_block::store_vec<ST>(sZ + idx, z);
        };
        if constexpr (kTier == gpad_mma::kHighest)
            gpad_block::block_product<V, ST, kThreads>(
                sMG, np, sW, log2T, P1, part1,
                [&](int j, int s0, const float (&v)[ST]) { emit1(j * T + s0, v); });
        else if (part1)
            gpad_mma::mma_product<kTier, kThreads>(sMG, np, sW, log2T, n_z, m,
                                                   s1, part1);
        else
            gpad_mma::mma_product_emit<kTier, kThreads>(
                sMG, np, sW, log2T, n_z, m, [&](int j, int s, float v) {
                    const float a[1] = {v};
                    emit1(j * T + s, a);
                });
        if (part1) {
            __syncthreads();
            for (int idx = tid * ST; idx < n_z * T; idx += kThreads * ST) {
                float v[ST];
                gpad_block::sum_parts<ST>(part1, up4(n_z) * T, s1, idx, v);
                emit1(idx, v);
            }
        }
        __syncthreads();
        // GL_T' zhat, projection, and the next iteration's w from (y_next, y)
        const bool more = k + 1 < iterations;
        const float bn = more ? beta[k + 1] : 0.0f;
        auto emit2 = [&](int idx, const float (&q)[ST]) {
            float y[ST], w[ST], p[ST];
            gpad_block::load_vec<ST>(sY + idx, y);
            gpad_block::load_vec<ST>(sW + idx, w);
            gpad_block::load_vec<ST>(sP + idx, p);
#pragma unroll
            for (int e = 0; e < ST; ++e) {
                const float y_new = fmaxf(w[e] + q[e] + p[e], 0.0f);
                w[e] = y_new + bn * (y_new - y[e]);
                y[e] = y_new;
            }
            gpad_block::store_vec<ST>(sY + idx, y);
            if (more) gpad_block::store_vec<ST>(sW + idx, w);
        };
        if constexpr (kTier == gpad_mma::kHighest)
            gpad_block::block_product<V, ST, kThreads>(
                sGL, mp, sZh, log2T, P2, part2,
                [&](int i, int s0, const float (&v)[ST]) { emit2(i * T + s0, v); });
        else if (part2)
            gpad_mma::mma_product<kTier, kThreads>(sGL, mp, sZh, log2T, m, n_z,
                                                   s2, part2);
        else
            gpad_mma::mma_product_emit<kTier, kThreads>(
                sGL, mp, sZh, log2T, m, n_z, [&](int i, int s, float v) {
                    const float a[1] = {v};
                    emit2(i * T + s, a);
                });
        if (part2) {
            __syncthreads();
            for (int idx = tid * ST; idx < m * T; idx += kThreads * ST) {
                float v[ST];
                gpad_block::sum_parts<ST>(part2, up4(m) * T, s2, idx, v);
                emit2(idx, v);
            }
        }
        __syncthreads();
    }

    for (int idx = tid; idx < n_z * T; idx += kThreads) {
        const int s = idx / n_z, j = idx - s * n_z;
        const long long b = b0 + s;
        if (b >= B) continue;
        z_out[b * n_z + j] = sZ[j * T + s];
        if (zhat_out) zhat_out[b * n_z + j] = sZh[j * T + s];
    }
    for (int idx = tid; idx < m * T; idx += kThreads) {
        const int s = idx / m, i = idx - s * m;
        const long long b = b0 + s;
        if (b >= B) continue;
        const int o = i * T + s;
        y_out[b * m + i] = sY[o];
        if (w_out)  // w of the last iteration; zeros when none ran
            w_out[b * m + i] = iterations > 0 ? sW[o] : 0.0f;
    }
}

using Kernel = decltype(&gpad_dense_kernel<1, 1, gpad_mma::kHighest>);

// The instances of a plan and tier, or null for an unknown tier: "highest"
// by a thread's product tile of min(T, 4) scenarios, the tiers' warp tiles
// at any T with one scenario an epilogue access.
Kernel kernel_of(int vec, int log2_tile, int tier) {
    using namespace gpad_mma;
    switch (tier) {
    case kHighest:
        return vec == 1        ? gpad_dense_kernel<1, 1, kHighest>
             : log2_tile == 0  ? gpad_dense_kernel<4, 1, kHighest>
             : log2_tile == 1  ? gpad_dense_kernel<4, 2, kHighest>
                               : gpad_dense_kernel<4, 4, kHighest>;
    case kHigh:
        return vec == 1 ? gpad_dense_kernel<1, 1, kHigh>
                        : gpad_dense_kernel<4, 1, kHigh>;
    case kDefault:
        return vec == 1 ? gpad_dense_kernel<1, 1, kDefault>
                        : gpad_dense_kernel<4, 1, kDefault>;
    case kBfloat16:
        return vec == 1 ? gpad_dense_kernel<1, 1, kBfloat16>
                        : gpad_dense_kernel<4, 1, kBfloat16>;
    default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan or a tier the kernel does not take.
// `smem` is the block's dynamic shared memory in bytes and (vec, s1, s2)
// the carve-up, computed by the caller (kernels.py::_dense_plan,
// _dense_smem_bytes) so the routing guard and the launch agree: vec 4
// (padded rows) or 1 (unpadded, one scenario per block, no split), s1 and
// s2 the parts of the two products. `tier` is the products' precision
// (gpad_mma::Tier: 0 "highest", 1 "high", 2 "default", 3 "bfloat16").
int gpad_dense_launch(
    const float* MG, const float* GL, const float* gP, const float* pD,
    const float* y0, long long y0_stride, const float* theta,
    const float* beta, int B, int m, int n_z, int iterations, int log2_tile,
    int vec, int s1, int s2,
    float* z_out, float* y_out, float* w_out, float* zhat_out,
    int smem, int tier, void* stream)
{
    const Kernel kernel = kernel_of(vec, log2_tile, tier);
    if (log2_tile < 0 || log2_tile > 5 || s1 < 1 || s2 < 1 || !kernel
        || (vec != 4 && (vec != 1 || log2_tile != 0 || s1 != 1 || s2 != 1)))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int T = 1 << log2_tile;
    const int grid = (B + T - 1) / T;
    kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
        MG, GL, gP, pD, y0, y0_stride, theta, beta, B, m, n_z, iterations,
        log2_tile, s1, s2, z_out, y_out, w_out, zhat_out);
    return (int)cudaGetLastError();
}

}  // extern "C"
