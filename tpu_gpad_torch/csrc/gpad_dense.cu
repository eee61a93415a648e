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
// 6.9 GFLOP, about 0.1 ms at the card's FP32 rate. The operands are 34 KB.
// As in gpad_paired_flat.cu, each multiply-add reads two shared-memory
// words, so shared-memory traffic and the two barriers per iteration bound
// it, not the FP32 rate or device memory.
//
// Design (that of gpad_paired_flat.cu): one block per tile of T scenarios
// (T a power of two <= 8, chosen by the wrapper from the carve-up below).
// MG_T and GL_T are staged once into dynamic shared memory, row-major as
// given; the per-scenario arrays are in shared memory laid out
// [row][scenario], so a warp reads neighbouring scenarios of one row while
// the operand word is a broadcast. Step 1 of iteration k+1 is fused into
// the projection of iteration k, so y_prev is never stored and each
// iteration is two phases with one barrier after each. Products are plain
// fp32 FMA (precision "highest").

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gpad_dense_kernel(
    const float* __restrict__ MG,     // (m, n_z) row-major
    const float* __restrict__ GL,     // (n_z, m) row-major
    const float* __restrict__ gP,     // (B, n_z)
    const float* __restrict__ pD,     // (B, m)
    const float* __restrict__ y0,     // (., m) or null (cold start)
    long long y0_stride,              // 0 (one y0 for all) or m
    const float* __restrict__ theta,  // (>= iterations,)
    const float* __restrict__ beta,
    int B, int m, int n_z, int iterations, int log2_tile,
    float* __restrict__ z_out,        // (B, n_z)
    float* __restrict__ y_out,        // (B, m)
    float* __restrict__ w_out,        // (B, m) or null (no diagnostics)
    float* __restrict__ zhat_out)     // (B, n_z) or null
{
    extern __shared__ float smem[];
    const int T = 1 << log2_tile;
    const int tmask = T - 1;
    const int tid = threadIdx.x;
    const long long b0 = (long long)blockIdx.x * T;
    const int mT = m * T;
    const int zT = n_z * T;

    float* sMG = smem;                 // m * n_z, [i][j]
    float* sGL = sMG + m * n_z;        // n_z * m, [j][i]
    float* sY = sGL + n_z * m;         // each dual array: [i][s], m * T
    float* sW = sY + mT;
    float* sP = sW + mT;
    float* sG = sP + mT;               // each primal array: [j][s], n_z * T
    float* sZ = sG + zT;
    float* sZh = sZ + zT;

    for (int idx = tid; idx < m * n_z; idx += kThreads) {
        sMG[idx] = MG[idx];
        sGL[idx] = GL[idx];
    }
    // Per-scenario inputs, read with consecutive threads on consecutive
    // global addresses; scenarios past B (the ragged last tile) are zero.
    for (int idx = tid; idx < zT; idx += kThreads) {
        const int s = idx / n_z, j = idx - s * n_z;
        const long long b = b0 + s;
        const int o = j * T + s;
        sG[o] = b < B ? gP[b * n_z + j] : 0.0f;
        sZ[o] = 0.0f;
        sZh[o] = 0.0f;
    }
    for (int idx = tid; idx < mT; idx += kThreads) {
        const int s = idx / m, i = idx - s * m;
        const long long b = b0 + s;
        const bool live = b < B;
        const int o = i * T + s;
        const float y = (live && y0) ? y0[b * y0_stride + i] : 0.0f;
        sP[o] = live ? pD[b * m + i] : 0.0f;
        sY[o] = y;
        sW[o] = y;  // y_prev = y0, so w_0 = y0 whatever beta_0 is
    }
    __syncthreads();

    for (int k = 0; k < iterations; ++k) {
        const float th = theta[k];
        // zhat = -MG_T' w - g_P ; z = (1 - th) z + th zhat
        for (int idx = tid; idx < zT; idx += kThreads) {
            const int j = idx >> log2_tile, s = idx & tmask;
            float acc = 0.0f;
            for (int i = 0; i < m; ++i)
                acc = fmaf(sMG[i * n_z + j], sW[i * T + s], acc);
            const float zh = -acc - sG[idx];
            sZh[idx] = zh;
            sZ[idx] = (1.0f - th) * sZ[idx] + th * zh;
        }
        __syncthreads();
        // GL_T' zhat, projection, and the next iteration's w from (y_next, y)
        const bool more = k + 1 < iterations;
        const float bn = more ? beta[k + 1] : 0.0f;
        for (int idx = tid; idx < mT; idx += kThreads) {
            const int i = idx >> log2_tile, s = idx & tmask;
            float q = 0.0f;
            for (int j = 0; j < n_z; ++j)
                q = fmaf(sGL[j * m + i], sZh[j * T + s], q);
            const float y_old = sY[idx];
            const float y = fmaxf(sW[idx] + q + sP[idx], 0.0f);
            sY[idx] = y;
            if (more) sW[idx] = y + bn * (y - y_old);
        }
        __syncthreads();
    }

    for (int idx = tid; idx < zT; idx += kThreads) {
        const int s = idx / n_z, j = idx - s * n_z;
        const long long b = b0 + s;
        if (b >= B) continue;
        z_out[b * n_z + j] = sZ[j * T + s];
        if (zhat_out) zhat_out[b * n_z + j] = sZh[j * T + s];
    }
    for (int idx = tid; idx < mT; idx += kThreads) {
        const int s = idx / m, i = idx - s * m;
        const long long b = b0 + s;
        if (b >= B) continue;
        const int o = i * T + s;
        y_out[b * m + i] = sY[o];
        if (w_out)  // w of the last iteration; zeros when none ran
            w_out[b * m + i] = iterations > 0 ? sW[o] : 0.0f;
    }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `smem` is the block's dynamic shared memory in bytes,
// 4 (2 m n_z + 3 m T + 3 n_z T), computed by the caller
// (kernels.py::_dense_smem_bytes) so the routing guard and the launch agree.
int gpad_dense_launch(
    const float* MG, const float* GL, const float* gP, const float* pD,
    const float* y0, long long y0_stride, const float* theta,
    const float* beta, int B, int m, int n_z, int iterations, int log2_tile,
    float* z_out, float* y_out, float* w_out, float* zhat_out,
    int smem, void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        gpad_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int T = 1 << log2_tile;
    const int grid = (B + T - 1) / T;
    gpad_dense_kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
        MG, GL, gP, pD, y0, y0_stride, theta, beta, B, m, n_z, iterations,
        log2_tile, z_out, y_out, w_out, zhat_out);
    return (int)cudaGetLastError();
}

}  // extern "C"
