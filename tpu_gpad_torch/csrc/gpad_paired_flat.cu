// Fixed-budget GPAD on the flat paired half stack, one launch per solve.
//
// Replaces tpu_gpad/solver/kernels.py::_gpad_kernel_paired_flat (the Pallas
// TPU kernel behind gpad_pallas_fixed_paired_flat). Per scenario, for each
// iteration k < iterations:
//
//   w+-  = y+- + beta_k (y+- - y+-_prev)
//   zhat = -MG_T' (w+ - w-) - g_P                 MG_T (m_h, n_z): all rows
//   z    = (1 - theta_k) z + theta_k zhat
//   q    = [ GL_T[:, :n_s]' zhat ; zhat / L ]     box rows need no product
//   y+   = relu(w+ od + q + p_D+),  y- = relu(w- od - q + p_D-)
//
// od is 1 - soft_damp (1 without soft rows). The dual rows are already in
// [struct | box] order (dualize puts the identity rows last), so no layout
// change happens on either side of the kernel.
//
// What bounds it: at the headline shape (battery n3 N10: n_z = 30,
// m_h = 70, n_s = 40) an iteration is 2 m_h n_z + 2 n_z n_s = 6.6 kFLOP per
// scenario, so a B = 4096, 100-iteration solve is about 2.7 GFLOP, a few
// hundredths of a millisecond at the card's FP32 rate. The operands are
// 13 KB. Each multiply-add reads two shared-memory words, so the kernel is
// bounded by shared-memory traffic and the two barriers per iteration, not
// by the FP32 rate or by device memory.
//
// Design: one block per tile of T scenarios (T a power of two <= 32; the
// wrapper picks 8, the fastest measured at the headline shape). MG_T
// and the struct columns of GL_T are staged once into dynamic shared
// memory; every per-scenario array is in shared memory too, laid out
// [row][scenario] so a warp reads neighbouring scenarios of one row while
// the operand word is a broadcast. Step 1 of iteration k+1 is fused into
// the projection of iteration k (the thread that writes y(i, s) also forms
// the next w(i, s)), so y_prev is never stored and each iteration is two
// phases with one barrier after each: the zhat/z update, then the q /
// projection / next-w update. Products are plain fp32 FMA (precision
// "highest"); TF32, tensor cores and register-resident state are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gpad_paired_flat_kernel(
    const float* __restrict__ MG,     // (m_h, n_z) row-major
    const float* __restrict__ GL,     // (n_z, m_h) row-major; cols [:n_s] used
    const float* __restrict__ gP,     // (B, n_z)
    const float* __restrict__ pD,     // (B, 2, m_h)
    const float* __restrict__ y0,     // (., 2, m_h) or null (cold start)
    long long y0_stride,              // 0 (one y0 for all) or 2 m_h
    const float* __restrict__ od,     // (m_h,) or null (no soft rows)
    const float* __restrict__ theta,  // (>= iterations,)
    const float* __restrict__ beta,
    const float* __restrict__ L,      // () Lipschitz constant
    int B, int m_h, int n_z, int n_s, int iterations, int log2_tile,
    float* __restrict__ z_out,        // (B, n_z)
    float* __restrict__ y_out,        // (B, 2, m_h)
    float* __restrict__ w_out,        // (B, 2, m_h) or null (no diagnostics)
    float* __restrict__ zhat_out)     // (B, n_z) or null
{
    extern __shared__ float smem[];
    const float inv_L = 1.0f / L[0];  // IEEE division, as torch's 1 / L
    const int T = 1 << log2_tile;
    const int tmask = T - 1;
    const int tid = threadIdx.x;
    const long long b0 = (long long)blockIdx.x * T;
    const int hT = m_h * T;
    const int zT = n_z * T;

    float* sMG = smem;                 // m_h * n_z
    float* sGL = sMG + m_h * n_z;      // n_z * n_s, [j][i]
    float* sOD = sGL + n_z * n_s;      // m_h
    float* sYp = sOD + m_h;            // each dual array: [i][s], m_h * T
    float* sYm = sYp + hT;
    float* sWp = sYm + hT;
    float* sWm = sWp + hT;
    float* sWd = sWm + hT;
    float* sPp = sWd + hT;
    float* sPm = sPp + hT;
    float* sG = sPm + hT;              // each primal array: [j][s], n_z * T
    float* sZ = sG + zT;
    float* sZh = sZ + zT;

    for (int idx = tid; idx < m_h * n_z; idx += kThreads) sMG[idx] = MG[idx];
    for (int idx = tid; idx < n_z * n_s; idx += kThreads) {
        const int j = idx / n_s, i = idx - j * n_s;
        sGL[idx] = GL[(long long)j * m_h + i];
    }
    for (int i = tid; i < m_h; i += kThreads) sOD[i] = od ? od[i] : 1.0f;
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
    for (int idx = tid; idx < 2 * hT; idx += kThreads) {
        const int s = idx / (2 * m_h), r = idx - s * 2 * m_h;
        const int side = r >= m_h, i = r - side * m_h;
        const long long b = b0 + s;
        const bool live = b < B;
        const float p = live ? pD[b * 2 * m_h + r] : 0.0f;
        const float y = (live && y0) ? y0[b * y0_stride + r] : 0.0f;
        const int o = i * T + s;
        // y_prev = y0, so w_0 = y0 whatever beta_0 is
        if (side) { sPm[o] = p; sYm[o] = y; sWm[o] = y; }
        else      { sPp[o] = p; sYp[o] = y; sWp[o] = y; }
    }
    __syncthreads();
    for (int idx = tid; idx < hT; idx += kThreads) sWd[idx] = sWp[idx] - sWm[idx];
    __syncthreads();

    for (int k = 0; k < iterations; ++k) {
        const float th = theta[k];
        // zhat = -MG_T' wd - g_P ; z = (1 - th) z + th zhat
        for (int idx = tid; idx < zT; idx += kThreads) {
            const int j = idx >> log2_tile, s = idx & tmask;
            float acc = 0.0f;
            for (int i = 0; i < m_h; ++i)
                acc = fmaf(sMG[i * n_z + j], sWd[i * T + s], acc);
            const float zh = -acc - sG[idx];
            sZh[idx] = zh;
            sZ[idx] = (1.0f - th) * sZ[idx] + th * zh;
        }
        __syncthreads();
        // q, projection, and the next iteration's w from (y_next, y)
        const bool more = k + 1 < iterations;
        const float bn = more ? beta[k + 1] : 0.0f;
        for (int idx = tid; idx < hT; idx += kThreads) {
            const int i = idx >> log2_tile, s = idx & tmask;
            float q;
            if (i < n_s) {
                q = 0.0f;
                for (int j = 0; j < n_z; ++j)
                    q = fmaf(sGL[j * n_s + i], sZh[j * T + s], q);
            } else {
                q = sZh[(i - n_s) * T + s] * inv_L;
            }
            const float o = sOD[i];
            const float yp_old = sYp[idx], ym_old = sYm[idx];
            const float yp = fmaxf(sWp[idx] * o + q + sPp[idx], 0.0f);
            const float ym = fmaxf(sWm[idx] * o - q + sPm[idx], 0.0f);
            sYp[idx] = yp;
            sYm[idx] = ym;
            if (more) {
                const float wp = yp + bn * (yp - yp_old);
                const float wm = ym + bn * (ym - ym_old);
                sWp[idx] = wp;
                sWm[idx] = wm;
                sWd[idx] = wp - wm;
            }
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
    for (int idx = tid; idx < 2 * hT; idx += kThreads) {
        const int s = idx / (2 * m_h), r = idx - s * 2 * m_h;
        const int side = r >= m_h, i = r - side * m_h;
        const long long b = b0 + s;
        if (b >= B) continue;
        const int o = i * T + s;
        y_out[b * 2 * m_h + r] = side ? sYm[o] : sYp[o];
        if (w_out)  // w of the last iteration; zeros when none ran
            w_out[b * 2 * m_h + r] =
                iterations > 0 ? (side ? sWm[o] : sWp[o]) : 0.0f;
    }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `smem` is the block's dynamic shared memory in bytes,
// 4 (m_h n_z + n_z n_s + m_h + 7 m_h T + 3 n_z T), computed by the caller
// (kernels.py::_smem_bytes) so the routing guard and the launch agree.
int gpad_paired_flat_launch(
    const float* MG, const float* GL, const float* gP, const float* pD,
    const float* y0, long long y0_stride, const float* od,
    const float* theta, const float* beta, const float* L,
    int B, int m_h, int n_z, int n_s, int iterations, int log2_tile,
    float* z_out, float* y_out, float* w_out, float* zhat_out,
    int smem, void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        gpad_paired_flat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const int T = 1 << log2_tile;
    const int grid = (B + T - 1) / T;
    gpad_paired_flat_kernel<<<grid, kThreads, (size_t)smem,
                              (cudaStream_t)stream>>>(
        MG, GL, gP, pD, y0, y0_stride, od, theta, beta, L,
        B, m_h, n_z, n_s, iterations, log2_tile, z_out, y_out, w_out, zhat_out);
    return (int)cudaGetLastError();
}

}  // extern "C"
