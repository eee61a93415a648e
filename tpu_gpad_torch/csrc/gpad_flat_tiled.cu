// Flat paired mvp GPAD with both operands read from device memory on every
// iteration: a whole fixed-budget solve per launch.
//
// Replaces tpu_gpad/solver/kernels.py::_gpad_kernel_flat_tiled (the Pallas
// TPU kernel behind gpad_pallas_fixed_flat_tiled). It computes what the
// flat instance of csrc/gpad_paired_flat.cu computes, for stacks whose
// operands do not fit one block's shared memory (the reference's battery
// 30x30: MG_T is 1830 x 900 and GL_T's structural columns 900 x 930, 9.9 MB
// together). Per scenario, for each iteration k < iterations:
//
//   w+-  = y+- + beta_k (y+- - y+-_prev)          every dual row first
//   zhat = -MG_T' (w+ - w-) - g_P                 MG_T (m_h, n_z)
//   z    = (1 - theta_k) z + theta_k zhat         z starts at 0
//   q    = [ GL_T[:, :n_s]' zhat ; zhat / L ]     box rows need no product
//   y+   = relu(w+ + q + p_D+),  y- = relu(w- - q + p_D-)
//
// The dual rows are in [struct | box] order (dualize puts the identity rows
// last), so unlike the TPU kernel there is no padding or layout mapping on
// either side. Fixed mode only: no restart and no soft rows, as in
// tpu_gpad.
//
// What bounds it: at the flagship an iteration is 2 n_z (m_h + n_s) =
// 4.97 MFLOP per scenario, so B = 256 x 100 iterations is 127.2 GFLOP,
// 1.90 ms at the card's FP32 rate. Each block reads both operands once per
// iteration, 9.9 MB from L2 (they and the state fit the 50 MB L2), and does
// 2 T FLOP per operand word read: at small T the L2-to-SM traffic bounds
// it, at large T the FMA rate of the few SMs that have a block.
//
// Design: one block of 512 threads owns T scenarios (T a power of two
// <= 8) for the whole launch: zhat needs every dual row of its scenario,
// and every dual row needs all of zhat. The state (y, y_prev, w, z, zhat)
// lives in device memory in the output tensors; dual row i belongs to
// thread i mod 512 in step 1 and in the projection, primal entry c to
// thread c mod 512 in step 2, so a thread rereads only what it wrote. Only
// wd and zhat, laid out [row][scenario], sit in shared memory. Three
// phases per iteration, two barriers: (A) w and wd; (B) the MG_T product
// into zhat and z; (C) the GL_T product and the projection of the
// structural rows, then the box rows. The products are those of
// csrc/tiled_product.cuh: up to 4 columns x T scenarios of fp32 FMA
// accumulators per thread (precision "highest"). Staging operand chunks
// with TMA, clusters that share one stream, and tensor cores are later
// work.

#include <cuda_runtime.h>

#include "tiled_product.cuh"

namespace {

using gpad_tiled::kThreads;
using gpad_tiled::product;

template <int T>
__global__ void __launch_bounds__(kThreads)
gpad_flat_tiled_kernel(
    const float* __restrict__ MG,     // (m_h, n_z) row-major
    const float* __restrict__ GL,     // (n_z, m_h) row-major; cols [:n_s] used
    const float* __restrict__ gP,     // (B, n_z)
    const float* __restrict__ pD,     // (B, 2, m_h)
    const float* __restrict__ y0,     // (., 2, m_h) or null (cold start)
    long long y0_stride,              // 0 (one y0 for all) or 2 m_h
    const float* __restrict__ theta,  // (>= iterations,)
    const float* __restrict__ beta,
    const float* __restrict__ L,      // () Lipschitz constant
    int B, int m_h, int n_z, int n_s, int iterations,
    float* z,                         // (B, n_z)
    float* y,                         // (B, 2, m_h)
    float* yprev,                     // (B, 2, m_h) scratch
    float* w,                         // (B, 2, m_h): the last w (or scratch)
    float* zhat)                      // (B, n_z): the last zhat (or scratch)
{
    extern __shared__ float smem[];
    float* wd = smem;                 // [i][t], m_h * T
    float* zh = wd + m_h * T;         // [c][t], n_z * T
    const float inv_L = 1.0f / L[0];  // IEEE division, as torch's 1 / L
    const int tid = threadIdx.x;
    const long long b0 = (long long)blockIdx.x * T;
    const int nv = (int)min((long long)T, B - b0);
    const long long h = 2LL * m_h;
    // y = y_prev = y0; z, w and zhat start at 0 (an empty loop's output)
    for (int idx = tid; idx < nv * 2 * m_h; idx += kThreads) {
        const int t = idx / (2 * m_h), r = idx - t * 2 * m_h;
        const long long o = (b0 + t) * h + r;
        const float v = y0 ? y0[(b0 + t) * y0_stride + r] : 0.0f;
        y[o] = v;
        yprev[o] = v;
        w[o] = 0.0f;
    }
    for (int idx = tid; idx < nv * n_z; idx += kThreads) {
        z[b0 * n_z + idx] = 0.0f;
        zhat[b0 * n_z + idx] = 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < iterations; ++k) {
        const float theta_k = theta[k], beta_k = beta[k];
        // (A) w = y + beta (y - y_prev) for every dual row
#pragma unroll
        for (int t = 0; t < T; ++t) {
            const long long o = (b0 + t) * h;
            for (int i = tid; i < m_h; i += kThreads) {
                if (t >= nv) {
                    wd[i * T + t] = 0.0f;
                    continue;
                }
                const float yp = y[o + i], ym = y[o + m_h + i];
                const float wp = yp + beta_k * (yp - yprev[o + i]);
                const float wm = ym + beta_k * (ym - yprev[o + m_h + i]);
                w[o + i] = wp;
                w[o + m_h + i] = wm;
                wd[i * T + t] = wp - wm;
            }
        }
        __syncthreads();
        // (B) zhat = -(wd MG_T) - g_P, z = (1 - theta) z + theta zhat
        auto primal = [&](int c, const float (&acc)[T]) {
#pragma unroll
            for (int t = 0; t < T; ++t) {
                float v = 0.0f;
                if (t < nv) {
                    const long long o = (b0 + t) * n_z + c;
                    v = -acc[t] - gP[o];
                    zhat[o] = v;
                    z[o] = (1.0f - theta_k) * z[o] + theta_k * v;
                }
                zh[c * T + t] = v;
            }
        };
        product<T>(MG, n_z, m_h, n_z, wd, primal);
        __syncthreads();
        // (C) q = zhat GL_T[:, :n_s] on the structural rows, zhat / L on
        // the box rows; projection, y_prev = y
        auto project = [&](int i, float q, int t) {
            const long long o = (b0 + t) * h;
            const float yp = y[o + i], ym = y[o + m_h + i];
            yprev[o + i] = yp;
            yprev[o + m_h + i] = ym;
            y[o + i] = fmaxf(w[o + i] + q + pD[o + i], 0.0f);
            y[o + m_h + i] = fmaxf(w[o + m_h + i] - q + pD[o + m_h + i], 0.0f);
        };
        auto structural = [&](int i, const float (&acc)[T]) {
#pragma unroll
            for (int t = 0; t < T; ++t)
                if (t < nv) project(i, acc[t], t);
        };
        product<T>(GL, m_h, n_z, n_s, zh, structural);
        for (int i = tid; i < m_h; i += kThreads) {
            if (i < n_s) continue;
#pragma unroll
            for (int t = 0; t < T; ++t)
                if (t < nv) project(i, zh[(i - n_s) * T + t] * inv_L, t);
        }
        // the next phase A writes only wd, which phase B has read; phase
        // C's zh reads end before the barrier that follows it
    }
}

template <int T>
int launch(const float* MG, const float* GL, const float* gP, const float* pD,
           const float* y0, long long y0_stride, const float* theta,
           const float* beta, const float* L, int B, int m_h, int n_z, int n_s,
           int iterations, float* z, float* y, float* yprev, float* w,
           float* zhat, int smem, cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        gpad_flat_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    gpad_flat_tiled_kernel<T><<<(B + T - 1) / T, kThreads, (size_t)smem,
                                stream>>>(
        MG, GL, gP, pD, y0, y0_stride, theta, beta, L, B, m_h, n_z, n_s,
        iterations, z, y, yprev, w, zhat);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs on `stream` and returns cudaGetLastError() (0 on success). `smem` is
// the block's dynamic shared memory in bytes, computed by the caller
// (kernels.py::_flat_tiled_smem_bytes) so the routing guard and the launch
// agree; log2_tile must be in [0, 3].
int gpad_flat_tiled_launch(
    const float* MG, const float* GL, const float* gP, const float* pD,
    const float* y0, long long y0_stride, const float* theta,
    const float* beta, const float* L, int B, int m_h, int n_z, int n_s,
    int iterations, int log2_tile, float* z, float* y, float* yprev, float* w,
    float* zhat, int smem, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
#define GPAD_FLAT(T)                                                          \
    return launch<T>(MG, GL, gP, pD, y0, y0_stride, theta, beta, L, B, m_h,   \
                     n_z, n_s, iterations, z, y, yprev, w, zhat, smem, st)
    switch (log2_tile) {
        case 0: GPAD_FLAT(1);
        case 1: GPAD_FLAT(2);
        case 2: GPAD_FLAT(4);
        case 3: GPAD_FLAT(8);
        default: return (int)cudaErrorInvalidValue;
    }
#undef GPAD_FLAT
}

}  // extern "C"
