// Dense (unpaired) GPAD with both operands read from device memory on every
// iteration: a whole fixed-budget solve per launch.
//
// Replaces tpu_gpad/solver/kernels.py::_gpad_kernel (the Pallas TPU kernel
// behind gpad_pallas_fixed) at the stacks past one block's shared memory,
// where the resident dense kernel (csrc/gpad_dense.cu, m <= 280 at n_z 60)
// stops and the Pallas kernel's VMEM does not (battery n5 N20, m 440, to
// n5 N50, m 1100). It computes what csrc/gpad_dense.cu computes, per
// scenario, for each iteration k < iterations:
//
//   w    = y + beta_k (y - y_prev)
//   zhat = -MG_T' w - g_P                         MG_T (m, n_z)
//   z    = (1 - theta_k) z + theta_k zhat         z starts at 0
//   y    = relu(w + GL_T' zhat + p_D)             GL_T (n_z, m)
//
// on the reference's [S; -S; I; -I; K; -K] stack (dualize(..., paired=
// False)). Fixed mode only, no soft rows, as tpu_gpad's dense kernel.
//
// What bounds it: an iteration is 4 m n_z FLOP per scenario, so B = 256 x
// 100 iterations is 17.2 GFLOP at battery n10 N20 (m 840, n_z 200), 0.26 ms
// at the card's FP32 rate, and 337 GFLOP at the 30x30 flagship's dense
// layout (m 3660, n_z 900), 5.0 ms; the operands (2 m n_z words, 26 MB at
// the flagship) fit the 50 MB L2, so every operand word read from L2 feeds
// T multiply-adds per scenario tile, the L2-to-SM traffic 8 m n_z B / T
// bytes an iteration.
//
// Design: the flat tiled kernel's body (csrc/tiled_mvp.cuh) with a
// one-sided state: clusters of up to 16 blocks own a tile of up to 16
// scenarios; block r computes zhat and z for its n_z / C columns from its
// slice of MG_T and the projection and the next w for its m / C rows from
// its slice of GL_T; wd (= w here) and zhat reach every block of the
// cluster through distributed shared memory. Its plan is the flat tiled
// kernel's with m in place of m_h (kernels.py::pick_flat_tiled): one block
// holds 4 T (m + n_z + 512) bytes, T 8 at the flagship (162 KB). Every
// precision tier as the flat tiled kernel runs it (tiled_product.cuh).

#include <cuda_runtime.h>

#include "tiled_mvp.cuh"

namespace {

template <int T, int kTier>
__global__ void __launch_bounds__(gpad_tiled_mvp::kThreads, 1)
gpad_dense_tiled_kernel(
    const float* __restrict__ MG, const float* __restrict__ GL,
    const float* __restrict__ gP, const float* __restrict__ pD,
    const float* __restrict__ y0, long long y0_stride,
    const float* __restrict__ theta, const float* __restrict__ beta,
    const float* __restrict__ L, int B, int m_h, int n_z, int n_s,
    int iterations, int grouped, float* z, float* y, float* w, float* zhat)
{
    // no soft rows: the dense loop never reads od
    gpad_tiled_mvp::mvp_loop<T, kTier, true>(
        MG, GL, gP, pD, y0, y0_stride, nullptr, theta, beta, L, B, m_h, n_z,
        n_s, iterations, grouped, z, y, w, zhat);
}

// The instances, for gpad_tiled_mvp::kernel_of (no soft rows)
struct Instances {
    using Fn = decltype(&gpad_dense_tiled_kernel<1, gpad_mma::kHighest>);
    static constexpr bool kHasSoft = false;
    template <int T, int kTier, bool>
    static Fn of() { return gpad_dense_tiled_kernel<T, kTier>; }
};

}  // namespace

extern "C" {

// Runs on `stream` and returns a cudaError_t (0 on success), refusing what
// gpad_flat_tiled_launch refuses (cudaErrorInvalidValue), else the
// launch's error. pD, y0, y and w are (., m); `y0_stride` is 0 (one y0 for
// all) or m. The plan (log2_tile, cluster, grouped) and `smem` are
// kernels.py::pick_flat_tiled's and _flat_tiled_smem_bytes's at m; `w` is
// the state (the last w on return); `zhat` may be null; `tier` as there.
int gpad_dense_tiled_launch(
    const float* MG, const float* GL, const float* gP, const float* pD,
    const float* y0, long long y0_stride, const float* theta,
    const float* beta, int B, int m, int n_z, int iterations, int log2_tile,
    int cluster, int grouped, float* z, float* y, float* w, float* zhat,
    int smem, int tier, void* stream)
{
    if (!gpad_tiled_mvp::plan_ok(B, m, n_z, log2_tile, cluster, grouped, smem,
                                 tier))
        return (int)cudaErrorInvalidValue;
    return gpad_tiled_mvp::launch(
        gpad_tiled_mvp::kernel_of<Instances>(log2_tile, tier), B,
        1 << log2_tile, cluster, smem, (cudaStream_t)stream, MG, GL, gP, pD,
        y0, y0_stride, theta, beta, (const float*)nullptr, B, m, n_z, m,
        iterations, grouped, z, y, w, zhat);
}

}  // extern "C"
