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
//   w+-  = y+- + beta_k (y+- - y+-_prev)
//   zhat = -MG_T' (w+ - w-) - g_P                 MG_T (m_h, n_z)
//   z    = (1 - theta_k) z + theta_k zhat         z starts at 0
//   q    = [ GL_T[:, :n_s]' zhat ; zhat / L ]     box rows need no product
//   y+   = relu(w+ od + q + p_D+),  y- = relu(w- od - q + p_D-)
//
// The dual rows are in [struct | box] order (dualize puts the identity rows
// last), so unlike the TPU kernel there is no padding or layout mapping on
// either side. Fixed mode only: no restart, as in tpu_gpad. od = 1 -
// soft_damp damps the soft rows of device-condensed data (one float a row,
// read from L1/L2 beside p_D, in instances of their own), as the resident
// kernels _gpad_kernel_paired_flat and _gpad_kernel_paired carry it;
// tpu_gpad's streamed kernel declines soft data, which its resident ones
// take up to their 12 MB VMEM budget, past this port's resident kernels'
// 227 KB. The damp adds m_h floats to the bytes moved and one multiply a
// row an iteration: soft ran at 1.000-1.008x the hard launch's time on an
// H100 80GB HBM3 at 700 W (PERF.md, section 5).
//
// What bounds it: at the flagship an iteration is 2 n_z (m_h + n_s) =
// 4.97 MFLOP per scenario, so B = 256 x 100 iterations is 127.2 GFLOP,
// 1.90 ms at the card's FP32 rate (0.26 ms at TF32's, 0.77 ms for "high"'s
// three products, 0.13 ms at bf16's). Every operand word read from L2 feeds T
// multiply-adds per scenario tile, so the L2-to-SM traffic is 9.9 MB B / T
// per iteration. The first design ran one block per tile of up to 8
// scenarios, and every block streamed both whole operands on every
// iteration.
//
// Design (csrc/tiled_mvp.cuh): clusters of up to 16 blocks own a tile of up to 16
// scenarios for the whole launch; each block reads only its slices of the
// operands, and wd and zhat go to every block of the cluster through
// distributed shared memory, two cluster barriers an iteration. The tier
// is a template parameter: fp32 FMA at "highest", mma.sync strips under a
// tier (tiled_product.cuh).
//
// The same kernel runs the full paired loop past one block's shared memory
// (the counterpart of _gpad_kernel_paired there, kernels.py::
// gpad_fixed_paired_tiled): at n_s = m_h a block owns no box row, and q is
// GL_T' zhat on every row.

#include <cuda_runtime.h>

#include "tiled_mvp.cuh"

namespace {

template <int T, int kTier, bool kSoft>
__global__ void __launch_bounds__(gpad_tiled_mvp::kThreads, 1)
gpad_flat_tiled_kernel(
    const float* __restrict__ MG, const float* __restrict__ GL,
    const float* __restrict__ gP, const float* __restrict__ pD,
    const float* __restrict__ y0, long long y0_stride,
    const float* __restrict__ od,
    const float* __restrict__ theta, const float* __restrict__ beta,
    const float* __restrict__ L, int B, int m_h, int n_z, int n_s,
    int iterations, int grouped, float* z, float* y, float* w, float* zhat)
{
    gpad_tiled_mvp::mvp_loop<T, kTier, kSoft>(
        MG, GL, gP, pD, y0, y0_stride, od, theta, beta, L, B, m_h, n_z, n_s,
        iterations, grouped, z, y, w, zhat);
}

// The instances, for gpad_tiled_mvp::kernel_of: soft rows (od) in
// instances of their own, so the hard ones are as they were
struct Instances {
    using Fn = decltype(&gpad_flat_tiled_kernel<1, gpad_mma::kHighest, false>);
    static constexpr bool kHasSoft = true;
    template <int T, int kTier, bool kSoft>
    static Fn of() { return gpad_flat_tiled_kernel<T, kTier, kSoft>; }
};

}  // namespace

extern "C" {

// Runs on `stream` and returns a cudaError_t (0 on success):
// cudaErrorInvalidValue for a tile outside [0, 4], a cluster that is not a
// power of two up to 16, `smem` below the carve-up's need, an unknown tier
// or, under a tier, a tile wider than one scenario without the groups'
// scratch (pick_flat_tiled gives none), else the launch's error. `smem` is
// the block's dynamic shared memory in bytes and (log2_tile, cluster,
// grouped) the plan, computed by the caller (kernels.py::pick_flat_tiled,
// _flat_tiled_smem_bytes) so the routing guard and the launch agree. A
// cluster of `cluster` blocks owns 2**log2_tile scenarios. pD, y0, y and w
// are (., 2, m_h); n_s = m_h runs the full paired loop. `od` (m_h,) is
// 1 - soft_damp, or null for hard rows. `w` is the state (the last w on
// return, undamped); `zhat` may be null. `tier` is the products'
// precision (gpad_mma::Tier: 0 "highest", 1 "high", 2 "default", 3
// "bfloat16").
int gpad_flat_tiled_launch(
    const float* MG, const float* GL, const float* gP, const float* pD,
    const float* y0, long long y0_stride, const float* od, const float* theta,
    const float* beta, const float* L, int B, int m_h, int n_z, int n_s,
    int iterations, int log2_tile, int cluster, int grouped, float* z,
    float* y, float* w, float* zhat, int smem, int tier, void* stream)
{
    if (n_s < 0 || n_s > m_h
        || !gpad_tiled_mvp::plan_ok(B, m_h, n_z, log2_tile, cluster, grouped,
                                    smem, tier))
        return (int)cudaErrorInvalidValue;
    return gpad_tiled_mvp::launch(
        gpad_tiled_mvp::kernel_of<Instances>(log2_tile, tier, od != nullptr),
        B, 1 << log2_tile, cluster, smem, (cudaStream_t)stream, MG, GL, gP,
        pD, y0, y0_stride, od, theta, beta, L, B, m_h, n_z, n_s, iterations,
        grouped, z, y, w, zhat);
}

// Clusters of the plan (log2_tile, cluster, smem, tier; hard rows) the
// card holds at once (cudaOccupancyMaxActiveClusters), or a negative
// cudaError_t.
int gpad_flat_tiled_max_clusters(int log2_tile, int cluster, int smem,
                                 int tier)
{
    if (log2_tile < 0 || log2_tile > 4 || tier < gpad_mma::kHighest
        || tier > gpad_mma::kBfloat16)
        return -(int)cudaErrorInvalidValue;
    return gpad_tiled_mvp::max_clusters(
        gpad_tiled_mvp::kernel_of<Instances>(log2_tile, tier), cluster, smem);
}

}  // extern "C"
