// The products of the tiled GPAD kernels (csrc/gpad_dual_tiled.cu,
// csrc/gpad_flat_tiled.cu): a thread's or a warp's share of X' A for a
// cluster's T scenarios, with A a row-major operand read from device memory
// (L2) and X, laid out [row][scenario], in shared memory. The kernels split
// the rows over groups of threads and add the groups' sums in one fixed
// order.
//
// product_rows (precision "highest", fp32 FMA): a thread holds CPT
// consecutive columns x T scenarios of sums in registers over a range of
// A's rows, so one coalesced load of an operand word feeds T multiply-adds
// and one broadcast shared-memory read of X feeds CPT; the next U rows'
// operand words are in flight meanwhile.
//
// mma_strip (the tiers "high", "default", "bfloat16", on the tensor cores;
// mma_product.cuh says how each tier rounds): a warp computes the sums of a
// strip of kStripCols = 64 columns (4 tiles of 16) x T scenarios (tiles of
// 8) over the same range of rows, each k-step one mma.sync per tile (three
// for "high"). Its lanes load their fragments by hand: A's values from L2
// through the read-only path, 8 consecutive columns of a row a lane group
// (one 32-byte sector), X's from shared memory, each value rounded or split
// as it is loaded, so the operands stay fp32 in memory. The next k-step's A
// values are loaded while the current one's mmas run. The strip runs in
// passes of a few tiles, whose loads are in flight together: 4 (bf16's
// twice-deep k-step 2) where the caller holds the whole strip's sums
// anyway (the flat tiled kernel), 2 (bf16 1) where each pass's sums go to
// the caller as it ends (the tiled dual kernel, whose wider passes spilled
// 44-80 bytes past the 128 registers of a 512-thread block). On an H100
// the wider passes ran the flat tiled kernel 10-15% faster under a tier
// (PERF.md section 6). At T < 8 a tile's columns past T stay idle.

#pragma once

#include <cuda_runtime.h>

#include "mma_product.cuh"

namespace gpad_tiled {

// acc[q][t] = sum_{j in [j_lo, j_hi)} X[j][t] A[j][col0 + q], ascending j,
// for the CPT columns col0.. below c_end (zeros past it); A has row stride
// lda. The next U rows' A words are loaded while the current U rows are
// multiplied.
template <int T, int CPT, int U>
__device__ __forceinline__ void product_rows(
    const float* __restrict__ A, int lda, int j_lo, int j_hi, int col0,
    int c_end, const float* X, float (&acc)[CPT][T])
{
    bool ok[CPT];
    int col[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
        ok[q] = col0 + q < c_end;
        col[q] = ok[q] ? col0 + q : 0;
#pragma unroll
        for (int t = 0; t < T; ++t) acc[q][t] = 0.0f;
    }
    const float* row = A + (long long)j_lo * lda;
    float next[U][CPT];
    auto fetch = [&](int j0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const bool in = j0 + u < j_hi;
#pragma unroll
            for (int q = 0; q < CPT; ++q)
                next[u][q] = ok[q] && in
                                 ? __ldg(row + (long long)u * lda + col[q]) : 0.0f;
        }
    };
    fetch(j_lo);
    for (int j0 = j_lo; j0 < j_hi; j0 += U) {
        float cur[U][CPT];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int q = 0; q < CPT; ++q) cur[u][q] = next[u][q];
        row += (long long)U * lda;
        fetch(j0 + U);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = j0 + u;
            if (j >= j_hi) break;
            float vj[T];
            if constexpr (T >= 4) {
#pragma unroll
                for (int t = 0; t < T; t += 4) {
                    const float4 x =
                        *reinterpret_cast<const float4*>(X + j * T + t);
                    vj[t] = x.x; vj[t + 1] = x.y; vj[t + 2] = x.z; vj[t + 3] = x.w;
                }
            } else {
#pragma unroll
                for (int t = 0; t < T; ++t) vj[t] = X[j * T + t];
            }
#pragma unroll
            for (int q = 0; q < CPT; ++q)
#pragma unroll
                for (int t = 0; t < T; ++t)
                    acc[q][t] = fmaf(vj[t], cur[u][q], acc[q][t]);
        }
    }
}

// A warp's strip under a tier: kStripTiles tiles of 16 columns, and the
// scenario tiles of 8 that T needs; its tiles a pass where each pass's
// sums go to the caller as it ends, and where the caller holds them all
constexpr int kStripTiles = 4;
constexpr int kStripCols = 16 * kStripTiles;
template <int T>
constexpr int kScenarioTiles = (T + 7) / 8;
template <int kTier>
constexpr int kPassTiles = kTier == gpad_mma::kBfloat16 ? 1 : 2;
template <int kTier>
constexpr int kHeldPassTiles = kTier == gpad_mma::kBfloat16 ? 2 : 4;

// d[C0 + c][n] += the tile sums of NC column tiles c from col0 + 16 C0
// (columns below c_end) over A's rows [j_lo, j_hi) at kTier, in the mma's C
// layout: lane (g, t)'s d[c][n][e] is column col0 + 16 c + g + 8 (e / 2),
// scenario 8 n + 2 t + e mod 2 (C0 a constant, so that d stays in
// registers). A's values for the next k-step are loaded before this one's
// mmas; X's come from shared memory as each k-step starts.
template <int kTier, int T, int NC, int C0, int ND>
__device__ __forceinline__ void strip_pass(
    const float* __restrict__ A, int lda, int j_lo, int j_hi, int col0,
    int c_end, const float* X, float (&d)[ND][kScenarioTiles<T>][4])
{
    using namespace gpad_mma;
    static_assert(C0 + NC <= ND, "the pass's tiles lie in d");
    constexpr int NS = kScenarioTiles<T>, KL = kLaneK<kTier>;
    constexpr int kS = kStep<kTier>;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    // this lane's column 16 c + 8 h (past col0 + 16 C0 + g) is below c_end
    // iff 16 c + 8 h < ncol, its scenario 8 n (past g) below T iff 8 n < nsc
    const int ncol = c_end - col0 - 16 * C0 - g, nsc = T - g;
    const float* Ag = A + col0 + 16 * C0 + g;
    const float* Xg = X + g;
    float an[NC][KL][2];
    auto fetch = [&](int kk) {
#pragma unroll
        for (int e = 0; e < KL; ++e) {
            const int k = kk + lane_k<kTier>(t, e);
            const bool in = k < j_hi;
            const float* row = Ag + (long long)k * lda;
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    an[c][e][h] = in && 16 * c + 8 * h < ncol
                                      ? __ldg(row + 16 * c + 8 * h) : 0.0f;
        }
    };
    fetch(j_lo);
    for (int kk = j_lo; kk < j_hi; kk += kS) {
        float a[NC][KL][2];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int e = 0; e < KL; ++e) {
                a[c][e][0] = an[c][e][0];
                a[c][e][1] = an[c][e][1];
            }
        fetch(kk + kS);  // the next k-step's values (zeros past j_hi)
        uint32_t bh[NS][2], bl[NS][2] = {};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
            float x[KL];
#pragma unroll
            for (int e = 0; e < KL; ++e) {
                const int k = kk + lane_k<kTier>(t, e);
                x[e] = k < j_hi && 8 * n < nsc ? Xg[k * T + 8 * n] : 0.0f;
            }
            b_frag<kTier>(x, bh[n], bl[n]);
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            uint32_t ah[4], al[4] = {};
            a_frag<kTier>(a[c], ah, al);
#pragma unroll
            for (int n = 0; n < NS; ++n)
                mma_tier<kTier>(d[C0 + c][n], ah, al, bh[n], bl[n]);
        }
    }
}

// f(col, s, sum) once for each of NC column tiles' sums from col0 at a
// column below c_end and a scenario below T (strip_pass's layout).
template <int T, int NC, typename F>
__device__ __forceinline__ void for_each_sum(
    const float (&d)[NC][kScenarioTiles<T>][4], int col0, int c_end, F&& f)
{
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int n = 0; n < kScenarioTiles<T>; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = col0 + 16 * c + g + 8 * (e >> 1);
                const int s = 8 * n + 2 * t + (e & 1);
                if (col < c_end && s < T) f(col, s, d[c][n][e]);
            }
}

// The warp's strip of columns [col0, col0 + kStripCols) (those below c_end)
// x T scenarios, pass by pass: f(col, s, sum) once for each sum, with
// sum = sum_{j in [j_lo, j_hi)} X[j][s] A[j][col], each k-step's products
// at kTier. Each pass's sums go to f as it ends.
template <int kTier, int T, typename F>
__device__ __forceinline__ void mma_strip(
    const float* __restrict__ A, int lda, int j_lo, int j_hi, int col0,
    int c_end, const float* X, F&& f)
{
    constexpr int NS = kScenarioTiles<T>, NC = kPassTiles<kTier>;
#pragma unroll
    for (int c = 0; c < kStripTiles; c += NC) {
        float d[NC][NS][4];
#pragma unroll
        for (int q = 0; q < NC; ++q)
#pragma unroll
            for (int n = 0; n < NS; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) d[q][n][e] = 0.0f;
        strip_pass<kTier, T, NC, 0>(A, lda, j_lo, j_hi, col0 + 16 * c, c_end,
                                    X, d);
        for_each_sum<T, NC>(d, col0 + 16 * c, c_end, f);
    }
}

// The warp's whole strip held in d (the flat tiled kernel's groups add
// their sums across a barrier), pass by pass, in strip_pass's layout.
template <int kTier, int T>
__device__ __forceinline__ void mma_strip(
    const float* __restrict__ A, int lda, int j_lo, int j_hi, int col0,
    int c_end, const float* X, float (&d)[kStripTiles][kScenarioTiles<T>][4])
{
    constexpr int NS = kScenarioTiles<T>, NC = kHeldPassTiles<kTier>;
#pragma unroll
    for (int c = 0; c < kStripTiles; ++c)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[c][n][e] = 0.0f;
    static_assert(kStripTiles == 4 && (NC == 2 || NC == 4), "the passes");
    strip_pass<kTier, T, NC, 0>(A, lda, j_lo, j_hi, col0, c_end, X, d);
    if constexpr (NC == 2)
        strip_pass<kTier, T, NC, 2>(A, lda, j_lo, j_hi, col0, c_end, X, d);
}

}  // namespace gpad_tiled
