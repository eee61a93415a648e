// The product of the tiled GPAD kernels (csrc/gpad_dual_tiled.cu,
// csrc/gpad_flat_tiled.cu): a thread's share of X' A for a cluster's T
// scenarios, with A a row-major operand read from device memory (L2) and
// X, laid out [row][scenario], in shared memory.
//
// A thread holds CPT consecutive columns x T scenarios of sums in
// registers over a range of A's rows, so one coalesced load of an operand
// word feeds T multiply-adds and one broadcast shared-memory read of X
// feeds CPT; the next U rows' operand words are in flight meanwhile. The
// kernels split the rows over groups of threads and add the groups' sums
// in one fixed order. Plain fp32 FMA (precision "highest").

#pragma once

#include <cuda_runtime.h>

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

}  // namespace gpad_tiled
