// The product of the flat tiled GPAD kernel (csrc/gpad_flat_tiled.cu): v M
// for a block's T scenarios, with M a row-major operand read from device
// memory (L2) and v in shared memory.
//
// Each of the block's kThreads threads owns the output columns
// c = tid (mod kThreads) and holds up to kMaxCols of them x T scenarios of
// accumulators in registers, so one coalesced load of an operand word feeds
// T FMAs and one shared-memory read of v (a broadcast) feeds up to
// kMaxCols; the next rows' operand words are in flight meanwhile. The caller's epilogue gets each column's T sums in the thread
// that owns the column, so per-column state kept in device memory is only
// ever reread by the thread that wrote it. Plain fp32 FMA.

#pragma once

#include <cuda_runtime.h>

namespace gpad_tiled {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 4;  // columns per thread in one pass of a product

// out[c][t] = sum_j v[j][t] M[j][c] for the columns c = c0 + q kThreads +
// tid (q < C) of row-major M (n_rows, ld); v is [j][t] in shared memory.
// Calls epi(c, acc) for each column c < n_cols with its T sums, each summed
// over j in ascending order. The operand words of the next U rows are
// loaded while the current U rows are multiplied, so a thread keeps U C
// loads in flight: one block alone must cover the L2 latency where it is
// the only block on its SM.
template <int T, int C, typename Epi>
__device__ __forceinline__ void product_pass(
    const float* __restrict__ M, long long ld, int n_rows, int n_cols, int c0,
    const float* v, Epi& epi)
{
    // rows in flight, within the 128 registers a 512-thread block allows
    constexpr int U = C * T <= 8 ? 8 : (C * T <= 16 ? 4 : 2);
    const int tid = threadIdx.x;
    float acc[C][T];
    bool ok[C];
    int col[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
        const int c = c0 + q * kThreads + tid;
        ok[q] = c < n_cols;
        col[q] = ok[q] ? c : 0;
#pragma unroll
        for (int t = 0; t < T; ++t) acc[q][t] = 0.0f;
    }
    float next[U][C];
    const float* row = M;  // row j0 of the batch being fetched
    auto fetch = [&](int j0) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int q = 0; q < C; ++q)
                next[u][q] = ok[q] && j0 + u < n_rows
                                 ? __ldg(row + u * ld + col[q]) : 0.0f;
    };
    fetch(0);
    for (int j0 = 0; j0 < n_rows; j0 += U) {
        float cur[U][C];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int q = 0; q < C; ++q) cur[u][q] = next[u][q];
        row += U * ld;
        fetch(j0 + U);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = j0 + u;
            if (j >= n_rows) break;
            float vj[T];
            if constexpr (T >= 4) {
#pragma unroll
                for (int t = 0; t < T; t += 4) {
                    const float4 x =
                        *reinterpret_cast<const float4*>(v + j * T + t);
                    vj[t] = x.x; vj[t + 1] = x.y; vj[t + 2] = x.z; vj[t + 3] = x.w;
                }
            } else {
#pragma unroll
                for (int t = 0; t < T; ++t) vj[t] = v[j * T + t];
            }
#pragma unroll
            for (int q = 0; q < C; ++q)
#pragma unroll
                for (int t = 0; t < T; ++t)
                    acc[q][t] = fmaf(vj[t], cur[u][q], acc[q][t]);
        }
    }
#pragma unroll
    for (int q = 0; q < C; ++q)
        if (ok[q]) epi(c0 + q * kThreads + tid, acc[q]);
}

// Every column of the product v M (see product_pass), in passes of up to
// kMaxCols columns per thread.
template <int T, typename Epi>
__device__ void product(const float* __restrict__ M, long long ld, int n_rows,
                        int n_cols, const float* v, Epi epi)
{
    for (int c0 = 0; c0 < n_cols; c0 += kMaxCols * kThreads) {
        const int left = n_cols - c0;
        if (left > 3 * kThreads)
            product_pass<T, 4>(M, ld, n_rows, n_cols, c0, v, epi);
        else if (left > 2 * kThreads)
            product_pass<T, 3>(M, ld, n_rows, n_cols, c0, v, epi);
        else if (left > kThreads)
            product_pass<T, 2>(M, ld, n_rows, n_cols, c0, v, epi);
        else
            product_pass<T, 1>(M, ld, n_rows, n_cols, c0, v, epi);
    }
}

}  // namespace gpad_tiled
