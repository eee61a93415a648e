// The register-tiled block product of the resident dense, dual and paired
// GPAD kernels (csrc/gpad_dense.cu, csrc/gpad_dual.cu,
// csrc/gpad_paired_flat.cu):
//
//   out[r][s] = sum_{k < K} A[k][r] X[k][s]      r < R, s < T
//
// with A (K, R) an operand and X (K, T) the state of the block's T
// scenarios, both in shared memory, row-major, X laid out [k][scenario].
//
// Each thread computes a tile of 4 rows x ST scenarios (ST = min(T, 4)) in
// registers: per k it reads 4 consecutive words of A and ST consecutive
// words of X, in one 16-byte load each where A's rows are padded to a
// multiple of 4 (V = 4), and does 4 ST multiply-adds; the next k's words
// are loaded before this k's multiply-adds, so a load's latency overlaps
// them. An old design read two shared-memory words per multiply-add; here
// one word feeds ST (A) or 4 (X) of them. The block's NT = (ceil(R / 4))
// (T / ST) tiles are each split over K into S parts (split-K), so a short
// product still keeps the block's threads busy and no thread runs a
// K-long dependent chain. With S > 1 each part's sums go to a scratch
// [p][r][s] in shared memory, and after a barrier sum_parts adds them in
// part order 0, 1, ..., S - 1, each part's own sum taken over k in
// ascending order: one fixed order, so a run is deterministic. With S = 1
// and no scratch the caller's epilogue takes each tile's sums from
// registers. A thread's work items are the same in every iteration, so
// its first one is computed once (Product) and only a block with more
// items than threads divides again.
//
// Plain fp32 FMA (precision "highest").

#pragma once

#include <cuda_runtime.h>

namespace gpad_block {

constexpr int kRows = 4;  // rows of a thread's tile

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
    if constexpr (N == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else if constexpr (N == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        x[0] = v.x; x[1] = v.y;
    } else {
        x[0] = p[0];
    }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
    if constexpr (N == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else if constexpr (N == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
    } else {
        p[0] = x[0];
    }
}

// A work item: rows r0.. and scenarios s0.. of part p, k in [k0, k1).
struct Item {
    int r0, s0, k0, k1, p;
};

// One product's carve-up over the block, and this thread's first item.
struct Product {
    int R, K, S, NT, log2_per_row, items;
    Item first;
};

template <int ST>
__device__ __forceinline__ Item item_of(const Product& P, int w) {
    const int tile = w % P.NT, p = w / P.NT;
    const int st = tile & ((1 << P.log2_per_row) - 1);
    return {(tile >> P.log2_per_row) * kRows, st * ST, p * P.K / P.S,
            (p + 1) * P.K / P.S, p};
}

// out = A' X with R output rows over K, for 2**log2T scenarios in S parts.
template <int ST>
__device__ Product make_product(int R, int K, int log2T, int S) {
    Product P;
    P.R = R;
    P.K = K;
    P.S = S;
    P.log2_per_row = log2T - (ST == 4 ? 2 : ST == 2 ? 1 : 0);
    P.NT = (up4(R) / kRows) << P.log2_per_row;
    P.items = P.NT * S;
    // a product with no rows (an empty structural block) has no items
    P.first = P.NT ? item_of<ST>(P, threadIdx.x) : Item{0, 0, 0, 0, 0};
    return P;
}

// acc[r][s] = sum_{k0 <= k < k1} A[k lda + r0 + r] X[k T + s0 + s]. V = 4:
// lda and r0 are multiples of 4 (one 16-byte load of A per k); V = 1: A is
// unpadded and rows past R - 1 are read at R - 1 (their sums are never
// stored).
template <int V, int ST>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ A, int lda, int R, const float* __restrict__ X,
    int T, const Item& it, float (&acc)[kRows][ST])
{
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int s = 0; s < ST; ++s) acc[r][s] = 0.0f;
    if (it.k0 >= it.k1) return;
    int row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) row[r] = min(it.r0 + r, R - 1);
    auto load = [&](int k, float (&a)[kRows], float (&x)[ST]) {
        if constexpr (V == 4) {
            load_vec<4>(A + k * lda + it.r0, a);
        } else {
#pragma unroll
            for (int r = 0; r < kRows; ++r) a[r] = A[k * lda + row[r]];
        }
        load_vec<ST>(X + k * T + it.s0, x);
    };
    float a[kRows], x[ST];
    load(it.k0, a, x);
#pragma unroll 2
    for (int k = it.k0; k < it.k1; ++k) {
        // the next k's words (the last step reloads its own)
        float an[kRows], xn[ST];
        load(min(k + 1, it.k1 - 1), an, xn);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int s = 0; s < ST; ++s) acc[r][s] = fmaf(a[r], x[s], acc[r][s]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = an[r];
#pragma unroll
        for (int s = 0; s < ST; ++s) x[s] = xn[s];
    }
}

// The block's share of out = A' X: work item w = p NT + tile taken by
// thread w mod kThreads; tile = rt (T / ST) + st covers rows 4 rt.. and
// scenarios ST st..; part p covers k in [p K / S, (p + 1) K / S). With
// `part` (S * up4(R) * T floats) each item's sums are stored there;
// without it (S must be 1) emit(r, s0, sums) is called with the ST sums of
// each of the tile's rows r < R.
template <int V, int ST, int kThreads, typename Emit>
__device__ __forceinline__ void block_product(
    const float* __restrict__ A, int lda, const float* __restrict__ X,
    int log2T, const Product& P, float* part, Emit&& emit)
{
    const int T = 1 << log2T;
    auto run = [&](const Item& it) {
        float acc[kRows][ST];
        tile_product<V, ST>(A, lda, P.R, X, T, it, acc);
        if (part) {
            float* dst = part + ((long long)it.p * up4(P.R) + it.r0) * T + it.s0;
#pragma unroll
            for (int r = 0; r < kRows; ++r) store_vec<ST>(dst + r * T, acc[r]);
        } else {
#pragma unroll
            for (int r = 0; r < kRows; ++r)
                if (it.r0 + r < P.R) emit(it.r0 + r, it.s0, acc[r]);
        }
    };
    if ((int)threadIdx.x < P.items) run(P.first);
    // only a block with more items than threads divides again
    for (int w = threadIdx.x + kThreads; w < P.items; w += kThreads)
        run(item_of<ST>(P, w));
}

// The N outputs idx.. (one row, consecutive scenarios) of a product stored
// in parts of `stride` floats: the S partial sums added in part order.
template <int N>
__device__ __forceinline__ void sum_parts(const float* part, int stride,
                                          int S, int idx, float (&v)[N]) {
    load_vec<N>(part + idx, v);
#pragma unroll 4
    for (int p = 1; p < S; ++p) {
        float t[N];
        load_vec<N>(part + p * stride + idx, t);
#pragma unroll
        for (int e = 0; e < N; ++e) v[e] += t[e];
    }
}

}  // namespace gpad_block
