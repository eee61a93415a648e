// The tensor-core products of the precision tiers in the GPAD kernels: the
// tier counterpart of block_product.cuh (the resident dual, paired and dense
// kernels, csrc/gpad_dual.cu, csrc/gpad_paired_flat.cu, csrc/gpad_dense.cu)
// and, through the fragment helpers below, of tiled_product.cuh (the tiled
// kernels, csrc/gpad_dual_tiled.cu, csrc/gpad_flat_tiled.cu). The FFMA
// products of those headers stay the products of precision "highest". The
// block form computes the same
//
//   out[r][s] = sum_{k < K} A[k][r] X[k][s]      r < R, s < T
//
// from the same fp32 operands in shared memory (A (K, R) laid out [k][r],
// X the state of the block's T scenarios, [k][scenario]), and replaces
// tpu_gpad/solver/kernels.py::_kdot (with _prep_operand, _kernel_precision)
// in the Pallas kernels' bodies. The tiers on the card (the CPU mirror:
// kernels.py::_tier_mm over core._round_tf32, _split_tf32_rna, _round_bf16):
//
//   default   one mma.sync m16n8k8 TF32 product a k-step, both operands
//             rounded by cvt.rna.tf32.f32, fp32 accumulation
//   high      3xTF32: hi = rna(a), lo = rna(a - hi) of both operands, and
//             per k-step lo.hi + hi.lo first, then hi.hi. The TPU's "high"
//             is bf16x3; on Hopper it is 3xTF32, about fp32's accuracy.
//   bfloat16  mma.sync m16n8k16 bf16 (__float2bfloat16_rn), fp32
//             accumulation and output
//
// A warp owns a tile of 16 rows x 8 scenarios over one split-K part and
// loads its fragments by hand from fp32 shared memory, rounding or splitting
// each value as it loads it: the constants stay fp32 in shared memory, so a
// block's operand bytes do not grow with the tier. Rows past R, scenarios
// past T (T is 1 to 16: a tile of T < 8 leaves columns idle) and k past the
// part's end read as zeros; rows and scenarios past them are never stored.
// The tiles x parts work items go round the block's warps; part p covers the
// k-steps [p steps / S, (p + 1) steps / S), and every part's sums go to the
// caller's split-K scratch [p][up4(R)][T], which gpad_block::sum_parts adds
// in part order, so a run is deterministic; a product of one part may hand
// each sum to the caller's epilogue from the fragment instead (the dense
// kernel, whose one-part products have no scratch). What bounds it at these
// shapes is latency, as it bounds the FFMA product (PERF.md section 5: the
// resident kernels at 4.4-9.3x their fp32 bound at B4096): a k-step is one
// mma, or three, behind its fragments' shared-memory loads. wgmma, TMA and
// bf16 operands in shared memory are not used.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gpad_mma {

// The tiers as the C launchers take them (kernels.py::KERNEL_TIERS)
enum Tier { kHighest = 0, kHigh = 1, kDefault = 2, kBfloat16 = 3 };

constexpr int kRows = 16;  // rows of a warp's tile (the mma's M)
constexpr int kCols = 8;   // scenarios of a warp's tile (the mma's N)

// The k of one mma: 8 TF32 values (m16n8k8) or 16 bf16 ones (m16n8k16)
template <int kTier>
constexpr int kStep = kTier == kBfloat16 ? 16 : 8;

// x rounded to TF32, to nearest with ties away from zero; the low 13 bits
// cleared, so that x - tf32_rna(x) is exact
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r & 0xffffe000u;
}

// Two values rounded to bf16 (to nearest even), the first in the low half
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b on one 16 x 8 tile: TF32 over k = 8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b on one 16 x 8 tile: bf16 over k = 16
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The k of the values a lane loads in a k-step, e < kLaneK: the PTX
// fragment layouts' (TF32: t and t + 4; bf16: 2t, 2t + 1, 2t + 8, 2t + 9)
template <int kTier>
constexpr int kLaneK = kStep<kTier> / 4;

template <int kTier>
__device__ __forceinline__ int lane_k(int t, int e) {
    if constexpr (kTier == kBfloat16) return 2 * t + (e & 1) + 8 * (e >> 1);
    else return t + 4 * e;
}

// One k-step's A fragment at kTier from a lane's raw fp32 values a[e][h]
// (k = lane_k(t, e), row g + 8 h): TF32 hi and, for "high", lo; bf16 pairs
// (lo unused).
template <int kTier>
__device__ __forceinline__ void a_frag(const float (&a)[kLaneK<kTier>][2],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    if constexpr (kTier == kBfloat16) {
        hi[0] = bf16_pair(a[0][0], a[1][0]);
        hi[1] = bf16_pair(a[0][1], a[1][1]);
        hi[2] = bf16_pair(a[2][0], a[3][0]);
        hi[3] = bf16_pair(a[2][1], a[3][1]);
    } else {
        const float v[4] = {a[0][0], a[0][1], a[1][0], a[1][1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            hi[e] = tf32_rna(v[e]);
            if constexpr (kTier == kHigh)
                lo[e] = tf32_rna(v[e] - __uint_as_float(hi[e]));
        }
    }
}

// One k-step's X fragment at kTier from a lane's raw values x[e]
// (k = lane_k(t, e), scenario g)
template <int kTier>
__device__ __forceinline__ void b_frag(const float (&x)[kLaneK<kTier>],
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
    if constexpr (kTier == kBfloat16) {
        hi[0] = bf16_pair(x[0], x[1]);
        hi[1] = bf16_pair(x[2], x[3]);
    } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            hi[e] = tf32_rna(x[e]);
            if constexpr (kTier == kHigh)
                lo[e] = tf32_rna(x[e] - __uint_as_float(hi[e]));
        }
    }
}

// d += one k-step's product at kTier, in warp_tile's order ("high": lo.hi,
// hi.lo, then hi.hi)
template <int kTier>
__device__ __forceinline__ void mma_tier(float (&d)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
    if constexpr (kTier == kBfloat16) {
        mma_bf16(d, ah, bh);
    } else {
        if constexpr (kTier == kHigh) {
            mma_tf32(d, al, bh);
            mma_tf32(d, ah, bl);
        }
        mma_tf32(d, ah, bh);
    }
}

// The warp's sums d of the tile at rows r0.., scenarios s0.., k in [k0, k1).
// Lane (g, t) = (lane / 4, lane mod 4) loads the fragments of the PTX
// layouts: A's rows g and g + 8 (the mma's row-major A is A[k][r] read
// across), X's column g; d[0..1] are row g, scenarios 2t and 2t + 1, and
// d[2..3] row g + 8.
template <int kTier>
__device__ __forceinline__ void warp_tile(
    const float* __restrict__ A, int lda, int R, const float* __restrict__ X,
    int T, int r0, int s0, int k0, int k1, float (&d)[4])
{
    constexpr int KL = kLaneK<kTier>;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bool row_a = r0 + g < R, row_b = r0 + g + 8 < R, col = s0 + g < T;
    const float* Ag = A + r0 + g;
    const float* Xg = X + s0 + g;
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = 0.0f;
    for (int kk = k0; kk < k1; kk += kStep<kTier>) {
        // A[k][r0 + g + 8 h] and X[k][s0 + g], zero past the edges and the
        // part
        float a[KL][2], x[KL];
#pragma unroll
        for (int e = 0; e < KL; ++e) {
            const int k = kk + lane_k<kTier>(t, e);
            const bool in = k < k1;
            a[e][0] = row_a && in ? Ag[k * lda] : 0.0f;
            a[e][1] = row_b && in ? Ag[k * lda + 8] : 0.0f;
            x[e] = col && in ? Xg[k * T] : 0.0f;
        }
        uint32_t ah[4], al[4] = {}, bh[2], bl[2] = {};
        a_frag<kTier>(a, ah, al);
        b_frag<kTier>(x, bh, bl);
        mma_tier<kTier>(d, ah, al, bh, bl);
    }
}

// The warp tiles of out = A' X at a tier (kHigh, kDefault, kBfloat16) for
// 2**log2T scenarios in S parts: work item w = p tiles + tile taken by warp
// w mod kWarps (every lane of a warp takes the same items, as mma.sync
// needs); store(p, r, s, sum) once for each of an item's sums at r < R and
// s < T.
template <int kTier, int kThreads, typename Store>
__device__ __forceinline__ void mma_items(
    const float* __restrict__ A, int lda, const float* __restrict__ X,
    int log2T, int R, int K, int S, Store&& store)
{
    static_assert(kTier != kHighest, "highest runs block_product.cuh");
    constexpr int kWarps = kThreads / 32, kS = kStep<kTier>;
    const int T = 1 << log2T, cols = (T + kCols - 1) / kCols;
    const int tiles = (R + kRows - 1) / kRows * cols;
    const int steps = (K + kS - 1) / kS;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    for (int w = threadIdx.x >> 5; w < tiles * S; w += kWarps) {
        const int tile = w % tiles, p = w / tiles;
        const int r0 = tile / cols * kRows, s0 = tile % cols * kCols;
        const int k0 = p * steps / S * kS;
        const int k1 = min((p + 1) * steps / S * kS, K);
        float d[4];
        warp_tile<kTier>(A, lda, R, X, T, r0, s0, k0, k1, d);
        const int s = s0 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + g + 8 * h;
            if (r >= R) continue;
            if (s < T) store(p, r, s, d[2 * h]);
            if (s + 1 < T) store(p, r, s + 1, d[2 * h + 1]);
        }
    }
}

// The block's share of out = A' X at a tier in S parts, each item's sums to
// `part` (S * up4(R) * T floats, [p][r][s]).
template <int kTier, int kThreads>
__device__ __forceinline__ void mma_product(
    const float* __restrict__ A, int lda, const float* __restrict__ X,
    int log2T, int R, int K, int S, float* __restrict__ part)
{
    const int T = 1 << log2T, Rp = (R + 3) & ~3;
    mma_items<kTier, kThreads>(A, lda, X, log2T, R, K, S,
                               [&](int p, int r, int s, float v) {
                                   part[((long long)p * Rp + r) * T + s] = v;
                               });
}

// The block's share of out = A' X at a tier in one part, with no scratch:
// emit(r, s, sum) once for each r < R and s < T, from the fragment.
template <int kTier, int kThreads, typename Emit>
__device__ __forceinline__ void mma_product_emit(
    const float* __restrict__ A, int lda, const float* __restrict__ X,
    int log2T, int R, int K, Emit&& emit)
{
    mma_items<kTier, kThreads>(A, lda, X, log2T, R, K, 1,
                               [&](int, int r, int s, float v) {
                                   emit(r, s, v);
                               });
}

}  // namespace gpad_mma
