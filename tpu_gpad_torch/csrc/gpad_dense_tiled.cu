// Dense (unpaired) GPAD with both operands read from device memory on every
// iteration: a whole fixed-budget solve per launch.
//
// Replaces tpu_gpad/solver/kernels.py::_gpad_kernel (the Pallas TPU kernel
// behind gpad_pallas_fixed, kernels.py:336) at the stacks past one block's
// shared memory, where the resident dense kernel (csrc/gpad_dense.cu, m <=
// 280 at n_z 60) stops and the Pallas kernel's VMEM does not (battery n5
// N20, m 440, to the 30x30 flagship's dense layout, m 3660). It computes
// what csrc/gpad_dense.cu computes, per scenario, for each iteration
// k < iterations:
//
//   w    = y + beta_k (y - y_prev)
//   zhat = -MG_T' w - g_P                         MG_T (m, n_z)
//   z    = (1 - theta_k) z + theta_k zhat         z starts at 0
//   y    = relu(w + GL_T' zhat + p_D)             GL_T (n_z, m)
//
// on the reference's [S; -S; I; -I; K; -K] stack (dualize(..., paired=
// False)). Fixed mode only, no soft rows, as tpu_gpad's dense kernel.
//
// What bounds it: over the batch an iteration is two plain products,
// zhat (B x n_z) = -w (B x m) MG_T - g_P and q (B x m) = zhat GL_T, 4 m n_z
// B FLOP in all: at the flagship's dense layout (m 3660, n_z 900) B256 x
// 100 iterations is 337 GFLOP, 5.0 ms at the card's FP32 rate. The
// operands (2 m n_z words, 26 MB there) fit the 50 MB L2, so what sets the
// design is how many multiply-adds each operand byte staged from L2 feeds:
// a unit that tiles BM scenarios against 128 columns feeds BM / 4 FMA per
// operand byte and 32 per byte of the state, past the 2-4 at which the
// card's L2 would bound the FMA pipes. Measured on an H100 (PERF.md,
// section 6): a k-tile of 32 rows takes 1.3 us at 16 scenarios to 3.3 at
// 128 (about 73% of the FMA rate there), a grid barrier 2.6 us; the
// flagship B256 ran in 12.3 ms, 2.5x its bound.
//
// Design: one persistent cooperative launch of one block an SM, an
// iteration two card-wide product phases apart grid barriers:
//   A: units (scenario tile x 128 n_z columns x part of m), K = m;
//   B: units (scenario tile x 128 rows of m x part of n_z), K = n_z;
// the parts (kernels.py::pick_dense_tiled: as many as leave every unit of a
// phase in one wave) write partial sums to a scratch, which a pass of their
// own adds in part order before the epilogue; a phase of one part runs its
// epilogue in the unit. Phase A's epilogue forms zhat and z, phase B's the
// projection y = relu(w + q + p_D) and the next w; each element of the
// state is written by one thread. Everything a stage reads lives in the
// scratch the wrapper allocates (in L2 at these sizes), laid out so that a
// stage is one contiguous block of each: the operands in column tiles of
// 128 (rows padded to 136 floats, zeros past the stack), copied there once
// a launch, and the state (w, y, zhat, z, with p_D and g_P) in scenario
// tiles of BM (rows padded to BM + 8); the outputs are written in their
// (B, .) layout on the last iteration.
//
// A block is 8 consumer warps and a producer warp. The producer's lane 0
// stages each unit's operand and state tiles (32 rows of each) into a ring
// of shared-memory stages (8, 6 at 128 scenarios: what fits) by two bulk
// copies (cp.async.bulk), each stage's arrival signalled on an mbarrier
// ("full") and its release by the 8 consumer warps on another ("empty"),
// up to a ring ahead of the consumers and on into the block's next unit.
// (Staging from a consumer's thread instead held that warp back at every
// release and ran the flagship 1.4-1.8x slower.) The consumers compute
// from the stages that have arrived:
//   "highest": fp32 FMA, each thread a register tile of BM / 16 scenarios
//     x 8 columns from float4 reads of the staged tiles;
//   "high" (3xTF32), "default" (TF32), "bfloat16": mma.sync from the same
//     staged tiles (mma_product.cuh's fragments and rounding), each warp a
//     tile of BM / 2 scenarios x 32 columns; the operands stay fp32 in
//     memory and are rounded or split as each fragment is loaded, so every
//     tier stages the same tiles and the bf16 rounding costs no pass of its
//     own. wgmma is not used: it reads TF32 operands from shared memory
//     K-major only, which MG_T and GL_T as staged here are not.
// Every sum is taken in one fixed order (k ascending within a part, the
// parts in order), with no atomics, so two launches are bit-equal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_product.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;                 // the consumers
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kCols = 128;   // columns of a unit
constexpr int kDepth = 32;   // rows (k) of a stage
constexpr int kPad = 8;      // a staged row's padding, in floats
constexpr int kLdA = kCols + kPad;
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 16 * kMaxStages;
constexpr int kSmemLimit = 232448;  // a block's shared memory on sm_90

__host__ __device__ constexpr int ld_x(int BM) { return BM + kPad; }
__host__ __device__ constexpr int stage_floats(int BM) {
    return kDepth * (kLdA + ld_x(BM));
}
// The ring's stages: as many as fit a block's shared memory, at most 8
// (kernels.py::dense_tiled_stages)
__host__ __device__ constexpr int stages_of(int BM) {
    return (kSmemLimit - kBarrierBytes) / (stage_floats(BM) * 4) < kMaxStages
               ? (kSmemLimit - kBarrierBytes) / (stage_floats(BM) * 4)
               : kMaxStages;
}
// Dynamic shared memory of a block (kernels.py::_dense_tiled_smem_bytes)
__host__ __device__ constexpr int smem_bytes(int BM) {
    return kBarrierBytes + stages_of(BM) * stage_floats(BM) * 4;
}
__host__ __device__ constexpr long long up(long long n, long long q) {
    return (n + q - 1) / q * q;
}

struct Args {
    const float* MG;  // (m, n_z) row-major
    const float* GL;  // (n_z, m) row-major
    const float* gP;  // (B, n_z)
    const float* pD;  // (B, m)
    const float* y0;  // null (cold) or rows of y0_stride floats (0: one)
    long long y0_stride;
    const float* theta;
    const float* beta;
    int B, m, n_z, iterations, parts_a, parts_b;
    int Bp, m_pad, nz_pad;  // the padded extents: Bp a multiple of BM
    // The scratch: the operands in column tiles of kCols, each row padded
    // to kLdA (MGb: n_z tiles x m_pad rows; GLb: m tiles x nz_pad rows),
    // zeros past the stack; the state in scenario tiles of BM, each row
    // padded to ld_x(BM) (w, y, p_D: Bp / BM tiles x m_pad rows; zhat, z,
    // g_P: x nz_pad rows), zeros past m, n_z and B; the parts' sums,
    // [part][column][Bp]. A stage of a unit is then one contiguous block
    // of each.
    float *MGb, *GLb;
    float *wT, *yT, *pDT, *zhT, *zT, *gPT;
    float* part;
    float *z, *y, *w, *zhat;  // outputs; w and zhat may be null
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_addr(bar)), "r"(count) : "memory");
}

// Wait for the phase of `bar` with `parity` to complete. A wait that
// outlasts any stage's copy by orders of magnitude (2**26 polls, each of
// which may suspend the thread for a while) traps, so that a fault in the
// ring ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    for (unsigned n = 0;; ++n) {
        unsigned done;
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
        if (done) return;
        if (n == (1u << 26)) __trap();
    }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                     smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
        "r"(smem_addr(bar)) : "memory");
}

// Element q of a float or a float4, and loads and stores of either (the
// state bypasses L1: other blocks wrote it)
__device__ __forceinline__ float& elem(float& v, int) { return v; }
__device__ __forceinline__ float& elem(float4& v, int q) {
    return reinterpret_cast<float*>(&v)[q];
}
template <class V>
__device__ __forceinline__ V ldcg(const float* p) {
    if constexpr (sizeof(V) == 4) return __ldcg(p);
    else return __ldcg(reinterpret_cast<const float4*>(p));
}
template <class V>
__device__ __forceinline__ void store(float* p, const V& v) {
    *reinterpret_cast<V*>(p) = v;
}

// The ring of stages and its barriers; `it`, the stages a thread has
// walked, is alike in every thread of the block (every thread walks the
// same units and k-tiles).
struct Ring {
    float* base;
    uint64_t* full;
    uint64_t* empty;
};

// One phase's product: X' A over the state X (scenario tiles of K_pad
// padded rows) and the operand A (column tiles of K_pad padded rows), N
// columns, in P parts of K.
struct Phase {
    const float* A;
    const float* X;
    int N, K_pad, P, CT, KT, units;
};

__device__ inline Phase make_phase(const float* A, int N, int K, int K_pad,
                                   const float* X, int P, int ST) {
    Phase f;
    f.A = A;
    f.X = X;
    f.N = N;
    f.K_pad = K_pad;
    f.P = P;
    f.CT = (N + kCols - 1) / kCols;
    f.KT = (K + kDepth - 1) / kDepth;
    f.units = ST * f.CT * P;
    return f;
}

// The producer warp's lane 0: stage `it` of the ring, k-tile kt of the
// unit at scenario tile s, column tile c, by two bulk copies once every
// consumer warp has released the stage's previous round
template <int BM>
__device__ __forceinline__ void produce(const Ring& R, unsigned it,
                                        const Phase& f, int s, int c,
                                        int kt) {
    constexpr unsigned kA = kDepth * kLdA * 4, kX = kDepth * ld_x(BM) * 4;
    constexpr unsigned S = stages_of(BM);
    const unsigned st = it % S, round = it / S;
    float* As = R.base + st * stage_floats(BM);
    const long long k0 = (long long)kt * kDepth;
    if (round > 0) mbar_wait(R.empty + st, (round - 1) & 1);
    mbar_expect(R.full + st, kA + kX);
    bulk_copy(As, f.A + ((long long)c * f.K_pad + k0) * kLdA, kA,
              R.full + st);
    bulk_copy(As + kDepth * kLdA,
              f.X + ((long long)s * f.K_pad + k0) * ld_x(BM), kX,
              R.full + st);
}

// "highest": a thread's register tile of TM = BM / 16 scenarios x TN = 8
// columns, k ascending, the threads a 16 x 16 grid (each warp 8 x 4, so
// that a warp's reads of a row are one 128-byte wavefront).
constexpr int kTN = 8;
template <int BM>
constexpr int kTM = BM / 16;

template <int BM>
__device__ __forceinline__ int scen_of(int ty, int i) {
    constexpr int TM = kTM<BM>;
    if constexpr (TM == 8) return (i >> 2) * (BM / 2) + 4 * ty + (i & 3);
    else return TM * ty + i;
}

__device__ __forceinline__ int col_of(int tx, int j) {
    return (j >> 2) * 64 + 4 * tx + (j & 3);
}

template <int BM>
__device__ __forceinline__ void fma_stage(const float* As, const float* Xs,
                                          int tx, int ty,
                                          float (&acc)[kTM<BM>][kTN]) {
    constexpr int TM = kTM<BM>, TN = kTN, LX = ld_x(BM);
    // row k's fragments into av, xv
    auto load = [&](int k, float (&av)[TN], float (&xv)[TM]) {
        const float* ar = As + k * kLdA;
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
            const float4 a4 =
                *reinterpret_cast<const float4*>(ar + col_of(tx, j));
            av[j] = a4.x; av[j + 1] = a4.y; av[j + 2] = a4.z; av[j + 3] = a4.w;
        }
        const float* xr = Xs + k * LX;
        if constexpr (TM >= 4) {
#pragma unroll
            for (int i = 0; i < TM; i += 4) {
                const float4 x4 =
                    *reinterpret_cast<const float4*>(xr + scen_of<BM>(ty, i));
                xv[i] = x4.x; xv[i + 1] = x4.y; xv[i + 2] = x4.z;
                xv[i + 3] = x4.w;
            }
        } else if constexpr (TM == 2) {
            const float2 x2 = *reinterpret_cast<const float2*>(xr + 2 * ty);
            xv[0] = x2.x; xv[1] = x2.y;
        } else {
            xv[0] = xr[ty];
        }
    };
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
        float av[TN], xv[TM];
        load(k, av, xv);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv[i], av[j], acc[i][j]);
    }
}

// A tier: warp (wm, wn) of a 2 x 4 grid, BM / 2 scenarios (NS tiles of 8)
// x 32 columns (2 tiles of 16) over one stage, one mma per tile a k-step
// (three for "high"), the fragments loaded from the staged tiles (rows
// padded by 8 floats: a fragment's 32 lanes hit 32 banks).
template <int BM>
constexpr int kScenarioTiles = BM / 16;

template <int kTier, int BM>
__device__ __forceinline__ void mma_stage(
    const float* As, const float* Xs, int wm, int wn,
    float (&d)[2][kScenarioTiles<BM>][4]) {
    using namespace gpad_mma;
    constexpr int NS = kScenarioTiles<BM>, KL = kLaneK<kTier>;
    constexpr int LX = ld_x(BM);
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* Ag = As + wn * 32 + g;
    const float* Xg = Xs + wm * (BM / 2) + g;
    auto kstep = [&](int kk) {
        uint32_t ah[2][4], al[2][4] = {};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            float av[KL][2];
#pragma unroll
            for (int e = 0; e < KL; ++e) {
                const int k = kk + lane_k<kTier>(t, e);
                av[e][0] = Ag[k * kLdA + 16 * c];
                av[e][1] = Ag[k * kLdA + 16 * c + 8];
            }
            a_frag<kTier>(av, ah[c], al[c]);
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
            float xv[KL];
#pragma unroll
            for (int e = 0; e < KL; ++e)
                xv[e] = Xg[(kk + lane_k<kTier>(t, e)) * LX + 8 * n];
            uint32_t bh[2], bl[2] = {};
            b_frag<kTier>(xv, bh, bl);
#pragma unroll
            for (int c = 0; c < 2; ++c)
                mma_tier<kTier>(d[c][n], ah[c], al[c], bh, bl);
        }
    };
    if constexpr (NS >= 8) {
        // k-steps one at a time: the 64 sums of a 128-scenario tile and the
        // fragments of more than one k-step pass the 168 registers a
        // thread of a 9-warp block has
#pragma unroll 1
        for (int kk = 0; kk < kDepth; kk += kStep<kTier>) kstep(kk);
    } else {
#pragma unroll
        for (int kk = 0; kk < kDepth; kk += kStep<kTier>) kstep(kk);
    }
}

// A consumer thread's share of one unit: its k-tiles [kt0, kt1) from the
// ring, then emit(scenario, column, sums) once for each of the thread's
// sums within the unit: a float4 of 4 consecutive scenarios where the
// thread's tile has them, else a float.
template <int BM, int kTier, class Emit>
__device__ __forceinline__ void consume(const Ring& R, unsigned& it, int kt0,
                                        int kt1, Emit&& emit) {
    constexpr unsigned S = stages_of(BM);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    auto stage = [&](auto&& body) {
        for (int kt = kt0; kt < kt1; ++kt, ++it) {
            const unsigned st = it % S;
            mbar_wait(R.full + st, (it / S) & 1);
            const float* As = R.base + st * stage_floats(BM);
            body(As, As + kDepth * kLdA);
            __syncwarp();  // the warp's reads of the stage are done
            if (lane == 0) mbar_arrive(R.empty + st);
        }
    };
    if constexpr (kTier == gpad_mma::kHighest) {
        constexpr int TM = kTM<BM>, TN = kTN;
        const int tx = (warp & 1) * 8 + (lane & 7);
        const int ty = (warp >> 1) * 4 + (lane >> 3);
        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
        stage([&](const float* As, const float* Xs) {
            fma_stage<BM>(As, Xs, tx, ty, acc);
        });
        if constexpr (TM >= 4) {
#pragma unroll
            for (int i = 0; i < TM; i += 4)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    emit(scen_of<BM>(ty, i), col_of(tx, j),
                         make_float4(acc[i][j], acc[i + 1][j],
                                     acc[i + 2][j], acc[i + 3][j]));
        } else {
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    emit(scen_of<BM>(ty, i), col_of(tx, j), acc[i][j]);
        }
    } else {
        constexpr int NS = kScenarioTiles<BM>;
        const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
        float d[2][NS][4];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int n = 0; n < NS; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) d[c][n][e] = 0.0f;
        stage([&](const float* As, const float* Xs) {
            mma_stage<kTier, BM>(As, Xs, wm, wn, d);
        });
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int n = 0; n < NS; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    emit(wm * (BM / 2) + 8 * n + 2 * t + (e & 1),
                         wn * 32 + 16 * c + g + 8 * (e >> 1), d[c][n][e]);
    }
}

// Every unit of a phase the block owns (units blockIdx.x, + gridDim.x, ..):
// unit u is column tile u mod CT of scenario tile (u / CT) mod ST, part
// u / (CT ST). A phase of one part hands each sum to epi(s, scenario in
// the tile, column, sums); of several, to the parts' scratch. The producer
// warp stages the block's k-tiles in order, on into its next unit, while
// the consumers work through them.
template <int BM, int kTier, class Epi>
__device__ __forceinline__ void run_phase(const Args& a, const Ring& R,
                                          unsigned& it, const Phase& f,
                                          int ST, Epi&& epi) {
    for (int u = blockIdx.x; u < f.units; u += gridDim.x) {
        const int c = u % f.CT, r = u / f.CT, s = r % ST, p = r / ST;
        const int kt0 = p * f.KT / f.P, kt1 = (p + 1) * f.KT / f.P;
        if (threadIdx.x >= kConsumers) {  // the producer warp
            for (int kt = kt0; kt < kt1; ++kt, ++it)
                if (threadIdx.x == kConsumers) produce<BM>(R, it, f, s, c, kt);
            continue;
        }
        consume<BM, kTier>(R, it, kt0, kt1, [&](int sl, int cl, auto v) {
            const int col = c * kCols + cl;
            if (col >= f.N) return;
            if (f.P == 1)
                epi(s, sl, col, v);
            else
                store(a.part + ((long long)p * f.N + col) * a.Bp
                          + (long long)s * BM + sl, v);
        });
    }
}

// The parts' sums of an N-column phase added in part order, then epi: a
// thread takes 4 consecutive scenarios of a column at a time (those past B
// are the tiles' padding), with 8 parts' loads in flight
template <int BM, class Epi>
__device__ __forceinline__ void reduce_parts(const Args& a, int N, int P,
                                             Epi&& epi) {
    const int quads = a.Bp / 4;
    const long long stride = (long long)N * a.Bp;
    for (int e = blockIdx.x * kThreads + threadIdx.x; e < N * quads;
         e += gridDim.x * kThreads) {
        const int c = e / quads, b = 4 * (e - c * quads);
        const float* src = a.part + (long long)c * a.Bp + b;
        float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        int p = 0;
        for (; p + 8 <= P; p += 8) {
            float4 v[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) v[q] = ldcg<float4>(src + (p + q) * stride);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                sum.x += v[q].x; sum.y += v[q].y;
                sum.z += v[q].z; sum.w += v[q].w;
            }
        }
        for (; p < P; ++p) {
            const float4 v = ldcg<float4>(src + p * stride);
            sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        }
        epi(b / BM, b % BM, c, sum);
    }
}

// The state written through the generic proxy is read by the next phase's
// bulk copies (the async proxy): fence, then the grid barrier.
__device__ __forceinline__ void phase_barrier(cg::grid_group& grid) {
    asm volatile("fence.proxy.async.global;" ::: "memory");
    grid.sync();
}

// The operand `src` (K x N row-major) in column tiles of K_pad rows of
// kLdA floats (zeros past K and N) at dst, grid-stride (the launcher keeps
// every region's index within int)
__device__ __forceinline__ void tile_operand(float* dst, const float* src,
                                             int K, int K_pad, int N, int g0,
                                             int gs) {
    const int n = (N + kCols - 1) / kCols * K_pad * kLdA;
    for (int e = g0; e < n; e += gs) {
        const int col = e % kLdA, r = e / kLdA;
        const int k = r % K_pad, c = r / K_pad * kCols + col;
        dst[e] = col < kCols && k < K && c < N ? src[(long long)k * N + c]
                                               : 0.0f;
    }
}

template <int BM, int kTier>
__global__ void __launch_bounds__(kThreads, 1)
gpad_dense_tiled_kernel(const Args a)
{
    constexpr int LX = ld_x(BM);
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Ring R;
    R.full = reinterpret_cast<uint64_t*>(smem_raw);
    R.empty = R.full + kMaxStages;
    R.base = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
    cg::grid_group grid = cg::this_grid();
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < stages_of(BM); ++s) {
            mbar_init(R.full + s, 1);
            mbar_init(R.empty + s, kWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // the operands in column tiles; the state: y = w = y0 (zeros past B
    // and m), z = zhat = 0, p_D and g_P in scenario tiles; an empty loop
    // writes its outputs here
    const int g0 = blockIdx.x * kThreads + tid, gs = gridDim.x * kThreads;
    tile_operand(a.MGb, a.MG, a.m, a.m_pad, a.n_z, g0, gs);
    tile_operand(a.GLb, a.GL, a.n_z, a.nz_pad, a.m, g0, gs);
    const int ST = a.Bp / BM;
    const bool none = a.iterations == 0;
    for (int e = g0; e < ST * a.m_pad * LX; e += gs) {
        const int bl = e % LX, r = e / LX;
        const int i = r % a.m_pad, b = r / a.m_pad * BM + bl;
        float v = 0.0f, pd = 0.0f;
        if (bl < BM && i < a.m && b < a.B) {
            if (a.y0) v = a.y0[b * a.y0_stride + i];
            pd = a.pD[(long long)b * a.m + i];
            if (none) {
                a.y[(long long)b * a.m + i] = v;
                if (a.w) a.w[(long long)b * a.m + i] = 0.0f;
            }
        }
        a.yT[e] = v;
        a.wT[e] = v;
        a.pDT[e] = pd;
    }
    for (int e = g0; e < ST * a.nz_pad * LX; e += gs) {
        const int bl = e % LX, r = e / LX;
        const int c = r % a.nz_pad, b = r / a.nz_pad * BM + bl;
        float gp = 0.0f;
        if (bl < BM && c < a.n_z && b < a.B) {
            gp = a.gP[(long long)b * a.n_z + c];
            if (none) {
                a.z[(long long)b * a.n_z + c] = 0.0f;
                if (a.zhat) a.zhat[(long long)b * a.n_z + c] = 0.0f;
            }
        }
        a.zhT[e] = 0.0f;
        a.zT[e] = 0.0f;
        a.gPT[e] = gp;
    }
    phase_barrier(grid);

    const Phase fa = make_phase(a.MGb, a.n_z, a.m, a.m_pad, a.wT, a.parts_a,
                                ST);
    const Phase fb = make_phase(a.GLb, a.m, a.n_z, a.nz_pad, a.zhT,
                                a.parts_b, ST);
    unsigned it = 0;
    for (int k = 0; k < a.iterations; ++k) {
        const float th = a.theta[k];
        const bool more = k + 1 < a.iterations;
        const float bn = more ? a.beta[k + 1] : 0.0f;
        // A: zhat = -(w MG_T) - g_P and z, for scenarios bl.. of tile s
        auto epi_a = [&](int s, int bl, int c, auto acc) {
            using V = decltype(acc);
            constexpr int W = sizeof(V) / sizeof(float);
            const long long o = ((long long)s * a.nz_pad + c) * LX + bl;
            V gp = ldcg<V>(a.gPT + o), zo = ldcg<V>(a.zT + o), v, zn;
#pragma unroll
            for (int q = 0; q < W; ++q) {
                elem(v, q) = -elem(acc, q) - elem(gp, q);
                elem(zn, q) = (1.0f - th) * elem(zo, q) + th * elem(v, q);
            }
            store(a.zT + o, zn);
            store(a.zhT + o, v);
            if (!more) {
#pragma unroll
                for (int q = 0; q < W; ++q) {
                    const int b = s * BM + bl + q;
                    if (b >= a.B) break;
                    const long long r = (long long)b * a.n_z + c;
                    a.z[r] = elem(zn, q);
                    if (a.zhat) a.zhat[r] = elem(v, q);
                }
            }
        };
        // B: q = zhat GL_T; the projection and the next iteration's w
        auto epi_b = [&](int s, int bl, int i, auto q) {
            using V = decltype(q);
            constexpr int W = sizeof(V) / sizeof(float);
            const long long o = ((long long)s * a.m_pad + i) * LX + bl;
            V wc = ldcg<V>(a.wT + o), yp = ldcg<V>(a.yT + o);
            V pd = ldcg<V>(a.pDT + o), yn, wn;
#pragma unroll
            for (int e = 0; e < W; ++e) {
                elem(yn, e) = fmaxf(elem(wc, e) + elem(q, e) + elem(pd, e),
                                    0.0f);
                elem(wn, e) = elem(yn, e) + bn * (elem(yn, e) - elem(yp, e));
            }
            store(a.yT + o, yn);
            if (more) {
                store(a.wT + o, wn);
            } else {
#pragma unroll
                for (int e = 0; e < W; ++e) {
                    const int b = s * BM + bl + e;
                    if (b >= a.B) break;
                    const long long r = (long long)b * a.m + i;
                    a.y[r] = elem(yn, e);
                    if (a.w) a.w[r] = elem(wc, e);
                }
            }
        };
        run_phase<BM, kTier>(a, R, it, fa, ST, epi_a);
        phase_barrier(grid);
        if (fa.P > 1) {
            reduce_parts<BM>(a, a.n_z, fa.P, epi_a);
            phase_barrier(grid);
        }
        run_phase<BM, kTier>(a, R, it, fb, ST, epi_b);
        if (fb.P > 1) {
            phase_barrier(grid);
            reduce_parts<BM>(a, a.m, fb.P, epi_b);
        }
        if (more) phase_barrier(grid);
    }
}

using Kernel = void (*)(const Args);

template <int kTier>
Kernel kernel_at(int tile) {
    switch (tile) {
        case 16: return gpad_dense_tiled_kernel<16, kTier>;
        case 32: return gpad_dense_tiled_kernel<32, kTier>;
        case 64: return gpad_dense_tiled_kernel<64, kTier>;
        default: return gpad_dense_tiled_kernel<128, kTier>;
    }
}

Kernel kernel_of(int tile, int tier) {
    using namespace gpad_mma;
    switch (tier) {
        case kHighest: return kernel_at<kHighest>(tile);
        case kHigh: return kernel_at<kHigh>(tile);
        case kDefault: return kernel_at<kDefault>(tile);
        default: return kernel_at<kBfloat16>(tile);
    }
}

bool tile_ok(int tile) {
    return tile == 16 || tile == 32 || tile == 64 || tile == 128;
}

// The scratch's regions (floats), in Args' order
struct Layout {
    long long mgb, glb, rm, rz, part, total;
};

Layout layout(int B, int m, int n_z, int tile, int parts_a, int parts_b) {
    Layout L;
    const long long Bp = up(B, tile), m_pad = up(m, kDepth);
    const long long nz_pad = up(n_z, kDepth), ST = Bp / tile;
    L.mgb = (n_z + kCols - 1) / kCols * m_pad * kLdA;
    L.glb = (m + kCols - 1) / kCols * nz_pad * kLdA;
    L.rm = ST * m_pad * ld_x(tile);
    L.rz = ST * nz_pad * ld_x(tile);
    L.part = 0;
    if (parts_a > 1) L.part = (long long)parts_a * n_z * Bp;
    if (parts_b > 1 && (long long)parts_b * m * Bp > L.part)
        L.part = (long long)parts_b * m * Bp;
    L.total = L.mgb + L.glb + 3 * L.rm + 3 * L.rz + L.part;
    return L;
}

}  // namespace

extern "C" {

// Floats of the scratch a launch needs (kernels.py::
// _dense_tiled_scratch_floats): the operands in column tiles, the state
// and p_D, g_P in scenario tiles, and the parts' sums of the phases of
// more than one part.
long long gpad_dense_tiled_scratch_floats(int B, int m, int n_z, int tile,
                                          int parts_a, int parts_b) {
    return layout(B, m, n_z, tile, parts_a, parts_b).total;
}

// Blocks of the instance (tile, tier) an SM holds at `smem` bytes, or a
// negative cudaError_t.
int gpad_dense_tiled_blocks_per_sm(int tile, int tier, int smem) {
    if (!tile_ok(tile)) return -(int)cudaErrorInvalidValue;
    const Kernel k = kernel_of(tile, tier);
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int n = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads,
                                                            (size_t)smem);
    return err == cudaSuccess ? n : -(int)err;
}

// Runs on `stream` and returns a cudaError_t (0 on success): the plan
// (tile scenarios a unit, parts_a and parts_b, kernels.py::
// pick_dense_tiled) is refused unless the tile is 16, 32, 64 or 128,
// each phase's parts are between 1 and its k-tiles, `smem` covers the ring
// and the tier is known (cudaErrorInvalidValue). MG (m, n_z) and GL (n_z,
// m) row-major; gP, z and zhat (B, n_z); pD, y and w (B, m); y0 null or
// rows of y0_stride floats (0: one y0 for all); `scratch` of
// gpad_dense_tiled_scratch_floats floats, 16-byte aligned; w and zhat may
// be null. One block an SM, launched cooperatively.
int gpad_dense_tiled_launch(
    const float* MG, const float* GL, const float* gP, const float* pD,
    const float* y0, long long y0_stride, const float* theta,
    const float* beta, int B, int m, int n_z, int iterations, int tile,
    int parts_a, int parts_b, float* scratch, float* z, float* y, float* w,
    float* zhat, int smem, int tier, void* stream)
{
    const int kt_a = (m + kDepth - 1) / kDepth, kt_b = (n_z + kDepth - 1) / kDepth;
    if (B < 1 || m < 1 || n_z < 1 || iterations < 0 || !tile_ok(tile)
        || parts_a < 1 || parts_a > kt_a || parts_b < 1 || parts_b > kt_b
        || smem < smem_bytes(tile) || tier < gpad_mma::kHighest
        || tier > gpad_mma::kBfloat16 || ((uintptr_t)scratch & 15))
        return (int)cudaErrorInvalidValue;
    const Layout L = layout(B, m, n_z, tile, parts_a, parts_b);
    const long long most = 0x7fffffffLL;  // the passes index in int
    if (L.mgb > most || L.glb > most || L.rm > most || L.rz > most
        || (long long)m * up(B, tile) > most
        || (long long)n_z * up(B, tile) > most)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.MG = MG;
    a.GL = GL;
    a.gP = gP;
    a.pD = pD;
    a.y0 = y0;
    a.y0_stride = y0_stride;
    a.theta = theta;
    a.beta = beta;
    a.B = B;
    a.m = m;
    a.n_z = n_z;
    a.iterations = iterations;
    a.parts_a = parts_a;
    a.parts_b = parts_b;
    a.Bp = (int)up(B, tile);
    a.m_pad = (int)up(m, kDepth);
    a.nz_pad = (int)up(n_z, kDepth);
    a.MGb = scratch;
    a.GLb = a.MGb + L.mgb;
    a.wT = a.GLb + L.glb;
    a.yT = a.wT + L.rm;
    a.pDT = a.yT + L.rm;
    a.zhT = a.pDT + L.rm;
    a.zT = a.zhT + L.rz;
    a.gPT = a.zT + L.rz;
    a.part = a.gPT + L.rz;
    a.z = z;
    a.y = y;
    a.w = w;
    a.zhat = zhat;

    const Kernel k = kernel_of(tile, tier);
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                            (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)sms);  // one block an SM, all resident
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, k, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
