// Stage-wise (non-condensed) GPAD: a whole fixed-budget solve per launch.
//
// Replaces two Pallas TPU kernels of tpu_gpad:
//   tpu_gpad/stagewise_kernel.py::_stagewise_kernel (solve_stagewise_pallas):
//     all dual and plan state on chip -> gpad_stagewise_resident_kernel;
//   tpu_gpad/stagewise_stream.py::_stream_kernel (solve_stagewise_stream):
//     the same function for dual state past on-chip memory, the dual
//     iterates streamed through device memory -> gpad_stagewise_stream_kernel.
// Each has an iteration body of its own (resident_iterations,
// stagewise_iterations) over the same phases and helpers.
//
// Per scenario and iteration, with w = y + beta (y - y_prev) per stage and the
// packed per-stage constants R = [E'|-K'], HB = [HiB'|Hi], M = [[E,-B],[-K,-I]]
// and block-diagonal G = diag(Gx, Gu) (stagewise_kernel.pack_stagewise_
// constants; R, HB and M are stored transposed, so row j of a stored matrix
// holds what multiplies v_j):
//
//   P1  st_k = Gx' wx_k + qoff_k,  ru_k = Gu' wu_k                 (all stages)
//   P1b st_k += R_{k+1} [0; ru_{k+1}]                               (all stages)
//   CB  st_k += R_{k+1} [st_{k+1}; 0],  k = N-2..0                  (chain)
//   P3  kff_k = HB_k [st_k + dtl_k; ru_k],
//       st_k <- d_k = M_k [0; kff_k]_top + c_k                      (all stages)
//   CF  x_{k+1} = M_k [x_k; 0]_top + d_k into st_k, k = 0..N-1      (chain)
//   P4  u_k = M_k [x_k; kff_k]_bottom,  zu_k = (1-theta) zu_k + theta u_k,
//       y+ = max(w + (G [x_{k+1}; u_k] - h_k) / L, 0),
//       y_prev <- y,  y <- y+   (in place: stage k alone touches its rows)
//
// i.e. the backward sweep s_k = qx_k + E_{k+1}' s_{k+1} - K_{k+1}' ru_{k+1}
// and the forward rollout kff_k = Hi_k (B_k' st_k + ru_k), u_k = -K_k x_k -
// kff_k, x_{k+1} = E_k x_k - B_k kff_k + c_k of the TPU kernels, with every
// product that does not depend on the previous stage taken out of the two
// chains. Restart (O'Donoghue-Candes): when r = sum (w - y+)(y+ - y) over the
// scenario's rows is > 0, the momentum recursion resets and the next
// iteration reads y_prev as y (the streamed TPU kernel's lazy per-lane mask;
// both kernels here use it). The epilogue rolls the averaged plan zu through
// the dynamics and returns the residual max(G z - h, 0) and the gap
// -y'(G z - h), as the TPU kernels do.
//
// What bounds it (H100 SXM: 67 TFLOP/s fp32, 3.35 TB/s): about 29 kFLOP
// per stage, scenario and iteration at battery n30 (1.2 TFLOP, about 18 ms,
// at N200 B1024 x 200 iterations) and about 2.1 kFLOP at n8 (13 GFLOP,
// about 0.19 ms, at N60 B1024 x 100). The bytes a solve must move once are
// a few hundred MB at most (under 0.1 ms), so the roofline says
// operation-bound. What binds in practice: latency, not throughput. Every
// phase walks its stages with loads from L2 that wait one after another,
// and the two chains are N dependent stage steps per iteration
// (chip_smoke.py --profile splits a solve by phase; PERF.md). The streamed
// kernel's dual slabs also cross HBM every iteration (about 0.5 GB per
// iteration at n30 N200 B1024). What both designs do:
//   - a block holds a tile of T <= 8 scenarios; every per-scenario slab is
//     laid out [stage][row][scenario], so the T values of one row sit side
//     by side (one vector access) and a warp's lanes walk consecutive rows
//     (coalesced in device memory, no bank conflicts in shared memory);
//   - the phases between the chains give each warp whole stages and each
//     lane one output row of a product (lanes split the input range when
//     the output is narrower than 32 and sum by shuffles), with the T
//     scenarios in registers: a stage's constants are read once per tile,
//     coalesced, through L2 (about 6 MB at n30 N200, far under its 50 MB);
//     each phase prefetches its warp's next stage;
//   - a chain keeps the carried vector in registers, lane i owning row i
//     and reading the others by shuffle, so a chain step needs no barrier.
// The streamed kernel (256 threads): stages dealt to warps in turn; the two
// chains one warp per scenario over all N stages, their matrices through a
// ring of 8 stage blocks in shared memory that the bulk-copy engine fills 8
// steps ahead (chain_ring); the dual slabs in device memory stream with
// evict-first hints, so the constants stay in L2; seven block barriers per
// iteration. The resident kernel (8 or 16 warps): contiguous stages per
// warp, segmented chains over every warp, their matrices staged in shared
// memory, three block barriers per iteration (see resident_iterations).
// The stage-invariant G blocks sit in shared memory, rows padded to an odd
// stride. Per-scenario slabs:
//   resident: y, y_prev, st, zu, ru (kff over ru) all in shared memory;
//   streamed: y and y_prev in device memory (a work buffer per tile, the
//   result copied out to the public (B, N, m) layout at the end); st, zu,
//   ru, kff in shared memory when two blocks still fit on an SM, else in
//   device memory (the tile rules live in stagewise_kernel.py and
//   stagewise_stream.py).
// Products are plain fp32 FMA (precision "highest"). n_x, n_u <= 32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLoadBatch = 4;  // device-memory loads a lane keeps in flight

// Built with -DGPAD_SW_PROFILE (chip_smoke.py --profile), thread 0 of every
// block adds the clock64() cycles between the block barriers that end the
// phases of an iteration into g_phase_cycles: decision, P1, P1b, CB, P3,
// CF, P4, then the epilogue; gpad_stagewise_profile_read() returns and
// clears them. Without it the marks compile to nothing.
constexpr int kPhases = 8;
#ifdef GPAD_SW_PROFILE
__device__ unsigned long long g_phase_cycles[kPhases];
#define SW_CLOCK long long clk_t_ = clock64(), clk_acc_[kPhases] = {}
#define SW_MARK(i)                                                     \
    do {                                                               \
        const long long now_ = clock64();                              \
        clk_acc_[i] += now_ - clk_t_;                                  \
        clk_t_ = now_;                                                 \
    } while (0)
#define SW_FLUSH()                                                     \
    do {                                                               \
        if (threadIdx.x == 0)                                          \
            for (int i_ = 0; i_ < kPhases; ++i_)                       \
                atomicAdd(&g_phase_cycles[i_],                         \
                          (unsigned long long)clk_acc_[i_]);           \
    } while (0)
#else
#define SW_CLOCK
#define SW_MARK(i) ((void)0)
#define SW_FLUSH() ((void)0)
#endif

// Bring the line holding `p` into L1. Generic addressing: on a shared-memory
// address the prefetch does nothing.
__device__ __forceinline__ void prefetch_l1(const void* p) {
    asm volatile("prefetch.L1 [%0];" ::"l"(p));
}

// Prefetch `floats` consecutive floats from `p`, the warp's lanes taking
// one 128-byte line each in turn.
__device__ __forceinline__ void prefetch_block(const float* p, int floats,
                                               int lane) {
    for (int off = lane * 32; off < floats; off += 32 * 32) prefetch_l1(p + off);
}

__host__ __device__ constexpr int up4(int x) { return (x + 3) & ~3; }

struct Dims {
    int N, n, p, m_x, m_u, m, np, gx_ld, gu_ld, wb;
};

__host__ __device__ inline Dims make_dims(int N, int n, int p, int m_x,
                                          int m_u, int T) {
    const int m = m_x + m_u;
    return {N, n, p, m_x, m_u, m, n + p, n | 1, p | 1, (m > p ? m : p) * T};
}

// Floats of shared memory a block needs (mirrored by stagewise_kernel.py::
// _smem_bytes): the G blocks, x0, one scratch row block per warp, two
// per-warp partials and (theta, beta, reset) per scenario; then the st, zu,
// ru, kff slabs; then y and y_prev. Every region starts 16-byte aligned.
__host__ __device__ inline int shared_floats(const Dims& d, int T) {
    return up4(d.m_x * d.gx_ld) + up4(d.m_u * d.gu_ld) + up4(d.n * T) +
           up4(kWarps * d.wb) + up4(2 * kWarps * T) + up4(3 * T);
}
__host__ __device__ inline int aux_floats(const Dims& d, int T) {
    return up4(d.N * d.n * T) + 3 * up4(d.N * d.p * T);
}
__host__ __device__ inline int dual_floats(const Dims& d, int T) {
    return up4(d.N * d.m * T);
}

// A per-scenario slab: row `row` of stage k for the tile's T scenarios is
// T consecutive floats at p + (k * W + row) * T.
template <int T>
struct Slab {
    float* p;
    int W;
    __device__ __forceinline__ float* at(int k, int row) const {
        return p + (k * W + row) * T;
    }
};

template <int T>
__device__ __forceinline__ void ldT(float (&v)[T], const float* q) {
    if constexpr (T == 1) {
        v[0] = q[0];
    } else if constexpr (T == 2) {
        const float2 a = *reinterpret_cast<const float2*>(q);
        v[0] = a.x;
        v[1] = a.y;
    } else {
#pragma unroll
        for (int s = 0; s < T; s += 4) {
            const float4 a = *reinterpret_cast<const float4*>(q + s);
            v[s] = a.x;
            v[s + 1] = a.y;
            v[s + 2] = a.z;
            v[s + 3] = a.w;
        }
    }
}

template <int T>
__device__ __forceinline__ void stT(float* q, const float (&v)[T]) {
    if constexpr (T == 1) {
        q[0] = v[0];
    } else if constexpr (T == 2) {
        *reinterpret_cast<float2*>(q) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
        for (int s = 0; s < T; s += 4)
            *reinterpret_cast<float4*>(q + s) =
                make_float4(v[s], v[s + 1], v[s + 2], v[s + 3]);
    }
}

// ldT / stT for the dual slabs: in device memory (kGY) they stream through
// the caches with an evict-first hint, so the per-stage constants stay in L2.
template <int T, bool kGY>
__device__ __forceinline__ void ldY(float (&v)[T], const float* q) {
    if constexpr (!kGY) {
        ldT(v, q);
    } else if constexpr (T == 1) {
        v[0] = __ldcs(q);
    } else if constexpr (T == 2) {
        const float2 a = __ldcs(reinterpret_cast<const float2*>(q));
        v[0] = a.x;
        v[1] = a.y;
    } else {
#pragma unroll
        for (int s = 0; s < T; s += 4) {
            const float4 a = __ldcs(reinterpret_cast<const float4*>(q + s));
            v[s] = a.x;
            v[s + 1] = a.y;
            v[s + 2] = a.z;
            v[s + 3] = a.w;
        }
    }
}

template <int T, bool kGY>
__device__ __forceinline__ void stY(float* q, const float (&v)[T]) {
    if constexpr (!kGY) {
        stT(q, v);
    } else if constexpr (T == 1) {
        __stcs(q, v[0]);
    } else if constexpr (T == 2) {
        __stcs(reinterpret_cast<float2*>(q), make_float2(v[0], v[1]));
    } else {
#pragma unroll
        for (int s = 0; s < T; s += 4)
            __stcs(reinterpret_cast<float4*>(q + s),
                   make_float4(v[s], v[s + 1], v[s + 2], v[s + 3]));
    }
}

template <bool kGY>
__device__ __forceinline__ float ld1(const float* q) {
    if constexpr (kGY) return __ldcs(q);
    return *q;
}

template <int T>
__device__ __forceinline__ void zeroT(float (&v)[T]) {
#pragma unroll
    for (int s = 0; s < T; ++s) v[s] = 0.0f;
}

// Sum over the lanes that share an output row: lane = g * NMAX + i.
template <int T, int NMAX>
__device__ __forceinline__ void group_sum(float (&v)[T]) {
#pragma unroll
    for (int off = NMAX; off < 32; off <<= 1)
#pragma unroll
        for (int s = 0; s < T; ++s) v[s] += __shfl_xor_sync(kFull, v[s], off);
}

template <int T>
__device__ __forceinline__ void warp_reduce(float (&v)[T], bool is_max) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int s = 0; s < T; ++s) {
            const float o = __shfl_xor_sync(kFull, v[s], off);
            v[s] = is_max ? fmaxf(v[s], o) : v[s] + o;
        }
}

struct Consts {
    const float* __restrict__ RT;   // (N, n+p, n)    R'
    const float* __restrict__ HBT;  // (N, n+p, p)    HB'
    const float* __restrict__ MT;   // (N, n+p, n+p)  M'
    const float* __restrict__ h;    // (N, m)         [hx | hu]
    const float* __restrict__ V;    // (N, 3, n)      dtl, qoff, c
    const float* __restrict__ theta;
    const float* __restrict__ beta;
    // streamed kernel: (2, N, n, 32) the chains' matrices, rows padded to
    // 128 bytes: [0][k] the E' block of R'_{k+1}, [1][k] the E block of M'_k
    const float* __restrict__ chainE;
};

struct Shared {
    float *Gx, *Gu, *x0, *wbuf, *rpart, *vpart, *mom;
    // streamed kernel: the chains' ring (see chain_ring)
    unsigned long long* mbar;
    float *ring, *aring;
};

template <int T>
struct State {
    Slab<T> y, yp, st, zu, ru, kff;
};

__device__ Shared carve_shared(float* smem, const Dims& d, int T) {
    Shared s;
    s.Gx = smem;
    s.Gu = s.Gx + up4(d.m_x * d.gx_ld);
    s.x0 = s.Gu + up4(d.m_u * d.gu_ld);
    s.wbuf = s.x0 + up4(d.n * T);
    s.rpart = s.wbuf + up4(kWarps * d.wb);
    s.vpart = s.rpart + kWarps * T;
    s.mom = s.rpart + up4(2 * kWarps * T);
    return s;
}

// st, zu, ru, kff from `base` (shared or device memory).
template <int T>
__device__ void carve_aux(State<T>& S, float* base, const Dims& d) {
    S.st = {base, d.n};
    S.zu = {base + up4(d.N * d.n * T), d.p};
    S.ru = {S.zu.p + up4(d.N * d.p * T), d.p};
    S.kff = {S.ru.p + up4(d.N * d.p * T), d.p};
}

template <int T>
__device__ void stage_shared(const Shared& sh, const float* __restrict__ Gx,
                             const float* __restrict__ Gu,
                             const float* __restrict__ x0, int B, long long b0,
                             const Dims& d, int nthreads = kThreads) {
    for (int idx = threadIdx.x; idx < d.m_x * d.n; idx += nthreads) {
        const int r = idx / d.n;
        sh.Gx[r * d.gx_ld + idx - r * d.n] = Gx[idx];
    }
    for (int idx = threadIdx.x; idx < d.m_u * d.p; idx += nthreads) {
        const int r = idx / d.p;
        sh.Gu[r * d.gu_ld + idx - r * d.p] = Gu[idx];
    }
    for (int idx = threadIdx.x; idx < d.n * T; idx += nthreads) {
        const int i = idx / T, s = idx - i * T;  // [i][s]
        sh.x0[idx] = (b0 + s < B) ? x0[(b0 + s) * d.n + i] : 0.0f;
    }
}

// y and y_prev <- y0 (zeros when null; scenarios past B read zero), zu <- 0.
template <int T>
__device__ void init_state(const State<T>& S, const float* __restrict__ y0,
                           long long y0_stride, int B, long long b0,
                           const Dims& d, int nthreads = kThreads) {
    const int rows = d.N * d.m;
    for (int e = threadIdx.x; e < rows * T; e += nthreads) {
        const int s = e & (T - 1), row = e / T;  // row = k * m + r
        const float v =
            (y0 && b0 + s < B) ? y0[(b0 + s) * y0_stride + row] : 0.0f;
        S.y.p[e] = v;
        S.yp.p[e] = v;
    }
    for (int e = threadIdx.x; e < d.N * d.p * T; e += nthreads)
        S.zu.p[e] = 0.0f;
}

// The streamed kernel's chains read their matrices from a ring of kRing
// stage blocks in shared memory, filled by the bulk-copy (TMA) engine
// kRing steps ahead: a "full" mbarrier per slot says its block landed, an
// "empty" one that every chain warp has read it. Addends that live in
// device memory come through a per-warp ring filled by cp.async. A step
// waits on shared memory only.
constexpr int kRing = 8;
constexpr int kRingBlock = 32 * 32;  // floats of a slot: n <= 32 rows of 32

__host__ __device__ inline int ring_floats(int T) {
    return up4(4 * kRing) + kRing * kRingBlock + kRing * 32 * T;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float lds(const float* p) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(smem_addr(p)));
    return v;
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
    asm volatile(
        "{\n\t.reg .pred p;\n"
        "WAIT_%=:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
        "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
        "r"(parity) : "memory");
}

// One chain over the horizon for scenario s (one warp; lane i owns row i),
// as chain() computes it, with the matrix of step t at
// blocks + stage(t) * n * 32 through the ring. The chain warps 0..T-1 walk
// the same stages; thread 0 refills the slot of step t - 1 once every
// chain warp has released it. `use` counts the ring's slots consumed so
// far, alike in every chain thread.
template <int T, int NMAX>
__device__ void chain_ring(const State<T>& S, const Shared& sh, int s,
                           const float* __restrict__ blocks, const Dims& d,
                           bool backward, float v, unsigned& use) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n = d.n, N = d.N;
    const bool own = lane < n;
    const int steps = backward ? N - 1 : N;
    const unsigned bytes = (unsigned)(n * 32 * 4);
    unsigned long long* full = sh.mbar;
    unsigned long long* empty = sh.mbar + kRing;
    auto stage = [&](int t) { return backward ? N - 2 - t : t; };
    auto issue = [&](int t) {  // thread 0: the block of step t
        const unsigned slot = (use + t) % kRing;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                smem_addr(full + slot)), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];" ::"r"(smem_addr(sh.ring + slot * kRingBlock)),
            "l"(blocks + (long long)stage(t) * n * 32), "r"(bytes),
            "r"(smem_addr(full + slot)) : "memory");
    };
    // addends in shared memory are read in place; in device memory they
    // come through the warp's ring, one cp.async group per step
    const bool st_global = !__isShared(S.st.p);
    float* aring = sh.aring + warp * kRing * 32;
    auto addend = [&](int t) {
        if (!st_global) return;
        if (t < steps && own) {
            const unsigned slot = (use + t) % kRing;
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                             smem_addr(aring + slot * 32 + lane)),
                         "l"(S.st.at(stage(t), lane) + s));
        }
        asm volatile("cp.async.commit_group;" ::);
    };
    for (int t = 0; t < kRing; ++t) {
        if (threadIdx.x == 0 && t < steps) issue(t);
        addend(t);
    }
    for (int t = 0; t < steps; ++t) {
        const unsigned g = use + t, slot = g % kRing;
        mbar_wait(full + slot, (g / kRing) & 1);
        float a = 0.0f;
        if (st_global) {
            asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 1));
            __syncwarp();
            if (own) a = aring[slot * 32 + lane];
        } else if (own) {
            a = S.st.at(stage(t), lane)[s];
        }
        // every lane shuffles every row: a shuffle under a condition the
        // compiler cannot prove uniform costs a reconvergence per row
        const float* e = sh.ring + slot * kRingBlock + lane;
        float acc[4] = {a, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
            const float vj = __shfl_sync(kFull, v, j);
            acc[j & 3] = fmaf(own && j < n ? lds(e + j * 32) : 0.0f, vj,
                              acc[j & 3]);
        }
        v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        __syncwarp();  // the warp's reads of the slot are done
        if (lane == 0)
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                             smem_addr(empty + slot)) : "memory");
        if (own) S.st.at(stage(t), lane)[s] = v;
        if (threadIdx.x == 0 && t >= 1 && t - 1 + kRing < steps) {
            const unsigned gp = g - 1;  // refill step t - 1's slot
            mbar_wait(empty + gp % kRing, (gp / kRing) & 1);
            issue(t - 1 + kRing);
        }
        addend(t + kRing);
    }
    if (st_global) asm volatile("cp.async.wait_group 0;" ::: "memory");
    use += steps;
}

// gg = row r of G [x; u] for the tile: a state row of Gx against x, or an
// input row of Gu against u, both [j][s] with T scenarios per entry.
template <int T, int NMAX>
__device__ __forceinline__ void row_dot(float (&gg)[T], int r,
                                        const float* x, const float* u,
                                        const Shared& sh, const Dims& d) {
    const bool state = r < d.m_x;
    const float* Grow = state ? sh.Gx + r * d.gx_ld : sh.Gu + (r - d.m_x) * d.gu_ld;
    const float* v = state ? x : u;
    const int len = state ? d.n : d.p;
    zeroT(gg);
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
        if (j < len) {
            const float gv = Grow[j];
            float vj[T];
            ldT(vj, v + j * T);
#pragma unroll
            for (int s = 0; s < T; ++s) gg[s] = fmaf(gv, vj[s], gg[s]);
        }
    }
}

// The streamed kernel's `iterations` GPAD iterations on the block's tile.
// Phases give each warp whole stages (k = warp, warp + 8, ...); lane =
// g * NMAX + i works on output row i and inputs j = g (mod 32 / NMAX).
// Ends with a barrier.
template <int T, int NMAX>
__device__ void stagewise_iterations(const State<T>& S, const Shared& sh,
                                     const Consts& c, const Dims& d,
                                     float inv_L, int iterations,
                                     bool restart) {
    constexpr bool kGY = true;  // the dual slabs live in device memory
    constexpr int G = 32 / NMAX;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane / NMAX, i = lane - g * NMAX;
    const int N = d.N, n = d.n, p = d.p, m = d.m, m_x = d.m_x, m_u = d.m_u;
    const int np = d.np;
    float* wb = sh.wbuf + warp * d.wb;
    unsigned ring_use = 0;        // the streamed chains' ring slots consumed
    float th = 1.0f, thp = 1.0f;  // scenario tid's recursion (tid < T)
    SW_CLOCK;
    for (int it = 0; it < iterations; ++it) {
        if (tid < T) {
            bool reset = false;
            if (restart && it > 0) {
                float r = 0.0f;
                for (int w = 0; w < kWarps; ++w) r += sh.rpart[w * T + tid];
                reset = r > 0.0f;
                if (reset) {
                    th = 1.0f;
                    thp = 1.0f;
                } else {
                    const float next = th * (sqrtf(th * th + 4.0f) - th) * 0.5f;
                    thp = th;
                    th = next;
                }
            }
            sh.mom[tid] = restart ? th : c.theta[it];
            sh.mom[T + tid] = restart ? th * (1.0f / thp - 1.0f) : c.beta[it];
            sh.mom[2 * T + tid] = reset ? 1.0f : 0.0f;
        }
        __syncthreads();
        SW_MARK(0);
        float theta[T], beta[T], keep[T];  // keep = 0 where y_prev reads as y
#pragma unroll
        for (int s = 0; s < T; ++s) {
            theta[s] = sh.mom[s];
            beta[s] = sh.mom[T + s];
            keep[s] = sh.mom[2 * T + s] != 0.0f ? 0.0f : 1.0f;
        }
        // P1: w rows of stage k into the warp's scratch, then st = Gx' wx +
        // qoff and ru = Gu' wu
        {
            const int sl = lane & (T - 1);  // 32 % T == 0: a lane's scenario
            const float bl = sh.mom[T + sl];
            const bool rl = sh.mom[2 * T + sl] != 0.0f;
            for (int k = warp; k < N; k += kWarps) {
                const float* yk = S.y.at(k, 0);
                const float* ypk = S.yp.at(k, 0);
                for (int e0 = lane; e0 < m * T; e0 += 32 * kLoadBatch) {
                    float y[kLoadBatch], yp[kLoadBatch];
#pragma unroll
                    for (int u = 0; u < kLoadBatch; ++u) {  // loads in flight
                        const int e = e0 + 32 * u;
                        y[u] = e < m * T ? ld1<kGY>(yk + e) : 0.0f;
                        yp[u] = e < m * T && !rl ? ld1<kGY>(ypk + e) : y[u];
                    }
#pragma unroll
                    for (int u = 0; u < kLoadBatch; ++u)
                        if (e0 + 32 * u < m * T)
                            wb[e0 + 32 * u] = y[u] + bl * (y[u] - yp[u]);
                }
                __syncwarp();
                float q[T], r[T], wv[T];
                zeroT(q);
                zeroT(r);
                if (i < n)
#pragma unroll 4
                    for (int rr = g; rr < m_x; rr += G) {
                        const float gv = sh.Gx[rr * d.gx_ld + i];
                        ldT(wv, wb + rr * T);
#pragma unroll
                        for (int s = 0; s < T; ++s) q[s] = fmaf(gv, wv[s], q[s]);
                    }
                if (i < p)
#pragma unroll 4
                    for (int rr = g; rr < m_u; rr += G) {
                        const float gv = sh.Gu[rr * d.gu_ld + i];
                        ldT(wv, wb + (m_x + rr) * T);
#pragma unroll
                        for (int s = 0; s < T; ++s) r[s] = fmaf(gv, wv[s], r[s]);
                    }
                group_sum<T, NMAX>(q);
                group_sum<T, NMAX>(r);
                if (g == 0 && i < n) {
                    const float qo = __ldg(c.V + (k * 3 + 1) * n + i);
#pragma unroll
                    for (int s = 0; s < T; ++s) q[s] += qo;
                    stT(S.st.at(k, i), q);
                }
                if (g == 0 && i < p) stT(S.ru.at(k, i), r);
                __syncwarp();
            }
        }
        __syncthreads();
        SW_MARK(1);
        // P1b: st_k += -K'_{k+1} ru_{k+1}, rows n.. of R'_{k+1}
        for (int k = warp; k < N - 1; k += kWarps) {
            const float* Kk = c.RT + ((long long)(k + 1) * np + n) * n;
            if (k + kWarps < N - 1)
                prefetch_block(Kk + (long long)kWarps * np * n, p * n, lane);
            float a[T], v[T];
            zeroT(a);
            if (i < n)
#pragma unroll
                for (int t = 0; t < NMAX / G; ++t) {
                    const int jj = g + G * t;
                    if (jj < p) {
                        const float kv = __ldg(Kk + jj * n + i);
                        ldT(v, S.ru.at(k + 1, jj));
#pragma unroll
                        for (int s = 0; s < T; ++s) a[s] = fmaf(kv, v[s], a[s]);
                    }
                }
            group_sum<T, NMAX>(a);
            if (g == 0 && i < n) {
                ldT(v, S.st.at(k, i));
#pragma unroll
                for (int s = 0; s < T; ++s) v[s] += a[s];
                stT(S.st.at(k, i), v);
            }
        }
        __syncthreads();
        SW_MARK(2);
        // CB: the backward chain through the E' block of R'_{k+1}
        if (warp < T) {
            const float v = lane < n ? S.st.at(N - 1, lane)[warp] : 0.0f;
            chain_ring<T, NMAX>(S, sh, warp, c.chainE, d, true, v, ring_use);
        }
        __syncthreads();
        SW_MARK(3);
        // P3: kff_k = HB_k [st_k + dtl_k; ru_k], st_k <- M_k [0; kff_k]_top + c_k
        for (int k = warp; k < N; k += kWarps) {
            const float* HBk = c.HBT + (long long)k * np * p;
            const float* MTk = c.MT + (long long)k * np * np;
            if (k + kWarps < N) {  // the warp's next stage
                prefetch_block(HBk + (long long)kWarps * np * p, np * p, lane);
                prefetch_block(MTk + (long long)kWarps * np * np + n * np, p * np,
                               lane);
            }
            float kf[T], v[T];
            zeroT(kf);
            if (i < p) {
#pragma unroll
                for (int t = 0; t < NMAX / G; ++t) {
                    const int j = g + G * t;
                    if (j < n) {
                        const float hb = __ldg(HBk + j * p + i);
                        const float dj = __ldg(c.V + k * 3 * n + j);
                        ldT(v, S.st.at(k, j));
#pragma unroll
                        for (int s = 0; s < T; ++s)
                            kf[s] = fmaf(hb, v[s] + dj, kf[s]);
                    }
                }
#pragma unroll
                for (int t = 0; t < NMAX / G; ++t) {
                    const int j = g + G * t;
                    if (j < p) {
                        const float hb = __ldg(HBk + (n + j) * p + i);
                        ldT(v, S.ru.at(k, j));
#pragma unroll
                        for (int s = 0; s < T; ++s) kf[s] = fmaf(hb, v[s], kf[s]);
                    }
                }
            }
            group_sum<T, NMAX>(kf);
            if (g == 0 && i < p) stT(S.kff.at(k, i), kf);
            __syncwarp();
            float dd[T];
            zeroT(dd);
            if (i < n)
#pragma unroll
                for (int t = 0; t < NMAX / G; ++t) {
                    const int j = g + G * t;
                    if (j < p) {
                        const float mt = __ldg(MTk + (n + j) * np + i);
                        ldT(v, S.kff.at(k, j));
#pragma unroll
                        for (int s = 0; s < T; ++s) dd[s] = fmaf(mt, v[s], dd[s]);
                    }
                }
            group_sum<T, NMAX>(dd);
            if (g == 0 && i < n) {
                const float ck = __ldg(c.V + (k * 3 + 2) * n + i);
#pragma unroll
                for (int s = 0; s < T; ++s) dd[s] += ck;
                stT(S.st.at(k, i), dd);
            }
            __syncwarp();
        }
        __syncthreads();
        SW_MARK(4);
        // CF: the forward chain through the E block of M', from x0
        if (warp < T) {
            const float v = lane < n ? sh.x0[lane * T + warp] : 0.0f;
            chain_ring<T, NMAX>(S, sh, warp,
                                c.chainE + (long long)d.N * n * 32, d,
                                false, v, ring_use);
        }
        __syncthreads();
        SW_MARK(5);
        // P4: u_k = M_k [x_k; kff_k]_bottom, averaging, the dual step
        float rsum[T];
        zeroT(rsum);
        for (int k = warp; k < N; k += kWarps) {
            const float* MTk = c.MT + (long long)k * np * np;
            if (k + kWarps < N)  // the warp's next stage
                prefetch_block(MTk + (long long)kWarps * np * np, n * np, lane);
            const float* xk = k == 0 ? sh.x0 : S.st.at(k - 1, 0);  // [j][s]
            float u[T], v[T];
            zeroT(u);
            if (i < p)
#pragma unroll
                for (int t = 0; t < NMAX / G; ++t) {
                    const int j = g + G * t;
                    if (j < n) {
                        const float mt = __ldg(MTk + j * np + n + i);
                        ldT(v, xk + j * T);
#pragma unroll
                        for (int s = 0; s < T; ++s) u[s] = fmaf(mt, v[s], u[s]);
                    }
                }
            group_sum<T, NMAX>(u);
            if (g == 0 && i < p) {  // u = -K x - kff: M's -I block
                float kf[T], z[T];
                ldT(kf, S.kff.at(k, i));
                ldT(z, S.zu.at(k, i));
#pragma unroll
                for (int s = 0; s < T; ++s) {
                    u[s] -= kf[s];
                    z[s] = (1.0f - theta[s]) * z[s] + theta[s] * u[s];
                }
                stT(S.zu.at(k, i), z);
                stT(wb + i * T, u);
            }
            __syncwarp();
            const float* xn = S.st.at(k, 0);  // x_{k+1}, [j][s]
            for (int r = lane; r < m; r += 32) {
                float gg[T], y[T], yp[T];
                float* yr = S.y.at(k, r);
                float* ypr = S.yp.at(k, r);
                ldY<T, kGY>(y, yr);  // in flight during the product
                ldY<T, kGY>(yp, ypr);
                const float hr = __ldg(c.h + k * m + r);
                row_dot<T, NMAX>(gg, r, xn, wb, sh, d);
#pragma unroll
                for (int s = 0; s < T; ++s) {
                    const float ys = y[s];
                    const float w = ys + beta[s] * (ys - (keep[s] * yp[s] +
                                                          (1.0f - keep[s]) * ys));
                    const float yn = fmaxf(w + (gg[s] - hr) * inv_L, 0.0f);
                    rsum[s] = fmaf(w - yn, yn - ys, rsum[s]);
                    yp[s] = ys;
                    y[s] = yn;
                }
                stY<T, kGY>(ypr, yp);
                stY<T, kGY>(yr, y);
            }
            __syncwarp();
        }
        if (restart) {
            warp_reduce<T>(rsum, false);
            if (lane < T) {
                float mine = rsum[0];
#pragma unroll
                for (int s = 1; s < T; ++s)
                    if (lane == s) mine = rsum[s];
                sh.rpart[warp * T + lane] = mine;
            }
        }
        __syncthreads();
        SW_MARK(6);
    }
    SW_FLUSH();
}

// Residual max(G z - h, 0) and gap -y'(G z - h) on the averaged plan rolled
// through the dynamics: kff = -(u + K x), x' = M [x; kff]_top + c.
template <int T, int NMAX, bool kGY>
__device__ void epilogue(const State<T>& S, const Shared& sh, const Consts& c,
                         const Dims& d, float* __restrict__ residual,
                         float* __restrict__ gap, int B, long long b0,
                         int W = kWarps) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int N = d.N, n = d.n, p = d.p, m = d.m;
    const int np = d.np;
    SW_CLOCK;
    if (warp < T) {  // rollout, one warp per scenario, x_{k+1} into st_k
        const int s = warp;
        float x = lane < n ? sh.x0[lane * T + s] : 0.0f;
        for (int k = 0; k < N; ++k) {
            const float* MTk = c.MT + (long long)k * np * np;
            float xs[NMAX];
#pragma unroll
            for (int j = 0; j < NMAX; ++j) xs[j] = __shfl_sync(kFull, x, j);
            float kx = 0.0f;  // (-K x)_lane
            if (lane < p)
#pragma unroll
                for (int j = 0; j < NMAX; ++j)
                    if (j < n) kx = fmaf(__ldg(MTk + j * np + n + lane), xs[j], kx);
            const float kff = lane < p ? kx - S.zu.at(k, lane)[s] : 0.0f;
            float acc = 0.0f;
            if (lane < n) {
                acc = __ldg(c.V + (k * 3 + 2) * n + lane);
#pragma unroll
                for (int j = 0; j < NMAX; ++j)
                    if (j < n) acc = fmaf(__ldg(MTk + j * np + lane), xs[j], acc);
            }
#pragma unroll
            for (int j = 0; j < NMAX; ++j) {
                const float kj = __shfl_sync(kFull, kff, j);
                if (lane < n && j < p)
                    acc = fmaf(__ldg(MTk + (n + j) * np + lane), kj, acc);
            }
            x = acc;
            if (lane < n) S.st.at(k, lane)[s] = x;
        }
    }
    __syncthreads();
    float vmax[T], gsum[T];
#pragma unroll
    for (int s = 0; s < T; ++s) {
        vmax[s] = -INFINITY;
        gsum[s] = 0.0f;
    }
    for (int k = warp; k < N; k += W) {
        const float* xn = S.st.at(k, 0);
        const float* zk = S.zu.at(k, 0);
        for (int r = lane; r < m; r += 32) {
            float gg[T], y[T];
            ldY<T, kGY>(y, S.y.at(k, r));
            const float hr = __ldg(c.h + k * m + r);
            row_dot<T, NMAX>(gg, r, xn, zk, sh, d);
#pragma unroll
            for (int s = 0; s < T; ++s) {
                const float gs = gg[s] - hr;
                vmax[s] = fmaxf(vmax[s], gs);
                gsum[s] = fmaf(y[s], gs, gsum[s]);
            }
        }
    }
    warp_reduce<T>(vmax, true);
    warp_reduce<T>(gsum, false);
    if (lane < T) {
        float vm = vmax[0], gs = gsum[0];
#pragma unroll
        for (int s = 1; s < T; ++s)
            if (lane == s) {
                vm = vmax[s];
                gs = gsum[s];
            }
        sh.vpart[warp * T + lane] = vm;
        sh.rpart[warp * T + lane] = gs;
    }
    __syncthreads();
    if (tid < T && b0 + tid < B) {
        float vm = -INFINITY, gs = 0.0f;
        for (int w = 0; w < W; ++w) {
            vm = fmaxf(vm, sh.vpart[w * T + tid]);
            gs += sh.rpart[w * T + tid];
        }
        residual[b0 + tid] = fmaxf(vm, 0.0f);
        gap[b0 + tid] = -gs;
    }
    SW_MARK(7);
    SW_FLUSH();
}

// A slab of the tile's scenarios out to public (B, N * W) storage.
template <int T>
__device__ void store_rows(float* __restrict__ dst, const Slab<T>& src,
                           int N, int B, long long b0,
                           int nthreads = kThreads) {
    const int rows = N * src.W;
    for (int idx = threadIdx.x; idx < T * rows; idx += nthreads) {
        const int s = idx / rows, row = idx - s * rows;
        if (b0 + s < B) dst[(b0 + s) * rows + row] = src.p[row * T + s];
    }
}

struct Args {
    Consts c;
    const float* Gx;
    const float* Gu;
    const float* L;
    const float* x0;
    const float* y0;
    long long y0_stride;
    int B, iterations, restart;
    Dims d;
    float *y_out, *zu_out, *residual, *gap;
    // streamed kernel only
    float *y_work, *yp_work, *aux;
    // resident kernel only: a per-block scratch for the segment products
    // where they are not in shared memory
    int chains_in_smem;
    float* qscratch;
};

template <int T, int NMAX>
__device__ void solve_tile(const Args& a, const State<T>& S, const Shared& sh,
                           long long b0) {
    stage_shared<T>(sh, a.Gx, a.Gu, a.x0, a.B, b0, a.d);
    init_state<T>(S, a.y0, a.y0_stride, a.B, b0, a.d);
    __syncthreads();
    const float inv_L = 1.0f / a.L[0];
    stagewise_iterations<T, NMAX>(S, sh, a.c, a.d, inv_L, a.iterations,
                                  a.restart != 0);
    epilogue<T, NMAX, true>(S, sh, a.c, a.d, a.residual, a.gap, a.B, b0);
    store_rows<T>(a.zu_out, S.zu, a.d.N, a.B, b0);
    store_rows<T>(a.y_out, S.y, a.d.N, a.B, b0);
}

// ---------------------------------------------------------------------------
// The resident kernel's own iteration body
// ---------------------------------------------------------------------------
//
// A block of W = 8 or 16 warps (blockDim.x = 32 W) keeps every slab of its
// tile in shared memory. Warp w owns the contiguous stages [k0, k1) =
// [w N / W, (w + 1) N / W) in every phase and one segment of each chain,
// so nothing of a warp's phases waits on another warp before its own chain
// segment. A chain (CB: v_k = st_k + E'_{k+1} v_{k+1}; CF: x_{k+1} = d_k +
// E_k x_k) runs in three passes, a parallel prefix cut to one level:
//   1. each warp runs its segment's steps from a zero entry for every
//      scenario of the tile: a group of NMAX lanes per scenario, lane i
//      owning row i, 32 / NMAX groups a warp, and each lane interleaving
//      the chains of R = T / (32 / NMAX) scenarios (rounded up), which
//      share each step's matrix rows; it leaves the segment's last value
//      l_j in its scratch; the segment whose entry is known (st_{N-1} for
//      CB, x0 for CF) runs from it and writes its values;
//   2. after a block barrier each warp carries its entry through the
//      segments between the known one and its own, e <- l_j + Q_j e, with
//      Q_j the product of segment j's step matrices (computed once per
//      solve, in the prologue);
//   3. it reruns its segment's steps from that entry, writing the values.
// A chain's depth falls from N steps to 2 N / W + W - 1. Each warp copies
// its segment's step matrices (n x n each) into a staging block of shared
// memory with cp.async during the phase before the chain (CB's during P1,
// CF's during P3), so a step waits on shared memory only; where the staging
// blocks and the segment products do not fit beside the tile's slabs, the
// steps read the matrices from device memory and Q lives in a per-block
// scratch there (`chains_in_smem` 0). Three block barriers per iteration:
//   [decision, P1, P1b, CB pass 1] B1 [CB passes 2-3, P3, CF pass 1] B2
//   [CF passes 2-3, P4] B3.
// Every warp takes the restart decision alike from the per-warp partial
// sums of r, added in warp order. kff_k overwrites ru_k, whose last reader
// is P3 at stage k. A warp's scratch block (wb floats, [row][scenario])
// holds in turn: P1's w rows [0, m T) and then ru_{k1} [0, p T); CB's l_j
// [0, n T) until B2; CF's l_j at [max(p, n) T, + n T) until B3; CF's entry
// x_{k0} [0, n T) for P4, whose u rows follow at [0, p T).

constexpr int kResMaxThreads = 512;  // W <= 16 warps

// Built with -DGPAD_SW_PROFILE, lane 0 of every warp adds the clock64()
// cycles of each part of the resident kernel into g_res_cycles:
// gpad_stagewise_resident_profile_read() returns and clears them.
constexpr int kResPhases = 14;  // prologue, decision, P1, P1b, CB1, B1,
                                // CB23, P3, CF1, B2, CF23, P4, B3, epilogue
#ifdef GPAD_SW_PROFILE
__device__ unsigned long long g_res_cycles[kResPhases];
#define RES_CLOCK long long rclk_t_ = clock64(), rclk_acc_[kResPhases] = {}
#define RES_MARK(i)                                                    \
    do {                                                               \
        const long long now_ = clock64();                              \
        rclk_acc_[i] += now_ - rclk_t_;                                \
        rclk_t_ = now_;                                                \
    } while (0)
#define RES_FLUSH()                                                    \
    do {                                                               \
        if ((threadIdx.x & 31) == 0)                                   \
            for (int i_ = 0; i_ < kResPhases; ++i_)                    \
                atomicAdd(&g_res_cycles[i_],                           \
                          (unsigned long long)rclk_acc_[i_]);          \
    } while (0)
#else
#define RES_CLOCK
#define RES_MARK(i) ((void)0)
#define RES_FLUSH() ((void)0)
#endif

// A warp's scratch block: P1's w rows, or the chains' values.
__host__ __device__ inline int res_wb(const Dims& d, int T) {
    const int q = (d.p > d.n ? d.p : d.n) + d.n;
    return (d.m > q ? d.m : q) * T;
}
// The longest segment, in stages.
__host__ __device__ inline int res_ls(const Dims& d, int W) {
    return (d.N + W - 1) / W;
}
// The segment products of both chains, W blocks of n x n each.
__host__ __device__ inline int res_q_floats(const Dims& d, int W) {
    return up4(2 * W * d.n * d.n);
}

// Floats of a resident block's shared memory (mirrored by stagewise_kernel.
// py::_resident_floats): the G blocks, x0, W scratch blocks, two per-warp
// partials per scenario; with `cs` the segment products and W staging
// blocks of res_ls step matrices; then the st, zu, ru slabs and y, y_prev.
// Every region starts 16-byte aligned.
__host__ __device__ inline long long res_floats(const Dims& d, int T, int W,
                                                bool cs) {
    long long f = up4(d.m_x * d.gx_ld) + up4(d.m_u * d.gu_ld) + up4(d.n * T) +
                  up4(W * res_wb(d, T)) + up4(2 * W * T);
    if (cs) f += res_q_floats(d, W) + up4(W * res_ls(d, W) * d.n * d.n);
    return f + up4(d.N * d.n * T) + 2LL * up4(d.N * d.p * T) +
           2LL * up4(d.N * d.m * T);
}

struct ResShared {
    Shared s;  // Gx, Gu, x0, wbuf, rpart, vpart
    float* Q;    // [chain][warp] segment products, column j at j * n
    float* stg;  // W staging blocks of res_ls step matrices, or null
    int wb, W, ls;
};

// First stage of warp w's segment.
__device__ __forceinline__ int seg_lo(int w, int N, int W) {
    return (w * N) / W;
}

// Step k's chain matrix: row j (what multiplies v_j) at at(k, j), lane i
// reading element i. In device memory (R' or M' in place) or in a staging
// block (first step k0, n x n per step).
struct ChainMat {
    const float* p;
    int k0;
    long long kstride;
    int ld;
    __device__ __forceinline__ const float* at(int k, int j) const {
        return p + (k - k0) * kstride + (long long)j * ld;
    }
};

// Copy the step matrices of steps [ka, kb) into a staging block with
// cp.async, as one commit group of the calling lanes.
__device__ void stage_chain(float* dst, const ChainMat& src, int ka, int kb,
                            int n, int lane) {
    const int nn = n * n, total = (kb - ka) * nn;
    for (int e = lane; e < total; e += 32) {
        const int s = e / nn, r = e - s * nn, j = r / n, i = r - j * n;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         smem_addr(dst + e)), "l"(src.at(ka + s, j) + i)
                     : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
}

// One group's chains over cnt steps k = kb, kb + dk, ...: RR independent
// chains per lane (chain r of scenario sc[r], where live[r]), interleaved so
// that their latencies overlap and they share each step's matrix rows:
// v <- a_k + C_k v, a_k = st_k's column sc when `addend`, else 0; v written
// over st_k when `store`. Lane i of the group holds row i; lanes past n and
// chains not live carry zeros. Every lane shuffles: the groups of a warp
// run in lockstep. The next step's rows and addends load during the
// current one.
template <int T, int NMAX, int RR>
__device__ void seg_chain(const ChainMat& C, const Slab<T>& st,
                          const int (&sc)[RR], const bool (&live)[RR], int kb,
                          int dk, int cnt, float (&v)[RR], bool addend,
                          bool store, int n) {
    const int i = threadIdx.x & (NMAX - 1);
    const bool row = i < n;
    bool own[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) own[r] = live[r] && row;
    if (cnt <= 0) return;
    float e[NMAX], en[NMAX], a[RR], an[RR];
    int k = kb;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
        e[j] = (row && j < n) ? C.at(k, j)[i] : 0.0f;
        en[j] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < RR; ++r)
        a[r] = (own[r] && addend) ? st.at(k, i)[sc[r]] : 0.0f;
    for (int t = 0; t < cnt; ++t) {
        const int kn = k + dk;
#pragma unroll
        for (int r = 0; r < RR; ++r) an[r] = 0.0f;
        if (t + 1 < cnt) {
#pragma unroll
            for (int j = 0; j < NMAX; ++j)
                en[j] = (row && j < n) ? C.at(kn, j)[i] : 0.0f;
#pragma unroll
            for (int r = 0; r < RR; ++r)
                an[r] = (own[r] && addend) ? st.at(kn, i)[sc[r]] : 0.0f;
        }
        float acc[RR][4];
#pragma unroll
        for (int r = 0; r < RR; ++r) {
            acc[r][0] = a[r];
            acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < NMAX; ++j)
#pragma unroll
            for (int r = 0; r < RR; ++r)
                acc[r][j & 3] = fmaf(e[j], __shfl_sync(kFull, v[r], j, NMAX),
                                     acc[r][j & 3]);
#pragma unroll
        for (int r = 0; r < RR; ++r) {
            v[r] = (acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]);
            if (store && own[r]) st.at(k, i)[sc[r]] = v[r];
            a[r] = an[r];
        }
#pragma unroll
        for (int j = 0; j < NMAX; ++j) e[j] = en[j];
        k = kn;
    }
}

// One carry step of a group's RR chains: e <- l + Q e, Q's column j at
// Q + j * n.
template <int NMAX, int RR>
__device__ __forceinline__ void carry_step(const float* Q, float (&e)[RR],
                                           const float (&l)[RR], int n) {
    const int i = threadIdx.x & (NMAX - 1);
    float acc[RR][4];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
        acc[r][0] = l[r];
        acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
        const float q = (i < n && j < n) ? Q[j * n + i] : 0.0f;
#pragma unroll
        for (int r = 0; r < RR; ++r)
            acc[r][j & 3] = fmaf(q, __shfl_sync(kFull, e[r], j, NMAX),
                                 acc[r][j & 3]);
    }
#pragma unroll
    for (int r = 0; r < RR; ++r)
        e[r] = (acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]);
}

// `iterations` GPAD iterations on the block's tile, the resident way (see
// above). lane = g * NMAX + i works on output row i and inputs j = g
// (mod 32 / NMAX) in the phases, and on row i of scenario sc = round * G +
// g in the chains. Ends with a barrier.
template <int T, int NMAX>
__device__ void resident_iterations(const State<T>& S, const ResShared& rs,
                                    const Consts& c, const Dims& d,
                                    float inv_L, int iterations,
                                    bool restart) {
    constexpr int G = 32 / NMAX;
    constexpr int R = (T + G - 1) / G;  // chain rounds over the tile
    const Shared& sh = rs.s;
    const int W = rs.W;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane / NMAX, i = lane - g * NMAX;
    const int N = d.N, n = d.n, p = d.p, m = d.m, m_x = d.m_x, m_u = d.m_u;
    const int np = d.np;
    const int k0 = seg_lo(warp, N, W), k1 = seg_lo(warp + 1, N, W);
    const int kcb = k1 < N - 1 ? k1 : N - 1;  // end of the warp's CB steps
    const bool top = k1 == N;    // CB's segment with a known entry
    const bool first = k0 == 0;  // CF's segment with a known entry
    const bool mine = k0 < k1;   // the warp owns stages (N < W leaves some idle)
    float* wb = sh.wbuf + warp * rs.wb;
    const int lcf = (p > n ? p : n) * T;  // CF's l_j in the scratch block
    const long long nn = (long long)n * n;
    float* stg = rs.stg ? rs.stg + warp * rs.ls * nn : nullptr;
    const ChainMat gcb{c.RT + (long long)np * n, 0, (long long)np * n, n};
    const ChainMat gcf{c.MT, 0, (long long)np * np, np};
    const ChainMat scm{stg, k0, nn, n};
    const ChainMat cb = stg ? scm : gcb;
    const ChainMat cf = stg ? scm : gcf;
    RES_CLOCK;
    // prologue: the segment products, column j the chain from unit vector j
    auto products = [&](const ChainMat& C, int kb, int dk, int cnt,
                        float* Qw) {
        for (int rr = 0; rr * G < n; ++rr) {
            const int jc = rr * G + g, sc[1] = {0};
            const bool live[1] = {jc < n};
            float v[1] = {(live[0] && i == jc) ? 1.0f : 0.0f};
            seg_chain<T, NMAX, 1>(C, S.st, sc, live, kb, dk, cnt, v, false,
                                  false, n);
            if (live[0] && i < n) Qw[jc * n + i] = v[0];
        }
    };
    // the tile's scenarios in the chains: chain r of group g runs sc[r]
    int sc[R];
    bool live[R], own[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        sc[r] = r * G + g;
        live[r] = sc[r] < T;
        own[r] = live[r] && i < n;
    }
    if (stg && kcb > k0) {
        stage_chain(stg, gcb, k0, kcb, n, lane);
        stage_wait();
    }
    if (!top && mine) products(cb, kcb - 1, -1, kcb - k0, rs.Q + warp * nn);
    __syncwarp();
    if (stg && mine) {
        stage_chain(stg, gcf, k0, k1, n, lane);
        stage_wait();
    }
    if (!first && mine)
        products(cf, k0, 1, k1 - k0, rs.Q + (W + warp) * nn);
    __syncwarp();
    if (stg && kcb > k0) stage_chain(stg, gcb, k0, kcb, n, lane);
    __syncthreads();
    RES_MARK(0);
    float th = 1.0f, thp = 1.0f;  // lane s < T: scenario s's recursion
    for (int it = 0; it < iterations; ++it) {
        // the decision: lane s adds scenario s's partials in warp order
        float theta[T], beta[T], keep[T];  // keep = 0 where y_prev reads as y
        if (restart) {
            float rpart = 0.0f;
            if (it > 0 && lane < T)
                for (int w = 0; w < W; ++w) rpart += sh.rpart[w * T + lane];
            const bool reset = rpart > 0.0f;
            if (reset) {
                th = 1.0f;
                thp = 1.0f;
            } else if (it > 0) {
                const float next = th * (sqrtf(th * th + 4.0f) - th) * 0.5f;
                thp = th;
                th = next;
            }
            const float b = th * (1.0f / thp - 1.0f), kp = reset ? 0.0f : 1.0f;
#pragma unroll
            for (int s = 0; s < T; ++s) {
                theta[s] = __shfl_sync(kFull, th, s);
                beta[s] = __shfl_sync(kFull, b, s);
                keep[s] = __shfl_sync(kFull, kp, s);
            }
        } else {
            const float t0 = c.theta[it], b0 = c.beta[it];
#pragma unroll
            for (int s = 0; s < T; ++s) {
                theta[s] = t0;
                beta[s] = b0;
                keep[s] = 1.0f;
            }
        }
        RES_MARK(1);
        // P1: st_k = Gx' wx_k + qoff_k and ru_k = Gu' wu_k on the warp's
        // stages, then ru_{k1} for P1b's last stage
        {
            const int sl = lane & (T - 1);  // 32 % T == 0: a lane's scenario
            float bl = 0.0f, kl = 1.0f;
#pragma unroll
            for (int s = 0; s < T; ++s)
                if (sl == s) {
                    bl = beta[s];
                    kl = keep[s];
                }
            const bool rl = kl == 0.0f;
            auto load_w = [&](int k, int row0) {  // w rows [row0, m) into wb
                const float* yk = S.y.at(k, 0);
                const float* ypk = S.yp.at(k, 0);
                for (int e0 = row0 * T + lane; e0 < m * T;
                     e0 += 32 * kLoadBatch) {
                    float y[kLoadBatch], yp[kLoadBatch];
#pragma unroll
                    for (int u = 0; u < kLoadBatch; ++u) {
                        const int e = e0 + 32 * u;
                        y[u] = e < m * T ? yk[e] : 0.0f;
                        yp[u] = e < m * T && !rl ? ypk[e] : y[u];
                    }
#pragma unroll
                    for (int u = 0; u < kLoadBatch; ++u)
                        if (e0 + 32 * u < m * T)
                            wb[e0 + 32 * u] = y[u] + bl * (y[u] - yp[u]);
                }
                __syncwarp();
            };
            auto gu_w = [&](float (&rr)[T]) {  // ru = Gu' wu from wb
                float wv[T];
                zeroT(rr);
                if (i < p)
#pragma unroll 4
                    for (int q = g; q < m_u; q += G) {
                        const float gv = sh.Gu[q * d.gu_ld + i];
                        ldT(wv, wb + (m_x + q) * T);
#pragma unroll
                        for (int s = 0; s < T; ++s) rr[s] = fmaf(gv, wv[s], rr[s]);
                    }
                group_sum<T, NMAX>(rr);
            };
            for (int k = k0; k < k1; ++k) {
                const float qo =
                    (g == 0 && i < n) ? __ldg(c.V + (k * 3 + 1) * n + i) : 0.0f;
                load_w(k, 0);
                float q[T], rr[T], wv[T];
                zeroT(q);
                if (i < n)
#pragma unroll 4
                    for (int q2 = g; q2 < m_x; q2 += G) {
                        const float gv = sh.Gx[q2 * d.gx_ld + i];
                        ldT(wv, wb + q2 * T);
#pragma unroll
                        for (int s = 0; s < T; ++s) q[s] = fmaf(gv, wv[s], q[s]);
                    }
                group_sum<T, NMAX>(q);
                gu_w(rr);
                if (g == 0 && i < n) {
#pragma unroll
                    for (int s = 0; s < T; ++s) q[s] += qo;
                    stT(S.st.at(k, i), q);
                }
                if (g == 0 && i < p) stT(S.ru.at(k, i), rr);
                __syncwarp();
            }
            if (mine && k1 < N) {
                load_w(k1, m_x);
                float rr[T];
                gu_w(rr);
                __syncwarp();
                if (g == 0 && i < p) stT(wb + i * T, rr);
                __syncwarp();
            }
        }
        RES_MARK(2);
        // P1b: st_k += -K'_{k+1} ru_{k+1}, rows n.. of R'_{k+1}
        for (int k = k0; k < kcb; ++k) {
            const float* Kk = c.RT + ((long long)(k + 1) * np + n) * n;
            if (k + 1 < kcb) prefetch_block(Kk + (long long)np * n, p * n, lane);
            const float* ru1 = k + 1 < k1 ? S.ru.at(k + 1, 0) : wb;  // [j][s]
            float a[T], v[T];
            zeroT(a);
            if (i < n)
#pragma unroll
                for (int t = 0; t < NMAX / G; ++t) {
                    const int jj = g + G * t;
                    if (jj < p) {
                        const float kv = __ldg(Kk + jj * n + i);
                        ldT(v, ru1 + jj * T);
#pragma unroll
                        for (int s = 0; s < T; ++s) a[s] = fmaf(kv, v[s], a[s]);
                    }
                }
            group_sum<T, NMAX>(a);
            if (g == 0 && i < n) {
                ldT(v, S.st.at(k, i));
#pragma unroll
                for (int s = 0; s < T; ++s) v[s] += a[s];
                stT(S.st.at(k, i), v);
            }
        }
        __syncwarp();
        if (stg && kcb > k0) stage_wait();
        RES_MARK(3);
        // CB pass 1: the segment from zero (the top one from st_{N-1})
        if (mine) {
            float v[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
                v[r] = (top && own[r]) ? S.st.at(N - 1, i)[sc[r]] : 0.0f;
            seg_chain<T, NMAX, R>(cb, S.st, sc, live, kcb - 1, -1, kcb - k0,
                                  v, true, top, n);
#pragma unroll
            for (int r = 0; r < R; ++r)
                if (own[r]) wb[i * T + sc[r]] = v[r];
        }
        RES_MARK(4);
        __syncthreads();
        RES_MARK(5);
        // CB passes 2 and 3: carry the entry v_{k1} down from the top
        // segment, then rerun the segment from it
        if (!top && mine) {
            float e[R], l[R];
            for (int j = W - 1; j > warp; --j) {
                if (seg_lo(j, N, W) == seg_lo(j + 1, N, W)) continue;
#pragma unroll
                for (int r = 0; r < R; ++r)
                    l[r] = own[r] ? sh.wbuf[j * rs.wb + i * T + sc[r]] : 0.0f;
                if (j == W - 1) {
#pragma unroll
                    for (int r = 0; r < R; ++r) e[r] = l[r];
                } else {
                    carry_step<NMAX, R>(rs.Q + j * nn, e, l, n);
                }
            }
            seg_chain<T, NMAX, R>(cb, S.st, sc, live, kcb - 1, -1, kcb - k0,
                                  e, true, true, n);
        }
        __syncwarp();
        if (stg && mine) stage_chain(stg, gcf, k0, k1, n, lane);
        RES_MARK(6);
        // P3: kff_k = HB_k [st_k + dtl_k; ru_k] over ru_k,
        // st_k <- M_k [0; kff_k]_top + c_k. Every constant of the stage is
        // loaded first, so the stage waits on one L2 round trip
        for (int k = k0; k < k1; ++k) {
            const float* HBk = c.HBT + (long long)k * np * p;
            const float* MTk = c.MT + (long long)k * np * np;
            if (k + 1 < k1) {  // the warp's next stage
                prefetch_block(HBk + (long long)np * p, np * p, lane);
                prefetch_block(MTk + (long long)np * np + n * np, p * np, lane);
            }
            // a lane's J inputs of each product, loaded up front where they
            // fit its registers (NMAX / G <= 8), else where they are used
            constexpr int J = NMAX / G;
            constexpr bool kAll = J <= 8;
            float hs[kAll ? J : 1], dl[kAll ? J : 1], hr[kAll ? J : 1],
                mt[kAll ? J : 1];
            auto ld_hs = [&](int j) { return __ldg(HBk + j * p + i); };
            auto ld_dl = [&](int j) { return __ldg(c.V + k * 3 * n + j); };
            auto ld_hr = [&](int j) { return __ldg(HBk + (n + j) * p + i); };
            auto ld_mt = [&](int j) { return __ldg(MTk + (n + j) * np + i); };
            if constexpr (kAll) {
#pragma unroll
                for (int t = 0; t < J; ++t) {
                    const int j = g + G * t;
                    hs[t] = i < p && j < n ? ld_hs(j) : 0.0f;
                    dl[t] = i < p && j < n ? ld_dl(j) : 0.0f;
                    hr[t] = i < p && j < p ? ld_hr(j) : 0.0f;
                    mt[t] = i < n && j < p ? ld_mt(j) : 0.0f;
                }
            }
            const float ck = g == 0 && i < n ? __ldg(c.V + (k * 3 + 2) * n + i)
                                             : 0.0f;
            float kf[T], v[T];
            zeroT(kf);
            if (i < p) {
#pragma unroll
                for (int t = 0; t < J; ++t) {
                    const int j = g + G * t;
                    if (j < n) {
                        float h1, d1;
                        if constexpr (kAll) {
                            h1 = hs[t];
                            d1 = dl[t];
                        } else {
                            h1 = ld_hs(j);
                            d1 = ld_dl(j);
                        }
                        ldT(v, S.st.at(k, j));
#pragma unroll
                        for (int s = 0; s < T; ++s)
                            kf[s] = fmaf(h1, v[s] + d1, kf[s]);
                    }
                }
#pragma unroll
                for (int t = 0; t < J; ++t) {
                    const int j = g + G * t;
                    if (j < p) {
                        float h1;
                        if constexpr (kAll) h1 = hr[t];
                        else h1 = ld_hr(j);
                        ldT(v, S.ru.at(k, j));
#pragma unroll
                        for (int s = 0; s < T; ++s) kf[s] = fmaf(h1, v[s], kf[s]);
                    }
                }
            }
            group_sum<T, NMAX>(kf);
            __syncwarp();  // every lane has read ru_k
            if (g == 0 && i < p) stT(S.kff.at(k, i), kf);
            __syncwarp();
            float dd[T];
            zeroT(dd);
            if (i < n)
#pragma unroll
                for (int t = 0; t < J; ++t) {
                    const int j = g + G * t;
                    if (j < p) {
                        float m1;
                        if constexpr (kAll) m1 = mt[t];
                        else m1 = ld_mt(j);
                        ldT(v, S.kff.at(k, j));
#pragma unroll
                        for (int s = 0; s < T; ++s) dd[s] = fmaf(m1, v[s], dd[s]);
                    }
                }
            group_sum<T, NMAX>(dd);
            if (g == 0 && i < n) {
#pragma unroll
                for (int s = 0; s < T; ++s) dd[s] += ck;
                stT(S.st.at(k, i), dd);
            }
            __syncwarp();
        }
        if (stg && mine) stage_wait();
        RES_MARK(7);
        // CF pass 1: the segment from zero (the first one from x0)
        if (mine) {
            float v[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
                v[r] = (first && own[r]) ? sh.x0[i * T + sc[r]] : 0.0f;
            seg_chain<T, NMAX, R>(cf, S.st, sc, live, k0, 1, k1 - k0, v, true,
                                  first, n);
#pragma unroll
            for (int r = 0; r < R; ++r)
                if (own[r]) wb[lcf + i * T + sc[r]] = v[r];
        }
        RES_MARK(8);
        __syncthreads();
        RES_MARK(9);
        // CF passes 2 and 3: carry the entry x_{k0} up from the first
        // segment, keep it for P4, rerun the segment from it
        if (!first && mine) {
            float e[R], l[R];
            for (int j = 0; j < warp; ++j) {
                const int j0 = seg_lo(j, N, W);
                if (j0 == seg_lo(j + 1, N, W)) continue;
#pragma unroll
                for (int r = 0; r < R; ++r)
                    l[r] = own[r] ? sh.wbuf[j * rs.wb + lcf + i * T + sc[r]]
                                  : 0.0f;
                if (j0 == 0) {
#pragma unroll
                    for (int r = 0; r < R; ++r) e[r] = l[r];
                } else {
                    carry_step<NMAX, R>(rs.Q + (W + j) * nn, e, l, n);
                }
            }
#pragma unroll
            for (int r = 0; r < R; ++r)
                if (own[r]) wb[i * T + sc[r]] = e[r];
            seg_chain<T, NMAX, R>(cf, S.st, sc, live, k0, 1, k1 - k0, e, true,
                                  true, n);
        }
        __syncwarp();
        if (stg && kcb > k0 && it + 1 < iterations)  // the next iteration's CB
            stage_chain(stg, gcb, k0, kcb, n, lane);
        RES_MARK(10);
        // P4: u_k = M_k [x_k; kff_k]_bottom, averaging, the dual step
        float rsum[T];
        zeroT(rsum);
        for (int k = k0; k < k1; ++k) {
            const float* MTk = c.MT + (long long)k * np * np;
            if (k + 1 < k1)  // the warp's next stage
                prefetch_block(MTk + (long long)np * np, n * np, lane);
            // x_k, [j][s]: x0, the carried entry, or CF's value at k - 1
            const float* xk = k > k0 ? S.st.at(k - 1, 0) : first ? sh.x0 : wb;
            float u[T], v[T];
            zeroT(u);
            if (i < p)
#pragma unroll
                for (int t = 0; t < NMAX / G; ++t) {
                    const int j = g + G * t;
                    if (j < n) {
                        const float mt = __ldg(MTk + j * np + n + i);
                        ldT(v, xk + j * T);
#pragma unroll
                        for (int s = 0; s < T; ++s) u[s] = fmaf(mt, v[s], u[s]);
                    }
                }
            group_sum<T, NMAX>(u);
            __syncwarp();  // every lane has read x_k
            if (g == 0 && i < p) {  // u = -K x - kff: M's -I block
                float kf[T], z[T];
                ldT(kf, S.kff.at(k, i));
                ldT(z, S.zu.at(k, i));
#pragma unroll
                for (int s = 0; s < T; ++s) {
                    u[s] -= kf[s];
                    z[s] = (1.0f - theta[s]) * z[s] + theta[s] * u[s];
                }
                stT(S.zu.at(k, i), z);
                stT(wb + i * T, u);
            }
            __syncwarp();
            const float* xn = S.st.at(k, 0);  // x_{k+1}, [j][s]
            for (int rw = lane; rw < m; rw += 32) {
                float gg[T], y[T], yp[T];
                float* yr = S.y.at(k, rw);
                float* ypr = S.yp.at(k, rw);
                ldT(y, yr);
                ldT(yp, ypr);
                const float hr = __ldg(c.h + k * m + rw);
                row_dot<T, NMAX>(gg, rw, xn, wb, sh, d);
#pragma unroll
                for (int s = 0; s < T; ++s) {
                    const float ys = y[s];
                    const float w = ys + beta[s] * (ys - (keep[s] * yp[s] +
                                                          (1.0f - keep[s]) * ys));
                    const float yn = fmaxf(w + (gg[s] - hr) * inv_L, 0.0f);
                    rsum[s] = fmaf(w - yn, yn - ys, rsum[s]);
                    yp[s] = ys;
                    y[s] = yn;
                }
                stT(ypr, yp);
                stT(yr, y);
            }
            __syncwarp();
        }
        if (restart) {
            warp_reduce<T>(rsum, false);
            if (lane < T) {
                float v = rsum[0];
#pragma unroll
                for (int s = 1; s < T; ++s)
                    if (lane == s) v = rsum[s];
                sh.rpart[warp * T + lane] = v;
            }
        }
        RES_MARK(11);
        __syncthreads();
        RES_MARK(12);
    }
    if (stg) stage_wait();
    RES_FLUSH();
}

template <int T, int NMAX>
__global__ void __launch_bounds__(kResMaxThreads, 1)
gpad_stagewise_resident_kernel(Args a) {
    extern __shared__ float4 smem4[];
    float* f = reinterpret_cast<float*>(smem4);
    const Dims& d = a.d;
    const int W = blockDim.x >> 5, nt = blockDim.x;
    const long long b0 = (long long)blockIdx.x * T;
    ResShared r;
    r.W = W;
    r.wb = res_wb(d, T);
    r.ls = res_ls(d, W);
    Shared& sh = r.s;
    sh = Shared{};
    sh.Gx = f;
    f += up4(d.m_x * d.gx_ld);
    sh.Gu = f;
    f += up4(d.m_u * d.gu_ld);
    sh.x0 = f;
    f += up4(d.n * T);
    sh.wbuf = f;
    f += up4(W * r.wb);
    sh.rpart = f;
    sh.vpart = f + W * T;
    f += up4(2 * W * T);
    if (a.chains_in_smem) {
        r.Q = f;
        f += res_q_floats(d, W);
        r.stg = f;
        f += up4(W * r.ls * d.n * d.n);
    } else {
        r.Q = a.qscratch + blockIdx.x * (long long)res_q_floats(d, W);
        r.stg = nullptr;
    }
    State<T> S;
    S.st = {f, d.n};
    f += up4(d.N * d.n * T);
    S.zu = {f, d.p};
    f += up4(d.N * d.p * T);
    S.ru = {f, d.p};
    S.kff = S.ru;  // kff_k overwrites ru_k in P3
    f += up4(d.N * d.p * T);
    S.y = {f, d.m};
    S.yp = {f + up4(d.N * d.m * T), d.m};
    stage_shared<T>(sh, a.Gx, a.Gu, a.x0, a.B, b0, d, nt);
    init_state<T>(S, a.y0, a.y0_stride, a.B, b0, d, nt);
    resident_iterations<T, NMAX>(S, r, a.c, d, 1.0f / a.L[0], a.iterations,
                                 a.restart != 0);
    RES_CLOCK;
    epilogue<T, NMAX, false>(S, sh, a.c, d, a.residual, a.gap, a.B, b0, W);
    store_rows<T>(a.zu_out, S.zu, d.N, a.B, b0, nt);
    store_rows<T>(a.y_out, S.y, d.N, a.B, b0, nt);
    RES_MARK(13);
    RES_FLUSH();
}

template <int T, int NMAX>
__global__ void __launch_bounds__(kThreads, 2)
gpad_stagewise_stream_kernel(Args a) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const Dims& d = a.d;
    const long long b0 = (long long)blockIdx.x * T;
    const Shared sh = carve_shared(smem, d, T);
    State<T> S;
    const long long ys = dual_floats(d, T);
    S.y = {a.y_work + blockIdx.x * ys, d.m};
    S.yp = {a.yp_work + blockIdx.x * ys, d.m};
    float* next = smem + shared_floats(d, T);
    if (a.aux) {
        carve_aux<T>(S, a.aux + blockIdx.x * (long long)aux_floats(d, T), d);
    } else {
        carve_aux<T>(S, next, d);
        next += aux_floats(d, T);
    }
    Shared shr = sh;
    shr.mbar = reinterpret_cast<unsigned long long*>(next);  // full, empty
    shr.ring = next + up4(4 * kRing);
    shr.aring = shr.ring + kRing * kRingBlock;
    if (threadIdx.x == 0) {
        for (int i = 0; i < kRing; ++i) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                             smem_addr(shr.mbar + i)) : "memory");
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                             smem_addr(shr.mbar + kRing + i)), "r"(T) : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    solve_tile<T, NMAX>(a, S, shr, b0);
}

int nmax_of(int n, int p) {
    const int q = n > p ? n : p;
    return q <= 8 ? 8 : q <= 16 ? 16 : q <= 32 ? 32 : 0;
}

template <typename K>
cudaError_t launch(K kernel, const Args& a, int T, int smem, cudaStream_t st,
                   int threads) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int grid = (a.B + T - 1) / T;
    kernel<<<grid, threads, (size_t)smem, st>>>(a);
    return cudaGetLastError();
}

// Every (T, NMAX) instance of KERNEL, by T * 100 + NMAX.
#define GPAD_SW_LAUNCH(KERNEL)                                              \
    switch (T * 100 + nmax) {                                               \
        case 108: return launch(KERNEL<1, 8>, a, T, smem, st, threads);     \
        case 116: return launch(KERNEL<1, 16>, a, T, smem, st, threads);    \
        case 132: return launch(KERNEL<1, 32>, a, T, smem, st, threads);    \
        case 208: return launch(KERNEL<2, 8>, a, T, smem, st, threads);     \
        case 216: return launch(KERNEL<2, 16>, a, T, smem, st, threads);    \
        case 232: return launch(KERNEL<2, 32>, a, T, smem, st, threads);    \
        case 408: return launch(KERNEL<4, 8>, a, T, smem, st, threads);     \
        case 416: return launch(KERNEL<4, 16>, a, T, smem, st, threads);    \
        case 432: return launch(KERNEL<4, 32>, a, T, smem, st, threads);    \
        case 808: return launch(KERNEL<8, 8>, a, T, smem, st, threads);     \
        case 816: return launch(KERNEL<8, 16>, a, T, smem, st, threads);    \
        case 832: return launch(KERNEL<8, 32>, a, T, smem, st, threads);    \
        default: return cudaErrorInvalidValue;                              \
    }

cudaError_t launch_resident(const Args& a, int T, int nmax, int smem,
                            cudaStream_t st, int threads) {
    GPAD_SW_LAUNCH(gpad_stagewise_resident_kernel)
}

cudaError_t launch_stream(const Args& a, int T, int nmax, int smem,
                          cudaStream_t st) {
    const int threads = kThreads;
    GPAD_SW_LAUNCH(gpad_stagewise_stream_kernel)
}

#undef GPAD_SW_LAUNCH

Args make_args(const float* RT, const float* HBT, const float* MT,
               const float* chainE,
               const float* Gx, const float* Gu, const float* h,
               const float* V, const float* theta, const float* beta,
               const float* L, const float* x0, const float* y0,
               long long y0_stride, int B, int N, int n, int p, int m_x,
               int m_u, int iterations, int restart, int log2_tile) {
    Args a{};
    a.c = {RT, HBT, MT, h, V, theta, beta, chainE};
    a.Gx = Gx;
    a.Gu = Gu;
    a.L = L;
    a.x0 = x0;
    a.y0 = y0;
    a.y0_stride = y0_stride;
    a.B = B;
    a.iterations = iterations;
    a.restart = restart;
    a.d = make_dims(N, n, p, m_x, m_u, 1 << log2_tile);
    return a;
}

bool bad_shape(int B, int N, int n, int p, int m_x, int m_u, int log2_tile) {
    return log2_tile < 0 || log2_tile > 3 || nmax_of(n, p) == 0 || N < 1 ||
           B < 1 || n < 1 || p < 1 || m_x < 1 || m_u < 1;
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return a cudaError_t (0 on success):
// cudaErrorInvalidValue for a shape they do not take or `smem` below the
// carve-up's need, else cudaGetLastError() after the launch. `smem` is the
// block's dynamic shared memory in bytes, computed by the caller
// (stagewise_kernel.py) so the routing guard and the launch agree; a block
// holds 2**log2_tile scenarios, log2_tile in [0, 3].

// The resident kernel on blocks of `warps` (8 or 16) warps. With
// `chains_in_smem` 0 the chains read their matrices from device memory and
// `qscratch` holds res_q_floats floats per block for the segment products.
int gpad_stagewise_launch(
    const float* RT, const float* HBT, const float* MT, const float* Gx,
    const float* Gu, const float* h, const float* V, const float* theta,
    const float* beta, const float* L, const float* x0, const float* y0,
    long long y0_stride, int B, int N, int n, int p, int m_x, int m_u,
    int iterations, int restart, int log2_tile, int warps,
    int chains_in_smem, float* qscratch, float* y_out, float* zu_out,
    float* residual, float* gap, int smem, void* stream)
{
    if (bad_shape(B, N, n, p, m_x, m_u, log2_tile) ||
        (warps != 8 && warps != 16) || (!chains_in_smem && !qscratch))
        return (int)cudaErrorInvalidValue;
    Args a = make_args(RT, HBT, MT, nullptr, Gx, Gu, h, V, theta, beta, L,
                       x0, y0, y0_stride, B, N, n, p, m_x, m_u, iterations,
                       restart, log2_tile);
    const int T = 1 << log2_tile;
    if (4LL * res_floats(a.d, T, warps, chains_in_smem != 0) > smem)
        return (int)cudaErrorInvalidValue;
    a.chains_in_smem = chains_in_smem;
    a.qscratch = qscratch;
    a.y_out = y_out;
    a.zu_out = zu_out;
    a.residual = residual;
    a.gap = gap;
    return (int)launch_resident(a, T, nmax_of(n, p), smem,
                                (cudaStream_t)stream, 32 * warps);
}

// y_work and yp_work hold dual_floats(T) floats per block of T scenarios
// (the kernel's own layout); y_out is the public (B, N, m) result. `aux` is
// null (st, zu, ru, kff in shared memory) or aux_floats(T) floats of device
// memory per block. `chainE`, the first argument, holds the chains'
// matrices, (2, N, n, 32).
int gpad_stagewise_stream_launch(
    const float* chainE, const float* RT, const float* HBT, const float* MT,
    const float* Gx,
    const float* Gu, const float* h, const float* V, const float* theta,
    const float* beta, const float* L, const float* x0, const float* y0,
    long long y0_stride, int B, int N, int n, int p, int m_x, int m_u,
    int iterations, int restart, int log2_tile, float* y_work, float* yp_work,
    float* aux, float* y_out, float* zu_out, float* residual, float* gap,
    int smem, void* stream)
{
    if (bad_shape(B, N, n, p, m_x, m_u, log2_tile))
        return (int)cudaErrorInvalidValue;
    Args a = make_args(RT, HBT, MT, chainE, Gx, Gu, h, V, theta, beta, L,
                       x0, y0, y0_stride, B, N, n, p, m_x, m_u, iterations,
                       restart, log2_tile);
    const int T = 1 << log2_tile;
    const long long need = 4LL * (shared_floats(a.d, T) + ring_floats(T) +
                                  (aux ? 0LL : (long long)aux_floats(a.d, T)));
    if (need > smem) return (int)cudaErrorInvalidValue;
    a.y_work = y_work;
    a.yp_work = yp_work;
    a.aux = aux;
    a.y_out = y_out;
    a.zu_out = zu_out;
    a.residual = residual;
    a.gap = gap;
    return (int)launch_stream(a, T, nmax_of(n, p), smem,
                              (cudaStream_t)stream);
}

#ifdef GPAD_SW_PROFILE
// The streamed kernel's phase cycles summed over the blocks since the last
// read, into out[kPhases]; clears them.
int gpad_stagewise_profile_read(unsigned long long* out)
{
    cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                           sizeof(g_phase_cycles));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[kPhases] = {};
    return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}

// The resident kernel's part cycles summed over every warp since the last
// read, into out[kResPhases]; clears them.
int gpad_stagewise_resident_profile_read(unsigned long long* out)
{
    cudaError_t err = cudaMemcpyFromSymbol(out, g_res_cycles,
                                           sizeof(g_res_cycles));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[kResPhases] = {};
    return (int)cudaMemcpyToSymbol(g_res_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
