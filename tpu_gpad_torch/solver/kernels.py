"""The paired and dense GPAD kernels (CUDA C++ for Hopper) and their plain
versions.

Five whole-solve kernels, each one launch per fixed-budget solve:

- ``gpad_fixed_paired_flat``: the flat paired mvp loop (the identity block
  of the input box costs a division), ``csrc/gpad_paired_flat.cu``; the
  counterpart of ``tpu_gpad.solver.kernels.gpad_pallas_fixed_paired_flat``.
- ``gpad_fixed_paired``: the paired mvp loop with the full ``GL_T``
  product and no identity block, the second instance of the same source;
  the counterpart of ``gpad_pallas_fixed_paired``.
- ``gpad_fixed_dense``: the dense (unpaired) loop on the reference's
  ``[S; -S; I; -I; K; -K]`` stack, ``csrc/gpad_dense.cu``; the counterpart
  of ``gpad_pallas_fixed``.
- ``gpad_fixed_flat_tiled``: the flat loop for stacks whose operands do
  not fit one block's shared memory (the reference's 30x30 flagship), both
  operands read from device memory on every iteration,
  ``csrc/gpad_flat_tiled.cu``; the counterpart of
  ``gpad_pallas_fixed_flat_tiled``.
- ``gpad_fixed_paired_tiled``: the full paired loop past one block's shared
  memory, the same kernel with every dual row structural (n_s = m_h); the
  counterpart of ``gpad_pallas_fixed_paired`` there.
- ``gpad_fixed_dense_tiled``: the dense loop past one block's shared
  memory, ``csrc/gpad_dense_tiled.cu`` (a persistent launch of two
  card-wide product phases an iteration on operand tiles staged by bulk
  copies, ``pick_dense_tiled``); the counterpart of ``gpad_pallas_fixed``
  there.

On CUDA tensors each launches its kernel or raises; on CPU tensors it runs
its plain version (``*_torch``), the same loop in torch ops, which is also
what the tests and ``chip_smoke.py`` hold the kernel against. Also here:
the helpers the dual kernels share (``dual_kernels.py``) and
``solve_batch_cuda``, the "cuda" engine's entry.

The data's dual rows are already in the flat kernel's [struct | box] order
(``dualize`` puts the identity rows last), so unlike the TPU kernels there
is no padding, transposition or layout mapping around a launch.

Every kernel here (and every dual one) takes the solve's precision tier
(``KERNEL_TIERS``): fp32 FFMA products at "highest", tensor-core
``mma.sync`` products at "high" (3xTF32), "default" (TF32) and "bfloat16"
(``csrc/mma_product.cuh``; the tiled kernels' strips in
``csrc/tiled_product.cuh``; the tiled dense kernel's from its staged
tiles); their plain versions mirror each tier's rounding (``_tier_mm``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from tpu_gpad_torch.types import GPADData, SolveResult

# Launches of each CUDA kernel in this process; a run resets them to 0 to
# show that a path went through its kernel.
PAIRED_FLAT_LAUNCHES = 0
PAIRED_LAUNCHES = 0
DENSE_LAUNCHES = 0
FLAT_TILED_LAUNCHES = 0
# the flat tiled kernel's launches at n_s = m_h (the full paired loop)
PAIRED_TILED_LAUNCHES = 0
DENSE_TILED_LAUNCHES = 0

# Dynamic shared memory one block may use on an H100 (232,448 bytes, the
# sm_90 opt-in maximum). The guard below is derived from it alone: which
# shapes are FASTER on the kernel than on the torch engine is unmeasured on
# H100.
SMEM_LIMIT_BYTES = 227 * 1024
def grid_tile(B: int, max_log2: int, min_blocks: int) -> int:
    """log2 of the scenarios per block for B scenarios: the widest power of
    two at most 2**max_log2 and at most B rounded up whose grid still has
    ``min_blocks`` blocks (one scenario per block below that)."""
    log2 = min(max_log2, max(B - 1, 0).bit_length())
    while log2 > 0 and -(-B // (1 << log2)) < min_blocks:
        log2 -= 1
    return log2


# The resident dense and dual kernels (csrc/gpad_dense.cu, csrc/gpad_dual.cu)
# run blocks of 256 threads over register-tiled block products
# (csrc/block_product.cuh): tiles of 4 rows x min(T, 4) scenarios, each
# split over K into parts of at least _MIN_PART_K steps. Under a tier the
# resident kernels' products are tensor-core ones (csrc/mma_product.cuh): a
# warp's tile of 16 rows x 8 scenarios, split over K into parts of at least
# _MMA_MIN_PART_K steps (one bf16 mma, two TF32 ones).
BLOCK_THREADS = 256
BLOCK_WARPS = BLOCK_THREADS // 32
_MIN_PART_K = 4
_MMA_ROWS, _MMA_COLS = 16, 8
_MMA_MIN_PART_K = 16

# The precision tiers every kernel of the condensed solve takes, in the
# order of the C launchers' ``tier`` argument (gpad_mma::Tier,
# csrc/mma_product.cuh)
KERNEL_TIERS = ("highest", "high", "default", "bfloat16")


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def block_parts(rows: int, log2_tile: int, K: int, cap: int | None = None,
                tier: str = "highest") -> int:
    """Split-K parts of a block product of ``rows`` output rows for
    2**log2_tile scenarios over K, at most ``cap``: at "highest" as many as
    leave every tile-part one thread of the block, none shorter than
    _MIN_PART_K steps of k; under a tier as many as leave every warp tile
    and part one warp, none shorter than _MMA_MIN_PART_K."""
    T = 1 << log2_tile
    if tier == "highest":
        tiles = _up4(rows) // 4 * (T // min(T, 4))
        parts = min(BLOCK_THREADS // tiles, -(-K // _MIN_PART_K))
    else:
        tiles = -(-rows // _MMA_ROWS) * -(-T // _MMA_COLS)
        parts = min(BLOCK_WARPS // tiles, -(-K // _MMA_MIN_PART_K))
    if cap is not None:
        parts = min(parts, cap)
    return max(parts, 1)


class DensePlan(NamedTuple):
    """A launch of the dense kernel: 2**log2_tile scenarios per block, rows
    padded to 4 (vec 4) or not (vec 1: one scenario per block, no split),
    and the split-K parts of zhat's product (split1) and of GL_T' zhat's
    (split2)."""
    log2_tile: int
    vec: int
    split1: int
    split2: int


# The dense kernel's grid: up to 16 scenarios per block, fewer while the
# grid would have fewer than 128 blocks, with the split-K parts of
# ``block_parts``. On an H100 80GB HBM3 at 700 W (PERF.md, §6,
# ``chip_smoke.py --sweep resident``, device ms of 100 iterations at
# battery n3 N10): B256 2 per block 0.141-0.149 against 0.165-0.168 at 1
# and over 0.17 at 4 or more; B4096 16 per block 0.43-0.47 against
# 0.48-0.52 at 32 and 1.05-1.17 at 8 (before the 128-register cap).
DENSE_MAX_LOG2_TILE = 4
DENSE_MIN_BLOCKS = 128


def _dense_smem_bytes(m: int, n_z: int, plan: DensePlan) -> int:
    """Shared memory of one block of the dense kernel (csrc carve-up): both
    operands with their rows padded to 4 (vec 4), 3 dual-row and 3
    primal-row arrays of 2**log2_tile scenarios each, and the scratch of
    the products' parts where either splits. Every tier has this carve-up:
    a tier's product of one part hands its sums to the epilogue from the
    fragments, as "highest"'s does from its registers."""
    T = 1 << plan.log2_tile
    mp, np_ = (_up4(m), _up4(n_z)) if plan.vec == 4 else (m, n_z)
    scratch = max([parts * _up4(rows) * T for parts, rows in
                   ((plan.split1, n_z), (plan.split2, m)) if parts > 1],
                  default=0)
    return 4 * (m * np_ + n_z * mp + 3 * (mp + np_) * T + scratch)


def _dense_plan(m: int, n_z: int, B: int, log2_tile: int | None = None,
                split: int | None = None,
                tier: str = "highest") -> DensePlan | None:
    """The dense kernel's launch for B scenarios at ``tier``: the tile of
    ``grid_tile`` (or ``log2_tile``), narrowed, then its parts (at most
    ``split``, counted by ``block_parts`` at the tier) halved, until the
    block fits shared memory; past that the unpadded layout at one scenario
    per block (the carve-up of the kernel's first design, so every shape it
    took still runs); None when nothing fits. The tile, and whether a plan
    exists, are the same under every tier: a tile fits at some parts iff
    it fits at one, and one part needs no scratch at any tier."""
    top = (grid_tile(B, DENSE_MAX_LOG2_TILE, DENSE_MIN_BLOCKS)
           if log2_tile is None else log2_tile)
    for log2 in range(top, -1 if log2_tile is None else top - 1, -1):
        s1 = block_parts(n_z, log2, m, split, tier)
        s2 = block_parts(m, log2, n_z, split, tier)
        while True:
            plan = DensePlan(log2, 4, s1, s2)
            if _dense_smem_bytes(m, n_z, plan) <= SMEM_LIMIT_BYTES:
                return plan
            if s1 == s2 == 1:
                break
            s1, s2 = max(s1 // 2, 1), max(s2 // 2, 1)
    plan = DensePlan(0, 1, 1, 1)
    if (log2_tile in (None, 0)
            and _dense_smem_bytes(m, n_z, plan) <= SMEM_LIMIT_BYTES):
        return plan
    return None


class PairedPlan(NamedTuple):
    """A launch of the paired kernels (flat and full instance):
    2**log2_tile scenarios per block, rows padded to 4 (vec 4) or not (vec
    1: one scenario per block, no split), and the split-K parts of zhat's
    product (split1) and of q's (split2)."""
    log2_tile: int
    vec: int
    split1: int
    split2: int


# The paired kernels' grid: up to 16 scenarios per block, fewer while the
# grid would have fewer than 128 blocks, and fewer while a thread's share
# of the state would not fit its registers (below), with the split-K parts
# of ``block_parts``, at most 8 up to 4 per block and at most 4 from 8 per
# block. On an H100 80GB HBM3 at 700 W (PERF.md, §6, ``chip_smoke.py
# --sweep flat paired``, device ms of 100 iterations at battery n3 N10,
# flat / full instance): B256 2 per block 0.140-0.143 / 0.145-0.151
# against 0.148-0.150 at 1 and over 0.19 at 4 or more; B4096 16 per block
# with at most 4 parts 0.373 / 0.417 against 0.454 / 0.462 with up to 8
# and 0.68 / 0.68 at 8 per block.
PAIRED_MAX_LOG2_TILE = 4
PAIRED_MIN_BLOCKS = 128


def _paired_split_cap(log2_tile: int) -> int:
    """The paired kernels' most split-K parts at 2**log2_tile per block:
    a wide tile's products already fill the block, and every part costs
    its epilogue a read."""
    return 8 if log2_tile <= 2 else 4


# Dual and primal elements of the [row][scenario] state a thread keeps in
# registers (max_elements, kMaxP of csrc/gpad_paired_flat.cu: one dual
# element fewer under a tier, whose product's fragments take registers too);
# past them, at one scenario per block, the kernel keeps the rest in device
# memory.
_PAIRED_MAX_ELEMENTS = 6
_PAIRED_MAX_ELEMENTS_TIER = 5
_PAIRED_MAX_PRIMAL = 2


def _paired_max_elements(tier: str = "highest") -> int:
    return _PAIRED_MAX_ELEMENTS if tier == "highest" else _PAIRED_MAX_ELEMENTS_TIER


def _paired_smem_bytes(m_h: int, n_z: int, n_s: int, plan: PairedPlan) -> int:
    """Shared memory of one block of the paired kernels (csrc carve-up):
    MG_T and the n_s used columns of GL_T (the full instance has n_s =
    m_h), their rows padded to 4 (vec 4), wd and zhat of 2**log2_tile
    scenarios (rows padded to 4), and the products' parts (one scratch of
    at least one part). Every tier has this carve-up, with fp32 operands:
    a tier changes only the plan's parts."""
    T = 1 << plan.log2_tile
    np_, nsp = (_up4(n_z), _up4(n_s)) if plan.vec == 4 else (n_z, n_s)
    scratch = max(plan.split1 * _up4(n_z), plan.split2 * _up4(n_s))
    return 4 * (m_h * np_ + n_z * nsp + (_up4(m_h) + _up4(n_z) + scratch) * T)


def _paired_overflows(m_h: int, log2_tile: int, tier: str = "highest") -> bool:
    """Does a tile's dual state pass the block's registers at ``tier`` (the
    kernel then keeps the rest in device memory, y_prev in a scratch)?"""
    return m_h << log2_tile > _paired_max_elements(tier) * BLOCK_THREADS


def _paired_plan(m_h: int, n_z: int, n_s: int, B: int,
                 log2_tile: int | None = None, split: int | None = None,
                 tier: str = "highest") -> PairedPlan | None:
    """The paired kernels' launch for B scenarios at ``tier``: the tile of
    ``grid_tile`` (or ``log2_tile``), narrowed until a thread's share of
    the state fits its registers, then it or its parts (at most ``split``,
    counted by ``block_parts`` at the tier) halved until the block fits
    shared memory; past that the unpadded layout at one scenario per block
    (so every shape the first design's carve-up took still runs); None
    when nothing fits. Whether a plan exists is the same under every tier
    (a tier may narrow the tile, its registers holding one dual element
    fewer, and a tile fits at some parts iff it fits at one), so routing
    never depends on the tier."""
    top = (grid_tile(B, PAIRED_MAX_LOG2_TILE, PAIRED_MIN_BLOCKS)
           if log2_tile is None else log2_tile)
    for log2 in range(top, -1 if log2_tile is None else top - 1, -1):
        if log2_tile is None and log2 and (
                _paired_overflows(m_h, log2, tier) or n_z << log2
                > _PAIRED_MAX_PRIMAL * BLOCK_THREADS):
            continue
        cap = _paired_split_cap(log2) if split is None else split
        s1 = block_parts(n_z, log2, m_h, cap, tier)
        s2 = block_parts(n_s, log2, n_z, cap, tier) if n_s else 1
        while True:
            plan = PairedPlan(log2, 4, s1, s2)
            if _paired_smem_bytes(m_h, n_z, n_s, plan) <= SMEM_LIMIT_BYTES:
                return plan
            if s1 == s2 == 1:
                break
            s1, s2 = max(s1 // 2, 1), max(s2 // 2, 1)
    plan = PairedPlan(0, 1, 1, 1)
    if (log2_tile in (None, 0)
            and _paired_smem_bytes(m_h, n_z, n_s, plan) <= SMEM_LIMIT_BYTES):
        return plan
    return None


def flat_fits_smem(data: GPADData) -> bool:
    """Can the flat kernel run this data: a flat paired layout whose
    operands and one scenario's state fit one block's shared memory?"""
    if not (data.paired and data.n_struct is not None):
        return False
    return _paired_plan(data.m_half, data.n_z, data.n_struct, 1) is not None


class FlatTiledPlan(NamedTuple):
    """A launch of the flat tiled kernel: clusters of ``cluster`` blocks,
    each owning 2**log2_tile scenarios, and whether a product's groups of
    threads meet in a shared scratch (``grouped``) or one group keeps each
    column's sums in its thread (shapes near the guard)."""
    log2_tile: int
    cluster: int
    grouped: bool


# The flat tiled kernel (csrc/gpad_flat_tiled.cu): 512 threads per block;
# a cluster owns the widest tile, up to 16 scenarios, that the batch fills
# and that fits shared memory; clusters of up to 16 blocks (the
# non-portable size) while the grid has at most 16 clusters, of up to 8
# beyond, and no more blocks than leave each at least 32 of the n_z
# primal columns (4 blocks at least). On an H100 80GB HBM3 at 700 W
# (PERF.md, §6, ``chip_smoke.py --sweep tiled``, ms of 100 iterations):
# the flagship (n_z 900) B256 12.82 ms on 16 x 16 against 13.09 on 16 x 4,
# 14.30 on 16 x 8 and over 15.2 at 8 per cluster; B1024 35.8 on 8 blocks
# against 40.1 on 4 and 42.7 on 16; B1 2.64 on 16 against 4.38 on 8;
# n5 N30 (n_z 150) B256 1.49 on 16 x 4 against 2.72 on 8 and 4.08 on 16.
FLAT_TILED_MAX_LOG2_TILE = 4
FLAT_TILED_WIDE_CLUSTER = 16
FLAT_TILED_CLUSTER = 8
FLAT_TILED_MAX_WIDE_CLUSTERS = 16
FLAT_TILED_MIN_CLUSTER = 4
FLAT_TILED_MIN_COLUMNS = 32
_FLAT_TILED_RED_COLS = 512  # kRedCols: the groups' scratch per scenario


def _flat_tiled_smem_bytes(m_h: int, n_z: int, log2_tile: int,
                           grouped: bool = True) -> int:
    """Shared memory of one block of the flat tiled kernel (csrc carve-up):
    wd and zhat of 2**log2_tile scenarios and, with grouped products, the
    groups' scratch; the operands and the state stay in device memory. The
    cluster size does not change it."""
    return 4 * (1 << log2_tile) * (
        m_h + n_z + (_FLAT_TILED_RED_COLS if grouped else 0))


def pick_flat_tiled(m_half: int, n_z: int, B: int = 1,
                    log2_tile: int | None = None,
                    cluster: int | None = None) -> FlatTiledPlan | None:
    """The flat tiled kernel's launch for B scenarios: the widest tile, at
    most 2**FLAT_TILED_MAX_LOG2_TILE and at most B rounded up to a power of
    two (or ``log2_tile``), narrowed until a block fits shared memory with
    grouped products; past that one scenario without the groups' scratch;
    None when not even that fits. The blocks per cluster follow the grid
    and n_z (see FLAT_TILED_CLUSTER); ``cluster`` overrides them."""
    top = (min(FLAT_TILED_MAX_LOG2_TILE, max(B - 1, 0).bit_length())
           if log2_tile is None else log2_tile)
    tiles = range(top, -1, -1) if log2_tile is None else (top,)
    fallback = [(0, False)] if log2_tile in (None, 0) else []
    for log2, grouped in [(t, True) for t in tiles] + fallback:
        if _flat_tiled_smem_bytes(m_half, n_z, log2, grouped) > SMEM_LIMIT_BYTES:
            continue
        if cluster is None:
            wide = -(-B // (1 << log2)) <= FLAT_TILED_MAX_WIDE_CLUSTERS
            cluster = FLAT_TILED_WIDE_CLUSTER if wide else FLAT_TILED_CLUSTER
            while (cluster > FLAT_TILED_MIN_CLUSTER
                   and n_z < FLAT_TILED_MIN_COLUMNS * cluster):
                cluster //= 2
        return FlatTiledPlan(log2, cluster, grouped)
    return None


def flat_tiled_fits(data: GPADData) -> bool:
    """Can the flat tiled kernel run this data: the flat paired layout with
    a non-empty structural block and one scenario's wd and zhat within a
    block's shared memory? Soft rows ride along (the damp column is read
    from device memory, so it costs no shared memory), as tpu_gpad's
    resident flat kernel carries them within its VMEM budget."""
    return (data.paired and data.n_struct is not None and data.n_struct > 0
            and pick_flat_tiled(data.m_half, data.n_z) is not None)


def paired_tiled_fits(data: GPADData) -> bool:
    """Can the flat tiled kernel run this data's full paired loop (n_s =
    m_h): a paired layout, soft rows or not, whose one scenario's wd and
    zhat fit a block's shared memory?"""
    return (data.paired
            and pick_flat_tiled(data.m_half, data.n_z) is not None)


# The tiled dense kernel (csrc/gpad_dense_tiled.cu): one block an SM, an
# iteration two card-wide product phases, A (zhat: K = m over n_z columns)
# and B (q: K = n_z over the m rows); a unit is a tile of `tile` scenarios x
# DENSE_TILED_COLS columns over one part of K, staged DENSE_TILED_DEPTH rows
# at a time (rows padded by 8 floats) through a ring of as many stages of
# shared memory as fit, at most DENSE_TILED_MAX_STAGES, two bulk copies a
# stage from the operands and the state laid out in tiles in the scratch.
# Parts past one write partial sums that a pass of their own adds in part
# order (a grid barrier and the parts' bytes).
DENSE_TILED_TILES = (16, 32, 64, 128)
DENSE_TILED_COLS = 128
DENSE_TILED_DEPTH = 32
DENSE_TILED_MAX_STAGES = 8
_DENSE_TILED_PAD = 8
_DENSE_TILED_BARRIER_BYTES = 16 * DENSE_TILED_MAX_STAGES
H100_SMS = 132
# The plan's model of a phase's time (it only ranks the tiles): the units
# run in waves of one an SM, each k-tile of a unit taking
# _DENSE_TILED_KTILE_US at its tile; a grid barrier a phase; a phase of
# several parts adds a pass over the parts' sums, a fixed cost and its
# bytes. Fitted to the plan sweep on an H100 80GB HBM3 at 700 W
# (``chip_smoke.py --sweep dense_tiled``, 100 iterations of the flagship's
# dense layout at B 1-1024 and of battery n5 N20, n10 N20 at B256; PERF.md
# section 6), within 5% at the median.
_DENSE_TILED_KTILE_US = {16: 1.29, 32: 1.45, 64: 1.81, 128: 3.26}
_DENSE_TILED_BARRIER_US = 2.61
_DENSE_TILED_REDUCE_US, _DENSE_TILED_REDUCE_US_PER_MB = 1.39, 1.65


class DenseTiledPlan(NamedTuple):
    """A launch of the tiled dense kernel: units of ``tile`` scenarios x
    ``cols`` columns, each phase's K in ``parts_a`` (A: m) and ``parts_b``
    (B: n_z) parts staged ``depth`` rows at a time through ``stages``
    shared-memory stages; ``smem`` bytes a block; ``units_a`` and
    ``units_b`` units a phase. The op takes (tile, parts_a, parts_b)."""
    tile: int
    parts_a: int
    parts_b: int
    cols: int = DENSE_TILED_COLS
    depth: int = DENSE_TILED_DEPTH
    stages: int = 0
    smem: int = 0
    units_a: int = 0
    units_b: int = 0


def _dense_tiled_stage_bytes(tile: int) -> int:
    """One stage of the ring: 32 operand rows and 32 state rows, each
    padded by 8 floats."""
    return 4 * DENSE_TILED_DEPTH * (DENSE_TILED_COLS + tile
                                    + 2 * _DENSE_TILED_PAD)


def dense_tiled_stages(tile: int) -> int:
    """The ring's stages at ``tile`` scenarios a unit: as many as fit a
    block's shared memory, at most DENSE_TILED_MAX_STAGES (csrc
    stages_of)."""
    return min(DENSE_TILED_MAX_STAGES,
               (SMEM_LIMIT_BYTES - _DENSE_TILED_BARRIER_BYTES)
               // _dense_tiled_stage_bytes(tile))


def _dense_tiled_smem_bytes(tile: int) -> int:
    """Shared memory of one block of the tiled dense kernel: the ring's
    barriers and its stages (csrc carve-up, smem_bytes). The shape does
    not change it."""
    return (_DENSE_TILED_BARRIER_BYTES
            + dense_tiled_stages(tile) * _dense_tiled_stage_bytes(tile))


def _dense_tiled_scratch_floats(m: int, n_z: int, B: int, tile: int,
                                parts_a: int, parts_b: int) -> int:
    """Floats of the scratch a launch of the tiled dense kernel needs (csrc
    layout(), gpad_dense_tiled_scratch_floats): MG_T and GL_T in column
    tiles of 128 (K up to 32 rows of 136 floats); w, y and p_D in scenario
    tiles (m up to 32 rows of tile + 8 floats), zhat, z and g_P likewise;
    and the parts' sums, [part][column][B up to the tile], of each phase
    of more than one part."""
    def up(n, q):
        return -(-n // q) * q

    d, ld, lx = DENSE_TILED_DEPTH, DENSE_TILED_COLS + _DENSE_TILED_PAD, (
        tile + _DENSE_TILED_PAD)
    Bp = up(B, tile)
    operands = (-(-n_z // DENSE_TILED_COLS) * up(m, d)
                + -(-m // DENSE_TILED_COLS) * up(n_z, d)) * ld
    state = 3 * Bp // tile * (up(m, d) + up(n_z, d)) * lx
    part = max(parts_a * n_z if parts_a > 1 else 0,
               parts_b * m if parts_b > 1 else 0) * Bp
    return operands + state + part


def _dense_tiled_units(m: int, n_z: int, B: int, tile: int, parts_a: int,
                       parts_b: int) -> tuple[int, int]:
    """Units of phase A and of phase B."""
    st = -(-B // tile)
    return (st * -(-n_z // DENSE_TILED_COLS) * parts_a,
            st * -(-m // DENSE_TILED_COLS) * parts_b)


def _phase_us(tile: int, units: int, parts: int, k_tiles: int, cols: int,
              B: int, sms: int) -> float:
    """The model's microseconds of one phase (see _DENSE_TILED_KTILE_US)."""
    us = (_DENSE_TILED_BARRIER_US
          + -(-units // sms) * -(-k_tiles // parts) * _DENSE_TILED_KTILE_US[tile])
    if parts > 1:
        us += (_DENSE_TILED_REDUCE_US
               + _DENSE_TILED_REDUCE_US_PER_MB * 4e-6 * parts * cols * B)
    return us


def pick_dense_tiled(m: int, n_z: int, B: int = 1, tier: str = "highest",
                     tile: int | None = None, parts_a: int | None = None,
                     parts_b: int | None = None,
                     sms: int = H100_SMS) -> DenseTiledPlan:
    """The tiled dense kernel's launch for B scenarios on ``sms`` SMs: each
    phase's K cut into as many parts as leave its units in one wave (one
    part where its tiles alone fill the card; at most its 32-row k-tiles),
    and the scenario tile, among those up to B rounded up to a power of two
    (16 to 128), whose phases the model (``_phase_us``) puts fastest.
    ``tile``, ``parts_a`` and ``parts_b`` override it (for sweeps). Every
    tier takes the same plan: its shared memory is the ring's alone."""
    if tier not in KERNEL_TIERS:
        raise ValueError(f"unknown tier {tier!r} (one of {KERNEL_TIERS})")
    kt_a = -(-m // DENSE_TILED_DEPTH)
    kt_b = -(-n_z // DENSE_TILED_DEPTH)
    top = min(DENSE_TILED_TILES[-1],
              max(DENSE_TILED_TILES[0], 1 << max(B - 1, 0).bit_length()))
    tiles = ([t for t in DENSE_TILED_TILES if t <= top] if tile is None
             else [tile])
    best = None
    for t in tiles:
        st = -(-B // t)
        tiles_a = st * -(-n_z // DENSE_TILED_COLS)
        tiles_b = st * -(-m // DENSE_TILED_COLS)
        pa = parts_a or max(1, min(kt_a, sms // tiles_a))
        pb = parts_b or max(1, min(kt_b, sms // tiles_b))
        us = (_phase_us(t, tiles_a * pa, pa, kt_a, n_z, B, sms)
              + _phase_us(t, tiles_b * pb, pb, kt_b, m, B, sms))
        if best is None or us < best[0]:
            best = (us, t, pa, pb)
    _, t, pa, pb = best
    units_a, units_b = _dense_tiled_units(m, n_z, B, t, pa, pb)
    return DenseTiledPlan(t, pa, pb, stages=dense_tiled_stages(t),
                          smem=_dense_tiled_smem_bytes(t),
                          units_a=units_a, units_b=units_b)


def dense_tiled_fits(data: GPADData) -> bool:
    """Can the tiled dense kernel run this data: an unpaired stack without
    soft rows? Its state lives in device memory and its shared memory is
    the staging ring's alone, so no shape is too large for it."""
    return not data.paired and data.soft_damp is None


# engine="auto" takes the tiled dense, paired tiled and flat tiled routes
# where the kernel beat the torch engine. The torch engine sits on a launch
# floor of 15-45 ms per 100 iterations until its products outgrow it; a
# kernel's time follows its work, rows a side x n_z x B, so each edge is a
# work, and at most the largest measured shape. Measured on an H100 80GB
# HBM3 at 700 W (PERF.md, section 5, ``chip_smoke.py --times routes``: ms
# of 100 iterations on battery shapes from m 440 / m_h 330 to the 30x30
# flagship, the route's solve against the torch engine's in two turns, at
# B1, 64, 256, 1024, 4096, 16384). Dense (the redesigned kernel): faster
# at 58 of the 60 points, from 1.27 against 19.8 ms (n5 N20, B1) to the
# flagship at B16384 (553.8 against 681.6: work 3660 x 900 x 16384, the
# largest measured); the other two tied within 0.7% (n25 N30 B1024, 33.25
# against 33.20; n10 N30 B4096, 32.00 against 31.79), so the edge is the
# largest measured work. Paired: faster at every shape to the flagship's
# m_h 1830 at B1, B64 and B256 (15.5 against 24.0); at B1024 to m_h 930
# (15.2 against 31.3), m_h 1230 lost (30.9 against 29.4); at B4096 to m_h
# 550 (23.9 against 32.9: work 550 x 250 x 4096), m_h 630 lost (40.8
# against 30.4); at B16384 m_h 330 lost (55.6 against 49.8). Flat: faster
# at every shape at B1-256 and at B1024, the flagship's 43.96 against
# 45.16 the closest; at B4096 to m_h 630 (35.0 against 42.2: work 630 x
# 300 x 4096), m_h 930 lost (50.9 against 42.4); at B16384 m_h 330 lost
# (61.2 against 49.8), m_h 350 won (62.4 against 76.1) and m_h 420 lost
# (68.8 against 63.9); the edge is the most work won below the first loss
# (the flagship's B1024, 2.7% ahead at 2.2x that work, and m_h 350 B16384
# are left out of it; an earlier run had the flagship B1024 and m_h 630
# B4096 losing, 35.8 against 33.3 and 35.9 against 32.5).
DENSE_TILED_AUTO_MAX_M, DENSE_TILED_AUTO_MAX_WORK = 3660, 3660 * 900 * 16384
PAIRED_TILED_AUTO_MAX_M_HALF, PAIRED_TILED_AUTO_MAX_WORK = (
    1830, 550 * 250 * 4096)
FLAT_TILED_AUTO_MAX_M_HALF, FLAT_TILED_AUTO_MAX_WORK = 1830, 630 * 300 * 4096


def tiled_auto(data: GPADData, batch: int = 1, flat: bool = False) -> bool:
    """Does ``engine="auto"`` take the paired tiled or the tiled dense
    route (``flat``: the flat tiled one) for this data at ``batch``
    scenarios: a shape no larger than the largest measured, and work (rows
    a side x n_z x batch) no more than the most at which the kernel was
    measured faster than the torch engine? Plan and layout aside:
    ``flat_tiled_fits``, ``paired_tiled_fits`` and ``dense_tiled_fits``
    say whether the kernel runs it at all."""
    rows, most_rows, most_work = (
        (data.m_half, FLAT_TILED_AUTO_MAX_M_HALF, FLAT_TILED_AUTO_MAX_WORK)
        if flat else
        (data.m_half, PAIRED_TILED_AUTO_MAX_M_HALF, PAIRED_TILED_AUTO_MAX_WORK)
        if data.paired
        else (data.m, DENSE_TILED_AUTO_MAX_M, DENSE_TILED_AUTO_MAX_WORK))
    return rows <= most_rows and rows * data.n_z * batch <= most_work


def paired_fits_smem(data: GPADData) -> bool:
    """Can the full paired kernel run this data: a paired layout whose
    operands and one scenario's state fit one block's shared memory?"""
    if not data.paired:
        return False
    return _paired_plan(data.m_half, data.n_z, data.m_half, 1) is not None


def dense_fits_smem(data: GPADData) -> bool:
    """Can the dense kernel run this data: an unpaired stack without soft
    rows whose operands and one scenario's state fit one block's shared
    memory? (tpu_gpad's VMEM guard admits far larger stacks; those run the
    torch engine here.)"""
    if data.paired or data.soft_damp is not None:
        return False
    return _dense_plan(data.m, data.n_z, 1) is not None


def _norm_y0(y0, B: int, m_h: int):
    """A warm-start dual as (rows, 2, m_h) with rows 1 (shared by every
    scenario) or B. Accepts what ``solve_batch`` documents: (2, m_h),
    (1, 2, m_h), (B..., 2, m_h) with leading batch dims flattened."""
    if y0.ndim > 3:
        y0 = y0.reshape((-1,) + tuple(y0.shape[-2:]))
    if y0.ndim == 2:
        y0 = y0[None]
    if y0.ndim != 3 or tuple(y0.shape[1:]) != (2, m_h) or y0.shape[0] not in (1, B):
        raise ValueError(
            f"y0 of shape {tuple(y0.shape)} does not broadcast to "
            f"({B}, 2, {m_h})"
        )
    return y0


def _norm_dense_y0(y0, B: int, m: int):
    """A dense warm-start dual as (rows, m) with rows 1 or B, as
    ``tpu_gpad.solver.kernels.solve_batch_pallas`` takes it: (m,), (1, m),
    or (B..., m) with leading batch dims flattened."""
    if y0.ndim > 2:
        y0 = y0.reshape(-1, y0.shape[-1])
    if y0.ndim == 1:
        y0 = y0[None]
    if y0.ndim != 2 or y0.shape[1] != m or y0.shape[0] not in (1, B):
        raise ValueError(
            f"y0 of shape {tuple(y0.shape)} does not broadcast to ({B}, {m})"
        )
    return y0


def _od(data: GPADData):
    """The (m_h,) column 1 - soft_damp, or None on hard data."""
    if data.soft_damp is None:
        return None
    return 1.0 - data.soft_damp.to(torch.float32)


def _tier_operand(b, tier: str):
    """A constant operand as the kernels' products at ``tier`` read it
    (``_tier_mm``'s ``b``, prepared once outside the loop): itself at
    "highest", rounded to TF32 ("default") or bf16 ("bfloat16"), its TF32
    (hi, lo) pair ("high")."""
    from tpu_gpad_torch.solver import core

    if tier == "highest":
        return b
    if tier == "high":
        return core._split_tf32_rna(b)
    if tier == "default":
        return core._round_tf32(b)
    if tier == "bfloat16":
        return core._round_bf16(b)
    raise ValueError(f"unknown tier {tier!r} (one of {KERNEL_TIERS})")


def _tier_mm(a, b, tier: str):
    """``a @ b`` as the kernels compute it at ``tier``
    (csrc/mma_product.cuh), with ``b`` from ``_tier_operand``: fp32 products
    of the tier's rounded operands ("high": lo.hi + hi.lo first, then
    hi.hi). On the card it runs with TF32 held off (the caller's switch),
    as the solve routes do."""
    from tpu_gpad_torch.solver import core

    if tier == "highest":
        return a @ b
    if tier == "high":
        (a_hi, a_lo), (b_hi, b_lo) = core._split_tf32_rna(a), b
        return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    if tier == "default":
        return core._round_tf32(a) @ b
    return core._round_bf16(a) @ b


def _paired_loop(MG_T, GL_T, theta, beta, L, od, g_P, p_D, y0,
                 iterations: int, diagnostics: bool, n_s: int, flat: bool,
                 tier: str = "highest"):
    """The paired kernels' loop in torch ops, on any device, on the
    operands themselves (``_paired_plain`` takes them from the data), its
    two products at ``tier``. ``flat`` replaces the identity block's
    product by a division, as the flat kernel does; ``n_s`` is the columns
    of ``GL_T`` the product uses."""
    B, m_h = g_P.shape[0], p_D.shape[-1]
    MGp = _tier_operand(MG_T, tier)
    GLp = _tier_operand(GL_T[:, :n_s], tier)
    inv_L = 1.0 / L
    if y0 is None:
        y = torch.zeros((B, 2, m_h), dtype=torch.float32, device=g_P.device)
    else:
        y = _norm_y0(y0, B, m_h).expand(B, 2, m_h).clone()
    y_prev = y
    z = torch.zeros_like(g_P)
    w = torch.zeros_like(y)
    zhat = torch.zeros_like(g_P)
    for k in range(iterations):
        w = y + beta[k] * (y - y_prev)
        zhat = -_tier_mm(w[:, 0] - w[:, 1], MGp, tier) - g_P
        z = (1.0 - theta[k]) * z + theta[k] * zhat
        q = _tier_mm(zhat, GLp, tier)
        if flat:
            q = torch.cat([q, zhat * inv_L], dim=-1)
        w_s = w if od is None else w * od
        y_prev, y = y, torch.clamp_min(w_s + torch.stack([q, -q], 1) + p_D, 0.0)
    if not diagnostics:
        return z, y, None, None
    return z, y, w, zhat


def _paired_plain(data: GPADData, g_P, p_D, y0, iterations: int,
                  diagnostics: bool, flat: bool, tier: str):
    """The paired kernels' loop in torch ops, on any device."""
    n_s = data.n_struct if flat else data.m_half
    return _paired_loop(data.MG_T, data.GL_T, data.theta, data.beta, data.L,
                        _od(data), g_P, p_D, y0, iterations, diagnostics,
                        n_s, flat, tier)


def gpad_fixed_paired_flat_torch(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True, tier: str = "highest",
):
    """The flat kernel's loop in torch ops, on any device: the plain
    version the kernel is checked against. Same contract as
    ``gpad_fixed_paired_flat``."""
    return _paired_plain(data, g_P, p_D, y0, iterations, diagnostics, True,
                         tier)


def gpad_fixed_paired_torch(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True, tier: str = "highest",
):
    """The full paired kernel's loop in torch ops, on any device: the plain
    version the kernel is checked against. Same contract as
    ``gpad_fixed_paired``."""
    return _paired_plain(data, g_P, p_D, y0, iterations, diagnostics, False,
                         tier)


def gpad_fixed_dense_torch(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True, tier: str = "highest",
):
    """The dense kernel's loop in torch ops, on any device: the plain
    version the kernel is checked against. Same contract as
    ``gpad_fixed_dense``."""
    return _dense_loop(data.MG_T, data.GL_T, data.theta, data.beta, g_P, p_D,
                       y0, iterations, diagnostics, tier)


def _dense_loop(MG_T, GL_T, theta, beta, g_P, p_D, y0, iterations: int,
                diagnostics: bool, tier: str = "highest"):
    """``gpad_fixed_dense_torch`` on the operands themselves, its two
    products at ``tier`` (``_tier_mm``)."""
    B, m = g_P.shape[0], p_D.shape[-1]
    MGp, GLp = _tier_operand(MG_T, tier), _tier_operand(GL_T, tier)
    if y0 is None:
        y = torch.zeros((B, m), dtype=torch.float32, device=g_P.device)
    else:
        y = _norm_dense_y0(y0, B, m).expand(B, m).clone()
    y_prev = y
    z = torch.zeros_like(g_P)
    w = torch.zeros_like(y)
    zhat = torch.zeros_like(g_P)
    for k in range(iterations):
        w = y + beta[k] * (y - y_prev)
        zhat = -_tier_mm(w, MGp, tier) - g_P
        z = (1.0 - theta[k]) * z + theta[k] * zhat
        y_prev, y = y, torch.clamp_min(w + _tier_mm(zhat, GLp, tier) + p_D,
                                       0.0)
    if not diagnostics:
        return z, y, None, None
    return z, y, w, zhat


_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of the launchers in csrc/gpad_paired_flat.cu (both
# instances), csrc/gpad_dense.cu, csrc/gpad_flat_tiled.cu and
# csrc/gpad_dense_tiled.cu
_PAIRED_ARGTYPES = ([_PTR] * 5 + [_LL] + [_PTR] * 4 + [_INT] * 9 + [_PTR] * 5
                    + [_INT, _INT, _PTR])
_DENSE_ARGTYPES = ([_PTR] * 5 + [_LL] + [_PTR] * 2 + [_INT] * 8 + [_PTR] * 4
                   + [_INT, _INT, _PTR])
_FLAT_TILED_ARGTYPES = ([_PTR] * 5 + [_LL] + [_PTR] * 4 + [_INT] * 8
                        + [_PTR] * 4 + [_INT, _INT, _PTR])
_DENSE_TILED_ARGTYPES = ([_PTR] * 5 + [_LL] + [_PTR] * 2 + [_INT] * 7
                         + [_PTR] * 5 + [_INT, _INT, _PTR])


def _launch_fn(library: str, symbol: str, argtypes):
    """A kernel's C launcher, built and loaded at first use."""
    from tpu_gpad_torch import cuda_build

    fn = getattr(cuda_build.load(library), symbol)
    fn.argtypes = argtypes
    fn.restype = _INT
    return fn


def _check_common(data: GPADData, g_P, p_D, dual_shape, iterations: int,
                  tensors) -> None:
    """Raise on a budget past the schedule, wrong shapes, or tensors the
    kernels do not take."""
    if iterations > data.max_iters:
        raise ValueError(f"{iterations} iterations exceed the schedule's "
                         f"{data.max_iters}")
    n_z = data.n_z
    if g_P.ndim != 2 or g_P.shape[1] != n_z:
        raise ValueError(f"g_P must be (B, {n_z}); got {tuple(g_P.shape)}")
    want = (g_P.shape[0],) + tuple(dual_shape)
    if tuple(p_D.shape) != want:
        raise ValueError(f"p_D must be {want}; got {tuple(p_D.shape)}")
    _check_tensors([data.MG_T, data.GL_T, data.theta, data.beta, g_P, p_D,
                    *tensors], g_P.device)


def _check_inputs(data: GPADData, g_P, p_D, y0, iterations: int,
                  flat: bool = True) -> None:
    """Raise on anything a paired kernel does not take."""
    if flat and (not data.paired or data.n_struct is None):
        raise ValueError("flat kernel needs paired data with a detected "
                         "identity block (GPADData.n_struct)")
    if not data.paired:
        raise ValueError("the paired kernel needs paired data")
    m_h, n_z = data.m_half, data.n_z
    if flat and m_h != data.n_struct + n_z:
        raise ValueError(f"flat layout needs m_half == n_struct + n_z; got "
                         f"{m_h} != {data.n_struct} + {n_z}")
    _check_common(data, g_P, p_D, (2, m_h), iterations,
                  [data.L, y0, data.soft_damp])


def _check_tensors(tensors, device) -> None:
    """Raise unless every tensor (None skipped) is contiguous float32 on
    ``device``."""
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"kernel takes float32 tensors; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")


def _ptr(t):
    """A tensor's device address for a C launcher (None for no tensor)."""
    return None if t is None else t.data_ptr()


def _empty(like):
    """The placeholder of an output a launch leaves out (w and zhat without
    diagnostics): a registered op returns tensors, never None."""
    return like.new_empty((0,))


def _none_if_empty(w, zhat, diagnostics: bool):
    """An op's (w, zhat) as the wrappers return them: None without
    diagnostics."""
    return (w, zhat) if diagnostics else (None, None)


def _fresh(outs, ins):
    """A CPU implementation's outputs as a registered op must return them:
    none an alias of an input or of another output (the plain loops hand
    back an input where a budget runs no iteration), each contiguous."""
    seen = {t.untyped_storage().data_ptr() for t in ins
            if t is not None and t.numel()}
    res = []
    for t in outs:
        if t.numel() and (t.untyped_storage().data_ptr() in seen
                          or not t.is_contiguous()):
            t = t.clone(memory_format=torch.contiguous_format)
        if t.numel():
            seen.add(t.untyped_storage().data_ptr())
        res.append(t)
    return tuple(res)


def _tier_code(tier: str) -> int:
    """The C launchers' ``tier`` (gpad_mma::Tier), -1 for a tier no kernel
    takes (the launcher then refuses it and the op raises)."""
    return KERNEL_TIERS.index(tier) if tier in KERNEL_TIERS else -1


def _launch(name: str, fn, device, *args) -> None:
    """Call a C launcher on ``device``'s current stream; raise on a CUDA
    error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def on_card(t) -> bool:
    """True for a CUDA tensor (the op launches its kernel), False for a CPU
    one (the op runs its plain version); raise for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type == "cuda"


def _too_big(what: str, shape: str):
    return ValueError(
        f"problem ({shape}) exceeds the {what} kernel's shared memory "
        f"({SMEM_LIMIT_BYTES} bytes); use engine='torch'"
    )


# Each kernel is the CUDA implementation of an op registered in the
# tpu_gpad_torch namespace (torch.library.custom_op): its CPU
# implementation is the plain version, its fake one allocates the outputs,
# so that torch.export traces a solve through the op and a loaded artifact
# launches the kernel. A launch plan is the wrapper's, passed as integers
# and read on the card only (CPU calls pass zeros). The counters count the
# CUDA implementation's launches: live calls and loaded artifacts alike,
# tracing none.
def _paired_fake(MG_T, GL_T, g_P, p_D, y0, od, theta, beta, L, n_s,
                 iterations, log2_tile, vec, split1, split2, diagnostics,
                 tier="highest"):
    z, y = g_P.new_empty(g_P.shape), p_D.new_empty(p_D.shape)
    if not diagnostics:
        return z, y, _empty(z), _empty(z)
    return z, y, p_D.new_empty(p_D.shape), g_P.new_empty(g_P.shape)


def _paired_cpu(flat: bool):
    """The CPU implementation (the plain version) of a paired kernel's op,
    typed: its signature is the op's schema."""
    def impl(MG_T: Tensor, GL_T: Tensor, g_P: Tensor, p_D: Tensor,
             y0: Optional[Tensor], od: Optional[Tensor], theta: Tensor,
             beta: Tensor, L: Tensor, n_s: int, iterations: int,
             log2_tile: int, vec: int, split1: int, split2: int,
             diagnostics: bool, tier: str = "highest",
             ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        z, y, w, zhat = _paired_loop(MG_T, GL_T, theta, beta, L, od, g_P, p_D,
                                     y0, iterations, diagnostics, n_s, flat,
                                     tier)
        if not diagnostics:
            w, zhat = _empty(z), _empty(z)
        return _fresh((z, y, w, zhat), (g_P, p_D, y0))
    return impl


def _paired_cuda(flat: bool):
    def impl(MG_T, GL_T, g_P, p_D, y0, od, theta, beta, L, n_s, iterations,
             log2_tile, vec, split1, split2, diagnostics, tier="highest"):
        global PAIRED_FLAT_LAUNCHES, PAIRED_LAUNCHES
        B, m_h, n_z = g_P.shape[0], p_D.shape[2], g_P.shape[1]
        plan = PairedPlan(log2_tile, vec, split1, split2)
        z, y = g_P.new_empty(g_P.shape), p_D.new_empty(p_D.shape)
        w = p_D.new_empty(p_D.shape) if diagnostics else None
        zhat = g_P.new_empty(g_P.shape) if diagnostics else None
        # y_prev of the dual elements past the registers (large m_h only)
        y_prev = (p_D.new_empty(p_D.shape)
                  if _paired_overflows(m_h, log2_tile, tier) else None)
        y0_stride = 0 if y0 is None or y0.shape[0] == 1 else 2 * m_h
        name = "gpad_paired_flat" if flat else "gpad_paired"
        fn = _launch_fn("gpad_paired_flat", f"{name}_launch", _PAIRED_ARGTYPES)
        _launch(name, fn, g_P.device, _ptr(MG_T), _ptr(GL_T), _ptr(g_P),
                _ptr(p_D), _ptr(y0), y0_stride, _ptr(od), _ptr(theta),
                _ptr(beta), _ptr(L), B, m_h, n_z, n_s, iterations, *plan,
                _ptr(z), _ptr(y), _ptr(w), _ptr(zhat), _ptr(y_prev),
                _paired_smem_bytes(m_h, n_z, n_s, plan), _tier_code(tier))
        if flat:
            PAIRED_FLAT_LAUNCHES += 1
        else:
            PAIRED_LAUNCHES += 1
        if not diagnostics:
            w, zhat = _empty(z), _empty(z)
        return z, y, w, zhat
    return impl


def _register(name: str, cpu, cuda, fake):
    """Register ``tpu_gpad_torch::<name>``: ``cpu`` (a typed function, the
    plain version) defines its schema, ``cuda`` launches the kernel."""
    op = torch.library.custom_op(f"tpu_gpad_torch::{name}", cpu,
                                 mutates_args=(), device_types="cpu")
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)
    return op


paired_flat_op = _register("paired_flat", _paired_cpu(True),
                           _paired_cuda(True), _paired_fake)
paired_op = _register("paired", _paired_cpu(False), _paired_cuda(False),
                      _paired_fake)


def _flat_tiled_cpu(MG_T: Tensor, GL_T: Tensor, g_P: Tensor, p_D: Tensor,
                    y0: Optional[Tensor], od: Optional[Tensor], theta: Tensor,
                    beta: Tensor, L: Tensor, n_s: int, iterations: int,
                    log2_tile: int, cluster: int, grouped: bool,
                    diagnostics: bool, tier: str = "highest",
                    ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    # n_s = m_h: every dual row structural, the full paired loop
    z, y, w, zhat = _paired_loop(MG_T, GL_T, theta, beta, L, od, g_P, p_D,
                                 y0, iterations, diagnostics, n_s,
                                 n_s < p_D.shape[2], tier)
    if not diagnostics:
        w, zhat = _empty(z), _empty(z)
    return _fresh((z, y, w, zhat), (g_P, p_D, y0))


def _flat_tiled_cuda(MG_T, GL_T, g_P, p_D, y0, od, theta, beta, L, n_s,
                     iterations, log2_tile, cluster, grouped, diagnostics,
                     tier="highest"):
    global FLAT_TILED_LAUNCHES, PAIRED_TILED_LAUNCHES
    B, m_h, n_z = g_P.shape[0], p_D.shape[2], g_P.shape[1]
    z, y = g_P.new_empty(g_P.shape), p_D.new_empty(p_D.shape)
    # the state lives in device memory: w is the kernel's too
    w = p_D.new_empty(p_D.shape)
    zhat = g_P.new_empty(g_P.shape) if diagnostics else None
    y0_stride = 0 if y0 is None or y0.shape[0] == 1 else 2 * m_h
    fn = _launch_fn("gpad_flat_tiled", "gpad_flat_tiled_launch",
                    _FLAT_TILED_ARGTYPES)
    _launch("gpad_flat_tiled", fn, g_P.device, _ptr(MG_T), _ptr(GL_T),
            _ptr(g_P), _ptr(p_D), _ptr(y0), y0_stride, _ptr(od), _ptr(theta),
            _ptr(beta), _ptr(L), B, m_h, n_z, n_s, iterations, log2_tile,
            cluster, grouped, _ptr(z), _ptr(y), _ptr(w), _ptr(zhat),
            _flat_tiled_smem_bytes(m_h, n_z, log2_tile, grouped),
            _tier_code(tier))
    if n_s == m_h:
        PAIRED_TILED_LAUNCHES += 1
    else:
        FLAT_TILED_LAUNCHES += 1
    if not diagnostics:
        return z, y, _empty(z), _empty(z)
    return z, y, w, zhat


def _flat_tiled_fake(MG_T, GL_T, g_P, p_D, y0, od, theta, beta, L, n_s,
                     iterations, log2_tile, cluster, grouped, diagnostics,
                     tier="highest"):
    return _paired_fake(MG_T, GL_T, g_P, p_D, y0, od, theta, beta, L, n_s,
                        iterations, log2_tile, 0, 0, 0, diagnostics)


flat_tiled_op = _register("flat_tiled", _flat_tiled_cpu, _flat_tiled_cuda,
                          _flat_tiled_fake)


def _dense_cpu(MG_T: Tensor, GL_T: Tensor, g_P: Tensor, p_D: Tensor,
               y0: Optional[Tensor], theta: Tensor, beta: Tensor,
               iterations: int, log2_tile: int, vec: int, split1: int,
               split2: int, diagnostics: bool, tier: str = "highest",
               ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    z, y, w, zhat = _dense_loop(MG_T, GL_T, theta, beta, g_P, p_D, y0,
                                iterations, diagnostics, tier)
    if not diagnostics:
        w, zhat = _empty(z), _empty(z)
    return _fresh((z, y, w, zhat), (g_P, p_D, y0))


def _dense_cuda(MG_T, GL_T, g_P, p_D, y0, theta, beta, iterations,
                log2_tile, vec, split1, split2, diagnostics, tier="highest"):
    global DENSE_LAUNCHES
    B, m, n_z = g_P.shape[0], p_D.shape[1], g_P.shape[1]
    plan = DensePlan(log2_tile, vec, split1, split2)
    z, y = g_P.new_empty(g_P.shape), p_D.new_empty(p_D.shape)
    w = p_D.new_empty(p_D.shape) if diagnostics else None
    zhat = g_P.new_empty(g_P.shape) if diagnostics else None
    y0_stride = 0 if y0 is None or y0.shape[0] == 1 else m
    fn = _launch_fn("gpad_dense", "gpad_dense_launch", _DENSE_ARGTYPES)
    _launch("gpad_dense", fn, g_P.device, _ptr(MG_T), _ptr(GL_T), _ptr(g_P),
            _ptr(p_D), _ptr(y0), y0_stride, _ptr(theta), _ptr(beta), B, m,
            n_z, iterations, *plan, _ptr(z), _ptr(y), _ptr(w), _ptr(zhat),
            _dense_smem_bytes(m, n_z, plan), _tier_code(tier))
    DENSE_LAUNCHES += 1
    if not diagnostics:
        w, zhat = _empty(z), _empty(z)
    return z, y, w, zhat


def _dense_fake(MG_T, GL_T, g_P, p_D, y0, theta, beta, iterations,
                log2_tile, vec, split1, split2, diagnostics, tier="highest"):
    return _paired_fake(MG_T, GL_T, g_P, p_D, y0, None, theta, beta, None, 0,
                        iterations, log2_tile, vec, split1, split2,
                        diagnostics)


dense_op = _register("dense", _dense_cpu, _dense_cuda, _dense_fake)


def _dense_tiled_cpu(MG_T: Tensor, GL_T: Tensor, g_P: Tensor, p_D: Tensor,
                     y0: Optional[Tensor], theta: Tensor, beta: Tensor,
                     iterations: int, tile: int, parts_a: int, parts_b: int,
                     diagnostics: bool, tier: str = "highest",
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    return _dense_cpu(MG_T, GL_T, g_P, p_D, y0, theta, beta, iterations, 0,
                      0, 0, 0, diagnostics, tier)


def _dense_tiled_cuda(MG_T, GL_T, g_P, p_D, y0, theta, beta, iterations,
                      tile, parts_a, parts_b, diagnostics, tier="highest"):
    global DENSE_TILED_LAUNCHES
    B, m, n_z = g_P.shape[0], p_D.shape[1], g_P.shape[1]
    # the operands and the state, in tiles, live in the scratch: the kernel
    # writes the outputs on its last iteration
    scratch = g_P.new_empty(_dense_tiled_scratch_floats(m, n_z, B, tile,
                                                        parts_a, parts_b))
    z, y = g_P.new_empty(g_P.shape), p_D.new_empty(p_D.shape)
    w = p_D.new_empty(p_D.shape) if diagnostics else None
    zhat = g_P.new_empty(g_P.shape) if diagnostics else None
    y0_stride = 0 if y0 is None or y0.shape[0] == 1 else m
    fn = _launch_fn("gpad_dense_tiled", "gpad_dense_tiled_launch",
                    _DENSE_TILED_ARGTYPES)
    _launch("gpad_dense_tiled", fn, g_P.device, _ptr(MG_T), _ptr(GL_T),
            _ptr(g_P), _ptr(p_D), _ptr(y0), y0_stride, _ptr(theta),
            _ptr(beta), B, m, n_z, iterations, tile, parts_a, parts_b,
            _ptr(scratch), _ptr(z), _ptr(y), _ptr(w), _ptr(zhat),
            _dense_tiled_smem_bytes(tile), _tier_code(tier))
    DENSE_TILED_LAUNCHES += 1
    if not diagnostics:
        w, zhat = _empty(z), _empty(z)
    return z, y, w, zhat


def _dense_tiled_fake(MG_T, GL_T, g_P, p_D, y0, theta, beta, iterations,
                      tile, parts_a, parts_b, diagnostics, tier="highest"):
    return _paired_fake(MG_T, GL_T, g_P, p_D, y0, None, theta, beta, None, 0,
                        iterations, tile, 0, 0, 0, diagnostics)


def dense_tiled_blocks_per_sm(tile: int, tier: str = "highest") -> int:
    """Blocks of the tiled dense kernel's (tile, tier) instance an SM of the
    current card holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the
    launch takes one an SM. Builds the kernel at first use."""
    from tpu_gpad_torch import cuda_build

    fn = cuda_build.load("gpad_dense_tiled").gpad_dense_tiled_blocks_per_sm
    fn.argtypes, fn.restype = [_INT, _INT, _INT], _INT
    return fn(tile, _tier_code(tier), _dense_tiled_smem_bytes(tile))


def flat_tiled_max_clusters(plan: FlatTiledPlan, m_h: int, n_z: int,
                            tier: str = "highest") -> int:
    """Clusters of the flat tiled kernel's ``plan`` at m_h rows a side the
    current card holds at once (cudaOccupancyMaxActiveClusters)."""
    from tpu_gpad_torch import cuda_build

    fn = cuda_build.load("gpad_flat_tiled").gpad_flat_tiled_max_clusters
    fn.argtypes, fn.restype = [_INT] * 4, _INT
    return fn(plan.log2_tile, plan.cluster,
              _flat_tiled_smem_bytes(m_h, n_z, plan.log2_tile, plan.grouped),
              _tier_code(tier))


dense_tiled_op = _register("dense_tiled", _dense_tiled_cpu, _dense_tiled_cuda,
                           _dense_tiled_fake)


def _paired(data: GPADData, g_P, p_D, y0, iterations: int, diagnostics: bool,
            flat: bool, log2_tile, split, tier: str):
    """A paired kernel instance's op at ``tier``: the kernel on CUDA
    tensors, the plain version on CPU ones."""
    B, m_h, n_z = g_P.shape[0], data.m_half, data.n_z
    n_s = data.n_struct if flat else m_h
    plan = PairedPlan(0, 0, 0, 0)
    if on_card(g_P):
        if log2_tile is not None and not 0 <= log2_tile <= PAIRED_MAX_LOG2_TILE:
            raise ValueError(f"log2_tile {log2_tile} outside "
                             f"0..{PAIRED_MAX_LOG2_TILE}")
        plan = _paired_plan(m_h, n_z, n_s, B, log2_tile, split, tier)
        if plan is None:
            raise _too_big("flat" if flat else "paired",
                           f"m_half={m_h}, n_z={n_z}, n_struct={n_s}")
    y0_rows = None if y0 is None else _norm_y0(y0, B, m_h)
    z, y, w, zhat = (paired_flat_op if flat else paired_op)(
        data.MG_T, data.GL_T, g_P, p_D, y0_rows, _od(data), data.theta,
        data.beta, data.L, n_s, iterations, *plan, diagnostics, tier)
    return (z, y, *_none_if_empty(w, zhat, diagnostics))


def gpad_fixed_paired_flat(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True, log2_tile: int | None = None,
    split: int | None = None, tier: str = "highest",
):
    """Fixed-budget flat paired GPAD for a batch: returns (z, y, w, zhat).

    ``g_P`` (B, n_z), ``p_D`` (B, 2, m_h), optional warm start ``y0``
    broadcasting to (B, 2, m_h). ``z``/``zhat`` are (B, n_z), ``y``/``w``
    (B, 2, m_h); ``w`` and ``zhat`` are the last iteration's, and both are
    None when ``diagnostics`` is False. ``log2_tile`` and ``split``
    override the scenarios per block and cap the split-K parts (for
    sweeps). ``tier`` (``KERNEL_TIERS``) is the products' precision. CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain version
    (the op ``tpu_gpad_torch::paired_flat``)."""
    _check_inputs(data, g_P, p_D, y0, iterations)
    return _paired(data, g_P, p_D, y0, iterations, diagnostics, True,
                   log2_tile, split, tier)


def gpad_fixed_paired(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True, log2_tile: int | None = None,
    split: int | None = None, tier: str = "highest",
):
    """Fixed-budget paired mvp GPAD with the full ``GL_T`` product (no
    identity block), soft rows carried: the contract of
    ``gpad_fixed_paired_flat`` on any paired data. CUDA tensors launch the
    kernel (or raise); CPU tensors run the plain version (the op
    ``tpu_gpad_torch::paired``)."""
    _check_inputs(data, g_P, p_D, y0, iterations, flat=False)
    return _paired(data, g_P, p_D, y0, iterations, diagnostics, False,
                   log2_tile, split, tier)


def gpad_fixed_flat_tiled(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True, log2_tile: int | None = None,
    cluster: int | None = None, tier: str = "highest",
):
    """``gpad_fixed_paired_flat``'s contract for flat stacks too large for
    it: both operands are read from device memory on every iteration (the
    counterpart of ``tpu_gpad.solver.kernels.gpad_pallas_fixed_flat_tiled``,
    and of ``gpad_pallas_fixed_paired_flat`` on soft data past one block's
    shared memory). Fixed mode, no restart; soft rows carried, an empty
    structural block refused. ``log2_tile`` and ``cluster`` override the
    scenarios per cluster and the blocks per cluster (for sweeps). ``tier``
    (``KERNEL_TIERS``) is the products' precision; it does not change the
    launch plan. CUDA tensors launch the kernel (or raise); CPU tensors run
    the plain version, ``gpad_fixed_paired_flat_torch`` (the op
    ``tpu_gpad_torch::flat_tiled``)."""
    if data.n_struct == 0:
        raise ValueError("the flat tiled kernel needs a non-empty structural "
                         "block (GPADData.n_struct > 0)")
    _check_inputs(data, g_P, p_D, y0, iterations)
    return _flat_tiled(data, g_P, p_D, y0, iterations, diagnostics,
                       data.n_struct, log2_tile, cluster, tier)


def gpad_fixed_paired_tiled(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True, log2_tile: int | None = None,
    cluster: int | None = None, tier: str = "highest",
):
    """``gpad_fixed_paired``'s contract for paired stacks too large for it:
    the flat tiled kernel with every dual row structural (n_s = m_h), so
    the full ``GL_T`` product on every row (the counterpart of
    ``tpu_gpad.solver.kernels.gpad_pallas_fixed_paired`` past one block's
    shared memory). Fixed mode; soft rows carried, as tpu_gpad's resident
    paired kernel carries them. ``log2_tile``, ``cluster`` and ``tier`` as
    in ``gpad_fixed_flat_tiled``. CUDA tensors launch the kernel (or raise;
    counted in ``PAIRED_TILED_LAUNCHES``); CPU tensors run the plain
    version, ``gpad_fixed_paired_torch`` (the op ``tpu_gpad_torch::
    flat_tiled`` at n_s = m_h)."""
    _check_inputs(data, g_P, p_D, y0, iterations, flat=False)
    return _flat_tiled(data, g_P, p_D, y0, iterations, diagnostics,
                       data.m_half, log2_tile, cluster, tier)


def _tiled_plan(g_P, rows: int, n_z: int, log2_tile, cluster,
                what: str) -> FlatTiledPlan:
    """The flat tiled plan of B scenarios over ``rows`` dual rows a side on
    the card (zeros on the CPU, where the op runs its plain version)."""
    if not on_card(g_P):
        return FlatTiledPlan(0, 0, False)
    top = FLAT_TILED_MAX_LOG2_TILE
    if log2_tile is not None and not 0 <= log2_tile <= top:
        raise ValueError(f"log2_tile {log2_tile} outside 0..{top}")
    if cluster is not None and (cluster not in (1, 2, 4, 8, 16)):
        raise ValueError(f"cluster {cluster} is not a power of two up to 16")
    plan = pick_flat_tiled(rows, n_z, g_P.shape[0], log2_tile, cluster)
    if plan is None:
        raise _too_big(what, f"rows={rows}, n_z={n_z}")
    return plan


def _flat_tiled(data: GPADData, g_P, p_D, y0, iterations: int,
                diagnostics: bool, n_s: int, log2_tile, cluster, tier: str):
    """The flat tiled kernel's op at ``n_s`` structural rows (m_h: the full
    paired loop)."""
    B, m_h = g_P.shape[0], data.m_half
    plan = _tiled_plan(g_P, m_h, data.n_z, log2_tile, cluster,
                       "flat tiled" if n_s < m_h else "paired tiled")
    y0_rows = None if y0 is None else _norm_y0(y0, B, m_h)
    z, y, w, zhat = flat_tiled_op(
        data.MG_T, data.GL_T, g_P, p_D, y0_rows, _od(data), data.theta,
        data.beta, data.L, n_s, iterations, *plan, diagnostics, tier)
    return (z, y, *_none_if_empty(w, zhat, diagnostics))


def _check_dense(data: GPADData, what: str) -> None:
    """Raise unless the data is unpaired and without soft rows."""
    if data.paired:
        raise ValueError(f"{what} needs unpaired data")
    if data.soft_damp is not None:
        raise ValueError(
            f"{what} does not carry soft (dual-damped) rows; soft data is "
            "paired: use the paired kernels or engine='torch'"
        )


def gpad_fixed_dense(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True, log2_tile: int | None = None,
    split: int | None = None, tier: str = "highest",
):
    """Fixed-budget dense (unpaired) GPAD for a batch: returns
    (z, y, w, zhat).

    ``g_P`` (B, n_z), ``p_D`` (B, m), optional warm start ``y0``
    broadcasting to (B, m) (leading batch dims flattened). ``z``/``zhat``
    are (B, n_z), ``y``/``w`` (B, m); ``w`` and ``zhat`` are the last
    iteration's, and both are None when ``diagnostics`` is False. Soft rows
    are refused, as by ``tpu_gpad``'s dense kernel. ``log2_tile`` and
    ``split`` override the scenarios per block and cap the split-K parts
    (for sweeps). ``tier`` (``KERNEL_TIERS``) is the products' precision.
    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version (the op ``tpu_gpad_torch::dense``)."""
    _check_dense(data, "the dense kernel")
    m, n_z = data.m, data.n_z
    _check_common(data, g_P, p_D, (m,), iterations, [y0])
    B = g_P.shape[0]
    plan = DensePlan(0, 0, 0, 0)
    if on_card(g_P):
        if log2_tile is not None and not 0 <= log2_tile <= 5:
            raise ValueError(f"log2_tile {log2_tile} outside 0..5")
        plan = _dense_plan(m, n_z, B, log2_tile, split, tier)
        if plan is None:
            raise _too_big("dense", f"m={m}, n_z={n_z}")
    y0_rows = None if y0 is None else _norm_dense_y0(y0, B, m)
    z, y, w, zhat = dense_op(data.MG_T, data.GL_T, g_P, p_D, y0_rows,
                             data.theta, data.beta, iterations, *plan,
                             diagnostics, tier)
    return (z, y, *_none_if_empty(w, zhat, diagnostics))


def gpad_fixed_dense_tiled(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True, tile: int | None = None,
    parts_a: int | None = None, parts_b: int | None = None,
    tier: str = "highest",
):
    """``gpad_fixed_dense``'s contract for dense stacks too large for it:
    both operands staged from device memory on every iteration by a
    persistent launch of two card-wide product phases (the counterpart of
    ``tpu_gpad.solver.kernels.gpad_pallas_fixed`` past one block's shared
    memory). Soft rows are refused. ``tile`` (scenarios a unit: 16, 32,
    64 or 128), ``parts_a`` and ``parts_b`` (each phase's parts of K)
    override ``pick_dense_tiled``'s plan (for sweeps). ``tier``
    (``KERNEL_TIERS``) is the products' precision; it does not change the
    plan. CUDA tensors launch the kernel (or raise); CPU tensors run the
    plain version, ``gpad_fixed_dense_torch`` (the op
    ``tpu_gpad_torch::dense_tiled``)."""
    _check_dense(data, "the tiled dense kernel")
    m, n_z = data.m, data.n_z
    _check_common(data, g_P, p_D, (m,), iterations, [y0])
    B = g_P.shape[0]
    knobs = (0, 0, 0)
    if on_card(g_P):
        if tile is not None and tile not in DENSE_TILED_TILES:
            raise ValueError(f"tile {tile} is not one of {DENSE_TILED_TILES}")
        for name, parts, k in (("parts_a", parts_a, m), ("parts_b", parts_b,
                                                         n_z)):
            most = -(-k // DENSE_TILED_DEPTH)
            if parts is not None and not 1 <= parts <= most:
                raise ValueError(f"{name} {parts} outside 1..{most}")
        sms = torch.cuda.get_device_properties(g_P.device).multi_processor_count
        knobs = pick_dense_tiled(m, n_z, B, tier, tile, parts_a, parts_b,
                                 sms)[:3]
    y0_rows = None if y0 is None else _norm_dense_y0(y0, B, m)
    z, y, w, zhat = dense_tiled_op(data.MG_T, data.GL_T, g_P, p_D, y0_rows,
                                   data.theta, data.beta, iterations, *knobs,
                                   diagnostics, tier)
    return (z, y, *_none_if_empty(w, zhat, diagnostics))


def solve_batch_cuda(data: GPADData, g_P, p_D, config, y0=None) -> SolveResult:
    """CUDA-engine entry called from ``solver.core.solve_batch``: the
    counterpart of ``tpu_gpad.solver.kernels.solve_batch_pallas``, with the
    kernel that ``core.cuda_kernel`` picks.

    Residuals and gap are recovered outside the kernels with plain fp32
    products, as the JAX package does outside Pallas (at the tier there).
    Every kernel runs its products at the config's tier (``core.tier``)."""
    from tpu_gpad_torch.solver import core, dual_kernels

    batch_shape = g_P.shape[:-1]
    kernel = core.cuda_kernel(data, config, batch=math.prod(batch_shape))
    tier = core.tier(config)
    gP2 = g_P.reshape(-1, data.n_z).contiguous()
    dual_shape = (2, data.m_half) if data.paired else (data.m,)
    pD2 = p_D.reshape((-1,) + dual_shape).contiguous()
    # a warm start keeps its own rows (1 or B); each wrapper flattens its
    # leading batch dims, as tpu_gpad's solve_batch_pallas does
    y0 = None if y0 is None else y0.contiguous()
    kw = dict(iterations=config.iterations, diagnostics=config.diagnostics)
    if kernel in ("dual_chunk", "dual_tiled_chunk"):
        res = dual_kernels.gpad_eps_dual(data, gP2, pD2, config, y0)
    else:
        if kernel == "dual":
            z, y, w, zhat = dual_kernels.gpad_fixed_dual(
                data, gP2, pD2, y0, restart=config.restart, tier=tier, **kw)
        elif kernel == "dual_tiled":
            z, y, w, zhat = dual_kernels.gpad_fixed_dual_tiled(
                data, gP2, pD2, y0, restart=config.restart, tier=tier, **kw)
        elif kernel == "paired_flat":
            z, y, w, zhat = gpad_fixed_paired_flat(data, gP2, pD2, y0,
                                                   tier=tier, **kw)
        elif kernel == "flat_tiled":
            z, y, w, zhat = gpad_fixed_flat_tiled(data, gP2, pD2, y0,
                                                  tier=tier, **kw)
        elif kernel == "paired":
            z, y, w, zhat = gpad_fixed_paired(data, gP2, pD2, y0, tier=tier,
                                              **kw)
        elif kernel == "paired_tiled":
            z, y, w, zhat = gpad_fixed_paired_tiled(data, gP2, pD2, y0,
                                                    tier=tier, **kw)
        elif kernel == "dense":
            z, y, w, zhat = gpad_fixed_dense(data, gP2, pD2, y0, tier=tier,
                                             **kw)
        elif kernel == "dense_tiled":
            z, y, w, zhat = gpad_fixed_dense_tiled(data, gP2, pD2, y0,
                                                   tier=tier, **kw)
        else:
            raise ValueError("no CUDA kernel serves this solve")
        res = core._finish(data, gP2, pD2, z, zhat, w, y, config, False,
                           core._Matmul(core._fp32(config), data))
    return SolveResult(
        **{
            name: t.reshape(tuple(batch_shape) + tuple(t.shape[1:]))
            for name, t in vars(res).items()
        }
    )
