"""The dual-form GPAD kernels (CUDA C++ for Hopper), their plain versions,
and the eps-mode host loop.

``gpad_fixed_dual`` runs a whole fixed-budget dual-form solve in one
launch, the counterpart of ``tpu_gpad.solver.kernels.gpad_pallas_fixed_dual``;
``gpad_dual_chunk`` runs ``chunk`` iterations from schedule offset ``k0``
with the state in and out (``_dual_chunk_call``), and ``gpad_eps_dual``
drives it one check window at a time (``gpad_pallas_eps_dual``). Both
kernels are in ``csrc/gpad_dual.cu`` and share one iteration body; they
keep D and the state in one block's shared memory (``dual_fits_smem``).
For larger duals (the reference's 30x30 flagship, D 13.4 MB),
``gpad_fixed_dual_tiled`` and ``gpad_dual_tiled_chunk`` have the same
contracts, soft rows included, and read D from device memory on every
iteration (``csrc/gpad_dual_tiled.cu``, the counterpart of
``_gpad_kernel_dual_tiled``, and of the resident Pallas kernels on soft
data; ``dual_tiled_fits``); the eps loop takes them where
``dual_fits_smem`` declines. On CUDA tensors the wrappers launch the
kernel or raise; on CPU tensors they run the plain versions
``gpad_fixed_dual_torch`` and ``gpad_dual_chunk_torch``, which are also
what the tests and ``chip_smoke.py`` hold the kernels against.

The state keeps the public layouts: y and y_prev (B, 2, m_h), s (B, m_h),
and ``mom`` (B, 2), each scenario's restart recursion (theta, theta_prev).

Every kernel here takes the precision tier (``kernels.KERNEL_TIERS``):
the product ``wd D`` runs fp32 FFMA at "highest" and on the tensor cores
under a tier (``csrc/mma_product.cuh``, the tiled kernels' strips in
``csrc/tiled_product.cuh``); the relu offsets and the primal recovery
around a launch stay fp32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from tpu_gpad_torch.solver import kernels
from tpu_gpad_torch.tracing import span
from tpu_gpad_torch.types import GPADData, SolveResult

# Launches of each CUDA kernel in this process; a run resets them to 0 to
# show that a path went through the kernels.
DUAL_LAUNCHES = 0
DUAL_CHUNK_LAUNCHES = 0
DUAL_TILED_LAUNCHES = 0
DUAL_TILED_CHUNK_LAUNCHES = 0
# The eps loop's host syncs: one per all-converged test, after every
# window but the budget's last (its windows are DUAL_CHUNK_LAUNCHES, or
# DUAL_TILED_CHUNK_LAUNCHES past dual_fits_smem).
EPS_SYNCS = 0

# kWarps of csrc/gpad_dual.cu: one restart partial per warp
_WARPS = kernels.BLOCK_THREADS // 32
# csrc/gpad_dual_tiled.cu: 512 threads per block, clusters of up to 16
_TILED_THREADS = 512
_TILED_WARPS = _TILED_THREADS // 32
_MAX_CLUSTER = 16
_TILED_COLS = 2  # kCols: product columns per thread
# The tiled dual kernels' grid (PERF.md, the tiled tile and cluster sweep,
# H100 80GB HBM3 at 700 W, flagship x 100 iterations): a cluster owns the
# widest tile, up to 16 scenarios, that the batch fills, since a D word
# read from L2 then feeds the most FMAs (B64: 16 per cluster 4.4-4.7 ms, 8
# per cluster 6.5-6.9, 4 per cluster 8.9); clusters of 16 blocks (the
# non-portable size) while the grid has at most 16 clusters, of 8 beyond
# (B256: 12.96-14.2 ms on 16, 15.7-17.2 on 8; B1024: 43.1-47.0 on 16,
# 39.9-43.4 on 8; B1: 2.65-3.06 on 16, 4.7-5.6 on 8).
DUAL_TILED_MAX_LOG2_TILE = 4
DUAL_TILED_WIDE_CLUSTER = 16
DUAL_TILED_CLUSTER = 8
DUAL_TILED_MAX_WIDE_CLUSTERS = 16


class DualPlan(NamedTuple):
    """A launch of the resident dual kernels: 2**log2_tile scenarios per
    block and the split-K parts of the product wd D."""
    log2_tile: int
    split: int


# The resident dual kernels' grid: up to 16 scenarios per block, fewer
# while the grid would have fewer than 128 blocks, with the split-K parts
# of ``kernels.block_parts``. On an H100 80GB HBM3 at 700 W (PERF.md, §6,
# ``chip_smoke.py --sweep resident``, device ms at battery n3 N10, 100
# restart iterations): B256 1 / 2 / 8 / 16 per block 0.159 / 0.142 / 0.24
# / 0.27; B4096 8 / 16 per block 0.72 / 0.39 (32 does not fit a thread's
# registers); a 10-iteration window 0.018 ms at B256 (2 per block), 0.054
# at B4096 (16).
DUAL_MAX_LOG2_TILE = 4
DUAL_MIN_BLOCKS = 128


# Elements of the [row][scenario] state a thread keeps in registers
# (kMaxE of csrc/gpad_dual.cu): a tile needs m_h 2**log2_tile <= 6 x 256.
_MAX_ELEMENTS = 6


def _dual_smem_bytes(m_h: int, plan: DualPlan) -> int:
    """Shared memory of one block of either resident dual kernel (csrc
    carve-up), rows padded to 4 (mp): D, wd and the product's parts of
    2**log2_tile scenarios each, and one restart partial per warp and
    scenario; the rest of the state is in registers."""
    T = 1 << plan.log2_tile
    mp = kernels._up4(m_h)
    return 4 * (m_h * mp + (1 + plan.split) * mp * T + _WARPS * T)


def _dual_plan(m_h: int, B: int, log2_tile: int | None = None,
               split: int | None = None,
               tier: str = "highest") -> DualPlan | None:
    """The resident dual kernels' launch for B scenarios at ``tier``: the
    tile of ``kernels.grid_tile`` (or ``log2_tile``), narrowed until a
    thread's share of the state fits its registers, then it or its parts
    (at most ``split``, counted by ``kernels.block_parts`` at the tier)
    halved until the block fits shared memory; None when not even one
    scenario does. The tile, and whether a plan exists, are the same under
    every tier."""
    top = (kernels.grid_tile(B, DUAL_MAX_LOG2_TILE, DUAL_MIN_BLOCKS)
           if log2_tile is None else log2_tile)
    for log2 in range(top, -1 if log2_tile is None else top - 1, -1):
        if m_h << log2 > _MAX_ELEMENTS * kernels.BLOCK_THREADS:
            continue
        parts = kernels.block_parts(m_h, log2, m_h, split, tier)
        while True:
            plan = DualPlan(log2, parts)
            if _dual_smem_bytes(m_h, plan) <= kernels.SMEM_LIMIT_BYTES:
                return plan
            if parts == 1:
                break
            parts //= 2
    return None


def dual_fits_smem(data: GPADData) -> bool:
    """Can the dual kernels run this data: paired with D, with D and one
    scenario's state within one block's shared memory? Both kernels share
    one carve-up, so one guard serves the fixed and the eps path."""
    if not (data.paired and data.D is not None):
        return False
    return _dual_plan(data.m_half, 1) is not None


def _dual_tiled_smem_bytes(m_h: int, log2_tile: int) -> int:
    """Shared memory of one block of either tiled dual kernel (csrc
    carve-up): the whole wd of 2**log2_tile scenarios (rows padded to 4),
    the row groups' partial sums (2 columns per thread), the cluster's
    restart partials (up to 16 blocks) and one partial per warp; D and the
    state stay in device memory. The cluster size does not change it."""
    T = 1 << log2_tile
    return 4 * (T * (-(-m_h // 4) * 4 + _TILED_COLS * _TILED_THREADS
                     + _MAX_CLUSTER) + _TILED_WARPS)


def pick_tiled_tiles(m_half: int, B: int = 1) -> int | None:
    """log2 of the tiled dual kernels' scenarios per cluster for B
    scenarios: the widest, at most 16 and at most B rounded up to a power
    of two, whose block fits shared memory; None when not even one
    scenario's wd fits."""
    log2 = min(DUAL_TILED_MAX_LOG2_TILE, max(B - 1, 0).bit_length())
    while log2 >= 0:
        if _dual_tiled_smem_bytes(m_half, log2) <= kernels.SMEM_LIMIT_BYTES:
            return log2
        log2 -= 1
    return None


def pick_tiled_cluster(log2_tile: int, B: int) -> int:
    """Blocks per cluster of the tiled dual kernels for B scenarios at
    2**log2_tile per cluster: 16 while the grid has at most 16 clusters,
    else 8 (see DUAL_TILED_CLUSTER)."""
    clusters = -(-B // (1 << log2_tile))
    return (DUAL_TILED_WIDE_CLUSTER if clusters <= DUAL_TILED_MAX_WIDE_CLUSTERS
            else DUAL_TILED_CLUSTER)


def dual_tiled_fits(data: GPADData) -> bool:
    """Can the tiled dual kernels run this data: paired with D and one
    scenario's wd within a block's shared memory? Soft rows ride along
    (the damp column is read from device memory, so it costs no shared
    memory), as tpu_gpad's resident dual kernels carry them within their
    VMEM budget."""
    return (data.paired and data.D is not None
            and pick_tiled_tiles(data.m_half) is not None)


def relu_offsets(data: GPADData, g_P, p_D):
    """c = (p_D+ - e, p_D- + e) with e = g_P @ GL_T, hoisted out of the
    loop: (B, 2, m_h)."""
    e = g_P @ data.GL_T
    return (p_D - torch.stack([e, -e], dim=-2)).contiguous()


def _init_state(data: GPADData, B: int, y0, device):
    """Cold or warm y (y_prev starts equal to it), s = 0, mom = 1."""
    rows = None if y0 is None else kernels._norm_y0(y0, B, data.m_half)
    return _init_rows(B, data.m_half, rows, device)


def _init_rows(B: int, m_h: int, y0, device):
    """``_init_state`` of a warm start already in rows (1 or B), or None."""
    if y0 is None:
        y = torch.zeros((B, 2, m_h), dtype=torch.float32, device=device)
    else:
        y = y0.expand(B, 2, m_h).contiguous()
    s = torch.zeros((B, m_h), dtype=torch.float32, device=device)
    mom = torch.ones((B, 2), dtype=torch.float32, device=device)
    return y, s, mom


def _primal(data: GPADData, g_P, s, w, a, diagnostics: bool = True):
    """z = -(s @ MG_T) - a g_P and, with ``diagnostics``, the last zhat."""
    z = -(s @ data.MG_T) - a * g_P
    if not diagnostics:
        return z, None
    return z, -((w[:, 0] - w[:, 1]) @ data.MG_T) - g_P


def recovery_weight(data: GPADData, iterations: int):
    """a_K = 1 - prod_k (1 - theta_k): the weight of g_P in the recovered
    z. theta_0 = 1 makes it exactly 1 for K >= 1, under restart too; the
    eps loop relies on that."""
    return 1.0 - torch.prod(1.0 - data.theta[:iterations])


def gpad_dual_chunk_torch(data: GPADData, c, y, y_prev, s, mom, *, k0: int,
                          chunk: int, restart: bool = False,
                          tier: str = "highest"):
    """The kernels' iteration body in torch ops, on any device: the plain
    version of the chunk kernel (same contract as ``gpad_dual_chunk``),
    and, from k0 = 0, of the whole-solve kernel's loop."""
    return _dual_loop(data.D, kernels._od(data), data.theta, data.beta, c, y,
                      y_prev, s, mom, k0, chunk, restart, tier)


def _dual_loop(D, od, theta, beta, c, y, y_prev, s, mom, k0: int, chunk: int,
               restart: bool, tier: str = "highest"):
    """``gpad_dual_chunk_torch`` on the operands themselves, the product
    ``wd D`` at ``tier`` (``kernels._tier_mm``)."""
    from tpu_gpad_torch.solver import core

    Dp = kernels._tier_operand(D, tier)
    th, thp = mom[:, 0], mom[:, 1]
    w = torch.zeros_like(y)
    for i in range(chunk):
        if restart:
            theta_k = th[:, None]
            beta_k = (th * (1.0 / thp - 1.0))[:, None, None]
        else:
            theta_k, beta_k = theta[k0 + i], beta[k0 + i]
        w = y + beta_k * (y - y_prev)
        wd = w[:, 0] - w[:, 1]
        d = -kernels._tier_mm(wd, Dp, tier)
        w_s = w if od is None else w * od
        y_next = torch.clamp_min(w_s + torch.stack([d, -d], dim=1) + c, 0.0)
        s = s + theta_k * (wd - s)
        if restart:
            y_prev, th, thp = core._restart_update(th, thp, y, y_next, w)
        else:
            y_prev = y
        y = y_next
    return y, y_prev, s, torch.stack([th, thp], dim=1), w


def _check_data(data: GPADData) -> None:
    if not (data.paired and data.D is not None):
        raise ValueError("the dual kernels need paired data with D "
                         "(GPADData.D)")


def _check_schedule(data: GPADData, end: int, restart: bool) -> None:
    if end > data.max_iters and not restart:
        raise ValueError(f"iterations up to {end} exceed the schedule's "
                         f"{data.max_iters}")


def _launch_fns():
    """The kernels' C launchers, built and loaded at first use."""
    from tpu_gpad_torch import cuda_build

    lib = cuda_build.load("gpad_dual")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fixed, chunk = lib.gpad_dual_launch, lib.gpad_dual_chunk_launch
    fixed.argtypes = [P, P, P, P, LL, P, P, I, I, I, I, I, I, P, P, P, I, I,
                      P]
    chunk.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                      P, P, P, P, P, I, I, P]
    fixed.restype = chunk.restype = I
    return fixed, chunk


def _tiled_launch_fns():
    """The tiled kernels' C launchers, built and loaded at first use."""
    from tpu_gpad_torch import cuda_build

    lib = cuda_build.load("gpad_dual_tiled")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fixed, chunk = lib.gpad_dual_tiled_launch, lib.gpad_dual_tiled_chunk_launch
    fixed.argtypes = [P, P, P, P, LL, P, P, I, I, I, I, I, I, P, P, P, P, I,
                      I, P]
    chunk.argtypes = [P] * 9 + [I] * 7 + [P] * 5 + [I, I, P]
    fixed.restype = chunk.restype = I
    return fixed, chunk


def _plan_or_raise(m_h: int, B: int, log2_tile, split,
                   tier: str = "highest") -> DualPlan:
    if log2_tile is not None and not 0 <= log2_tile <= 5:
        raise ValueError(f"log2_tile {log2_tile} outside 0..5")
    plan = _dual_plan(m_h, B, log2_tile, split, tier)
    if plan is None and log2_tile is not None:
        raise ValueError(f"the resident dual kernels take no tile of "
                         f"2**{log2_tile} at m_half={m_h}")
    if plan is None:
        raise ValueError(
            f"dual problem (m_half={m_h}) exceeds the kernels' shared memory "
            f"({kernels.SMEM_LIMIT_BYTES} bytes); use engine='torch'"
        )
    return plan


def gpad_fixed_dual_torch(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    restart: bool = False, diagnostics: bool = True, tier: str = "highest",
):
    """The whole-solve kernel in torch ops, on any device: the plain version
    the kernel is checked against. Same contract as ``gpad_fixed_dual``."""
    y, s, mom = _init_state(data, g_P.shape[0], y0, g_P.device)
    y, _, s, _, w = gpad_dual_chunk_torch(
        data, relu_offsets(data, g_P, p_D), y, y, s, mom, k0=0,
        chunk=iterations, restart=restart, tier=tier,
    )
    z, zhat = _primal(data, g_P, s, w, recovery_weight(data, iterations),
                      diagnostics)
    return (z, y, w, zhat) if diagnostics else (z, y, None, None)


def _check_fixed(data: GPADData, g_P, p_D, y0, iterations: int,
                 restart: bool) -> None:
    """Raise on anything the whole-solve dual kernels do not take."""
    _check_data(data)
    _check_schedule(data, iterations, restart)
    B, m_h = g_P.shape[0], data.m_half
    if g_P.ndim != 2 or g_P.shape[1] != data.n_z:
        raise ValueError(f"g_P must be (B, {data.n_z}); got {tuple(g_P.shape)}")
    if tuple(p_D.shape) != (B, 2, m_h):
        raise ValueError(f"p_D must be ({B}, 2, {m_h}); got {tuple(p_D.shape)}")
    kernels._check_tensors([data.D, data.MG_T, data.GL_T, data.theta,
                           data.beta, g_P, p_D, y0, data.soft_damp], g_P.device)


def _check_chunk(data: GPADData, c, y, y_prev, s, mom, k0: int, chunk: int,
                 restart: bool) -> None:
    """Raise on anything the chunk kernels do not take (a tensor ``k0``
    gathers its window of the schedule: see ``_window_schedule``)."""
    _check_data(data)
    if not isinstance(k0, torch.Tensor):
        _check_schedule(data, k0 + chunk, restart)
    B, m_h = c.shape[0], data.m_half
    for name, t, shape in (("c", c, (B, 2, m_h)), ("y", y, (B, 2, m_h)),
                           ("y_prev", y_prev, (B, 2, m_h)),
                           ("s", s, (B, m_h)), ("mom", mom, (B, 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    kernels._check_tensors([data.D, data.theta, data.beta, c, y, y_prev, s,
                           mom, data.soft_damp], c.device)


# The kernels as ops of the tpu_gpad_torch namespace (see the note above
# kernels._register): the CPU implementations are the plain versions, the
# CUDA ones launch and count; the fake ones allocate the outputs.
def _dual_cpu(D: Tensor, od: Optional[Tensor], c: Tensor, y0: Optional[Tensor],
              theta: Tensor, beta: Tensor, iterations: int, restart: bool,
              log2_tile: int, split: int, diagnostics: bool,
              tier: str = "highest") -> tuple[Tensor, Tensor, Tensor]:
    y, s, mom = _init_rows(c.shape[0], c.shape[2], y0, c.device)
    y, _, s, _, w = _dual_loop(D, od, theta, beta, c, y, y, s, mom, 0,
                               iterations, restart, tier)
    return kernels._fresh((s, y, w if diagnostics else kernels._empty(s)),
                          (c, y0))


def _dual_cuda(D, od, c, y0, theta, beta, iterations, restart, log2_tile,
               split, diagnostics, tier="highest"):
    global DUAL_LAUNCHES
    fixed, _ = _launch_fns()
    B, m_h = c.shape[0], c.shape[2]
    plan = DualPlan(log2_tile, split)
    y0_stride = 0 if y0 is None or y0.shape[0] == 1 else 2 * m_h
    s, y = c.new_empty((B, m_h)), c.new_empty(c.shape)
    w = c.new_empty(c.shape) if diagnostics else None
    ptr = kernels._ptr
    kernels._launch("gpad_dual", fixed, c.device, ptr(D), ptr(od), ptr(c),
                    ptr(y0), y0_stride, ptr(theta), ptr(beta), B, m_h,
                    iterations, int(restart), *plan, ptr(s), ptr(y), ptr(w),
                    _dual_smem_bytes(m_h, plan), kernels._tier_code(tier))
    DUAL_LAUNCHES += 1
    return s, y, w if diagnostics else kernels._empty(s)


def _whole_fake(c, diagnostics):
    s, y = c.new_empty((c.shape[0], c.shape[2])), c.new_empty(c.shape)
    return s, y, c.new_empty(c.shape) if diagnostics else kernels._empty(s)


dual_op = kernels._register(
    "dual", _dual_cpu, _dual_cuda,
    lambda D, od, c, y0, theta, beta, iterations, restart, log2_tile, split,
    diagnostics, tier="highest": _whole_fake(c, diagnostics))


def _dual_tiled_cpu(D: Tensor, od: Optional[Tensor], c: Tensor,
                    y0: Optional[Tensor], theta: Tensor, beta: Tensor,
                    iterations: int, restart: bool, log2_tile: int,
                    cluster: int, diagnostics: bool, tier: str = "highest",
                    ) -> tuple[Tensor, Tensor, Tensor]:
    return _dual_cpu(D, od, c, y0, theta, beta, iterations, restart,
                     log2_tile, 0, diagnostics, tier)


def _dual_tiled_cuda(D, od, c, y0, theta, beta, iterations, restart,
                     log2_tile, cluster, diagnostics, tier="highest"):
    global DUAL_TILED_LAUNCHES
    fixed, _ = _tiled_launch_fns()
    B, m_h = c.shape[0], c.shape[2]
    y0_stride = 0 if y0 is None or y0.shape[0] == 1 else 2 * m_h
    # the state lives in device memory: y_prev and, without diagnostics,
    # w are the kernel's scratch
    s = c.new_empty((B, m_h))
    y, y_prev, w = (c.new_empty(c.shape) for _ in range(3))
    ptr = kernels._ptr
    kernels._launch("gpad_dual_tiled", fixed, c.device, ptr(D), ptr(od),
                    ptr(c), ptr(y0), y0_stride, ptr(theta), ptr(beta), B, m_h,
                    iterations, int(restart), log2_tile, cluster, ptr(s),
                    ptr(y), ptr(y_prev), ptr(w),
                    _dual_tiled_smem_bytes(m_h, log2_tile),
                    kernels._tier_code(tier))
    DUAL_TILED_LAUNCHES += 1
    return s, y, w if diagnostics else kernels._empty(s)


dual_tiled_op = kernels._register(
    "dual_tiled", _dual_tiled_cpu, _dual_tiled_cuda,
    lambda D, od, c, y0, theta, beta, iterations, restart, log2_tile,
    cluster, diagnostics, tier="highest": _whole_fake(c, diagnostics))


def _chunk_cpu(D: Tensor, od: Optional[Tensor], c: Tensor, y: Tensor,
               y_prev: Tensor, s: Tensor, mom: Tensor, theta: Tensor,
               beta: Tensor, k0: int, chunk: int, restart: bool,
               log2_tile: int, split: int, tier: str = "highest",
               ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    return kernels._fresh(
        _dual_loop(D, od, theta, beta, c, y, y_prev, s, mom, k0, chunk,
                   restart, tier), (c, y, y_prev, s, mom))


def _chunk_cuda(D, od, c, y, y_prev, s, mom, theta, beta, k0, chunk, restart,
                log2_tile, split, tier="highest"):
    global DUAL_CHUNK_LAUNCHES
    _, launch = _launch_fns()
    B, m_h = c.shape[0], c.shape[2]
    plan = DualPlan(log2_tile, split)
    out = [torch.empty_like(t) for t in (y, y_prev, s, mom, y)]
    ptr = kernels._ptr
    kernels._launch("gpad_dual_chunk", launch, c.device, ptr(D), ptr(od),
                    ptr(c), ptr(y), ptr(y_prev), ptr(s), ptr(mom), ptr(theta),
                    ptr(beta), B, m_h, k0, chunk, int(restart), *plan,
                    *(ptr(t) for t in out), _dual_smem_bytes(m_h, plan),
                    kernels._tier_code(tier))
    DUAL_CHUNK_LAUNCHES += 1
    return tuple(out)


def _chunk_fake(c, y, y_prev, s, mom):
    return tuple(t.new_empty(t.shape) for t in (y, y_prev, s, mom, y))


dual_chunk_op = kernels._register(
    "dual_chunk", _chunk_cpu, _chunk_cuda,
    lambda D, od, c, y, y_prev, s, mom, theta, beta, k0, chunk, restart,
    log2_tile, split, tier="highest": _chunk_fake(c, y, y_prev, s, mom))


def _tiled_chunk_cpu(D: Tensor, od: Optional[Tensor], c: Tensor, y: Tensor,
                     y_prev: Tensor, s: Tensor, mom: Tensor, theta: Tensor,
                     beta: Tensor, k0: int, chunk: int, restart: bool,
                     log2_tile: int, cluster: int, tier: str = "highest",
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    return _chunk_cpu(D, od, c, y, y_prev, s, mom, theta, beta, k0, chunk,
                      restart, log2_tile, 0, tier)


def _tiled_chunk_cuda(D, od, c, y, y_prev, s, mom, theta, beta, k0, chunk,
                      restart, log2_tile, cluster, tier="highest"):
    global DUAL_TILED_CHUNK_LAUNCHES
    _, launch = _tiled_launch_fns()
    B, m_h = c.shape[0], c.shape[2]
    out = [torch.empty_like(t) for t in (y, y_prev, s, mom, y)]
    ptr = kernels._ptr
    kernels._launch("gpad_dual_tiled_chunk", launch, c.device, ptr(D),
                    ptr(od), ptr(c), ptr(y), ptr(y_prev), ptr(s), ptr(mom),
                    ptr(theta),
                    ptr(beta), B, m_h, k0, chunk, int(restart), log2_tile,
                    cluster, *(ptr(t) for t in out),
                    _dual_tiled_smem_bytes(m_h, log2_tile),
                    kernels._tier_code(tier))
    DUAL_TILED_CHUNK_LAUNCHES += 1
    return tuple(out)


dual_tiled_chunk_op = kernels._register(
    "dual_tiled_chunk", _tiled_chunk_cpu, _tiled_chunk_cuda,
    lambda D, od, c, y, y_prev, s, mom, theta, beta, k0, chunk, restart,
    log2_tile, cluster, tier="highest": _chunk_fake(c, y, y_prev, s, mom))


def gpad_fixed_dual(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    restart: bool = False, diagnostics: bool = True,
    log2_tile: int | None = None, split: int | None = None,
    tier: str = "highest",
):
    """Fixed-budget dual-form GPAD for a batch: returns (z, y, w, zhat).

    ``g_P`` (B, n_z), ``p_D`` (B, 2, m_h), optional warm start ``y0``
    broadcasting to (B, 2, m_h). ``z`` is recovered after the loop from
    the running average s; ``w`` and ``zhat`` are the last iteration's and
    come back only with ``diagnostics`` (else None). Under ``restart`` the
    budget may exceed the schedule. ``log2_tile`` and ``split`` override
    the scenarios per block and cap the product's split-K parts (for
    sweeps). ``tier`` (``kernels.KERNEL_TIERS``) is the product's
    precision. CUDA tensors launch the kernel (or raise); CPU tensors run
    the plain version."""
    _check_fixed(data, g_P, p_D, y0, iterations, restart)
    B, m_h = g_P.shape[0], data.m_half
    plan = DualPlan(0, 0)
    if kernels.on_card(g_P):
        plan = _plan_or_raise(m_h, B, log2_tile, split, tier)
    c = relu_offsets(data, g_P, p_D)
    y0_rows = None if y0 is None else kernels._norm_y0(y0, B, m_h)
    s, y, w = dual_op(data.D, kernels._od(data), c, y0_rows, data.theta,
                      data.beta, iterations, restart, *plan, diagnostics,
                      tier)
    w = w if diagnostics else None
    z, zhat = _primal(data, g_P, s, w, recovery_weight(data, iterations),
                      diagnostics)
    return z, y, w, zhat


def _tiled_tile_or_raise(m_h: int, B: int, log2_tile, cluster) -> tuple:
    """(log2_tile, cluster) of a tiled launch: the picks, or the caller's
    overrides checked."""
    if log2_tile is None:
        log2_tile = pick_tiled_tiles(m_h, B)
        if log2_tile is None:
            raise ValueError(
                f"dual problem (m_half={m_h}) exceeds even the tiled dual "
                f"kernels' shared memory ({kernels.SMEM_LIMIT_BYTES} bytes); "
                "use engine='torch'"
            )
    if not 0 <= log2_tile <= DUAL_TILED_MAX_LOG2_TILE:
        raise ValueError(f"log2_tile {log2_tile} outside the tiled kernels' "
                         f"0..{DUAL_TILED_MAX_LOG2_TILE}")
    if _dual_tiled_smem_bytes(m_h, log2_tile) > kernels.SMEM_LIMIT_BYTES:
        raise ValueError(f"tile 2**{log2_tile} exceeds shared memory at "
                         f"m_half={m_h}")
    if cluster is None:
        cluster = pick_tiled_cluster(log2_tile, B)
    if cluster not in (1, 2, 4, 8, 16):
        raise ValueError(f"cluster {cluster} is not a power of two <= 16")
    return log2_tile, cluster


def gpad_fixed_dual_tiled(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    restart: bool = False, diagnostics: bool = True,
    log2_tile: int | None = None, cluster: int | None = None,
    tier: str = "highest",
):
    """``gpad_fixed_dual``'s contract for duals too large for it: D is read
    from device memory on every iteration (the counterpart of
    ``tpu_gpad.solver.kernels.gpad_pallas_fixed_dual_tiled``, and of
    ``gpad_pallas_fixed_dual`` on soft data past one block's shared
    memory); soft rows carried. ``log2_tile`` and ``cluster`` override the
    scenarios per cluster and the blocks per cluster (for sweeps); ``tier``
    (``kernels.KERNEL_TIERS``) is the product's precision and does not
    change the launch plan. CUDA tensors launch the kernel (or raise); CPU
    tensors run the plain version, ``gpad_fixed_dual_torch``."""
    _check_fixed(data, g_P, p_D, y0, iterations, restart)
    B, m_h = g_P.shape[0], data.m_half
    log2_tile, cluster = ((0, 0) if not kernels.on_card(g_P) else
                          _tiled_tile_or_raise(m_h, B, log2_tile, cluster))
    c = relu_offsets(data, g_P, p_D)
    y0_rows = None if y0 is None else kernels._norm_y0(y0, B, m_h)
    s, y, w = dual_tiled_op(data.D, kernels._od(data), c, y0_rows,
                            data.theta, data.beta, iterations, restart,
                            log2_tile, cluster, diagnostics, tier)
    w = w if diagnostics else None
    z, zhat = _primal(data, g_P, s, w, recovery_weight(data, iterations),
                      diagnostics)
    return z, y, w, zhat


def _window_schedule(data: GPADData, k0, chunk: int, restart: bool):
    """(theta, beta, k0) of a chunk launch. A tensor ``k0`` (a window of the
    eps loop as torch.export traces it, ``core._export_windows``) gathers
    the window's schedule on the device and launches from offset 0; under
    restart the schedule is not read."""
    from tpu_gpad_torch.solver import core

    if not isinstance(k0, torch.Tensor):
        return data.theta, data.beta, k0
    if restart:
        return data.theta, data.beta, 0
    return (*core._schedule_window(data.theta, data.beta, k0, chunk), 0)


def gpad_dual_chunk(data: GPADData, c, y, y_prev, s, mom, *, k0: int,
                    chunk: int, restart: bool = False,
                    log2_tile: int | None = None, split: int | None = None,
                    tier: str = "highest"):
    """``chunk`` dual-form iterations from schedule index ``k0``: returns
    the advanced (y, y_prev, s, mom) and the last iteration's w.

    ``c`` (B, 2, m_h) are the relu offsets (``relu_offsets``); y, y_prev
    (B, 2, m_h), s (B, m_h) and mom (B, 2) the state, which comes back in
    new tensors. Consecutive chunks compose to one whole solve.
    ``log2_tile``, ``split`` and ``tier`` as for ``gpad_fixed_dual``. CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain version
    (the op ``tpu_gpad_torch::dual_chunk``)."""
    _check_chunk(data, c, y, y_prev, s, mom, k0, chunk, restart)
    plan = _chunk_plan(data, c, False, log2_tile, split, tier)
    return _launch_chunk(data, False, plan, c, y, y_prev, s, mom, k0, chunk,
                         restart, tier)


def gpad_dual_tiled_chunk(data: GPADData, c, y, y_prev, s, mom, *, k0: int,
                          chunk: int, restart: bool = False,
                          log2_tile: int | None = None,
                          cluster: int | None = None, tier: str = "highest"):
    """``gpad_dual_chunk``'s contract for duals too large for it, with D
    read from device memory on every iteration (the chunk form of
    ``gpad_fixed_dual_tiled``; ``_dual_tiled_call`` in tpu_gpad, and
    ``_dual_chunk_call`` on soft data past one block's shared memory); soft
    rows carried. ``tier`` as for ``gpad_fixed_dual_tiled``. CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain
    version, ``gpad_dual_chunk_torch`` (the op
    ``tpu_gpad_torch::dual_tiled_chunk``)."""
    _check_chunk(data, c, y, y_prev, s, mom, k0, chunk, restart)
    plan = _chunk_plan(data, c, True, log2_tile, cluster)
    return _launch_chunk(data, True, plan, c, y, y_prev, s, mom, k0, chunk,
                         restart, tier)


def _chunk_plan(data: GPADData, c, tiled: bool, log2_tile, split_or_cluster,
                tier: str = "highest"):
    """A chunk kernel's launch for the batch of ``c``: (log2_tile, split)
    at ``tier``, or for the tiled one (log2_tile, cluster); zeros for CPU
    tensors."""
    if not kernels.on_card(c):
        return 0, 0
    if tiled:
        return _tiled_tile_or_raise(data.m_half, c.shape[0], log2_tile,
                                    split_or_cluster)
    return tuple(_plan_or_raise(data.m_half, c.shape[0], log2_tile,
                                split_or_cluster, tier))


def _launch_chunk(data: GPADData, tiled: bool, plan, c, y, y_prev, s, mom,
                  k0, chunk: int, restart: bool, tier: str = "highest"):
    """One window on a chunk kernel's op at ``tier``, its inputs checked and
    its ``plan`` fixed by the caller."""
    theta, beta, k0 = _window_schedule(data, k0, chunk, restart)
    op = dual_tiled_chunk_op if tiled else dual_chunk_op
    return op(data.D, kernels._od(data), c, y, y_prev, s, mom, theta, beta,
              k0, chunk, restart, *plan, tier)


def gpad_eps_dual(data: GPADData, g_P, p_D, config, y0=None,
                  chunk_fn=None) -> SolveResult:
    """Algorithm-1 (eps-terminated) solve of a batch with the chunk kernel:
    the resident one where ``dual_fits_smem`` admits the data, else the
    tiled one where ``dual_tiled_fits`` does. The windows run at the
    config's tier (``core.tier``), the residual tests and the primal
    recovery in fp32. ``chunk_fn``
    replaces the kernel (``gpad_dual_chunk_torch`` runs the same loop on
    the plain version, ``tier`` passed as a keyword).

    Full windows of C = min(check_every, iterations) iterations, then one
    partial window to the budget's end. After each window the host runs
    the residual/gap test (``core._eps_test``, soft rows against the
    recovered slack), captures each newly converged scenario's point, and
    stops once every scenario has converged: one host sync per window.
    Under a sharded solve the unconverged count is summed over
    ``config.collective_axes`` first, so every rank runs until the last
    scenario of all of them has converged. It skips the partial window too
    when all have converged, where ``tpu_gpad`` runs it anyway (the
    captured points are the same; y and the gap are then those of the
    stopping window); with the summed count every rank skips it or none
    does."""
    global EPS_SYNCS
    from tpu_gpad_torch.solver import core

    with span("solve_batch.iterate"):
        B, dev = g_P.shape[0], g_P.device
        iterations = config.iterations
        C = max(min(config.check_every, iterations), 1)
        n_full, rem = divmod(iterations, C)
        tier = core.tier(config)
        c = relu_offsets(data, g_P, p_D)
        y, s, mom = _init_state(data, B, y0, dev)
        mm = core._Matmul(core._fp32(config), data)  # the tests' products
        if chunk_fn is None:
            # the kernel's checks and launch plan once, for every window:
            # sizes are symbols in the body of a loop that torch.export
            # traces, and a plan cannot branch on them there
            tiled = not dual_fits_smem(data) and dual_tiled_fits(data)
            _check_chunk(data, c, y, y, s, mom, 0, iterations,
                         config.restart)
            plan = _chunk_plan(data, c, tiled, None, None, tier)

            def chunk_fn(data, c, y, y_prev, s, mom, *, k0, chunk, restart,
                         tier):
                return _launch_chunk(data, tiled, plan, c, y, y_prev, s,
                                     mom, k0, chunk, restart, tier)

        def window(k0, chunk, state):
            """One check window from schedule index ``k0`` and its test."""
            y, y_prev, s, mom, w, converged, iters, z_out = state
            y, y_prev, s, mom, w = chunk_fn(
                data, c, y, y_prev, s, mom, k0=k0, chunk=chunk,
                restart=config.restart, tier=tier,
            )
            z, zhat = _primal(data, g_P, s, w, 1.0)  # a = 1: theta_0 = 1
            converged, iters, z_out = core._eps_test(
                data, g_P, p_D, config, k0 + chunk, z, zhat, w, y,
                converged, iters, z_out, False, mm)
            return y, y_prev, s, mom, w, converged, iters, z_out

        state = (y, y.clone(), s, mom, torch.zeros_like(y),
                 torch.zeros((B,), dtype=torch.bool, device=dev),
                 torch.full((B,), iterations, dtype=torch.int32,
                            device=dev),
                 torch.zeros((B, data.n_z), dtype=torch.float32,
                             device=dev))
        if torch.compiler.is_exporting():
            state = core._export_windows(window, state, 5, n_full, C, rem)
        else:
            windows = [C] * n_full + ([rem] if rem else [])
            k0 = 0
            for i, chunk in enumerate(windows):
                state = window(k0, chunk, state)
                k0 += chunk
                if i + 1 < len(windows):
                    EPS_SYNCS += 1
                    if core._all_converged(state[5], config):
                        break
        y, _, s, _, w, converged, iters, z_out = state
        z, zhat = _primal(data, g_P, s, w, 1.0)
    with span("solve_batch.finish"):
        return core._eps_result(data, g_P, p_D, z, zhat, w, y, converged,
                                iters, z_out, False, None, mm)
