"""The flat paired GPAD kernel (CUDA C++ for Hopper) and its plain version.

``gpad_fixed_paired_flat`` runs a whole fixed-budget solve in one launch of
the kernel in ``csrc/gpad_paired_flat.cu``, the counterpart of
``tpu_gpad.solver.kernels.gpad_pallas_fixed_paired_flat``. On CUDA tensors
it launches the kernel or raises; on CPU tensors it runs
``gpad_fixed_paired_flat_torch``, the same loop in torch ops, which is also
what the tests and ``chip_smoke.py`` hold the kernel against.

The data's dual rows are already in the kernel's [struct | box] order
(``dualize`` puts the identity rows last), so unlike the TPU kernel there is
no padding, transposition or flat-layout mapping around the launch.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_gpad_torch.types import GPADData, SolveResult

# Launches of the CUDA kernel in this process; a run resets it to 0 to
# show that a path went through the kernel.
PAIRED_FLAT_LAUNCHES = 0

# Dynamic shared memory one block may use on an H100 (232,448 bytes, the
# sm_90 opt-in maximum). The guard below is derived from it alone: which
# shapes are FASTER on the kernel than on the torch engine is unmeasured on
# H100.
SMEM_LIMIT_BYTES = 227 * 1024
# At most 8 scenarios per block. On an H100 at battery n3 N10, 8 beat 4, 16
# and 32 at B = 4096 (0.611 vs 0.629, 0.638, 0.914 ms) and 32 at B = 16384:
# more, smaller blocks put more warps on each SM to hide the latency of the
# dependent shared-memory FMA chains (PERF.md, PR 1 findings).
_MAX_LOG2_TILE = 3


def _smem_bytes(m_h: int, n_z: int, n_s: int, log2_tile: int) -> int:
    """Shared memory of one block of the kernel (csrc carve-up): both
    operands, the od column, 7 dual-row arrays and 3 primal arrays of
    2**log2_tile scenarios each."""
    T = 1 << log2_tile
    return 4 * (m_h * n_z + n_z * n_s + m_h + 7 * m_h * T + 3 * n_z * T)


def _pick_log2_tile(m_h: int, n_z: int, n_s: int, B: int) -> int | None:
    """The widest scenario tile (a power of two, at most 2**_MAX_LOG2_TILE
    and at most B rounded up) whose block fits shared memory, or None."""
    log2 = min(_MAX_LOG2_TILE, max(B - 1, 0).bit_length())
    while log2 >= 0:
        if _smem_bytes(m_h, n_z, n_s, log2) <= SMEM_LIMIT_BYTES:
            return log2
        log2 -= 1
    return None


def flat_fits_smem(data: GPADData) -> bool:
    """Can the kernel run this data: a flat paired layout whose operands
    and one scenario's state fit one block's shared memory?"""
    if not (data.paired and data.n_struct is not None):
        return False
    return _pick_log2_tile(data.m_half, data.n_z, data.n_struct, 1) is not None


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


def _od(data: GPADData):
    """The (m_h,) column 1 - soft_damp, or None on hard data."""
    if data.soft_damp is None:
        return None
    return 1.0 - data.soft_damp.to(torch.float32)


def gpad_fixed_paired_flat_torch(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True,
):
    """The kernel's loop in torch ops, on any device: the plain version
    the kernel is checked against. Same contract as
    ``gpad_fixed_paired_flat``."""
    B, m_h, n_s = g_P.shape[0], data.m_half, data.n_struct
    GLs = data.GL_T[:, :n_s]
    inv_L = 1.0 / data.L
    od = _od(data)
    if y0 is None:
        y = torch.zeros((B, 2, m_h), dtype=torch.float32, device=g_P.device)
    else:
        y = _norm_y0(y0, B, m_h).expand(B, 2, m_h).clone()
    y_prev = y
    z = torch.zeros_like(g_P)
    w = torch.zeros_like(y)
    zhat = torch.zeros_like(g_P)
    for k in range(iterations):
        w = y + data.beta[k] * (y - y_prev)
        zhat = -((w[:, 0] - w[:, 1]) @ data.MG_T) - g_P
        z = (1.0 - data.theta[k]) * z + data.theta[k] * zhat
        q = torch.cat([zhat @ GLs, zhat * inv_L], dim=-1)
        w_s = w if od is None else w * od
        y_prev, y = y, torch.clamp_min(w_s + torch.stack([q, -q], 1) + p_D, 0.0)
    if not diagnostics:
        return z, y, None, None
    return z, y, w, zhat


def _launch_fn():
    """The kernel's C launcher, built and loaded at first use."""
    from tpu_gpad_torch import cuda_build

    fn = cuda_build.load("gpad_paired_flat").gpad_paired_flat_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, ctypes.c_longlong, P, P, P, P,
                   I, I, I, I, I, I, P, P, P, P, I, P]
    fn.restype = I
    return fn


def _check_inputs(data: GPADData, g_P, p_D, y0, iterations: int) -> None:
    """Raise on anything the kernel does not take."""
    if not data.paired or data.n_struct is None:
        raise ValueError("flat kernel needs paired data with a detected "
                         "identity block (GPADData.n_struct)")
    m_h, n_z, n_s = data.m_half, data.n_z, data.n_struct
    if m_h != n_s + n_z:
        raise ValueError(f"flat layout needs m_half == n_struct + n_z; got "
                         f"{m_h} != {n_s} + {n_z}")
    if iterations > data.max_iters:
        raise ValueError(f"{iterations} iterations exceed the schedule's "
                         f"{data.max_iters}")
    if g_P.ndim != 2 or g_P.shape[1] != n_z:
        raise ValueError(f"g_P must be (B, {n_z}); got {tuple(g_P.shape)}")
    if tuple(p_D.shape) != (g_P.shape[0], 2, m_h):
        raise ValueError(f"p_D must be ({g_P.shape[0]}, 2, {m_h}); got "
                         f"{tuple(p_D.shape)}")
    tensors = [data.MG_T, data.GL_T, data.L, data.theta, data.beta, g_P, p_D]
    tensors += [t for t in (y0, data.soft_damp) if t is not None]
    for t in tensors:
        if t.device != g_P.device:
            raise ValueError(f"tensor on {t.device}, g_P on {g_P.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"kernel takes float32 tensors; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")


def gpad_fixed_paired_flat(
    data: GPADData, g_P, p_D, y0=None, *, iterations: int,
    diagnostics: bool = True,
):
    """Fixed-budget flat paired GPAD for a batch: returns (z, y, w, zhat).

    ``g_P`` (B, n_z), ``p_D`` (B, 2, m_h), optional warm start ``y0``
    broadcasting to (B, 2, m_h). ``z``/``zhat`` are (B, n_z), ``y``/``w``
    (B, 2, m_h); ``w`` and ``zhat`` are the last iteration's, and both are
    None when ``diagnostics`` is False. CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    global PAIRED_FLAT_LAUNCHES
    _check_inputs(data, g_P, p_D, y0, iterations)
    if g_P.device.type == "cpu":
        return gpad_fixed_paired_flat_torch(
            data, g_P, p_D, y0, iterations=iterations, diagnostics=diagnostics
        )
    if g_P.device.type != "cuda":
        raise ValueError(f"no kernel for device {g_P.device}")
    fn = _launch_fn()
    B, m_h, n_z, n_s = g_P.shape[0], data.m_half, data.n_z, data.n_struct
    log2_tile = _pick_log2_tile(m_h, n_z, n_s, B)
    if log2_tile is None:
        raise ValueError(
            f"problem (m_half={m_h}, n_z={n_z}, n_struct={n_s}) exceeds the "
            f"kernel's shared memory ({SMEM_LIMIT_BYTES} bytes); use "
            "engine='torch'"
        )
    y0_rows = None if y0 is None else _norm_y0(y0, B, m_h)
    y0_stride = 0 if y0_rows is None or y0_rows.shape[0] == 1 else 2 * m_h
    od = _od(data)
    z = torch.empty((B, n_z), dtype=torch.float32, device=g_P.device)
    y = torch.empty((B, 2, m_h), dtype=torch.float32, device=g_P.device)
    w = torch.empty_like(y) if diagnostics else None
    zhat = torch.empty_like(z) if diagnostics else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(g_P.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptr(data.MG_T), ptr(data.GL_T), ptr(g_P), ptr(p_D),
                 ptr(y0_rows), y0_stride, ptr(od), ptr(data.theta),
                 ptr(data.beta), ptr(data.L), B, m_h, n_z, n_s, iterations,
                 log2_tile, ptr(z), ptr(y), ptr(w), ptr(zhat),
                 _smem_bytes(m_h, n_z, n_s, log2_tile), stream)
    if err != 0:
        raise RuntimeError(f"gpad_paired_flat launch failed: CUDA error {err}")
    PAIRED_FLAT_LAUNCHES += 1
    return z, y, w, zhat


def solve_batch_cuda(data: GPADData, g_P, p_D, config, y0=None) -> SolveResult:
    """CUDA-engine entry called from ``solver.core.solve_batch``: the
    fixed-mode branch of ``tpu_gpad.solver.kernels.solve_batch_pallas``.

    Residuals and gap are recovered outside the kernel with plain
    products, as the JAX package does outside Pallas."""
    from tpu_gpad_torch.solver import core

    batch_shape = g_P.shape[:-1]
    gP2 = g_P.reshape(-1, data.n_z).contiguous()
    pD2 = p_D.reshape(-1, 2, data.m_half).contiguous()
    z, y, w, zhat = gpad_fixed_paired_flat(
        data, gP2, pD2, None if y0 is None else y0.contiguous(),
        iterations=config.iterations, diagnostics=config.diagnostics,
    )
    res = core._finish(data, gP2, pD2, z, zhat, w, y, config, flat=False)
    return SolveResult(
        **{
            name: t.reshape(tuple(batch_shape) + tuple(t.shape[1:]))
            for name, t in vars(res).items()
        }
    )
