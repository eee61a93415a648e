"""GPAD solver in PyTorch (the online layer), fixed-iteration mode.

The counterpart of ``tpu_gpad.solver.core``. The JAX package traces the
iteration into one ``lax.fori_loop``; here the loop is a Python loop of
tensor ops (``engine="torch"``, the XLA engine's counterpart) or one
hand-written CUDA kernel launch for the whole solve (``engine="cuda"``,
the Pallas engine's counterpart, ``solver/kernels.py``).

Routing (``engine="auto"``) keys on the device of the data tensors: on a
CUDA device the kernel serves flat paired mvp solves in fixed mode whose
operands fit one block's shared memory; everything else runs the torch
engine, as the JAX package sends what its kernels do not serve to XLA.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tpu_gpad_torch.types import GPADData, SolveResult


@dataclass(frozen=True)
class SolverConfig:
    """Runtime solver configuration; the same fields as
    ``tpu_gpad.solver.SolverConfig``.

    ``engine``: "auto" | "torch" | "cuda". "auto" launches the CUDA kernel
    when the data lives on a CUDA device and the kernel serves the case
    (flat paired mvp form, fixed mode, no restart, operands fit shared
    memory) and runs the torch loop otherwise. Forcing "cuda" where the
    kernel does not serve the case, or on CPU tensors, raises.

    Not yet ported (raise ``NotImplementedError``): ``mode="eps"``,
    ``restart=True``, ``model_axis``/``collective_axes``, ``precision``
    other than "highest" and ``matmul_dtype`` other than "float32".
    ``unroll`` is accepted for parity and has no effect on the eager loop.
    """

    iterations: int | None = None  # None: the full shipped schedule
    mode: str = "fixed"  # "fixed" | "eps"
    eps_g: float = 1e-6
    eps_V: float = 1e-6
    check_every: int = 10
    engine: str = "auto"  # "auto" | "torch" | "cuda"
    form: str = "auto"  # "auto" | "mvp" | "dual"
    matmul_dtype: str = "float32"
    precision: str = "highest"  # true fp32 products: no TF32 anywhere
    collective_axes: tuple = ()
    model_axis: str | None = None
    unroll: int = 1
    flat: str = "auto"  # "auto" | "on" | "off"
    diagnostics: bool = True  # False: residual/gap come back NaN
    restart: bool = False


def _check_ported(config: SolverConfig) -> None:
    """Raise for the configuration values the port does not carry yet."""
    if config.mode == "eps":
        raise NotImplementedError(
            "mode='eps' is not yet ported to tpu_gpad_torch "
            "(ROADMAP Queue 1, item 3: eps mode)"
        )
    if config.mode != "fixed":
        raise ValueError(f"unknown mode: {config.mode!r}")
    if config.restart:
        raise NotImplementedError(
            "restart=True is not yet ported to tpu_gpad_torch "
            "(ROADMAP Queue 1, item 3: restart)"
        )
    if config.model_axis is not None or config.collective_axes:
        raise NotImplementedError(
            "model_axis/collective_axes are not yet ported to "
            "tpu_gpad_torch (ROADMAP Queue 1, item 11: torch.distributed)"
        )
    if config.precision != "highest":
        raise NotImplementedError(
            f"precision={config.precision!r} is not yet ported to "
            "tpu_gpad_torch (ROADMAP Queue 1, item 3: precision tiers)"
        )
    if config.matmul_dtype != "float32":
        raise NotImplementedError(
            f"matmul_dtype={config.matmul_dtype!r} is not yet ported to "
            "tpu_gpad_torch (ROADMAP Queue 1, item 3: precision tiers)"
        )
    if config.engine not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown engine: {config.engine!r}")


def affine_params(data: GPADData, x0: torch.Tensor):
    """Per-scenario dual constants g_P(x0), p_D(x0).

    In the paired layout ``p_D`` has shape (..., 2, m_h)."""
    g_P = torch.tensordot(x0, data.gP_map, dims=1) + data.gP_const
    p_D = torch.tensordot(x0, data.pD_map, dims=1) + data.pD_const
    return g_P, p_D


def resolve_flat(data: GPADData, config: SolverConfig) -> bool:
    """Whether the mvp iteration exploits the input-box identity block."""
    avail = (
        data.paired
        and data.n_struct is not None
        and config.model_axis is None
    )
    if config.flat == "auto":
        return avail
    if config.flat == "on":
        if not avail:
            raise ValueError(
                "flat='on' needs paired data with a detected identity block "
                "(GPADData.n_struct) and no model-axis sharding"
            )
        return True
    if config.flat == "off":
        return False
    raise ValueError(f"unknown flat: {config.flat!r}")


def _step4_product(data: GPADData, zhat, flat: bool):
    """q = zhat @ GL_T for the paired layout; with ``flat`` the box columns
    of GL_T are exactly I/L and cost a division instead of a product."""
    if not flat:
        return zhat @ data.GL_T
    ns = data.n_struct
    if ns == 0:
        return zhat / data.L
    q_s = zhat @ data.GL_T[:, :ns]
    return torch.cat([q_s, zhat / data.L], dim=-1)


def _pm(q):
    """Stack a half-stack vector with both signs: (..., m_h) -> (..., 2, m_h)."""
    return torch.stack([q, -q], dim=-2)


def _iteration(data: GPADData, g_P, p_D, theta_k, beta_k, y, y_prev, z,
               flat: bool = False):
    """One GPAD iteration (steps 1-4), batched."""
    w = y + beta_k * (y - y_prev)
    if data.paired:
        zhat = -((w[..., 0, :] - w[..., 1, :]) @ data.MG_T) - g_P
    else:
        zhat = -(w @ data.MG_T) - g_P
    z = (1.0 - theta_k) * z + theta_k * zhat
    w_s = w if data.soft_damp is None else w * (1.0 - data.soft_damp)
    if data.paired:
        q = _step4_product(data, zhat, flat)
        y_next = torch.clamp_min(w_s + _pm(q) + p_D, 0.0)
    else:
        y_next = torch.clamp_min(w_s + zhat @ data.GL_T + p_D, 0.0)
    return w, zhat, z, y_next


def _residuals(data: GPADData, g_P, p_D, z, zhat, w, flat: bool = False,
               y=None):
    """Primal violation max(G z - b) and gap surrogate -w' g(zhat),
    recovered from the scaled operands as g(z) = L (G_L z + p_D); soft rows
    are measured against the recovered slack (see tpu_gpad.solver.core)."""
    if data.paired:
        gz = data.L * (_pm(_step4_product(data, z, flat)) + p_D)
        gzh = data.L * (_pm(_step4_product(data, zhat, flat)) + p_D)
    else:
        gz = data.L * (z @ data.GL_T + p_D)
        gzh = data.L * (zhat @ data.GL_T + p_D)
    if data.soft_damp is not None:
        if y is not None:
            gz = gz - (data.L * data.soft_damp) * y
        gzh = gzh - (data.L * data.soft_damp) * w
    dims = (-2, -1) if data.paired else (-1,)
    viol_z = torch.amax(gz, dim=dims)
    viol_zhat = torch.amax(gzh, dim=dims)
    gap = -torch.sum(w * gzh, dim=dims)
    return viol_z, viol_zhat, gap


def _init_y(data: GPADData, batch_shape, y0, device):
    """Initial dual iterate: zeros, or ``y0`` broadcast to the batch."""
    dual_shape = (2, data.m_half) if data.paired else (data.m,)
    shape = tuple(batch_shape) + dual_shape
    if y0 is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
    return y0.expand(shape).clone()


def _init_state(data: GPADData, batch_shape, y0=None):
    """Initial iterates; ``y0`` warm-starts the dual (both y and y_prev, so
    the first extrapolation step is momentum-free from the warm point)."""
    y = _init_y(data, batch_shape, y0, data.device)
    z = torch.zeros(tuple(batch_shape) + (data.n_z,), dtype=torch.float32,
                    device=data.device)
    return y, y, z, torch.zeros_like(y), torch.zeros_like(z)


def _finish(data: GPADData, g_P, p_D, z, zhat, w, y, config, flat):
    """Residual/gap recovery and the SolveResult of a fixed-budget solve."""
    batch_shape = g_P.shape[:-1]
    if config.diagnostics:
        viol_z, _, gap = _residuals(data, g_P, p_D, z, zhat, w, flat, y=y)
        residual = torch.clamp_min(viol_z, 0.0)
    else:
        residual = torch.full(batch_shape, float("nan"), dtype=torch.float32,
                              device=z.device)
        gap = residual
    return SolveResult(
        u=z[..., : data.n_u],
        z=z,
        y=y,
        iterations=torch.full(batch_shape, config.iterations,
                              dtype=torch.int32, device=z.device),
        residual=residual,
        gap=gap,
        converged=torch.ones(batch_shape, dtype=torch.bool, device=z.device),
    )


def _solve_fixed(data: GPADData, g_P, p_D, config: SolverConfig,
                 y0=None) -> SolveResult:
    """Fixed-budget mvp loop (flat or dense products, paired or dense)."""
    flat = resolve_flat(data, config)
    y, y_prev, z, w, zhat = _init_state(data, g_P.shape[:-1], y0)
    for k in range(config.iterations):
        w, zhat, z, y_next = _iteration(
            data, g_P, p_D, data.theta[k], data.beta[k], y, y_prev, z, flat
        )
        y_prev, y = y, y_next
    return _finish(data, g_P, p_D, z, zhat, w, y, config, flat)


def _solve_fixed_dual(data: GPADData, g_P, p_D, config: SolverConfig,
                      y0=None) -> SolveResult:
    """Dual-only fixed-budget loop: one (m_h, m_h) product per iteration
    against D; the primal is recovered after the loop from the running
    momentum combination s of the w differences:
    z_K = -(s_K @ MG_T) - a_K g_P with a_K = 1 - prod_k (1 - theta_k)."""
    batch_shape = g_P.shape[:-1]
    y = _init_y(data, batch_shape, y0, g_P.device)
    y_prev = y
    w = torch.zeros_like(y)
    s = torch.zeros(tuple(batch_shape) + (data.m_half,), dtype=torch.float32,
                    device=g_P.device)
    e = g_P @ data.GL_T  # (B, m_h), hoisted out of the loop
    for k in range(config.iterations):
        theta_k, beta_k = data.theta[k], data.beta[k]
        w = y + beta_k * (y - y_prev)
        wd = w[..., 0, :] - w[..., 1, :]
        q = -(wd @ data.D) - e
        w_s = w if data.soft_damp is None else w * (1.0 - data.soft_damp)
        y_next = torch.clamp_min(w_s + _pm(q) + p_D, 0.0)
        s = (1.0 - theta_k) * s + theta_k * wd
        y_prev, y = y, y_next
    a = 1.0 - torch.prod(1.0 - data.theta[: config.iterations])
    z = -(s @ data.MG_T) - a * g_P
    wd = w[..., 0, :] - w[..., 1, :]
    zhat = -(wd @ data.MG_T) - g_P
    return _finish(data, g_P, p_D, z, zhat, w, y, config, flat=False)


def _kernel_serves(data: GPADData, config: SolverConfig) -> bool:
    """Does the CUDA kernel serve this (data, config), device aside?"""
    from tpu_gpad_torch.solver import kernels

    return (
        config.mode == "fixed"
        and not config.restart
        and resolve_form(data, config) == "mvp"
        and resolve_flat(data, config)
        and kernels.flat_fits_smem(data)
    )


def resolve_engine(data: GPADData, config: SolverConfig) -> str:
    """Pick the execution engine: "cuda" (the kernel) or "torch".

    "auto" keys on the device of the data tensors (the counterpart of the
    JAX package's ``jax.default_backend() == "tpu"`` test); a warm start
    never changes the choice. Forcing "cuda" where the kernel does not
    serve the case raises."""
    if config.engine == "torch":
        return "torch"
    if config.engine == "cuda":
        if data.device.type != "cuda":
            raise ValueError(
                "engine='cuda' needs the data on a CUDA device; got "
                f"{data.device}"
            )
        if not _kernel_serves(data, config):
            raise ValueError(
                "engine='cuda' serves only flat paired mvp solves in fixed "
                "mode without restart whose operands fit shared memory "
                "(kernels.flat_fits_smem); use engine='torch' here"
            )
        return "cuda"
    if config.engine != "auto":
        raise ValueError(f"unknown engine: {config.engine!r}")
    if data.device.type == "cuda" and _kernel_serves(data, config):
        return "cuda"
    return "torch"


def resolve_form(data: GPADData, config: SolverConfig) -> str:
    """Pick the iteration algebra for this (data, config) combination.

    "auto" picks the flat mvp form on a CUDA device whenever the identity
    block is available (the kernel's form) and the dual form elsewhere,
    as the JAX package does on TPU and CPU."""
    dual_ok = (
        data.paired
        and data.D is not None
        and config.mode == "fixed"
        and config.model_axis is None
    )
    if config.form == "auto":
        flat_avail = (
            dual_ok
            and data.n_struct is not None
            and config.flat != "off"
            and not config.restart
            and data.device.type == "cuda"
        )
        if flat_avail:
            from tpu_gpad_torch.solver import kernels

            if config.engine != "cuda" or kernels.flat_fits_smem(data):
                return "mvp"
        return "dual" if dual_ok else "mvp"
    if config.form == "dual":
        if not dual_ok:
            raise ValueError(
                "form='dual' needs paired data with D, fixed mode, and no "
                "model-axis sharding"
            )
        return "dual"
    if config.form == "mvp":
        return "mvp"
    raise ValueError(f"unknown form: {config.form!r}")


def solve_batch(
    data: GPADData,
    x0: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    y0: torch.Tensor | None = None,
) -> SolveResult:
    """Solve a batch of MPC QPs: ``x0`` has shape (..., n_x).

    All scenarios share the plant; per-scenario constants are the affine
    maps of x0. ``x0`` (and ``y0``) may be NumPy arrays or tensors; they
    are moved to the data's device. ``y0`` warm-starts the dual iterate
    and must broadcast to (..., 2, m_half) (paired) or (..., m)."""
    n_iters = (
        config.iterations if config.iterations is not None else data.max_iters
    )
    if n_iters > data.max_iters:
        raise ValueError(
            f"config asks for {n_iters} iterations but the shipped momentum "
            f"schedule only has {data.max_iters}; re-dualize with a longer one"
        )
    config = dataclasses.replace(config, iterations=n_iters)
    if not config.diagnostics and config.mode != "fixed":
        raise ValueError(
            "diagnostics=False requires mode='fixed' (the eps termination "
            "test needs the residual/gap diagnostics)"
        )
    _check_ported(config)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=data.device)
    if y0 is not None:
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=data.device)
    g_P, p_D = affine_params(data, x0)
    if resolve_engine(data, config) == "cuda":
        from tpu_gpad_torch.solver import kernels

        return kernels.solve_batch_cuda(data, g_P, p_D, config, y0=y0)
    if resolve_form(data, config) == "dual":
        return _solve_fixed_dual(data, g_P, p_D, config, y0)
    return _solve_fixed(data, g_P, p_D, config, y0)


def solve(
    data: GPADData,
    x0: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    y0: torch.Tensor | None = None,
) -> SolveResult:
    """Single-scenario solve: ``x0`` of shape (n_x,)."""
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=data.device)
    if y0 is not None:
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=data.device)
        if y0.ndim in (1, 2):
            y0 = y0[None]
    return solve_batch(data, x0[None, :], config=config, y0=y0)
