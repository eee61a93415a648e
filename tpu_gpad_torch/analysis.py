"""Convergence analysis: per-iteration residual/gap traces.

The counterpart of ``tpu_gpad.analysis``. The cookbook's per-step analysis
(``ECE_5770_GPAD_Cookbook.pdf`` p.5) and the paper's iteration-count
experiments (``nmpc12-gpad.pdf`` sec. 5.2) both study how GPAD converges
over iterations. This module runs the torch engine's iteration
(``solver.core._iteration``, the mvp form) and records the primal
infeasibility and the duality-gap surrogate at every iteration; it is kept
apart from ``solver.core`` so the solve paths never pay for the records.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tpu_gpad_torch.solver.core import (
    SolverConfig,
    _check_config,
    _init_state,
    _iteration,
    _Matmul,
    _momentum,
    _residuals,
    _restart_update,
    affine_params,
    tf32_matmuls,
)
from tpu_gpad_torch.types import GPADData


@dataclass
class ConvergenceTrace:
    """Per-iteration diagnostics: arrays of shape (iterations, B)."""

    residual: np.ndarray  # max primal infeasibility of z_k (unscaled)
    gap: np.ndarray  # duality-gap surrogate -w_k' g(zhat_k)
    u: np.ndarray  # (B, n_u) final first move (sanity/cross-check)


def convergence_trace(
    data: GPADData,
    x0,
    config: SolverConfig = SolverConfig(),
) -> ConvergenceTrace:
    """Run ``config.iterations`` GPAD iterations on the data's device,
    recording residual and gap at every step, as
    ``tpu_gpad.analysis.convergence_trace``. Uses the mvp-form iteration of
    the torch engine (the same math as the production engines); supports
    ``config.restart``, and the products of ``config``'s precision tier
    (``solver.core._Matmul``), as JAX's. The records stay on the
    device until the end."""
    if config.iterations is None:
        config = dataclasses.replace(config, iterations=data.max_iters)
    if config.iterations > data.max_iters and not config.restart:
        # as solve_batch: the momentum scalars come from the shipped
        # schedule, which has no entries past its end
        raise ValueError(
            f"config asks for {config.iterations} iterations but the "
            f"shipped momentum schedule only has {data.max_iters}; "
            "re-dualize with a longer one"
        )
    _check_config(config)
    x0 = torch.atleast_2d(
        torch.as_tensor(x0, dtype=torch.float32, device=data.device))
    with tf32_matmuls(False):
        g_P, p_D = affine_params(data, x0)
    batch_shape = g_P.shape[:-1]
    y, y_prev, z, _, _ = _init_state(data, batch_shape)
    th = th_prev = torch.ones(batch_shape, dtype=torch.float32,
                              device=data.device)
    mm = _Matmul(config, data)
    res_hist, gap_hist = [], []
    with tf32_matmuls(mm.tf32):
        for k in range(config.iterations):
            theta_k, beta_k = _momentum(config, data, k, th, th_prev)
            w, zhat, z, y_next = _iteration(
                data, g_P, p_D, theta_k, beta_k, y, y_prev, z, mm)
            if config.restart:
                y_prev, th, th_prev = _restart_update(th, th_prev, y, y_next,
                                                      w)
            else:
                y_prev = y
            y = y_next
            viol_z, _, gap = _residuals(data, g_P, p_D, z, zhat, w, mm)
            res_hist.append(torch.clamp_min(viol_z, 0.0))
            gap_hist.append(gap)
    return ConvergenceTrace(
        residual=torch.stack(res_hist).cpu().numpy(),
        gap=torch.stack(gap_hist).cpu().numpy(),
        u=z[..., : data.n_u].cpu().numpy(),
    )


def plot_convergence(trace: ConvergenceTrace, scenario: int = 0,
                     path: str | None = None):
    """Semilog residual/gap curves (the cookbook-figure analogue). Returns
    the matplotlib figure, or None if matplotlib is unavailable (it is
    imported only here, and is not a hard dependency)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return None
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.semilogy(np.maximum(trace.residual[:, scenario], 1e-16),
                label="primal infeasibility")
    ax.semilogy(np.maximum(np.abs(trace.gap[:, scenario]), 1e-16),
                label="|duality-gap surrogate|")
    ax.set_xlabel("iteration")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig
