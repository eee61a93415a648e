"""Numerical-health checks (the sanitizer story).

The counterpart of ``tpu_gpad.utils.debug``. What can go wrong numerically
in a GPAD solve is divergence (a too-small Lipschitz constant makes the
dual iteration expand) or NaN poisoning from bad problem data.
``solve_batch_checked`` raises on non-finite iterates instead of silently
returning garbage; the JAX package wraps its solve in ``checkify``, here
the checks run after the solve on the data's device and reach the host in
one sync.
"""

from __future__ import annotations

import torch

from tpu_gpad_torch.solver.core import SolverConfig, solve_batch
from tpu_gpad_torch.types import GPADData, SolveResult

# the checks of solve_batch_checked, in order, with tpu_gpad's messages
_CHECKS = (
    "GPAD primal iterate z is non-finite: the dual iteration diverged "
    "(L too small?) or the problem data contains NaN/inf",
    "GPAD dual iterate y is non-finite",
    "dual iterate left the nonnegative orthant (projection broken)",
)


def validate_data(data: GPADData) -> list[str]:
    """Host-side sanity checks on the dual constants; returns problem list."""
    problems = []
    for name in ("MG_T", "GL_T", "gP_map", "gP_const", "pD_map", "pD_const",
                 "theta", "beta", "L", "D"):
        arr = getattr(data, name)
        if arr is None:
            continue
        if not bool(torch.isfinite(arr).all()):
            problems.append(f"{name} contains non-finite values")
    if float(data.L) <= 0.0:
        problems.append(f"Lipschitz constant L={float(data.L)} is not positive")
    th = data.theta
    if bool(((th <= 0) | (th > 1)).any()):
        problems.append("theta schedule leaves (0, 1]")
    return problems


def solve_batch_checked(
    data: GPADData,
    x0,
    config: SolverConfig = SolverConfig(),
    y0=None,
) -> SolveResult:
    """``solve_batch`` followed by explicit checks: raises ``RuntimeError``
    with the failed check's message if the returned primal or dual
    iterates are non-finite (divergence / NaN poisoning) or the dual left
    the nonnegative orthant, instead of propagating garbage.

    Debug/CI tool: the checks cost one device-to-host sync; do not put it
    in a latency-critical loop."""
    res = solve_batch(data, x0, config=config, y0=y0)
    failed = torch.stack([
        ~torch.isfinite(res.z).all(),
        ~torch.isfinite(res.y).all(),
        ~(res.y >= 0.0).all(),
    ]).cpu()  # the one sync
    for bad, message in zip(failed.tolist(), _CHECKS):
        if bad:
            raise RuntimeError(message)
    return res
