"""Double-integrator benchmark plant (paper: ``nmpc12-gpad.pdf`` section 5.2)."""

from __future__ import annotations

import numpy as np

from tpu_gpad_torch.types import LinearMPCProblem


def double_integrator(
    horizon: int = 10,
    dt: float = 1.0,
    x_limit: float = 15.0,
    u_limit: float = 1.0,
    qx_weight: float = 1.0,
    qu_weight: float = 1.0,
) -> LinearMPCProblem:
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    return LinearMPCProblem(
        A=A,
        B=B,
        Q=qx_weight * np.eye(2),
        R=qu_weight * np.eye(1),
        horizon=horizon,
        x_min=np.full(2, -x_limit),
        x_max=np.full(2, x_limit),
        u_min=np.array([-u_limit]),
        u_max=np.array([u_limit]),
        name=f"double_integrator_N{horizon}",
    )
