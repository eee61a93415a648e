"""Series-cell battery balancing (the reference's application model).

Reference: ``Code/MATLAB/gpad.m:4-73`` and
``Documents/BatteryBalancingProblem.pdf``. ``n`` series cells with
state-of-charge dynamics x+ = x + B u, B = diag(-1/(3600*C_i)); SoC box
+-0.5, balancing-current box +-0.3 A; per-stage charge-conservation coupling
sum(u_k) = 0 encoded as K_u u = 0 (``gpad.m:44,65-73``). With all constraints
active the constraint count is m = 4*n*N + 2*N, matching the reference
fixtures (e.g. n=30, N=30 -> m=3660).
"""

from __future__ import annotations

import numpy as np

from tpu_gpad_torch.types import LinearMPCProblem


def battery(
    n_cells: int = 3,
    horizon: int = 4,
    cell_capacity_ah: float = 0.027 * 4.1,
    soc_limit: float = 0.5,
    current_limit: float = 0.3,
    qx_weight: float = 100.0,
    qu_weight: float = 1.0,
) -> LinearMPCProblem:
    n = n_cells
    A = np.eye(n)
    B = np.diag(np.full(n, -1.0 / (3600.0 * cell_capacity_ah)))
    return LinearMPCProblem(
        A=A,
        B=B,
        Q=qx_weight * np.eye(n),
        R=qu_weight * np.eye(n),
        horizon=horizon,
        x_min=np.full(n, -soc_limit),
        x_max=np.full(n, soc_limit),
        u_min=np.full(n, -current_limit),
        u_max=np.full(n, current_limit),
        K_u=np.ones((1, n)),  # sum of balancing currents = 0 per stage
        name=f"battery_n{n}_N{horizon}",
    )


def default_x0(n_cells: int, seed: int = 0) -> np.ndarray:
    """Initial SoC vector. Uses the reference's hand-picked vectors for
    n in {5, 10} (``gpad.m:9-15``) and a seeded uniform(-0.5, 0.5) otherwise."""
    if n_cells == 10:
        return np.array([-0.1, 0.45, -0.09, 0.05, 0.0, -0.05, 0.3, 0.2, 0.25, -0.45])
    if n_cells == 5:
        return np.array([-0.1, 0.05, 0.0, -0.05, 0.1])
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, size=n_cells)
