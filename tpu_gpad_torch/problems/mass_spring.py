"""Chain of masses coupled by springs — the scalable benchmark plant
(paper experiments sweep state dimension; ``nmpc12-gpad.pdf`` section 5.1
uses problems of growing size). ``n_masses`` masses in a line, each with
position/velocity states; actuators apply force to each mass."""

from __future__ import annotations

import numpy as np

from tpu_gpad_torch.types import LinearMPCProblem


def mass_spring(
    n_masses: int = 4,
    horizon: int = 10,
    dt: float = 0.1,
    spring_k: float = 1.0,
    mass: float = 1.0,
    x_limit: float = 4.0,
    u_limit: float = 0.5,
    qx_weight: float = 1.0,
    qu_weight: float = 0.1,
) -> LinearMPCProblem:
    n = n_masses
    # Continuous dynamics: pos' = vel; m*vel_i' = k*(p_{i-1} - 2 p_i + p_{i+1}) + u_i
    K = -2.0 * np.eye(n) + np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
    Ac = np.block([[np.zeros((n, n)), np.eye(n)], [(spring_k / mass) * K, np.zeros((n, n))]])
    Bc = np.block([[np.zeros((n, n))], [np.eye(n) / mass]])
    # Forward-Euler discretization (adequate for small dt; keeps A,B exact rationals)
    A = np.eye(2 * n) + dt * Ac
    B = dt * Bc
    return LinearMPCProblem(
        A=A,
        B=B,
        Q=qx_weight * np.eye(2 * n),
        R=qu_weight * np.eye(n),
        horizon=horizon,
        x_min=np.full(2 * n, -x_limit),
        x_max=np.full(2 * n, x_limit),
        u_min=np.full(n, -u_limit),
        u_max=np.full(n, u_limit),
        name=f"mass_spring_n{n}_N{horizon}",
    )
