"""The series-cell battery-balancing plant and its condensed QP, in plain NumPy.

The deployment of shreyasren/GPU-DualGradient-MPC (``Code/MATLAB/gpad.m``
lines 4-73, ``Documents/BatteryBalancingProblem.pdf``): ``n`` cells in
series with state-of-charge dynamics x+ = x + B u, B = diag(-1 / (3600 C)),
stage cost x' Q x + u' R u over ``horizon`` steps, SoC box +-soc_limit,
balancing-current box +-current_limit and the charge conservation
sum(u_k) = 0 at every stage.

Written from that description alone, in float64: it shares no code, no row
order and no layout with the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Plant:
    A: np.ndarray  # (n_x, n_x)
    B: np.ndarray  # (n_x, n_u)
    Q: np.ndarray
    R: np.ndarray
    horizon: int
    x_min: np.ndarray
    x_max: np.ndarray
    u_min: np.ndarray
    u_max: np.ndarray
    K_u: np.ndarray  # (r, n_u): K_u u_k = 0 at every stage


@dataclass(frozen=True)
class QP:
    """min 0.5 z'Hz + (F' x0)' z  s.t.  G z <= b0 + E x0."""

    H: np.ndarray
    F: np.ndarray  # (n_x, n_z)
    G: np.ndarray  # (m, n_z)
    b0: np.ndarray  # (m,)
    E: np.ndarray  # (m, n_x)
    n_x: int
    n_u: int


def plant(params: dict) -> Plant:
    """The plant of a configuration file's ``problem`` parameters."""
    n = int(params["n_cells"])
    b = -1.0 / (3600.0 * float(params["cell_capacity_ah"]))
    soc, cur = float(params["soc_limit"]), float(params["current_limit"])
    return Plant(
        A=np.eye(n),
        B=b * np.eye(n),
        Q=float(params["qx_weight"]) * np.eye(n),
        R=float(params["qu_weight"]) * np.eye(n),
        horizon=int(params["horizon"]),
        x_min=np.full(n, -soc),
        x_max=np.full(n, soc),
        u_min=np.full(n, -cur),
        u_max=np.full(n, cur),
        K_u=np.ones((1, n)),
    )


def condense(p: Plant) -> QP:
    """Eliminate the states: x_k = A^k x0 + sum_{j<k} A^(k-1-j) B u_j for
    k = 1..N, so the cost and the constraints are functions of the stacked
    inputs z = (u_0, ..., u_{N-1}) and the parameter x0."""
    n_x, n_u, N = p.A.shape[0], p.B.shape[1], p.horizon
    powers = [np.eye(n_x)]
    for _ in range(N):
        powers.append(p.A @ powers[-1])
    T = np.vstack(powers[1:])  # (N n_x, n_x)
    S = np.zeros((N * n_x, N * n_u))
    for k in range(1, N + 1):
        for j in range(k):
            S[(k - 1) * n_x:k * n_x, j * n_u:(j + 1) * n_u] = powers[k - 1 - j] @ p.B
    Qbar = np.kron(np.eye(N), p.Q)
    H = S.T @ Qbar @ S + np.kron(np.eye(N), p.R)
    H = 0.5 * (H + H.T)
    F = T.T @ Qbar @ S
    I = np.eye(N * n_u)
    K = np.kron(np.eye(N), p.K_u)
    zero_x = np.zeros((K.shape[0], n_x))
    G = np.vstack([I, -I, S, -S, K, -K])
    b0 = np.concatenate([
        np.tile(p.u_max, N), -np.tile(p.u_min, N),
        np.tile(p.x_max, N), -np.tile(p.x_min, N),
        np.zeros(K.shape[0]), np.zeros(K.shape[0]),
    ])
    E = np.vstack([
        np.zeros((2 * N * n_u, n_x)), -T, T, zero_x, zero_x,
    ])
    return QP(H=H, F=F, G=G, b0=b0, E=E, n_x=n_x, n_u=n_u)


def shape(qp: QP) -> dict:
    """The sizes the work law needs. Every row of this stack has its
    negation in it ([I; -I; S; -S; K; -K]), so a half stack holds m / 2
    rows, of which the input box's n_z are the identity."""
    m, n_z = qp.G.shape
    m_half = m // 2
    return {"n_x": qp.n_x, "n_z": n_z, "m_half": m_half,
            "n_struct": m_half - n_z}
