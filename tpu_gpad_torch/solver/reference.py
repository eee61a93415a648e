"""Pure-NumPy GPAD oracle.

This is the in-repo ground truth, functionally replacing the reference's CPU
baselines: the per-step functions mirror the *behavior* of
``Code/CUDA/FinalProject/src/seq_functions.cpp`` (dense variants) and the
full loop mirrors ``Code/MATLAB/acceldualgrad.m``. Everything is float32 to
match the numerics the device solvers produce.

Sign convention note (SURVEY.md section 0): the canonical step 2 is
``zhat = -M_G w - g_P`` (MATLAB/paper). The reference CUDA kernel computes
``+M_G w - g_P`` against a pre-negated M_G (``kernel_functions.cu:62``);
``step2(..., negated_mg=True)`` reproduces that convention for fixture
parity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_gpad_torch.schedule import momentum_schedule


def step1(y: np.ndarray, y_prev: np.ndarray, beta: float) -> np.ndarray:
    """w = y + beta (y - y_prev). Reference: seq_functions.cpp:45-51."""
    return (y + beta * (y - y_prev)).astype(np.float32)


def step2(M_G: np.ndarray, w: np.ndarray, g_P: np.ndarray, negated_mg: bool = False) -> np.ndarray:
    """zhat = -M_G w - g_P (canonical) or +M_G w - g_P (CUDA convention).

    Reference: acceldualgrad.m:46 (canonical); seq_functions.cpp:54-66 and
    kernel_functions.cu:62 (pre-negated input convention)."""
    s = 1.0 if negated_mg else -1.0
    return (s * (M_G @ w) - g_P).astype(np.float32)


def step3(z_prev: np.ndarray, zhat: np.ndarray, theta: float) -> np.ndarray:
    """z = (1 - theta) z_prev + theta zhat. Reference: seq_functions.cpp:68-72."""
    return ((1.0 - theta) * z_prev + theta * zhat).astype(np.float32)


def step4(G_L: np.ndarray, w: np.ndarray, p_D: np.ndarray, zhat: np.ndarray) -> np.ndarray:
    """y+ = max(w + G_L zhat + p_D, 0). Reference: seq_functions.cpp:75-87."""
    raw = w + G_L @ zhat + p_D
    return np.maximum(raw, 0.0).astype(np.float32)


@dataclass
class OracleResult:
    u: np.ndarray
    z: np.ndarray
    y: np.ndarray
    iterations: int
    residual: float
    # per-iteration max primal infeasibility of z (unscaled), recorded when
    # ``history=True`` — the convergence-curve data behind the cookbook's
    # per-step analysis plots (ECE_5770_GPAD_Cookbook.pdf p.5)
    residual_history: np.ndarray | None = None


def gpad_solve(
    M_G: np.ndarray,
    g_P: np.ndarray,
    G_L: np.ndarray,
    p_D: np.ndarray,
    n_u: int,
    iterations: int = 100,
    theta: np.ndarray | None = None,
    beta: np.ndarray | None = None,
    schedule: str = "paper",
    negated_mg: bool = False,
    L: float | None = None,
    eps_g: float | None = None,
    eps_V: float | None = None,
    check_every: int = 1,
    restart: bool = False,
    history: bool = False,
) -> OracleResult:
    """Full GPAD loop on raw dual constants (reference acceldualgrad.m:39-64).

    If ``eps_g``/``eps_V`` are given, runs the epsilon-termination test of
    the paper's Algorithm 1 (the commented-out block at
    ``acceldualgrad.m:66-79``) every ``check_every`` iterations; otherwise
    runs the fixed budget (Algorithm 2 mode, the only mode the reference
    enables). The feasibility residual is recovered from the scaled
    quantities as g(z) = L * (G_L z + p_D), so ``L`` is required for
    epsilon mode.

    ``restart=True`` enables O'Donoghue-Candes gradient-based adaptive
    restart (no reference analogue): when the momentum direction opposes
    the projected-gradient step, i.e. (w - y+) . (y+ - y) > 0, the theta
    recursion resets to 1 and the extrapolation is cleared. On the bundled
    MPC duals this turns the O(1/k^2) tail into effectively linear
    convergence (machine precision within ~100 iterations where the plain
    schedule reaches ~1e-3). The momentum scalars are then computed on the
    fly (the shipped theta/beta arrays are ignored), and the certified
    iteration bounds of ``tpu_gpad.bounds`` no longer apply.
    """
    M_G = np.asarray(M_G, dtype=np.float32)
    g_P = np.asarray(g_P, dtype=np.float32)
    G_L = np.asarray(G_L, dtype=np.float32)
    p_D = np.asarray(p_D, dtype=np.float32)
    n_z = M_G.shape[0]
    m = G_L.shape[0]
    if theta is None or beta is None:
        theta, beta = momentum_schedule(iterations, schedule)

    y = np.zeros(m, dtype=np.float32)
    y_prev = np.zeros(m, dtype=np.float32)
    z = np.zeros(n_z, dtype=np.float32)
    eps_mode = eps_g is not None and eps_V is not None
    if eps_mode and L is None:
        raise ValueError("epsilon termination needs L to unscale the residual")

    niter = iterations
    th = th_prev = 1.0  # on-the-fly recursion state (restart mode)
    hist = [] if history else None
    for k in range(iterations):
        if restart:
            theta_k = th
            beta_k = th * (1.0 / th_prev - 1.0)
        else:
            theta_k, beta_k = float(theta[k]), float(beta[k])
        w = step1(y, y_prev, beta_k)
        zhat = step2(M_G, w, g_P, negated_mg=negated_mg)
        z = step3(z, zhat, theta_k)
        y_next = step4(G_L, w, p_D, zhat)
        if hist is not None:
            scale = L if L is not None else 1.0
            hist.append(float(np.maximum(G_L @ z + p_D, 0.0).max() * scale))
        if restart and float((w - y_next) @ (y_next - y)) > 0.0:
            th = th_prev = 1.0
            y_prev = y = y_next
            continue
        th_prev, th = th, th * (np.sqrt(th * th + 4.0) - th) / 2.0
        y_prev, y = y, y_next
        if eps_mode and (k + 1) % check_every == 0:
            gz = L * (G_L @ z + p_D)  # = G z - b
            gzh = L * (G_L @ zhat + p_D)
            gap = -float(w @ gzh)
            if gz.max() <= eps_g:
                niter = k + 1
                break
            if gzh.max() <= eps_g and gap <= eps_V:
                # zhat is the eps-optimal point on this branch (paper Alg. 1):
                # it is exactly optimal for the Lagrangian at w, while the
                # averaged z may still be infeasible.
                z = zhat
                niter = k + 1
                break

    residual = float(np.maximum(G_L @ z + p_D, 0.0).max() * (L if L is not None else 1.0))
    return OracleResult(
        u=z[:n_u].copy(), z=z, y=y, iterations=niter, residual=residual,
        residual_history=None if hist is None else np.asarray(hist[:niter]),
    )


def gpad_solve_qp(qp, x0, iterations: int = 100, lipschitz: str = "spectral_dual", schedule: str = "paper", **kw) -> OracleResult:
    """Solve a ``CondensedQP`` at parameter x0 with the NumPy oracle."""
    from tpu_gpad_torch.condense import lipschitz_constant

    L = lipschitz_constant(qp, lipschitz)
    f = qp.F.T @ np.asarray(x0, dtype=np.float64) + qp.g
    b = qp.b0 + qp.E @ np.asarray(x0, dtype=np.float64)
    M_G = np.linalg.solve(qp.H, qp.G.T)
    g_P = np.linalg.solve(qp.H, f)
    return gpad_solve(
        M_G, g_P, qp.G / L, -b / L, qp.n_u,
        iterations=iterations, schedule=schedule, L=L, **kw,
    )
