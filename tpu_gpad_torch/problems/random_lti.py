"""Random constrained LTI plants for hardening/property tests.

The reference only ever exercises the battery problem (SURVEY.md C1); a
general framework must hold up on arbitrary plants. ``random_lti`` draws a
Schur-stable A, full-rank B, random SPD costs, and box constraints sized so
a box of initial states yields feasible QPs with a mix of active/inactive
constraints — the regime where dual methods earn their keep.
"""

from __future__ import annotations

import numpy as np

from tpu_gpad_torch.types import LinearMPCProblem


def random_lti(
    n_x: int = 4,
    n_u: int = 2,
    horizon: int = 8,
    seed: int = 0,
    rho: float = 0.95,
    coupled: bool = False,
) -> LinearMPCProblem:
    """A random Schur-stable constrained LTI MPC problem.

    ``rho``: spectral radius of A (stable < 1). ``coupled=True`` adds a
    sum-of-inputs-equals-zero stage coupling like the battery problem's
    charge conservation (``gpad.m:44``).
    """
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_x, n_x))
    A *= rho / max(np.abs(np.linalg.eigvals(A)).max(), 1e-9)
    B = rng.normal(size=(n_x, n_u))
    # SPD costs with random scales per dimension
    qd = rng.uniform(0.5, 5.0, n_x)
    rd = rng.uniform(0.1, 2.0, n_u)
    return LinearMPCProblem(
        A=A,
        B=B,
        Q=np.diag(qd),
        R=np.diag(rd),
        horizon=horizon,
        x_min=np.full(n_x, -4.0),
        x_max=np.full(n_x, 4.0),
        u_min=np.full(n_u, -1.0),
        u_max=np.full(n_u, 1.0),
        K_u=np.ones((1, n_u)) if coupled else None,
        name=f"random_lti_s{seed}_n{n_x}x{n_u}_N{horizon}",
    )


def random_ltv(
    n_x: int = 4,
    n_u: int = 2,
    horizon: int = 8,
    seed: int = 0,
    rho: float = 0.95,
    drift: float = 0.3,
) -> LinearMPCProblem:
    """A random TIME-VARYING plant: per-stage (A_k, B_k) drifting smoothly
    from a stable base pair — the shape successive linearization of a
    nonlinear plant along a trajectory produces. ``drift`` scales the
    per-stage perturbation (0 reduces to a stacked copy of one LTI pair)."""
    rng = np.random.default_rng(seed)
    A0 = rng.normal(size=(n_x, n_x))
    A0 *= rho / max(np.abs(np.linalg.eigvals(A0)).max(), 1e-9)
    B0 = rng.normal(size=(n_x, n_u))
    ks = np.arange(horizon)[:, None, None] / max(horizon - 1, 1)
    A = A0 + drift * ks * rng.normal(size=(n_x, n_x)) / np.sqrt(n_x)
    B = B0 + drift * ks * rng.normal(size=(n_x, n_u)) / np.sqrt(n_x)
    qd = rng.uniform(0.5, 5.0, n_x)
    rd = rng.uniform(0.1, 2.0, n_u)
    return LinearMPCProblem(
        A=A,
        B=B,
        Q=np.diag(qd),
        R=np.diag(rd),
        horizon=horizon,
        x_min=np.full(n_x, -4.0),
        x_max=np.full(n_x, 4.0),
        u_min=np.full(n_u, -1.0),
        u_max=np.full(n_u, 1.0),
        name=f"random_ltv_s{seed}_n{n_x}x{n_u}_N{horizon}",
    )
