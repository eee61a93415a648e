"""Certified iteration bounds for fixed-count (hard real-time) GPAD.

A copy of ``tpu_gpad.bounds`` (NumPy only, the same code), so the port imports
nothing of the JAX package.

The reference runs Algorithm-2 mode: a fixed iteration budget N_nu certified
offline (``nmpc12-gpad.pdf`` p.4, eqs. (11), (13), (16); the repo itself
hardcodes N_nu = 100, ``main.cu:87``). This module computes such budgets.

Theory: GPAD is Nesterov's accelerated gradient method on the dual
``min_{y>=0} Phi(y)``, whose gradient is L-Lipschitz. With y_0 = 0 and the
theta recursion (theta_nu <= 2/(nu+2)), the standard estimate-sequence bound
gives dual suboptimality

    Phi(y_nu) - Phi* <= 2 L ||y*||^2 / (nu + 1)^2 ,

and the paper's primal bounds inherit the same O(1/nu^2) decay with constants
proportional to L and to Delta = an upper bound on ||y*(p)|| over the
parameter set P. Inverting these for a target (eps_g, eps_V) yields the
budgets below. The constants used here (2 for the dual/cost bound, 8 for the
feasibility bound) follow the accelerated dual gradient-projection analysis
of Patrinos & Bemporad; they are conservative (valid) upper bounds, and
``tests/test_bounds.py`` verifies empirically that the certified budget
always meets the target tolerances on sampled parameters.

Delta itself: ``dual_norm_bound`` computes Delta by exact QP solves at the
vertices of a box parameter set (exact for the bundled problems whose
y*(p) extremes occur at vertices) plus random interior sampling, with a
configurable safety factor; ``dual_norm_bound_milp`` implements the
paper's exact eq.-(16) bound as a big-M KKT MILP (HiGHS).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np

from tpu_gpad_torch.types import CondensedQP


def iterations_for_optimality(L: float, delta: float, eps_V: float) -> int:
    """Smallest nu with 2 L Delta^2 / (nu+1)^2 <= eps_V  (paper eq. (11) form)."""
    return max(0, math.ceil(math.sqrt(2.0 * L / eps_V) * delta) - 1)


def iterations_for_feasibility(L: float, delta: float, eps_g: float) -> int:
    """Smallest nu with 8 L Delta / (nu+1)^2 <= eps_g  (paper eq. (13) form)."""
    return max(0, math.ceil(math.sqrt(8.0 * L * delta / eps_g)) - 1)


def certified_budget(L: float, delta: float, eps_g: float, eps_V: float) -> int:
    """Fixed iteration count guaranteeing BOTH eps_g feasibility and eps_V
    optimality for every parameter with ||y*(p)|| <= delta."""
    return max(
        iterations_for_optimality(L, delta, eps_V),
        iterations_for_feasibility(L, delta, eps_g),
    )


@dataclass
class DualNormBound:
    delta: float  # the certified (safety-scaled) bound on ||y*(p)||_2
    delta_observed: float  # largest ||y*(p)||_2 actually seen
    n_points: int  # parameters probed
    argmax_p: np.ndarray  # parameter achieving delta_observed


def dual_norm_bound(
    qp: CondensedQP,
    p_min: np.ndarray,
    p_max: np.ndarray,
    n_samples: int = 200,
    safety: float = 1.2,
    seed: int = 0,
) -> DualNormBound:
    """Bound Delta >= max_p ||y*(p)||_2 over the box [p_min, p_max].

    Probes every vertex of the box (2^n_x points, capped at 1024) plus
    ``n_samples`` uniform interior samples, solving each QP exactly with the
    active-set ground truth and taking the max multiplier norm, scaled by
    ``safety``. This is the practical replacement for the paper's MILP bound
    (eq. (16)): exact vertex enumeration where the max is attained at a
    vertex, sampled lower bound + safety margin otherwise.
    """
    from tpu_gpad_torch.solver.qp import solve_condensed_qp

    p_min = np.asarray(p_min, dtype=np.float64)
    p_max = np.asarray(p_max, dtype=np.float64)
    n_x = p_min.size
    points = []
    if 2**n_x <= 1024:
        for corner in itertools.product(*zip(p_min, p_max)):
            points.append(np.asarray(corner))
    rng = np.random.default_rng(seed)
    for _ in range(n_samples):
        points.append(rng.uniform(p_min, p_max))

    best = 0.0
    best_p = points[0]
    n_ok = 0
    for p in points:
        sol = solve_condensed_qp(qp, p)
        if sol.status != "optimal":
            continue
        n_ok += 1
        nrm = float(np.linalg.norm(sol.lam))
        if nrm > best:
            best, best_p = nrm, p
    if n_ok == 0:
        raise ValueError("no parameter in the box yielded a solvable QP")
    return DualNormBound(
        delta=safety * best, delta_observed=best, n_points=n_ok, argmax_p=best_p
    )


def dual_norm_bound_milp(
    qp: CondensedQP,
    p_min: np.ndarray,
    p_max: np.ndarray,
    M_y: float | None = None,
    time_limit: float = 120.0,
) -> DualNormBound:
    """The paper's exact bound (``nmpc12-gpad.pdf`` eq. (16)): maximize
    ``||y*(p)||_1`` over the parameter box by encoding the QP's KKT system
    as a big-M mixed-integer linear program (binary delta_i selects whether
    constraint i is active), solved with scipy's HiGHS MILP.

    Since ``||y||_2 <= ||y||_1``, the result is a valid (conservative)
    Delta for the 2-norm-based budget formulas above. Equality-encoded
    +/- row pairs (``K z <= 0`` AND ``-K z <= 0``, where multipliers are
    non-unique and the naive MILP is unbounded) carry an SOS-style
    ``delta_+ + delta_- <= 1`` cut selecting the minimal-norm multiplier,
    matching ``Delta_y(P) = max_p min_{y in Y*(p)} ||y||`` — the quantity
    the paper actually bounds.

    ``M_y``: big-M cap on each multiplier; defaults to 10x the sampled
    bound. The solve is verified not to touch the cap (else raises with
    instructions to increase it). Requires bounded z (input boxes) for the
    slack big-M; raises otherwise.
    """
    from scipy.optimize import Bounds, LinearConstraint, milp
    from scipy import sparse

    from tpu_gpad_torch.condense import find_pairing

    H = np.asarray(qp.H, dtype=np.float64)
    G = np.asarray(qp.G, dtype=np.float64)
    E = np.asarray(qp.E, dtype=np.float64)
    F = np.asarray(qp.F, dtype=np.float64)
    b0 = np.asarray(qp.b0, dtype=np.float64)
    g = np.asarray(qp.g, dtype=np.float64)
    p_min = np.asarray(p_min, dtype=np.float64)
    p_max = np.asarray(p_max, dtype=np.float64)
    m, n = G.shape
    n_x = p_min.size

    # z bounds from the +/-identity rows of G (the input boxes); required
    # for a finite slack big-M
    z_lo = np.full(n, -np.inf)
    z_hi = np.full(n, np.inf)
    for i in range(m):
        row = G[i]
        nz = np.flatnonzero(row)
        if nz.size == 1 and not E[i].any():
            j = int(nz[0])
            if row[j] > 0:
                z_hi[j] = min(z_hi[j], b0[i] / row[j])
            else:
                z_lo[j] = max(z_lo[j], b0[i] / row[j])
    if not (np.isfinite(z_lo).all() and np.isfinite(z_hi).all()):
        raise ValueError(
            "MILP bound needs finite bounds on every z component "
            "(input box constraints); use dual_norm_bound instead"
        )

    # slack big-M per row via interval arithmetic over the z and p boxes
    Gz_lo = np.where(G > 0, G * z_lo, G * z_hi).sum(axis=1)
    Ep_hi = np.where(E > 0, E * p_max, E * p_min).sum(axis=1)
    M_s = b0 + Ep_hi - Gz_lo  # max possible slack per row
    M_s = np.maximum(M_s, 0.0) + 1e-6

    if M_y is None:
        M_y = 10.0 * max(
            dual_norm_bound(qp, p_min, p_max, n_samples=50).delta, 1.0
        )

    # variable vector x = [z (n), y (m), p (n_x), delta (m)]
    nv = n + m + n_x + m
    sl_z, sl_y = slice(0, n), slice(n, n + m)
    sl_p, sl_d = slice(n + m, n + m + n_x), slice(n + m + n_x, nv)

    cons = []
    # stationarity: H z + G' y + F' p = -g
    A = np.zeros((n, nv))
    A[:, sl_z] = H
    A[:, sl_y] = G.T
    A[:, sl_p] = F.T
    cons.append(LinearConstraint(sparse.csr_matrix(A), -g, -g))
    # primal feasibility: G z - E p <= b0
    A = np.zeros((m, nv))
    A[:, sl_z] = G
    A[:, sl_p] = -E
    cons.append(LinearConstraint(sparse.csr_matrix(A), -np.inf, b0))
    # y_i <= M_y delta_i
    A = np.zeros((m, nv))
    A[:, sl_y] = np.eye(m)
    A[:, sl_d] = -M_y * np.eye(m)
    cons.append(LinearConstraint(sparse.csr_matrix(A), -np.inf, np.zeros(m)))
    # slack_i <= M_s_i (1 - delta_i):  -G z + E p + M_s delta <= M_s - b0
    A = np.zeros((m, nv))
    A[:, sl_z] = -G
    A[:, sl_p] = E
    A[:, sl_d] = np.diag(M_s)
    cons.append(LinearConstraint(sparse.csr_matrix(A), -np.inf, M_s - b0))
    # minimal-norm multiplier cut for +/- pairs
    pairing = find_pairing(qp.G)
    if pairing is not None:
        idx_p, idx_m = pairing
        A = np.zeros((idx_p.size, nv))
        for r, (i, j) in enumerate(zip(idx_p, idx_m)):
            A[r, n + m + n_x + i] = 1.0
            A[r, n + m + n_x + j] = 1.0
        cons.append(
            LinearConstraint(sparse.csr_matrix(A), -np.inf, np.ones(idx_p.size))
        )

    lb = np.concatenate([z_lo, np.zeros(m), p_min, np.zeros(m)])
    ub = np.concatenate([z_hi, np.full(m, M_y), p_max, np.ones(m)])
    c = np.zeros(nv)
    c[sl_y] = -1.0  # maximize sum(y) == ||y||_1
    integrality = np.zeros(nv)
    integrality[sl_d] = 1

    res = milp(
        c=c,
        constraints=cons,
        bounds=Bounds(lb, ub),
        integrality=integrality,
        options={"time_limit": time_limit},
    )
    if not res.success:
        raise RuntimeError(f"MILP bound failed: {res.message}")
    y_star = res.x[sl_y]
    if y_star.max() > 0.999 * M_y:
        raise RuntimeError(
            f"a multiplier hit the big-M cap {M_y}; re-run with a larger M_y"
        )
    delta = float(-res.fun)
    return DualNormBound(
        delta=delta,
        delta_observed=delta,
        n_points=1,
        argmax_p=res.x[sl_p].copy(),
    )


def certify(
    qp: CondensedQP,
    p_min: np.ndarray,
    p_max: np.ndarray,
    eps_g: float = 1e-3,
    eps_V: float = 1e-3,
    lipschitz: str = "spectral_dual",
    method: str = "sampled",
    **bound_kw,
) -> tuple[int, DualNormBound, float]:
    """One-call certification: returns (N_nu, Delta bound, L) for a problem
    over a box parameter set — the offline step producing the Algorithm-2
    fixed budget that the reference hardcodes. ``method``: "sampled"
    (vertex enumeration + interior sampling with a safety factor) or
    "milp" (the paper's exact eq.-(16) bound)."""
    from tpu_gpad_torch.condense import lipschitz_constant

    L = lipschitz_constant(qp, lipschitz)
    if method == "milp":
        dn = dual_norm_bound_milp(qp, p_min, p_max, **bound_kw)
    elif method == "sampled":
        dn = dual_norm_bound(qp, p_min, p_max, **bound_kw)
    else:
        raise ValueError(f"unknown bound method: {method!r}")
    return certified_budget(L, dn.delta, eps_g, eps_V), dn, L
