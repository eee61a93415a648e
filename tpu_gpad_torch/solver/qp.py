"""Exact QP ground truth (the reference's ``quadprog`` cross-check).

A copy of ``tpu_gpad.solver.qp`` (NumPy only, the same code), so the port imports
nothing of the JAX package.

Reference ``Code/MATLAB/gpad.m:88-89`` keeps a (commented) MATLAB
``quadprog`` call as algorithm-level ground truth. This module provides the
same level of the oracle hierarchy (SURVEY.md section 4, level 3) with two
*independent* algorithms — neither shares code with GPAD:

- ``solve_qp_exact``: dense primal active-set method on the KKT system,
  float64, solved to machine precision (the default ground truth);
- ``solve_qp_admm``: OSQP-style ADMM, used as a second opinion / fallback.

Both solve:  minimize 0.5 z' H z + f' z   s.t.  G z <= b   with H ≻ 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class QPSolution:
    z: np.ndarray
    lam: np.ndarray  # dual multipliers for G z <= b (>= 0)
    active: np.ndarray  # indices of active constraints
    iterations: int
    status: str


def _kkt_solve(H, f, G_a, b_a):
    """Equality-constrained QP: min 0.5 z'Hz + f'z s.t. G_a z = b_a."""
    n = H.shape[0]
    k = G_a.shape[0]
    if k == 0:
        return np.linalg.solve(H, -f), np.zeros(0)
    KKT = np.block([[H, G_a.T], [G_a, np.zeros((k, k))]])
    rhs = np.concatenate([-f, b_a])
    sol = np.linalg.solve(KKT, rhs)
    return sol[:n], sol[n:]


def solve_qp_exact(
    H: np.ndarray,
    f: np.ndarray,
    G: np.ndarray,
    b: np.ndarray,
    max_iter: int = 500,
    tol: float = 1e-10,
    z0: np.ndarray | None = None,
) -> QPSolution:
    """Primal active-set method for strictly convex inequality QPs.

    Classic textbook scheme (Nocedal & Wright, Alg. 16.3): start at the
    unconstrained minimizer clipped into feasibility via a blocking-constraint
    line search, then add/drop constraints from the working set until the KKT
    conditions hold. ``z0``: optional (near-feasible) warm-start point,
    e.g. an ADMM phase-1 solution when z = 0 is infeasible.
    """
    H = np.asarray(H, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    G = np.asarray(G, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m, n = G.shape

    # Feasible start: z = 0 is feasible for all bundled problems (b >= 0 when
    # x0 is interior); otherwise back off toward the analytic center cheaply.
    z = np.zeros(n) if z0 is None else np.asarray(z0, dtype=np.float64).copy()
    feas_tol = 1e-9 * (1.0 + np.abs(b).max())
    viol = G @ z - b
    if viol.max() > feas_tol:
        # feasibility restoration: least-squares steps pushing violated rows
        # onto their boundary. The target is the boundary itself (margin 0):
        # equality-encoded +/- row pairs (K z <= 0 AND -K z <= 0) have no
        # strict interior, so pushing strictly inside can never terminate.
        # Rows left within feas_tol of the boundary are accepted — the
        # active-set line search handles boundary starts.
        for _ in range(100):
            V = viol > 0
            dz = np.linalg.lstsq(G[V], -viol[V], rcond=None)[0]
            z = z + dz
            viol = G @ z - b
            if viol.max() <= feas_tol:
                break
        else:
            return QPSolution(z, np.zeros(m), np.zeros(0, int), 0, "infeasible_start")

    W: list[int] = []  # working set
    lam_full = np.zeros(m)
    for it in range(1, max_iter + 1):
        G_a = G[W] if W else np.zeros((0, n))
        b_a = b[W] if W else np.zeros(0)
        # Solve EQP for the step direction from z
        z_eq, lam = _kkt_solve(H, f, G_a, b_a)
        p = z_eq - z
        if np.linalg.norm(p, np.inf) < tol:
            # Stationary on the working set: check multiplier signs
            lam_full[:] = 0.0
            if W:
                lam_full[np.asarray(W)] = lam
            if len(W) == 0 or lam.min() >= -tol:
                return QPSolution(z, np.maximum(lam_full, 0.0), np.asarray(sorted(W)), it, "optimal")
            W.pop(int(np.argmin(lam)))  # drop most negative multiplier
            continue
        # Line search to the nearest blocking constraint not in W
        Gp = G @ p
        mask = Gp > tol
        mask[W] = False
        if mask.any():
            alphas = (b[mask] - G[mask] @ z) / Gp[mask]
            idx = np.flatnonzero(mask)
            amin = alphas.min()
            if amin < 1.0:
                z = z + max(amin, 0.0) * p
                W.append(int(idx[np.argmin(alphas)]))
                continue
        z = z_eq
    return QPSolution(z, lam_full, np.asarray(sorted(W)), max_iter, "max_iter")


def polish(
    qp,
    x0: np.ndarray,
    z: np.ndarray,
    slack_tol: float = 1e-4,
    tol: float = 1e-9,
    max_refine: int = 30,
) -> QPSolution:
    """Active-set polish of a (near-)solution ``z`` to machine precision.

    Identify the active constraints of the accelerator's solution by their
    primal slacks, solve the equality-constrained KKT system in float64 on
    the host, and refine (add violated rows / drop negative-multiplier
    rows) until the KKT conditions hold. Starting from a converged GPAD
    iterate this typically costs ONE dense KKT solve — turning an
    fp32-accuracy device solve into an exact optimum, including on TPU
    where the fp32-highest iteration plateaus ~1e-3 from the fp64 optimum
    on near-degenerate directions (docs/DESIGN.md). No reference analogue
    (the reference never recovers beyond fp32).

    Equality-encoded pairs (the battery problem's charge coupling appears
    as ``K z <= 0`` AND ``-K z <= 0``, ``gpad.m:84-85``) are deduplicated
    to keep the KKT system nonsingular.
    """
    H = np.asarray(qp.H, dtype=np.float64)
    G = np.asarray(qp.G, dtype=np.float64)
    x0 = np.asarray(x0, dtype=np.float64)
    f = qp.F.T @ x0 + qp.g
    b = qp.b0 + qp.E @ x0
    z = np.asarray(z, dtype=np.float64)
    m, n = G.shape

    cur_slack = b - G @ z
    scale = 1.0 + np.abs(b)
    active = list(np.flatnonzero(cur_slack < slack_tol * scale))

    def dedup(idx):
        """Drop rows that are exact negations of earlier kept rows."""
        kept = []
        for i in idx:
            if any(
                np.array_equal(G[i], -G[j]) and b[i] == -b[j] for j in kept
            ):
                continue
            kept.append(i)
        return kept

    lam_full = np.zeros(m)
    for _ in range(max_refine):
        W = dedup(active)
        if len(W) > n:  # over-determined guess: keep the tightest rows,
            # ranked by the CURRENT iterate's slacks (a stale ranking would
            # evict rows just added by the refinement and cycle)
            W = sorted(W, key=lambda i: cur_slack[i])[:n]
        G_a = G[W] if W else np.zeros((0, n))
        b_a = b[W] if W else np.zeros(0)
        try:
            z_new, lam = _kkt_solve(H, f, G_a, b_a)
        except np.linalg.LinAlgError:
            sol = np.linalg.lstsq(
                np.block([[H, G_a.T], [G_a, np.zeros((len(W),) * 2)]]),
                np.concatenate([-f, b_a]),
                rcond=None,
            )[0]
            z_new, lam = sol[:n], sol[n:]
        viol = G @ z_new - b
        cur_slack = -viol
        viol[W] = 0.0
        rel = viol / scale
        if rel.max() > tol:
            active = W + [int(np.argmax(rel))]
            continue
        if len(W) and lam.min() < -tol:
            drop = W[int(np.argmin(lam))]
            active = [i for i in W if i != drop]
            continue
        lam_full[:] = 0.0
        if W:
            lam_full[np.asarray(W)] = np.maximum(lam, 0.0)
        return QPSolution(
            z_new, lam_full, np.asarray(sorted(W)), 1, "optimal"
        )
    # refinement did not settle: fall back to the full exact solver
    sol = solve_qp_exact(H, f, G, b, z0=z)
    if sol.status == "infeasible_start":
        phase1 = solve_qp_admm(H, f, G, b, tol=1e-12)
        sol = solve_qp_exact(H, f, G, b, z0=phase1.z)
    return sol


def certified_optimum(qp, x0, z_hint) -> QPSolution:
    """KKT-certified f64 optimum from a (near-)converged device iterate.

    The exact-oracle entry for LARGE stacks, where the from-scratch
    active-set method needs hundreds of pivots (each a dense KKT solve)
    and silently caps: ``polish`` starting at the accelerator's own
    solution identifies the active set directly and verifies stationarity
    + feasibility + multiplier signs in float64 — when ``status`` is
    "optimal" the returned point IS the optimum (the bundled problems are
    strictly convex: cond(H) ~ 1.2 at the 30x30 flagship, so the
    minimizer is unique). Callers must check ``status`` and skip/flag
    anything else."""
    return polish(qp, np.asarray(x0, np.float64),
                  np.asarray(z_hint, np.float64))


def polish_batch(qp, X0, Z, **kw):
    """Polish a batch: ``X0`` (B, n_x) parameters, ``Z`` (B, n_z) device
    solutions (e.g. ``np.asarray(result.z)``). Returns (Z_exact, statuses);
    rows whose refinement fell back still carry the exact answer."""
    X0 = np.asarray(X0, dtype=np.float64)
    Z = np.asarray(Z, dtype=np.float64)
    out = np.empty_like(Z)
    statuses = []
    for i in range(X0.shape[0]):
        sol = polish(qp, X0[i], Z[i], **kw)
        out[i] = sol.z
        statuses.append(sol.status)
    return out, statuses


def solve_qp_admm(
    H: np.ndarray,
    f: np.ndarray,
    G: np.ndarray,
    b: np.ndarray,
    rho: float = 1.0,
    max_iter: int = 20000,
    tol: float = 1e-10,
) -> QPSolution:
    """OSQP-style ADMM on the splitting  z, s:  G z - s = 0, s <= b."""
    H = np.asarray(H, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    G = np.asarray(G, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m, n = G.shape
    K = H + rho * (G.T @ G)
    K_inv = np.linalg.inv(K)
    z = np.zeros(n)
    s = np.zeros(m)
    u = np.zeros(m)
    it = 0
    for it in range(1, max_iter + 1):
        z = K_inv @ (-f + rho * G.T @ (s - u))
        Gz = G @ z
        s = np.minimum(Gz + u, b)
        r = Gz - s
        u = u + r
        if np.linalg.norm(r, np.inf) < tol and it % 50 == 0:
            # dual residual check
            if np.linalg.norm(rho * G.T @ (s - np.minimum(G @ z + u, b)), np.inf) < 1e2 * tol:
                break
    lam = rho * u
    active = np.flatnonzero(lam > 1e-8)
    return QPSolution(z, np.maximum(lam, 0.0), active, it, "optimal" if it < max_iter else "max_iter")


def solve_condensed_qp(qp, x0, method: str = "active_set",
                       max_iter: int = 500) -> QPSolution:
    """Ground-truth solve of a ``CondensedQP`` at parameter x0.

    When z = 0 is not feasible (e.g. soft-constrained problems with the
    measured state outside the hard box), the active-set method is
    restarted from an ADMM phase-1 point.

    CHECK ``status``: the active-set method adds/drops ONE row per
    iteration, so large stacks can exhaust ``max_iter`` far from the
    optimum — at the 30x30 flagship (m=3660) the default cap returned
    iterates ~0.08-0.10 from the certified optimum while earlier rounds
    read them as solver error (FLAGSHIP_ACCURACY.json post-mortem). For
    big shapes prefer ``certified_optimum`` (polish from a converged
    device iterate: one-to-few f64 KKT solves instead of hundreds of
    active-set pivots)."""
    x0 = np.asarray(x0, dtype=np.float64)
    f = qp.F.T @ x0 + qp.g
    b = qp.b0 + qp.E @ x0
    if method == "active_set":
        sol = solve_qp_exact(qp.H, f, qp.G, b, max_iter=max_iter)
        if sol.status == "infeasible_start":
            phase1 = solve_qp_admm(qp.H, f, qp.G, b, tol=1e-12)
            # pull strictly inside along the worst violations before the
            # crude restoration (ADMM iterates are only feasible in the limit)
            sol = solve_qp_exact(qp.H, f, qp.G, b, z0=phase1.z,
                                 max_iter=max_iter)
            if sol.status == "infeasible_start":
                return phase1
        return sol
    if method == "admm":
        return solve_qp_admm(qp.H, f, qp.G, b)
    raise ValueError(f"unknown method: {method!r}")
