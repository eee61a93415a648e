"""Multi-scenario (robust) MPC: one QP over several model realizations.

The counterpart of ``tpu_gpad.robust``. Classic scenario-based robust MPC
(Bemporad & Morari's multi-model formulation): given S realizations of the
plant (parametric uncertainty, packaged as S ``LinearMPCProblem``/
``CondensedQP`` instances over the same input/parameter spaces), optimize
ONE first move shared by every scenario while each scenario carries its
own tail plan:

    z~ = [u_0; v^1; ...; v^S],   v^s = [u_1^s; ...; u_{N-1}^s]

    minimize    sum_s w_s * (0.5 z_s' H^s z_s + (F^s' p + g^s)' z_s)
    subject to  G^s z_s <= b0^s + E^s p      for every s
    where       z_s = T_s z~  (selector: shared u_0 block + scenario tail)

The combined problem is again a dense strictly-convex ``CondensedQP``:
``dualize``/``solve_batch``/``Controller.from_qp`` and every engine (the
torch engine, the CUDA kernels, eps mode, restart) work on it unchanged,
and ``SolveResult.u`` is exactly the shared first move. The stage-wise
twin (``scenario_stagewise_problem``) stacks the scenarios as one block
plant for the O(N) engine.

Everything here is offline float64 NumPy assembly returning the port's
types, as ``condense`` is offline; ``scenario_plan`` and
``scenario_stagewise_plans`` also take the solver's tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpu_gpad_torch.types import CondensedQP, LinearMPCProblem


def _selector(n_shared: int, tail: int, s: int, S: int) -> np.ndarray:
    """T_s mapping the stacked decision z~ onto scenario s's plan z_s.

    z~ = [shared (n_shared) | tail^1 | ... | tail^S]; z_s = T_s z~ picks
    the shared block plus tail^s."""
    n_tilde = n_shared + S * tail
    T = np.zeros((n_shared + tail, n_tilde))
    T[:n_shared, :n_shared] = np.eye(n_shared)
    off = n_shared + s * tail
    T[n_shared:, off : off + tail] = np.eye(tail)
    return T


def scenario_qp(
    qps: Sequence[CondensedQP],
    weights: Optional[Sequence[float]] = None,
    n_shared: Optional[int] = None,
    dedupe: bool = True,
) -> CondensedQP:
    """Combine S per-scenario condensed QPs into one robust QP.

    ``n_shared`` is the number of leading decision variables forced equal
    across scenarios (default: ``n_u`` — the applied move, the standard
    non-anticipativity constraint of closed-loop scenario MPC). ``weights``
    are the scenario probabilities/costs (default uniform, normalized).
    ``dedupe`` drops exactly-duplicated constraint rows — the shared-move
    box rows repeat identically in every scenario and would otherwise
    inflate the dual dimension S-fold for those rows.

    All scenarios must agree on (n_u, n_x-parameter, horizon, n_z). The
    result's ``horizon`` is the stacked plan length ``n_z~ / n_u``
    (= 1 + S*(N-1) first-move-sharing scenarios of horizon N); ``u* =
    z~[:n_u]`` remains the applied move, so Controller/solve contracts
    hold unchanged.
    """
    if len(qps) == 0:
        raise ValueError("need at least one scenario QP")
    q0 = qps[0]
    for q in qps[1:]:
        if (q.n_u, q.n_x, q.horizon, q.n_z) != (
            q0.n_u, q0.n_x, q0.horizon, q0.n_z,
        ):
            raise ValueError(
                "scenario QPs must share (n_u, n_x, horizon, n_z); got "
                f"{(q.n_u, q.n_x, q.horizon, q.n_z)} vs "
                f"{(q0.n_u, q0.n_x, q0.horizon, q0.n_z)}"
            )
    S = len(qps)
    if weights is None:
        w = np.full(S, 1.0 / S)
    else:
        w = np.asarray(weights, dtype=np.float64)
        if w.shape != (S,) or (w <= 0).any():
            raise ValueError("weights must be S positive floats")
        w = w / w.sum()
    if n_shared is None:
        n_shared = q0.n_u
    if not 0 < n_shared <= q0.n_z:
        raise ValueError(f"n_shared must be in (0, {q0.n_z}]")
    tail = q0.n_z - n_shared
    n_tilde = n_shared + S * tail

    H = np.zeros((n_tilde, n_tilde))
    F = np.zeros((q0.F.shape[0], n_tilde))
    g = np.zeros(n_tilde)
    G_rows, b_rows, E_rows = [], [], []
    for s, q in enumerate(qps):
        T = _selector(n_shared, tail, s, S)
        H += w[s] * (T.T @ q.H @ T)
        F += w[s] * (q.F @ T)
        g += w[s] * (T.T @ q.g)
        G_rows.append(q.G @ T)
        b_rows.append(np.asarray(q.b0, dtype=np.float64))
        E_rows.append(np.asarray(q.E, dtype=np.float64))
    G = np.concatenate(G_rows, axis=0)
    b0 = np.concatenate(b_rows, axis=0)
    E = np.concatenate(E_rows, axis=0)

    if dedupe:
        # drop rows identical in (G, b0, E) — e.g. the shared-move input
        # boxes, which every scenario contributes verbatim
        stacked = np.concatenate([G, b0[:, None], E], axis=1)
        _, keep = np.unique(stacked, axis=0, return_index=True)
        keep = np.sort(keep)
        G, b0, E = G[keep], b0[keep], E[keep]

    if n_tilde % q0.n_u == 0:
        horizon = n_tilde // q0.n_u
    else:  # n_shared not a multiple of n_u: no consistent stage count
        horizon = q0.horizon
    return CondensedQP(
        H=H,
        F=F,
        g=g,
        G=G,
        b0=b0,
        E=E,
        n_u=q0.n_u,
        n_x=q0.n_x,
        horizon=horizon,
        name=f"scenario[{S}x{q0.name}]",
    )


def _host(z) -> np.ndarray:
    """``z`` as a NumPy array: a tensor (on any device) or an array."""
    if isinstance(z, torch.Tensor):
        return z.detach().cpu().numpy()
    return np.asarray(z)


def scenario_plan(z, s: int, n_u: int, horizon: int, n_scenarios: int,
                  n_shared: Optional[int] = None):
    """Extract scenario ``s``'s full plan (horizon, n_u) from the stacked
    primal ``z`` of a ``scenario_qp`` solve (leading batch dims pass
    through), as NumPy; ``z`` is a tensor or an array. ``horizon``/
    ``n_shared`` refer to the ORIGINAL per-scenario QP (defaults:
    ``n_shared = n_u``)."""
    if n_shared is None:
        n_shared = n_u
    z = _host(z)
    tail = n_u * horizon - n_shared
    off = n_shared + s * tail
    flat = np.concatenate([z[..., :n_shared], z[..., off : off + tail]],
                          axis=-1)
    return flat.reshape(flat.shape[:-1] + (horizon, n_u))


def lqr_gain(problem: LinearMPCProblem) -> np.ndarray:
    """The infinite-horizon LQR feedback K (u = K x) for (A, B, Q, R) —
    the standard tube-MPC ancillary controller. Sign convention: K
    already INCLUDES the minus, i.e. ``A + B K`` is the closed loop."""
    from scipy.linalg import solve_discrete_are

    if problem.is_ltv or np.ndim(problem.Q) == 3 or np.ndim(problem.R) == 3:
        raise ValueError("lqr_gain needs time-invariant dynamics and costs")
    A = np.asarray(problem.A, dtype=np.float64)
    B = np.asarray(problem.B, dtype=np.float64)
    Q = np.asarray(problem.Q, dtype=np.float64)
    R = np.asarray(problem.R, dtype=np.float64)
    P = solve_discrete_are(A, B, Q, R)
    return -np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)


def tube_tightened_problem(
    problem: LinearMPCProblem,
    w_max: np.ndarray,
    K: Optional[np.ndarray] = None,
) -> LinearMPCProblem:
    """Constraint-tightened nominal problem for tube MPC under additive
    box disturbances ``|w_k| <= w_max`` (componentwise).

    Classic Chisci-Rossiter-Zappa tightening: with the ancillary feedback
    ``u = u_nom + K (x - x_nom)`` (pass ``K=lqr_gain(problem)``; ``K=None``
    means no feedback — an open-loop tube, sensible only for stable A),
    the tracking error obeys ``e_{k+1} = (A + B K) e_k + w_k`` from
    ``e_0 = 0``, so componentwise ``|e_k| <= m_k = sum_{j<k} |A_K^j| w_max``.
    Planning the NOMINAL trajectory against boxes tightened by ``m_k``
    (states, stages 1..N) and ``|K| m_k`` (inputs, stages 0..N-1)
    guarantees the TRUE trajectory under any admissible disturbance
    satisfies the original constraints. Returns a new problem with
    per-stage bounds (condense handles (N, n)-shaped boxes); raises if
    the tube outgrows a box within the horizon (the problem would be
    infeasible for every x0).

    The closed-loop law to APPLY is ``u = u_mpc + K (x_measured -
    x_nominal)``; re-planning from the measured state each sample (as
    ``Controller`` does) is simpler and inherits the same guarantee
    one step ahead. Robustness beyond the reference's nominal-only
    formulation; complements ``scenario_qp`` (parametric uncertainty)
    with additive-disturbance uncertainty.

    With a nonzero ``K`` the applied input differs from the nominal plan
    by ``K e_k``, which would also perturb rate (du) and coupling (K_u)
    constraints — those rows are NOT tightened here, so the function
    raises rather than hand back a vacuous guarantee. ``K=None`` applies
    the nominal input verbatim, so du/K_u constraints hold exactly and
    remain allowed."""
    if problem.is_ltv:
        raise ValueError("tube tightening needs time-invariant dynamics")
    if K is not None and (
        problem.du_min is not None
        or problem.du_max is not None
        or problem.K_u is not None
    ):
        raise ValueError(
            "tube feedback K perturbs the applied input by K e_k, which "
            "this tightening does not propagate into du_min/du_max/K_u "
            "rows — use K=None (open-loop tube) for rate-limited or "
            "input-coupled problems"
        )
    N = problem.horizon
    n_x, n_u = problem.n_x, problem.n_u
    w = np.asarray(w_max, dtype=np.float64)
    if w.shape != (n_x,) or (w < 0).any():
        raise ValueError(f"w_max must be ({n_x},) nonnegative; got {w.shape}")
    A = np.asarray(problem.A, dtype=np.float64)
    if K is None:
        K_arr = np.zeros((n_u, n_x))
    else:
        K_arr = np.asarray(K, dtype=np.float64)
        if K_arr.shape != (n_u, n_x):
            raise ValueError(f"K must be ({n_u}, {n_x}); got {K_arr.shape}")
    A_K = A + np.asarray(problem.B, dtype=np.float64) @ K_arr

    # m_k = sum_{j<k} |A_K^j| w componentwise, k = 1..N
    m = np.zeros((N + 1, n_x))
    P_j = np.eye(n_x)
    for k in range(1, N + 1):
        m[k] = m[k - 1] + np.abs(P_j) @ w
        P_j = A_K @ P_j
    abs_K = np.abs(K_arr)

    def tighten(bound, margin_rows, lower: bool):
        if bound is None:
            return None
        b = np.asarray(bound, dtype=np.float64)
        if b.ndim == 1:
            b = np.tile(b, (N, 1))
        return b + margin_rows if lower else b - margin_rows

    x_margin = m[1 : N + 1]  # state boxes cover stages 1..N
    u_margin = (abs_K @ m[0:N].T).T  # input boxes cover stages 0..N-1
    x_max = tighten(problem.x_max, x_margin, lower=False)
    x_min = tighten(problem.x_min, x_margin, lower=True)
    u_max = tighten(problem.u_max, u_margin, lower=False)
    u_min = tighten(problem.u_min, u_margin, lower=True)
    # state boxes cover stages 1..N, input boxes stages 0..N-1
    for lo, hi, what, k0 in (
        (x_min, x_max, "state", 1), (u_min, u_max, "input", 0)
    ):
        if lo is not None and hi is not None and (lo > hi).any():
            k_bad = int(np.argmax((lo > hi).any(axis=1)))
            raise ValueError(
                f"tube outgrows the {what} box at stage {k_bad + k0}: "
                "shorten the horizon, shrink w_max, or stabilize with K"
            )
    import dataclasses

    return dataclasses.replace(
        problem, x_min=x_min, x_max=x_max, u_min=u_min, u_max=u_max,
        name=f"{problem.name}_tube",
    )


def scenario_stagewise_problem(
    problems: Sequence[LinearMPCProblem],
    weights: Optional[Sequence[float]] = None,
) -> LinearMPCProblem:
    """The stage-wise twin of ``scenario_qp``: S model realizations as
    ONE block plant, solvable by the O(N) stage-wise engine — robust MPC
    past the condensation wall.

    Construction: stack the scenarios into a block-diagonal LTV plant
    (state [x^1; ...; x^S], input [u^1; ...; u^S], per-stage block-diag
    A/B, costs weighted by the scenario probabilities) and encode the
    non-anticipativity constraint (every scenario applies the SAME first
    move) as general-polytope input rows ``u^s_0 - u^1_0 = 0`` (+/-
    pairs) whose per-stage rhs is 0 at stage 0 and an inert 1e30 at
    stages >= 1 — the same free-stage trick as ``mhe_stagewise``. The
    feasible set and objective match the condensed ``scenario_qp``
    exactly (there the shared move is ELIMINATED by a selector; here it
    is equality-constrained — same primal optimum, tested), so
    ``build_stagewise(scenario_stagewise_problem(...))`` +
    ``solve_stagewise(data, tile(x0, S))`` is the long-horizon robust
    stack. Per-scenario plans come out of ``res.z`` with
    ``scenario_stagewise_plans``.

    Scope (v1): constant Q/R (plus optional Q_terminal) per scenario,
    box bounds / K_u couplings / affine offsets supported when present
    in EVERY scenario; per-stage bounds and per-scenario H_x/H_u are
    condensation-path features here."""
    if len(problems) < 2:
        raise ValueError("need at least two scenarios")
    p0 = problems[0]
    n, p, N = p0.n_x, p0.n_u, p0.horizon
    for q in problems[1:]:
        if (q.n_x, q.n_u, q.horizon) != (n, p, N):
            raise ValueError("scenarios must share (n_x, n_u, horizon)")
        if q.H_x is not None or q.H_u is not None:
            raise ValueError(
                "per-scenario H_x/H_u polytopes are condensation-path "
                "features in the stage-wise stack (v1)")
        if q.du_min is not None or q.du_max is not None:
            raise ValueError("rate limits are condensation-path features")
    S = len(problems)
    if weights is None:
        w = np.full(S, 1.0 / S)
    else:
        w = np.asarray(weights, dtype=np.float64)
        if w.shape != (S,) or (w <= 0).any():
            raise ValueError("weights must be S positive floats")
        w = w / w.sum()

    def _stage(M, r, c_):
        M = np.asarray(M, np.float64)
        return (
            M if M.ndim == 3 else np.broadcast_to(M, (N, r, c_))
        ).astype(np.float64)

    A_seq = np.zeros((N, S * n, S * n))
    B_seq = np.zeros((N, S * n, S * p))
    c_seq = None
    for s, q in enumerate(problems):
        A_seq[:, s * n:(s + 1) * n, s * n:(s + 1) * n] = _stage(q.A, n, n)
        B_seq[:, s * n:(s + 1) * n, s * p:(s + 1) * p] = _stage(q.B, n, p)
        if q.c is not None:
            if c_seq is None:
                c_seq = np.zeros((N, S * n))
            cs = np.asarray(q.c, np.float64)
            c_seq[:, s * n:(s + 1) * n] = (
                cs if cs.ndim == 2 else np.broadcast_to(cs, (N, n))
            )

    def _blockdiag(mats):
        sizes = [m.shape for m in mats]
        out = np.zeros((sum(r for r, _ in sizes), sum(c for _, c in sizes)))
        ro = co = 0
        for m in mats:
            out[ro:ro + m.shape[0], co:co + m.shape[1]] = m
            ro += m.shape[0]
            co += m.shape[1]
        return out

    for q in problems:
        if np.ndim(q.Q) == 3 or np.ndim(q.R) == 3:
            raise ValueError(
                "per-stage Q/R are condensation-path features in the "
                "stage-wise scenario stack (v1)")
    Q = _blockdiag([w[s] * np.asarray(q.Q, np.float64)
                    for s, q in enumerate(problems)])
    R = _blockdiag([w[s] * np.asarray(q.R, np.float64)
                    for s, q in enumerate(problems)])
    QT = (
        _blockdiag([
            w[s] * np.asarray(
                q.Q_terminal if q.Q_terminal is not None else q.Q,
                np.float64)
            for s, q in enumerate(problems)
        ])
        if any(q.Q_terminal is not None for q in problems)
        else None
    )

    def _cat_bound(attr, size):
        have = [getattr(q, attr) is not None for q in problems]
        if not any(have):
            return None
        if not all(have):
            raise ValueError(
                f"{attr} must be present in every scenario or none")
        return np.concatenate([
            np.broadcast_to(np.asarray(getattr(q, attr), float), (size,))
            for q in problems
        ])

    x_min = _cat_bound("x_min", n)
    x_max = _cat_bound("x_max", n)
    u_min = _cat_bound("u_min", p)
    u_max = _cat_bound("u_max", p)
    K_u = None
    if any(q.K_u is not None for q in problems):
        if not all(q.K_u is not None for q in problems):
            raise ValueError("K_u must be present in every scenario or none")
        K_u = _blockdiag([np.asarray(q.K_u, float) for q in problems])

    # non-anticipativity: u^s_0 == u^1_0 for s >= 2, as +/- polytope rows
    # live only at stage 0 (inert 1e30 afterwards)
    Hc = np.zeros((2 * (S - 1) * p, S * p))
    for s in range(1, S):
        r = 2 * (s - 1) * p
        Hc[r:r + p, :p] = -np.eye(p)
        Hc[r:r + p, s * p:(s + 1) * p] = np.eye(p)
        Hc[r + p:r + 2 * p, :p] = np.eye(p)
        Hc[r + p:r + 2 * p, s * p:(s + 1) * p] = -np.eye(p)
    h_u = np.full((N, 2 * (S - 1) * p), 1e30)
    h_u[0] = 0.0

    return LinearMPCProblem(
        A=A_seq,
        B=B_seq,
        Q=Q,
        R=R,
        horizon=N,
        x_min=x_min,
        x_max=x_max,
        Q_terminal=QT,
        u_min=u_min,
        u_max=u_max,
        K_u=K_u,
        H_u=Hc,
        h_u=h_u,
        c=c_seq,
        name=f"scenario_sw[{S}x{p0.name}]",
    )


def scenario_stagewise_x0(x0, S: int):
    """Tile the measured state for the S-scenario block plant."""
    x0 = _host(x0)
    return np.concatenate([x0] * S, axis=-1)


def scenario_stagewise_plans(z, S: int, n_u: int, horizon: int):
    """Per-scenario plans (..., S, N, n_u) from the block ``res.z`` (a
    tensor or an array), as NumPy."""
    z = _host(z)
    lead = z.shape[:-1]
    return (
        z.reshape(*lead, horizon, S, n_u).swapaxes(-3, -2)
    )


def scenario_problem_variants(
    problem: LinearMPCProblem,
    A_list: Optional[Sequence[np.ndarray]] = None,
    B_list: Optional[Sequence[np.ndarray]] = None,
) -> list[LinearMPCProblem]:
    """Convenience: clone ``problem`` with per-scenario (A, B) realizations
    (e.g. vertices of an uncertain parameter box). Lengths must match; pass
    None for either to keep the nominal matrices everywhere."""
    import dataclasses

    if A_list is None and B_list is None:
        raise ValueError("pass at least one of A_list/B_list")
    S = len(A_list if A_list is not None else B_list)
    if A_list is not None and B_list is not None and len(A_list) != len(B_list):
        raise ValueError("A_list and B_list must have equal length")
    out = []
    for s in range(S):
        kw = {}
        if A_list is not None:
            kw["A"] = np.asarray(A_list[s], dtype=np.float64)
        if B_list is not None:
            kw["B"] = np.asarray(B_list[s], dtype=np.float64)
        out.append(dataclasses.replace(problem, name=f"{problem.name}_s{s}", **kw))
    return out
