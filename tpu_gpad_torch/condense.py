"""Offline condensation: LTI MPC problem -> condensed QP -> dual GPAD data.

This is the L0 layer of the framework (reference: ``Code/MATLAB/gpad.m:34-85``
builds the prediction matrices, Hessian and constraint stack for the battery
problem; here it is generalized to any ``LinearMPCProblem``).

All of this runs offline in float64 NumPy — conditioning of ``H^-1`` matters
far more than speed here — and only the final ``GPADData`` is cast to the
on-device dtype.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tpu_gpad_torch.types import LinearMPCProblem, CondensedQP, GPADData
from tpu_gpad_torch.schedule import momentum_schedule


def prediction_matrices(A: np.ndarray, B: np.ndarray, N: int) -> tuple[np.ndarray, np.ndarray]:
    """Stacked prediction matrices ``T`` and ``S`` with x = T x0 + S z.

    ``T`` stacks ``A^i`` for i = 1..N (reference ``M_ak``, ``gpad.m:50-52``);
    ``S`` is lower block-triangular with blocks ``A^(i-j) B`` (reference
    ``M_ab``, ``gpad.m:55-63``).
    """
    n_x, n_u = B.shape
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    # powers[i] = A^i, i = 0..N
    powers = [np.eye(n_x)]
    for _ in range(N):
        powers.append(A @ powers[-1])
    T = np.concatenate(powers[1:], axis=0)  # (n_x*N, n_x)
    S = np.zeros((n_x * N, n_u * N))
    for i in range(1, N + 1):  # block row (state x_i)
        for j in range(1, i + 1):  # block col (input u_{j-1})
            S[(i - 1) * n_x : i * n_x, (j - 1) * n_u : j * n_u] = powers[i - j] @ B
    return T, S


def prediction_matrices_ltv(
    A_seq: np.ndarray, B_seq: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Stacked prediction matrices for TIME-VARYING dynamics
    ``x_{k+1} = A_k x_k + B_k u_k`` (k = 0..N-1).

    ``T`` block i (state x_i) is the transition product
    ``Phi(i, 0) = A_{i-1} ... A_0``; ``S`` block (i, j) is
    ``Phi(i, j) B_{j-1}`` with ``Phi(i, i) = I``. Reduces to
    ``prediction_matrices`` when every stage shares (A, B)."""
    A_seq = np.asarray(A_seq, dtype=np.float64)
    B_seq = np.asarray(B_seq, dtype=np.float64)
    N, n_x, _ = A_seq.shape
    n_u = B_seq.shape[-1]
    if B_seq.shape != (N, n_x, n_u):
        raise ValueError(
            f"LTV B must be ({N}, {n_x}, n_u); got {B_seq.shape}"
        )
    T_blocks = []
    S = np.zeros((n_x * N, n_u * N))
    phi = np.eye(n_x)  # Phi(i, 0) running product
    for i in range(1, N + 1):
        phi = A_seq[i - 1] @ phi
        T_blocks.append(phi)
        # Phi(i, j) B_{j-1} for j = 1..i, built by back-accumulating
        acc = np.eye(n_x)  # Phi(i, j) for j = i down to 1
        for j in range(i, 0, -1):
            S[(i - 1) * n_x : i * n_x, (j - 1) * n_u : j * n_u] = acc @ B_seq[j - 1]
            acc = acc @ A_seq[j - 1]
    return np.concatenate(T_blocks, axis=0), S


def blocking_matrix(n_u: int, N: int, M: int) -> np.ndarray:
    """Move-blocking map ``z_full = B z_blocked``: the first M moves are
    free, moves M..N-1 hold the last free move (hold-last blocking)."""
    if not 1 <= M <= N:
        raise ValueError(f"control horizon M={M} must be in [1, {N}]")
    Bm = np.zeros((n_u * N, n_u * M))
    for k in range(N):
        j = min(k, M - 1)
        Bm[k * n_u : (k + 1) * n_u, j * n_u : (j + 1) * n_u] = np.eye(n_u)
    return Bm


def dare_terminal_weight(problem: LinearMPCProblem) -> np.ndarray:
    """The infinite-horizon LQR terminal weight: the stabilizing solution
    of the discrete algebraic Riccati equation for (A, B, Q, R).

    Using it as ``Q_terminal`` makes the finite-horizon MPC cost equal the
    infinite-horizon LQR cost whenever constraints are inactive at the
    tail — the standard recipe for closed-loop stability guarantees. The
    reference weights every stage equally (``gpad.m:76``)."""
    from scipy.linalg import solve_discrete_are

    if problem.is_ltv or np.ndim(problem.Q) == 3 or np.ndim(problem.R) == 3:
        raise ValueError(
            "dare_terminal_weight needs time-invariant dynamics and costs; "
            "for LTV problems pass an explicit Q_terminal (e.g. the DARE "
            "weight of the final-stage linearization)"
        )

    return solve_discrete_are(
        np.asarray(problem.A, dtype=np.float64),
        np.asarray(problem.B, dtype=np.float64),
        np.asarray(problem.Q, dtype=np.float64),
        np.asarray(problem.R, dtype=np.float64),
    )


def _stage_blockdiag(W: np.ndarray, N: int, n: int, name: str) -> np.ndarray:
    """Stack a stage cost weight into its horizon block diagonal.

    ``W`` is (n, n) (shared across stages, the reference's formulation —
    ``gpad.m:76``) or (N, n, n) stacked per stage (time-varying costs,
    e.g. from linearizing a nonlinear cost along a trajectory)."""
    W = np.asarray(W, dtype=np.float64)
    if W.ndim == 2:
        return np.kron(np.eye(N), W)
    if W.shape != (N, n, n):
        raise ValueError(
            f"per-stage {name} must be ({N}, {n}, {n}); got {W.shape}"
        )
    out = np.zeros((N * n, N * n))
    for k in range(N):
        out[k * n : (k + 1) * n, k * n : (k + 1) * n] = W[k]
    return out


def _stage_bounds(v, N: int, n: int, name: str) -> np.ndarray:
    """Stacked box RHS: a constant (n,) bound tiles over the horizon; a
    per-stage (N, n) bound (e.g. tube-MPC constraint tightening,
    ``tpu_gpad.robust.tube_tightened_problem``) ravels in stage order.
    State boxes index stages 1..N, input boxes stages 0..N-1."""
    arr = np.asarray(v, dtype=np.float64)
    if arr.ndim == 1:
        if arr.shape != (n,):
            raise ValueError(f"{name} must be ({n},) or ({N}, {n}); got {arr.shape}")
        return np.tile(arr, N)
    if arr.shape != (N, n):
        raise ValueError(f"{name} must be ({n},) or ({N}, {n}); got {arr.shape}")
    return arr.ravel()


def condense(
    problem: LinearMPCProblem,
    soft_state: float | None = None,
    tracking: bool | str = False,
    control_horizon: int | None = None,
    input_reference: bool = False,
    process_disturbance: bool = False,
) -> CondensedQP:
    """Condense an MPC problem into the parametric QP of ``CondensedQP``.

    Cost: sum_{k=1..N} x_k' Q x_k + sum_{k=0..N-1} u_k' R u_k, which after
    substituting x = T x0 + S z gives H = S' Qbar S + Rbar and F = T' Qbar S
    (reference ``gpad.m:76-77``). Constraint stack rows, in reference order
    (``gpad.m:84-85``): state upper box, state lower box, input upper box,
    input lower box, coupling +, coupling -.

    ``tracking``: if True, the stage cost becomes the setpoint-tracking
    form ``(x_k - r)' Q (x_k - r)`` and the QP's PARAMETER doubles to
    ``p = [x0; r]`` (2*n_x entries): the linear cost gains the term
    ``-(1_N' kron I)' Qbar S`` acting on ``r`` while the constraint RHS is
    r-independent. Everything downstream (dualize, engines, bounds,
    polish, Controller) works unchanged on the extended parameter — solve
    with ``x0 = concat([x, r])``. The constant ``r' Q r`` offset is
    dropped (it does not affect the minimizer). The reference is
    regulation-only (``gpad.m`` drives SoC spreads to zero).

    ``tracking="preview"``: per-stage references — the stage cost is
    ``(x_k - r_k)' Q (x_k - r_k)`` with an INDEPENDENT reference at every
    prediction stage, and the parameter becomes
    ``p = [x0; r_1; ...; r_N]`` (``n_x*(N+1)`` entries, references in
    stage order). This is reference *preview* (a.k.a. trajectory
    tracking): the controller anticipates future setpoint motion instead
    of chasing a constant. The linear cost is ``-(Qbar S)'`` acting on the
    stacked references; with ``Q_terminal`` set, stage N's reference is
    weighted by it, consistently with the quadratic term.

    ``input_reference``: adds an input target to the tracking cost —
    stage cost gains ``(u_k - u_r)' R (u_k - u_r)`` with a single shared
    ``u_r`` appended to the parameter (``n_u`` entries, after the state
    references, before ``u_prev``). Required for offset-free designs
    where the steady-state input is nonzero (``tpu_gpad.estimator``).
    Only meaningful together with ``tracking``; the quadratic term is
    unchanged (the ``u_r' R u_r`` constant is dropped).

    ``process_disturbance``: predictions gain a constant per-stage state
    offset ``c`` — dynamics ``x_{k+1} = A x_k + B u_k + c`` — entering as
    ``n_x`` more parameter entries (after the references, before
    ``u_prev``). ``x = T x0 + S z + S_c c`` with ``S_c`` stacking the
    partial geometric sums ``sum_{j<i} A^j``; ``c`` shifts both the
    tracking cost and the state-box RHS. This is how the offset-free
    controller makes the MPC plan with its disturbance estimate
    (``c = Bd d_hat``, Pannocchia & Rawlings 2003) — without it the loop
    deadlocks off-target wherever the planned first move exactly cancels
    the true disturbance.

    ``soft_state``: if set, the state box constraints are SOFTENED with
    quadratic slack penalties of weight ``soft_state`` — the decision
    vector becomes ``[z; s_up; s_lo]`` with ``S z - s_up <= xmax - T x0``,
    ``-S z - s_lo <= -xmin + T x0``, ``s >= 0``, and cost
    ``+ soft_state/2 (|s_up|^2 + |s_lo|^2)``. The result is a QP of the
    same parametric class, so everything downstream (dualize, engines,
    bounds, polish) works unchanged; the QP stays feasible for ANY x0
    (infeasible hard problems become large-violation soft ones) — a
    standard production-MPC necessity the reference lacks. Input boxes
    and couplings remain hard. Primal recovery is unaffected:
    ``u* = z[:n_u]`` still (slacks sit at the tail of the vector).

    Input rate limits (``problem.du_min``/``du_max``): slew constraints
    ``du_min <= u_k - u_{k-1} <= du_max`` with ``u_{-1}`` = the previously
    applied move. The parameter grows by ``n_u`` trailing entries:
    ``p = [x0; r (if tracking); u_prev]``. ``Controller`` and
    ``closed_loop.simulate`` thread ``u_prev`` automatically; direct
    ``solve_batch`` callers concatenate it themselves.
    """
    N = problem.horizon
    n_x, n_u = problem.n_x, problem.n_u
    n_z = n_u * N
    # O(N^2) host-memory wall, with a redirect (the stage-wise engine is
    # O(N) and exists for exactly this regime): project the dense float64
    # intermediates (S, Qbar, H + the constraint stack) BEFORE allocating.
    # Override with TPU_GPAD_CONDENSE_LIMIT_GB for hosts with more RAM.
    m_stage = 0  # constraint rows per stage -> G and M_G are (N*m_stage, n_z)
    if problem.x_max is not None:
        m_stage += n_x
    if problem.x_min is not None:
        m_stage += n_x
    if problem.H_x is not None:
        m_stage += int(np.asarray(problem.H_x).shape[0])
    if problem.u_max is not None:
        m_stage += n_u
    if problem.u_min is not None:
        m_stage += n_u
    if problem.K_u is not None:
        m_stage += 2 * int(np.asarray(problem.K_u).shape[0])
    if problem.H_u is not None:
        m_stage += int(np.asarray(problem.H_u).shape[0])
    if problem.du_min is not None:
        m_stage += n_u  # slew rows are dense over TWO stages' inputs
    if problem.du_max is not None:
        m_stage += n_u
    est_gb = (
        8.0 * N * N
        * (n_x * n_u + n_x * n_x + n_u * n_u + 2 * m_stage * n_u)
        / 1e9
    )
    limit_gb = float(os.environ.get("TPU_GPAD_CONDENSE_LIMIT_GB", "8"))
    if est_gb > limit_gb:
        from tpu_gpad_torch.stagewise import stagewise_compatible

        ok, why = stagewise_compatible(problem)
        hint = (
            "this problem IS stage-wise compatible: use "
            "tpu_gpad_torch.stagewise.build_stagewise/solve_stagewise (O(N) "
            "memory) or tpu_gpad_torch.stagewise.auto_solver"
            if ok
            else f"the stage-wise engine cannot take it either ({why})"
        )
        raise ValueError(
            f"condensing horizon={N} with n_x={n_x}, n_u={n_u} allocates "
            f"~{est_gb:.1f} GB of dense host matrices (limit "
            f"{limit_gb:.0f} GB; set TPU_GPAD_CONDENSE_LIMIT_GB to "
            f"raise); {hint}"
        )
    if problem.is_ltv:
        if np.asarray(problem.A).shape[0] != N:
            raise ValueError(
                f"LTV A must stack horizon={N} stages; got "
                f"{np.asarray(problem.A).shape}"
            )
        T, S = prediction_matrices_ltv(problem.A, problem.B)
    else:
        T, S = prediction_matrices(problem.A, problem.B, N)

    s_off = None  # (n_x*N,) constant prediction offset from problem.c
    if problem.c is not None:
        # known affine dynamics x_{k+1} = A_k x_k + B_k u_k + c_k: the
        # prediction gains the constant x = T x0 + S z + s_off with
        # off_{k+1} = A_k off_k + c_k (cf. the process_disturbance S_c,
        # which carries the same recurrence for a per-solve PARAMETER)
        c_seq = np.asarray(problem.c, dtype=np.float64)
        if c_seq.ndim == 1:
            c_seq = np.tile(c_seq, (N, 1))
        if c_seq.shape != (N, n_x):
            raise ValueError(
                f"c must be (n_x,) or (N, n_x) = ({N}, {n_x}); got "
                f"{np.asarray(problem.c).shape}"
            )
        A64 = np.asarray(problem.A, dtype=np.float64)
        off, offs = np.zeros(n_x), []
        for k in range(N):
            off = (A64[k] if problem.is_ltv else A64) @ off + c_seq[k]
            offs.append(off)
        s_off = np.concatenate(offs)

    Qbar = _stage_blockdiag(problem.Q, N, n_x, "Q")
    if problem.Q_terminal is not None:
        # replace the last diagonal block: stage-N state weighted by Q_N
        Qbar[(N - 1) * n_x :, (N - 1) * n_x :] = np.asarray(
            problem.Q_terminal, dtype=np.float64
        )
    Rbar = _stage_blockdiag(problem.R, N, n_u, "R")
    H = S.T @ Qbar @ S + Rbar
    H = 0.5 * (H + H.T)  # symmetrize against roundoff
    F = T.T @ Qbar @ S  # (n_x, n_z)
    # constant linear cost: the prediction offset enters every stage cost
    # as (S z)' Qbar s_off (constants in s_off alone are dropped)
    g_vec = np.zeros(n_z) if s_off is None else S.T @ Qbar @ s_off
    if tracking not in (False, True, "preview"):
        raise ValueError(f"tracking must be False, True or 'preview': {tracking!r}")
    if input_reference and not tracking:
        raise ValueError("input_reference requires tracking")
    ref_dim = 0  # extra parameter entries carrying references
    if tracking == "preview":
        # parameter p = [x0; r_1; ...; r_N]: per-stage references enter the
        # linear cost as -(Qbar S)' rbar (expanding (x_k - r_k)' Q (x_k - r_k)
        # stage by stage; Q_terminal, already folded into Qbar, weights r_N)
        F_r = -(Qbar @ S)  # (n_x*N, n_z)
        F = np.concatenate([F, F_r], axis=0)
        ref_dim = n_x * N
    elif tracking:
        # parameter p = [x0; r]: linear cost f(p) = F' x0 + F_r' r with
        # F_r = -(1_N' kron I)' Qbar S (from expanding (x_k - r)' Q (x_k - r))
        ones_kron = np.tile(np.eye(n_x), (N, 1))  # (n_x*N, n_x)
        F_r = -(ones_kron.T @ Qbar @ S)  # (n_x, n_z)
        F = np.concatenate([F, F_r], axis=0)  # (2*n_x, n_z)
        ref_dim = n_x
    if input_reference:
        # shared input target u_r: (u_k - u_r)' R_k (u_k - u_r) contributes
        # the linear term -u_r' R_k u_k at every stage -> F_u = -[R_1 .. R_N]
        # (Rbar's diagonal blocks, so per-stage R weights are honored)
        F_u = -np.concatenate(
            [Rbar[k * n_u : (k + 1) * n_u, k * n_u : (k + 1) * n_u] for k in range(N)],
            axis=1,
        )
        F = np.concatenate([F, F_u], axis=0)
        ref_dim += n_u
    S_c = None
    if process_disturbance:
        # x = T x0 + S z + S_c c: the per-stage offset obeys
        # off_i = A_{i-1} off_{i-1} + c, so block i of S_c follows the
        # recurrence Sc_i = A_{i-1} Sc_{i-1} + I (LTI: sum_{j<i} A^j)
        A64 = np.asarray(problem.A, dtype=np.float64)
        total = np.zeros((n_x, n_x))
        blocks = []
        for k in range(N):
            A_k = A64[k] if problem.is_ltv else A64
            total = A_k @ total + np.eye(n_x)
            blocks.append(total)
        S_c = np.concatenate(blocks, axis=0)  # (n_x*N, n_x)
        # the disturbance shifts predicted states: linear cost gains
        # z' S' Qbar S_c c -> parameter rows F_c = S_c' Qbar S
        F = np.concatenate([F, S_c.T @ Qbar @ S], axis=0)

    G_rows, b_rows, E_rows, c_rows = [], [], [], []

    def add(Gr, br, Er, cr=None):
        G_rows.append(Gr)
        b_rows.append(np.asarray(br, dtype=np.float64))
        E_rows.append(Er)
        c_rows.append(
            np.zeros((Gr.shape[0], n_x)) if cr is None else cr
        )

    if problem.x_max is not None:
        xmax = _stage_bounds(problem.x_max, N, n_x, "x_max")
        if s_off is not None:
            xmax = xmax - s_off
        add(S, xmax, -T, None if S_c is None else -S_c)  # S z <= xmax - T x0 - S_c c
    if problem.x_min is not None:
        xmin = _stage_bounds(problem.x_min, N, n_x, "x_min")
        if s_off is not None:
            xmin = xmin - s_off
        add(-S, -xmin, T, None if S_c is None else S_c)  # -S z <= -xmin + T x0 + S_c c
    I_z = np.eye(n_z)
    if problem.u_max is not None:
        add(I_z, _stage_bounds(problem.u_max, N, n_u, "u_max"), np.zeros((n_z, n_x)))
    if problem.u_min is not None:
        add(-I_z, -_stage_bounds(problem.u_min, N, n_u, "u_min"), np.zeros((n_z, n_x)))
    if problem.K_u is not None:
        K_u = np.asarray(problem.K_u, dtype=np.float64)
        Kbar = np.kron(np.eye(N), K_u)  # (n_c*N, n_z)
        zc = np.zeros(Kbar.shape[0])
        zE = np.zeros((Kbar.shape[0], n_x))
        add(Kbar, zc, zE)
        add(-Kbar, zc, zE)
    # general polytopes (beyond the reference's boxes): one-sided rows, so
    # find_pairing falls back to the dense dual layout unless the user
    # also supplies each row's negation
    if (problem.H_x is None) != (problem.h_x is None):
        raise ValueError("H_x and h_x must be passed together")
    if (problem.H_u is None) != (problem.h_u is None):
        raise ValueError("H_u and h_u must be passed together")
    if problem.H_x is not None:
        Hx = np.asarray(problem.H_x, dtype=np.float64)
        if Hx.ndim != 2 or Hx.shape[1] != n_x:
            raise ValueError(f"H_x must be (q_x, {n_x}); got {Hx.shape}")
        hx = _stage_bounds(problem.h_x, N, Hx.shape[0], "h_x")
        Hbar = np.kron(np.eye(N), Hx)  # (q_x*N, n_x*N)
        if s_off is not None:
            hx = hx - Hbar @ s_off
        # Hbar (T x0 + S z + S_c c) <= hx
        add(Hbar @ S, hx, -(Hbar @ T),
            None if S_c is None else -(Hbar @ S_c))
    if problem.H_u is not None:
        Hu = np.asarray(problem.H_u, dtype=np.float64)
        if Hu.ndim != 2 or Hu.shape[1] != n_u:
            raise ValueError(f"H_u must be (q_u, {n_u}); got {Hu.shape}")
        hu = _stage_bounds(problem.h_u, N, Hu.shape[0], "h_u")
        add(np.kron(np.eye(N), Hu), hu, np.zeros((Hu.shape[0] * N, n_x)))
    # input rate (slew) limits: du_min <= u_k - u_{k-1} <= du_max with
    # u_{-1} = the previously applied move, entering as an extra QP
    # parameter (p gains n_u trailing entries; see the u_prev column
    # append below). Dz is the block-difference map u_k - u_{k-1}
    # (first block row is just u_0). Emitting BOTH sides preserves the
    # paired half-stack layout; a one-sided limit falls back to the
    # dense layout automatically (find_pairing returns None).
    has_rate = problem.du_max is not None or problem.du_min is not None
    rate_blocks: list[tuple[int, float]] = []  # (start row, u_prev sign)
    if has_rate:
        Dz = np.eye(n_z)
        for k in range(1, N):
            Dz[k * n_u : (k + 1) * n_u, (k - 1) * n_u : k * n_u] = -np.eye(n_u)
        zE = np.zeros((n_z, n_x))
        if problem.du_max is not None:
            rate_blocks.append((sum(g.shape[0] for g in G_rows), +1.0))
            add(Dz, np.tile(np.asarray(problem.du_max, dtype=np.float64), N), zE)
        if problem.du_min is not None:
            rate_blocks.append((sum(g.shape[0] for g in G_rows), -1.0))
            add(-Dz, -np.tile(np.asarray(problem.du_min, dtype=np.float64), N), zE)
    if not G_rows:
        raise ValueError("problem has no constraints; GPAD needs at least one")

    G = np.concatenate(G_rows, axis=0)
    b0 = np.concatenate(b_rows, axis=0)
    E = np.concatenate(E_rows, axis=0)
    if control_horizon is not None and not 1 <= control_horizon <= N:
        raise ValueError(
            f"control horizon M={control_horizon} must be in [1, {N}]"
        )
    if control_horizon is not None and control_horizon < N:
        # move blocking: moves M..N-1 hold move M-1. The decision vector
        # shrinks to n_u*M; constraints stay at every stage (the held
        # moves' input-box rows become duplicates of move M-1's — harmless
        # for GPAD, though they may defeat the paired half-stack layout).
        # u* recovery is unchanged: the first blocked move IS u_0.
        Bm = blocking_matrix(n_u, N, control_horizon)
        H = Bm.T @ H @ Bm
        H = 0.5 * (H + H.T)
        F = F @ Bm
        G = G @ Bm
        g_vec = Bm.T @ g_vec
    if ref_dim:
        # the constraint RHS does not depend on the references
        E = np.concatenate([E, np.zeros((E.shape[0], ref_dim))], axis=1)
    param_dim = n_x + ref_dim
    if process_disturbance:
        # disturbance parameter c: state-box rows carry -/+ S_c columns
        E = np.concatenate([E, np.concatenate(c_rows, axis=0)], axis=1)
        param_dim += n_x
    if has_rate:
        # parameter becomes p = [x0; r?; u_prev]: only the FIRST stage of
        # each rate block depends on u_prev (u_0 - u_prev <= du_max gives
        # +I, the lower side -I; stages k >= 1 are parameter-free)
        u_cols = np.zeros((E.shape[0], n_u))
        for start, sign in rate_blocks:
            u_cols[start : start + n_u, :] = sign * np.eye(n_u)
        E = np.concatenate([E, u_cols], axis=1)
        # the cost does not depend on u_prev: zero rows in the F map
        F = np.concatenate([F, np.zeros((n_u, F.shape[1]))], axis=0)
        param_dim += n_u

    if soft_state is not None:
        if soft_state <= 0:
            raise ValueError("soft_state penalty weight must be positive")
        n_up = n_x * N if problem.x_max is not None else 0
        n_lo = n_x * N if problem.x_min is not None else 0
        n_s = n_up + n_lo
        if n_s == 0:
            raise ValueError("soft_state set but the problem has no state box")
        m0 = G.shape[0]
        n_zc = H.shape[0]  # current decision dim (may be move-blocked)
        # extended decision vector [z; s_up; s_lo]
        H = np.block([
            [H, np.zeros((n_zc, n_s))],
            [np.zeros((n_s, n_zc)), soft_state * np.eye(n_s)],
        ])
        F = np.concatenate([F, np.zeros((F.shape[0], n_s))], axis=1)
        # slack columns: -I on the state-box rows (stacked first, in order)
        S_cols = np.zeros((m0, n_s))
        S_cols[:n_up, :n_up] = -np.eye(n_up)
        S_cols[n_up : n_up + n_lo, n_up : n_up + n_lo] = -np.eye(n_lo)
        G = np.concatenate([G, S_cols], axis=1)
        # slack nonnegativity: -s <= 0
        G = np.concatenate(
            [G, np.concatenate(
                [np.zeros((n_s, n_zc)), -np.eye(n_s)], axis=1)],
            axis=0,
        )
        b0 = np.concatenate([b0, np.zeros(n_s)])
        E = np.concatenate([E, np.zeros((n_s, E.shape[1]))], axis=0)
        return CondensedQP(
            H=H,
            F=F,
            g=np.concatenate([g_vec, np.zeros(n_s)]),
            G=G,
            b0=b0,
            E=E,
            n_u=n_u,
            n_x=param_dim,
            horizon=N,
            name=problem.name
            + _suffix(tracking, input_reference, has_rate, process_disturbance)
            + ("_aff" if s_off is not None else "")
            + "_soft",
        )

    return CondensedQP(
        H=H,
        F=F,
        g=g_vec,
        G=G,
        b0=b0,
        E=E,
        n_u=n_u,
        n_x=param_dim,
        horizon=N,
        name=problem.name
        + _suffix(tracking, input_reference, has_rate, process_disturbance)
        + ("_aff" if s_off is not None else ""),
    )


def _suffix(
    tracking, input_reference: bool, has_rate: bool, process_disturbance: bool = False
) -> str:
    return (
        ("_preview" if tracking == "preview" else "_track" if tracking else "")
        + ("_uref" if input_reference else "")
        + ("_dist" if process_disturbance else "")
        + ("_rate" if has_rate else "")
    )


def lipschitz_constant(qp: CondensedQP, mode: str = "spectral_dual") -> float:
    """Lipschitz constant L of the dual gradient.

    The dual Hessian is ``H_d = G H^-1 G'`` (paper eq. (5)); the gradient is
    L-Lipschitz for any L >= lambda_max(H_d).

    - ``"spectral_dual"`` (default): exact lambda_max(H_d) — tightest valid
      constant, fastest convergence.
    - ``"fro_dual"``: ||H_d||_F, the paper's cheap upper bound.
    - ``"reference"``: ||H||_F^2 of the *primal* Hessian — reproduces the
      reference MATLAB (``acceldualgrad.m:11``, a much looser constant; only
      for bit-parity experiments against the reference trajectory).
    """
    if mode == "reference":
        return float(np.linalg.norm(qp.H, "fro") ** 2)
    Hinv_Gt = np.linalg.solve(qp.H, qp.G.T)
    Hd = qp.G @ Hinv_Gt
    if mode == "fro_dual":
        return float(np.linalg.norm(Hd, "fro"))
    if mode == "spectral_dual":
        return float(np.linalg.eigvalsh(0.5 * (Hd + Hd.T))[-1])
    raise ValueError(f"unknown lipschitz mode: {mode!r}")


def find_pairing(G: np.ndarray) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Find a permutation pairing every constraint row with its negation.

    MPC box/coupling stacks have this structure by construction
    (``gpad.m:84-85`` emits [S; -S; I; -I; K; -K]). Returns
    ``(idx_plus, idx_minus)`` with ``G[idx_minus] == -G[idx_plus]`` exactly,
    or None if no perfect pairing exists. Matching is bitwise on the float64
    rows (negated rows are exact negations by construction; +0.0 is
    normalized so sign-of-zero noise cannot break it).
    """
    m = G.shape[0]
    if m % 2:
        return None
    Gn = G + 0.0  # -0.0 -> +0.0
    by_bytes: dict[bytes, list[int]] = {}
    for i in range(m):
        by_bytes.setdefault(Gn[i].tobytes(), []).append(i)
    used = np.zeros(m, dtype=bool)
    plus, minus = [], []
    for i in range(m):
        if used[i]:
            continue
        cand = by_bytes.get((-Gn[i] + 0.0).tobytes(), [])
        j = next((c for c in cand if not used[c] and c != i), None)
        if j is None:
            return None
        used[i] = used[j] = True
        plus.append(i)
        minus.append(j)
    return np.asarray(plus), np.asarray(minus)


def _flat_reorder(P: np.ndarray):
    """Locate the input-box identity block inside the half stack.

    MPC stacks contain the rows ``I z <= u_max`` (reference:
    ``gpad.m:84-85`` emits [S; -S; I; -I; K; -K]; the CUDA "flat" kernels
    exploit exactly this block — ``seq_functions.cpp:5-43``,
    ``kernel_functions.cu:74-109``). Returns ``(order, flip, n_struct)``
    such that reordering the pairs by ``order`` (after swapping the +/-
    sides of pairs marked in ``flip``) puts rows forming EXACTLY the
    identity I_{n_z}, in column order, at the END of the half stack —
    those rows then need no matmul in step 4 (their G_L columns are I/L)
    and their MG_T rows are H^-1 rows. None if no full identity block
    exists."""
    m_h, n_z = P.shape
    if m_h < n_z:
        return None
    col = np.full(m_h, -1)
    sign = np.zeros(m_h)
    for r in range(m_h):
        nz = np.flatnonzero(P[r])
        if nz.size == 1 and abs(P[r, nz[0]]) == 1.0:
            col[r] = nz[0]
            sign[r] = P[r, nz[0]]
    chosen = np.full(n_z, -1)
    for r in range(m_h):
        c = col[r]
        if c >= 0 and chosen[c] < 0:
            chosen[c] = r
    if (chosen < 0).any():
        return None
    is_box = np.zeros(m_h, dtype=bool)
    is_box[chosen] = True
    struct = np.flatnonzero(~is_box)
    order = np.concatenate([struct, chosen])
    flip = sign < 0  # pairs whose canonical + side is -e_j: swap the pair
    return order, flip, int(struct.size)


def dualize(
    qp: CondensedQP,
    iterations: int = 100,
    lipschitz: str = "spectral_dual",
    schedule: str = "paper",
    dtype=torch.float32,
    L: Optional[float] = None,
    paired: bool | str = False,
    device="cuda",
) -> GPADData:
    """Precompute the dual-QP constants consumed by the online solver.

    Reference analogue: ``acceldualgrad.m:20-23`` computes
    ``M_G = H^-1 G'``, ``g_P = H^-1 f'``, ``G_L = G / L``, ``p_D = -b / L``
    per solve; here the x0-dependence is factored into affine maps so a batch
    of scenarios shares all the heavy matrices.

    ``paired``: store the half-stack layout (see ``GPADData``), halving the
    flops/memory of both hot MVPs by exploiting the [P; -P] structure of box
    constraint stacks. ``True`` requires a perfect pairing (ValueError
    otherwise); ``"auto"`` uses it when available.

    ``device``: where the emitted tensors live, the card by default
    (``"cpu"`` asks for the host). The algebra above runs in float64 NumPy
    on the host either way.
    """
    if L is None:
        L = lipschitz_constant(qp, lipschitz)
    gP_map = np.linalg.solve(qp.H, qp.F.T).T  # (n_x, n_z): x0 @ gP_map = H^-1 F' x0
    gP_const = np.linalg.solve(qp.H, qp.g)  # (n_z,)
    theta, beta = momentum_schedule(iterations, schedule)

    pairing = find_pairing(qp.G) if paired else None
    if paired is True and pairing is None:
        raise ValueError(
            f"{qp.name}: constraint stack has no perfect +/- row pairing; "
            "use paired=False"
        )
    use_paired = pairing is not None

    D = None
    n_struct = None
    if use_paired:
        idx_plus, idx_minus = pairing
        P = qp.G[idx_plus]  # (m_h, n_z)
        flat = _flat_reorder(P)
        if flat is not None:
            # flat layout: identity (input-box) rows last, in column order —
            # their GL_T columns are exactly I/L and their MG_T rows are
            # H^-1 rows, so step 4 can skip their matmul columns entirely
            # (the reference's flat-kernel structure, seq_functions.cpp:5-43)
            order, flip, n_struct = flat
            idx_plus, idx_minus = (
                np.where(flip, idx_minus, idx_plus)[order],
                np.where(flip, idx_plus, idx_minus)[order],
            )
            P = qp.G[idx_plus]
            assert np.array_equal(P[n_struct:], np.eye(qp.n_z))
        Hinv_Pt = np.linalg.solve(qp.H, P.T)  # (n_z, m_h)
        MG_T = Hinv_Pt.T
        GL_T = P.T / L
        D = MG_T @ GL_T  # (m_h, m_h) = P H^-1 P' / L, the scaled dual Hessian
        # dual-sized quantities in (2, m_h) layout: row 0 = +P, row 1 = -P
        pD_map = np.stack([-qp.E[idx_plus].T / L, -qp.E[idx_minus].T / L], axis=1)
        pD_const = np.stack([-qp.b0[idx_plus] / L, -qp.b0[idx_minus] / L], axis=0)
    else:
        MG_T = np.linalg.solve(qp.H, qp.G.T).T  # (m, n_z)
        GL_T = qp.G.T / L  # (n_z, m)
        pD_map = -qp.E.T / L  # (n_x, m)
        pD_const = -qp.b0 / L  # (m,)

    def t(a, dt=dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return GPADData(
        MG_T=t(MG_T),
        GL_T=t(GL_T),
        gP_map=t(gP_map),
        gP_const=t(gP_const),
        pD_map=t(pD_map),
        pD_const=t(pD_const),
        D=None if D is None else t(D),
        L=t(L, torch.float32),
        theta=t(theta, torch.float32),
        beta=t(beta, torch.float32),
        n_u=qp.n_u,
        n_x=qp.n_x,
        horizon=qp.horizon,
        name=qp.name,
        paired=use_paired,
        n_struct=n_struct,
    )
