"""Moving-horizon estimation (MHE): the solver's QP machinery pointed at
state estimation. The counterpart of ``tpu_gpad.mhe``.

MHE is the estimation-side twin of MPC: instead of choosing future inputs
to respect constraints, it chooses the disturbance history that best
explains the last T measurements — subject to KNOWN bounds on states and
disturbances, which a Kalman filter cannot honor. The MAP problem over a
window of T measurements,

    min_{x_0, w}  (x_0 - xbar)' P^-1 (x_0 - xbar)
                + sum_k w_k' W^-1 w_k + sum_k (y_k - C x_k)' V^-1 (y_k - C x_k)
    s.t.          x_{k+1} = A x_k + B u_k + w_k,
                  x_min <= x_k <= x_max,   w_min <= w_k <= w_max,

condenses to exactly the parametric QP this framework already solves
(``CondensedQP``: min 1/2 z'Hz + (F'p + g)'z, G z <= b0 + E p) with
decision z = [x_0; w_0..w_{T-2}] and parameter p = [xbar; y_0..y_{T-1};
u_0..u_{T-2}] — so the whole estimator stack rides the GPAD engines:
the CUDA kernels (the dual kernels under the default restart), warm
starts across window slides, and batched estimation of thousands of
plants/sensor streams per call (``MovingHorizonEstimator.solve_window``).
Long windows take the stage-wise engine (``mhe_stagewise``), whose
measurements ride the runtime ``q_lin``/``c`` parameters of the torch
engine.

Arrival cost: the steady-state *a-priori* covariance P from the predictor
DARE, with ``xbar`` advanced by one steady-state Kalman update as each
measurement leaves the window (the "filtering" arrival cost at steady
state). Consequence, tested in ``tests/test_mhe.py``: with inactive
bounds the MHE estimate equals the steady-state Kalman filter exactly —
and with active bounds it does what the filter cannot.

No reference analogue (the reference has no estimation layer at all);
the QP construction mirrors ``condense.condense``'s prediction-matrix
style (reference anchor ``gpad.m:76-85``) with time running backward.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tpu_gpad_torch.condense import dualize
from tpu_gpad_torch.solver.core import SolverConfig, solve_batch
from tpu_gpad_torch.stagewise import (
    AUTO_STAGEWISE_ABOVE_MB,
    build_stagewise,
    solve_stagewise,
)
from tpu_gpad_torch.types import CondensedQP, LinearMPCProblem


@dataclass(frozen=True)
class MHEStructure:
    """Static byproducts of the MHE condensation needed at solve time."""

    qp: CondensedQP
    M: np.ndarray  # (T*n_x, n_z): stacked states = M z + N_u u_stack
    N_u: np.ndarray  # (T*n_x, (T-1)*n_u)
    window: int
    n_x: int
    n_u: int
    n_y: int


def mhe_qp(
    A: np.ndarray,
    B: np.ndarray,
    C: np.ndarray,
    window: int,
    P_arrival: np.ndarray,
    W: np.ndarray,
    V: np.ndarray,
    x_min: Optional[np.ndarray] = None,
    x_max: Optional[np.ndarray] = None,
    w_min: Optional[np.ndarray] = None,
    w_max: Optional[np.ndarray] = None,
    name: str = "mhe",
) -> MHEStructure:
    """Condense the T-measurement MHE problem into a ``CondensedQP``.

    ``CondensedQP.n_u`` is set to n_x so ``SolveResult.u`` returns the
    window-start estimate x_0*; the current (filtered) estimate is the
    last block of ``M z* + N_u u_stack`` (``MovingHorizonEstimator``
    recovers it). At least one of the four bounds must be given — fully
    unconstrained MAP estimation is a Kalman filter; use that instead."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    C = np.asarray(C, np.float64)
    T = int(window)
    if T < 2:
        raise ValueError("window must be >= 2 (one slide per measurement)")
    n_x, n_u, n_y = A.shape[0], B.shape[1], C.shape[0]
    n_w = (T - 1) * n_x
    n_z = n_x + n_w

    # stacked states X = M z + N_u U:  x_k = A^k x_0
    #   + sum_{j<k} A^{k-1-j} (B u_j + w_j)
    powers = [np.eye(n_x)]
    for _ in range(T - 1):
        powers.append(A @ powers[-1])
    M = np.zeros((T * n_x, n_z))
    N_u = np.zeros((T * n_x, (T - 1) * n_u))
    for k in range(T):
        rows = slice(k * n_x, (k + 1) * n_x)
        M[rows, :n_x] = powers[k]
        for j in range(k):
            M[rows, n_x + j * n_x : n_x + (j + 1) * n_x] = powers[k - 1 - j]
            N_u[rows, j * n_u : (j + 1) * n_u] = powers[k - 1 - j] @ B
    CM = np.kron(np.eye(T), C) @ M  # (T*n_y, n_z)
    CN = np.kron(np.eye(T), C) @ N_u
    Rinv = np.linalg.inv(np.asarray(V, np.float64))
    Rbar = np.kron(np.eye(T), Rinv)
    Pinv = np.linalg.inv(np.asarray(P_arrival, np.float64))
    Winv = np.linalg.inv(np.asarray(W, np.float64))

    H = CM.T @ Rbar @ CM
    H[:n_x, :n_x] += Pinv
    for j in range(T - 1):
        s = slice(n_x + j * n_x, n_x + (j + 1) * n_x)
        H[s, s] += Winv

    # linear cost f = F' p, parameter p = [xbar; Y; U]
    F_xbar = np.zeros((n_x, n_z))
    F_xbar[:, :n_x] = -Pinv  # (Pinv symmetric)
    F_Y = -Rbar @ CM  # (T*n_y, n_z)
    F_U = CN.T @ Rbar @ CM  # ((T-1)*n_u, n_z)
    F = np.concatenate([F_xbar, F_Y, F_U], axis=0)  # (n_p, n_z)
    n_p = F.shape[0]

    # constraints G z <= b0 + E p (paired +/- rows; E acts on the U block)
    G_rows, b_rows, E_rows = [], [], []
    u_cols = slice(n_x + T * n_y, n_p)

    def add(Gr, br, Er=None):
        G_rows.append(Gr)
        b_rows.append(br)
        Eb = np.zeros((Gr.shape[0], n_p))
        if Er is not None:
            Eb[:, u_cols] = Er
        E_rows.append(Eb)

    if x_max is not None or x_min is not None:
        for k in range(T):
            rows = slice(k * n_x, (k + 1) * n_x)
            if x_max is not None:
                add(M[rows], np.broadcast_to(x_max, (n_x,)).astype(float),
                    -N_u[rows])
            if x_min is not None:
                add(-M[rows], -np.broadcast_to(x_min, (n_x,)).astype(float),
                    N_u[rows])
    if w_max is not None or w_min is not None:
        for j in range(T - 1):
            Iw = np.zeros((n_x, n_z))
            Iw[:, n_x + j * n_x : n_x + (j + 1) * n_x] = np.eye(n_x)
            if w_max is not None:
                add(Iw, np.broadcast_to(w_max, (n_x,)).astype(float))
            if w_min is not None:
                add(-Iw, -np.broadcast_to(w_min, (n_x,)).astype(float))
    if not G_rows:
        raise ValueError(
            "unconstrained MHE is a Kalman filter — give at least one of "
            "x_min/x_max/w_min/w_max, or use tpu_gpad_torch.KalmanFilter"
        )

    qp = CondensedQP(
        H=H,
        F=F,
        g=np.zeros(n_z),
        G=np.concatenate(G_rows, axis=0),
        b0=np.concatenate(b_rows, axis=0),
        E=np.concatenate(E_rows, axis=0),
        n_u=n_x,  # SolveResult.u == the window-start estimate x_0*
        n_x=n_p,
        horizon=T,
        name=f"{name}_T{T}",
    )
    return MHEStructure(qp=qp, M=M, N_u=N_u, window=T, n_x=n_x, n_u=n_u,
                        n_y=n_y)


@dataclass(frozen=True)
class StagewiseMHEStructure:
    """Static byproducts of the stage-wise MHE build."""

    data: object  # StagewiseData
    A: np.ndarray
    B: np.ndarray
    CtVinv: np.ndarray  # (n_x, n_y): forms q_lin_k = -(C'V^-1) y_k
    window: int
    n_x: int
    n_u: int
    n_y: int


# Inert bound for the unconstrained window-start shift v (stage 0 of the
# stage-wise MHE problem): rows evaluate to ~-1e30 violation, projecting
# their duals to exactly 0 (finite so 0 * g stays 0, never NaN).
_MHE_FREE_BOUND = 1e30


def mhe_stagewise(
    A: np.ndarray,
    B: np.ndarray,
    C: np.ndarray,
    window: int,
    P_arrival: np.ndarray,
    W: np.ndarray,
    V: np.ndarray,
    x_min: Optional[np.ndarray] = None,
    x_max: Optional[np.ndarray] = None,
    w_min: Optional[np.ndarray] = None,
    w_max: Optional[np.ndarray] = None,
    iterations: int = 200,
    name: str = "mhe",
    device="cuda",
) -> StagewiseMHEStructure:
    """The O(T) stage-wise twin of ``mhe_qp`` for LONG estimation windows.

    ``mhe_qp`` condenses the window — its prediction matrices and
    constraint stack grow O(T^2), the exact wall the stage-wise MPC
    engine removes (docs/DESIGN.md section 11). This maps the same MAP
    problem onto that engine via an affine change of variables: a
    pre-stage chooses the window start, and each later stage's control
    IS the process disturbance —

        stage 0:       x_1 = xbar + v,          cost 1/2 v' P^-1 v
        stage k>=1:    x_{k+1} = A x_k + w_{k-1} + [B u_{k-1}],
                                                 cost 1/2 w' W^-1 w
        every state:   cost 1/2 x' (C'V^-1 C) x - (C'V^-1 y) . x

    so stage-wise state k equals estimation state x_{k-1}, the arrival
    cost is exact (v = x_0 - xbar), the measurement terms ride the
    runtime ``q_lin`` parameter, and the known-input forcing rides the
    runtime ``c`` parameter — per-solve data, like the condensed QP's
    parameter vector p = [xbar; Y; U]. State bounds map verbatim;
    disturbance bounds become input bounds on stages >= 1 (stage 0's v
    is unbounded via inert +/-1e30 rows). Solves run
    ``solve_stagewise(data, xbar, q_lin=..., c=...)``; ``device`` places
    the data, the card by default.

    No reference analogue (the reference has no estimation layer); the
    formulation is the ``nmpc12-gpad.pdf`` p.3 non-condensed variant
    pointed at estimation."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    C = np.asarray(C, np.float64)
    T = int(window)
    if T < 2:
        raise ValueError("window must be >= 2 (one slide per measurement)")
    n_x, n_u, n_y = A.shape[0], B.shape[1], C.shape[0]
    if (x_min is None and x_max is None and w_min is None
            and w_max is None):
        raise ValueError(
            "unconstrained MHE is a Kalman filter — give at least one of "
            "x_min/x_max/w_min/w_max, or use tpu_gpad_torch.KalmanFilter"
        )
    Vinv = np.linalg.inv(np.asarray(V, np.float64))
    Winv = np.linalg.inv(np.asarray(W, np.float64))
    Pinv = np.linalg.inv(np.asarray(P_arrival, np.float64))
    A_seq = np.stack([np.eye(n_x)] + [A] * (T - 1))
    B_seq = np.broadcast_to(np.eye(n_x), (T, n_x, n_x)).copy()
    R_seq = np.stack([Pinv] + [Winv] * (T - 1))
    Q = C.T @ Vinv @ C

    def _u_bounds(wb, sign):
        if wb is None and x_min is None and x_max is None:
            return None  # w truly unbounded AND x rows exist elsewhere
        free = sign * _MHE_FREE_BOUND * np.ones(n_x)
        rows = [free]
        wrow = (
            free
            if wb is None
            else np.broadcast_to(np.asarray(wb, float), (n_x,))
        )
        rows += [wrow] * (T - 1)
        return np.stack(rows)

    problem = LinearMPCProblem(
        A=A_seq,
        B=B_seq,
        Q=Q,
        R=R_seq,
        horizon=T,
        x_min=None if x_min is None else np.asarray(x_min, float),
        x_max=None if x_max is None else np.asarray(x_max, float),
        u_min=_u_bounds(w_min, -1.0),
        u_max=_u_bounds(w_max, +1.0),
        name=f"{name}_sw_T{T}",
    )
    data = build_stagewise(problem, iterations=iterations, device=device)
    return StagewiseMHEStructure(
        data=data, A=A, B=B, CtVinv=C.T @ Vinv, window=T,
        n_x=n_x, n_u=n_u, n_y=n_y,
    )


def condensed_window_mb(window: int, n_x: int) -> float:
    """Projected MB of the condensed window QP's operands (the two
    (4 T n_x, T n_x) float32 stacks), as ``tpu_gpad.mhe`` reckons it."""
    return 2 * (4 * window * n_x) * (window * n_x) * 4 / 1e6


def auto_engine(window: int, n_x: int) -> str:
    """``engine="auto"`` of ``MovingHorizonEstimator``: "stagewise" past
    the memory backstop ``AUTO_STAGEWISE_ABOVE_MB``, else "condensed".

    Long windows hit the same O(T^2) condensation wall as long MPC
    horizons, but only the memory backstop routes here: the MPC throughput
    crossover (N >= 170) does not transfer to MHE's typically tiny state.
    The 256 MB figure and the routing are the TPU's (MHE_STAGEWISE.json:
    at T=180 n_x=2 the condensed window won, at n_x=30 T=120 the
    stage-wise one); neither is measured on the H100."""
    mb = condensed_window_mb(window, n_x)
    return "stagewise" if mb > AUTO_STAGEWISE_ABOVE_MB else "condensed"


class MovingHorizonEstimator:
    """Streaming constrained state estimation over a sliding window.

    ``update(y, u_prev)`` ingests one measurement (and the input applied
    since the previous one) and returns the current state estimate. Until
    the window fills, estimates come from the steady-state Kalman
    recursion that also advances the arrival state; afterwards every call
    is one warm-started GPAD solve of the window QP.

    ``solve_window(x_bar, Y, U)`` is the batched functional core: B
    independent windows -> one ``solve_batch`` call (condensed, where the
    CUDA kernels run) or one ``solve_stagewise`` call with runtime
    ``q_lin``/``c`` (the torch engine). ``engine``: "auto"
    (``auto_engine``), "condensed" or "stagewise"; ``device`` places the
    data, the card by default."""

    def __init__(
        self,
        A: np.ndarray,
        B: np.ndarray,
        C: np.ndarray,
        window: int,
        W: Optional[np.ndarray] = None,
        V: Optional[np.ndarray] = None,
        x_min=None,
        x_max=None,
        w_min=None,
        w_max=None,
        x0: Optional[np.ndarray] = None,
        iterations: int = 200,
        config: Optional[SolverConfig] = None,
        engine: str = "auto",
        device="cuda",
    ):
        from scipy.linalg import solve_discrete_are

        if engine not in ("auto", "condensed", "stagewise"):
            raise ValueError(
                f"engine must be 'auto', 'condensed' or 'stagewise': "
                f"{engine!r}")
        A = np.asarray(A, np.float64)
        B = np.asarray(B, np.float64)
        C = np.asarray(C, np.float64)
        n_x, n_y = A.shape[0], C.shape[0]
        W = np.eye(n_x) * 1e-3 if W is None else np.asarray(W, np.float64)
        V = np.eye(n_y) * 1e-4 if V is None else np.asarray(V, np.float64)
        # steady-state a-priori covariance (predictor DARE) = the fixed
        # arrival weight; its filter gain advances xbar on window slides
        P = solve_discrete_are(A.T, C.T, W, V)
        S = C @ P @ C.T + V
        self._Lf = np.linalg.solve(S.T, (P @ C.T).T).T  # P C' S^-1
        self._A, self._B, self._C = A, B, C
        if engine == "auto":
            engine = auto_engine(window, n_x)
        self.engine = engine
        if engine == "stagewise":
            self.structure = mhe_stagewise(
                A, B, C, window, P, W, V,
                x_min=x_min, x_max=x_max, w_min=w_min, w_max=w_max,
                iterations=iterations, device=device,
            )
            self.data = self.structure.data
        else:
            self.structure = mhe_qp(
                A, B, C, window, P, W, V,
                x_min=x_min, x_max=x_max, w_min=w_min, w_max=w_max,
            )
            self.data = dualize(
                self.structure.qp, iterations=iterations, paired="auto",
                device=device,
            )
            st = self.structure
            f32 = dict(dtype=torch.float32, device=device)
            self._M_last = torch.as_tensor(st.M[-st.n_x:], **f32)
            self._N_last = torch.as_tensor(st.N_u[-st.n_x:], **f32)
        self.config = config or SolverConfig(
            iterations=iterations, restart=True
        )
        self.x_bar = np.zeros(n_x) if x0 is None else np.asarray(
            x0, np.float64
        ).copy()
        self._ys: deque = deque()
        self._us: deque = deque()
        self._y0 = None  # dual warm start across slides
        self.last_result = None

    # -- batched functional core ----------------------------------------
    def solve_window(self, x_bar, Y, U, y0=None):
        """Solve B window QPs in one call.

        ``x_bar`` (B, n_x) arrival states; ``Y`` (B, T, n_y) measurements;
        ``U`` (B, T-1, n_u) applied inputs (arrays or tensors). Returns
        ``(x_hat, result)`` with ``x_hat`` (B, n_x) the current-state
        (filtered) estimates, a tensor of the data's dtype on its device
        (the stage-wise engine also runs float64 data)."""
        st = self.structure
        f = dict(dtype=self.data.E.dtype if self.engine == "stagewise"
                 else torch.float32, device=self.data.device)
        x_bar = torch.as_tensor(x_bar, **f)
        Y = torch.as_tensor(Y, **f)
        U = torch.as_tensor(U, **f)
        Bn = x_bar.shape[0]
        if self.engine == "stagewise":
            T, n = st.window, st.n_x
            # measurements enter as the runtime linear state cost, the
            # known-input forcing as the runtime dynamics offset
            q_lin = -torch.einsum("xy,bty->btx",
                                  torch.as_tensor(st.CtVinv, **f), Y)
            cb = torch.zeros((Bn, T, n), **f)
            cb[:, 1:] = torch.einsum("xz,btz->btx", torch.as_tensor(st.B, **f),
                                     U)
            res = solve_stagewise(
                st.data, x_bar, q_lin=q_lin, c=cb, config=self.config,
                y0=y0,
            )
            # current estimate = last rolled state of [v; w] from xbar,
            # in float64 on the host as tpu_gpad rolls it
            z = res.z.double().cpu().numpy().reshape(Bn, T, n)
            Un = U.double().cpu().numpy()
            x = x_bar.double().cpu().numpy() + z[:, 0]  # est x_0
            for k in range(1, T):
                x = x @ self._A.T + z[:, k] + Un[:, k - 1] @ self._B.T
            return torch.as_tensor(x, **f), res
        Uf = U.reshape(Bn, -1)
        p = torch.cat([x_bar, Y.reshape(Bn, -1), Uf], dim=1)
        res = solve_batch(self.data, p, config=self.config, y0=y0)
        x_hat = res.z @ self._M_last.T + Uf @ self._N_last.T
        return x_hat, res

    # -- streaming interface ----------------------------------------------
    def _kf_correct(self, x, y):
        """Steady-state Kalman measurement update."""
        return x + self._Lf @ (np.asarray(y, np.float64) - self._C @ x)

    def update(self, y, u_prev=None) -> np.ndarray:
        """Ingest one measurement; return the current state estimate."""
        T = self.structure.window
        if self._ys:
            if u_prev is None:
                raise ValueError("u_prev required after the first sample")
            self._us.append(np.asarray(u_prev, np.float64))
        self._ys.append(np.asarray(y, np.float64))
        if len(self._ys) > T:
            # the oldest measurement leaves the window: advance the
            # arrival state by one steady-state Kalman update + predict
            y_old = self._ys.popleft()
            u_old = self._us.popleft()
            self.x_bar = self._A @ self._kf_correct(self.x_bar, y_old) + (
                self._B @ u_old
            )
        if len(self._ys) < T:
            # window not yet full: pure steady-state Kalman estimate,
            # WITHOUT advancing x_bar (it stays the window-start prior)
            xh = self.x_bar.copy()
            for i, yi in enumerate(self._ys):
                if i > 0:
                    xh = self._A @ xh + self._B @ self._us[i - 1]
                xh = self._kf_correct(xh, yi)
            return xh
        Y = np.stack(self._ys)[None]
        U = (
            np.stack(self._us)[None]
            if self._us
            else np.zeros((1, 0, self.structure.n_u))
        )
        x_hat, res = self.solve_window(
            self.x_bar[None], Y, U, y0=self._y0
        )
        self._y0 = res.y
        self.last_result = res
        return x_hat[0].double().cpu().numpy()
