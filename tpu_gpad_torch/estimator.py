"""State estimation and offset-free MPC (output feedback).

The counterpart of ``tpu_gpad.estimator``. The reference assumes full
state measurement: ``gpad.m:91-93`` propagates the model state and feeds it
straight back into the solver. A production controller measures outputs
``y = C x`` (+ noise) and faces plant/model mismatch; feeding raw model
predictions back leaves a permanent steady-state offset. The standard fix
(Muske & Badgwell 2002, Pannocchia & Rawlings 2003) is the
*disturbance-model* design implemented here:

1. augment the model with an integrating disturbance ``d``::

       x+ = A x + B u + Bd d
       d+ = d
       y  = C x + Cd d

2. estimate ``[x; d]`` with a steady-state Kalman filter,
3. each sample, translate the output setpoint ``r`` and disturbance
   estimate into a steady-state TARGET ``(x_ss, u_ss)``::

       [A - I  B] [x_ss]   [    -Bd d    ]
       [  C    0] [u_ss] = [ r - Cd d    ]

4. run the tracking MPC toward ``(x_ss, u_ss)`` with the disturbance
   INSIDE the prediction model (``x+ = A x + B u + Bd d_hat``) — which
   maps exactly onto ``condense(tracking=True, input_reference=True,
   process_disturbance=True)``: parameter
   ``p = [x_hat; x_ss; u_ss; Bd d_hat]``. Omitting the prediction term
   deadlocks the loop off-target wherever the planned first move happens
   to cancel the true disturbance (the nominal-model plan believes the
   plant will drift; the real plant stands still).

All of this is cheap, host-side float64 linear algebra around the QP
solve on the card; the solve itself is the same ``Controller.step``.
``ExtendedKalmanFilter`` takes torch ``f``/``h`` and their Jacobians from
``torch.func.jacfwd``, in float32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu_gpad_torch.types import LinearMPCProblem
from tpu_gpad_torch.closed_loop import Controller
from tpu_gpad_torch.solver.core import SolverConfig, tf32_matmuls


def kalman_gain(
    A: np.ndarray, C: np.ndarray, W: np.ndarray, V: np.ndarray
) -> np.ndarray:
    """Steady-state Kalman *filter* gain for ``x+ = A x (+w)``, ``y = C x (+v)``.

    ``W``/``V`` are the process/measurement noise covariances. Returns the
    a-posteriori gain ``Lf = P C' (C P C' + V)^-1`` with ``P`` the
    stabilizing solution of the predictor DARE. The filter update is
    ``x_hat = x_pred + Lf (y - C x_pred)``.
    """
    from scipy.linalg import solve_discrete_are

    A = np.asarray(A, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    W = np.asarray(W, dtype=np.float64)
    V = np.asarray(V, dtype=np.float64)
    P = solve_discrete_are(A.T, C.T, W, V)
    S = C @ P @ C.T + V
    return np.linalg.solve(S.T, (P @ C.T).T).T  # P C' S^-1


def augment_disturbance(
    A: np.ndarray,
    B: np.ndarray,
    C: np.ndarray,
    Bd: np.ndarray,
    Cd: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the disturbance-augmented model (Aa, Ba, Ca) over ``[x; d]``.

    Raises if the augmented system is structurally undetectable — the
    well-posedness condition ``rank [I-A  -Bd; C  Cd] = n_x + n_d``
    (Pannocchia & Rawlings 2003, Lemma 1) which caps ``n_d <= n_y`` and
    guarantees the observer can separate state from disturbance.
    """
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    Bd = np.asarray(Bd, dtype=np.float64)
    Cd = np.asarray(Cd, dtype=np.float64)
    n_x = A.shape[0]
    n_d = Bd.shape[1]
    n_y = C.shape[0]
    if Cd.shape != (n_y, n_d):
        raise ValueError(f"Cd must be ({n_y}, {n_d}); got {Cd.shape}")
    test = np.block([[np.eye(n_x) - A, -Bd], [C, Cd]])
    if np.linalg.matrix_rank(test) < n_x + n_d:
        raise ValueError(
            "disturbance model is undetectable: rank [I-A -Bd; C Cd] "
            f"= {np.linalg.matrix_rank(test)} < {n_x + n_d} "
            "(need n_d <= n_y and independent disturbance directions)"
        )
    Aa = np.block([[A, Bd], [np.zeros((n_d, n_x)), np.eye(n_d)]])
    Ba = np.concatenate([B, np.zeros((n_d, B.shape[1]))], axis=0)
    Ca = np.concatenate([C, Cd], axis=1)
    return Aa, Ba, Ca


class KalmanFilter:
    """Steady-state Kalman filter over the disturbance-augmented state.

    ``update(y, u_prev)`` performs predict-then-correct and returns the
    current estimates ``(x_hat, d_hat)``. Host-side float64 — the filter
    is O((n_x+n_d)^2) per sample, negligible next to the QP solve.
    """

    def __init__(
        self,
        A: np.ndarray,
        B: np.ndarray,
        C: np.ndarray,
        Bd: np.ndarray,
        Cd: np.ndarray,
        W: Optional[np.ndarray] = None,
        V: Optional[np.ndarray] = None,
        x0: Optional[np.ndarray] = None,
    ):
        self.n_x = np.asarray(A).shape[0]
        self.n_d = np.asarray(Bd).shape[1]
        self.Aa, self.Ba, self.Ca = augment_disturbance(A, B, C, Bd, Cd)
        n_a = self.n_x + self.n_d
        n_y = self.Ca.shape[0]
        W = np.eye(n_a) * 1e-3 if W is None else np.asarray(W, dtype=np.float64)
        if W.shape == (self.n_x, self.n_x):
            # state-only covariance given: give the disturbance states a
            # slower random walk (1% of the mean state variance) so the
            # integrator keeps adapting without chasing noise
            Wa = np.eye(n_a) * (1e-2 * float(np.trace(W)) / self.n_x)
            Wa[: self.n_x, : self.n_x] = W
            W = Wa
        V = np.eye(n_y) * 1e-4 if V is None else np.asarray(V, dtype=np.float64)
        self.L = kalman_gain(self.Aa, self.Ca, W, V)
        self.xa = np.zeros(n_a) if x0 is None else self._init_state(x0)

    def _init_state(self, x0: np.ndarray) -> np.ndarray:
        x0 = np.asarray(x0, dtype=np.float64).reshape(-1)
        if x0.shape[0] == self.n_x:
            return np.concatenate([x0, np.zeros(self.n_d)])
        if x0.shape[0] == self.n_x + self.n_d:
            return x0.copy()
        raise ValueError(f"x0 must have {self.n_x} or {self.n_x + self.n_d} entries")

    def update(self, y: np.ndarray, u_prev: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One filter step: predict with ``u_prev``, correct with ``y``."""
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        u_prev = np.asarray(u_prev, dtype=np.float64).reshape(-1)
        pred = self.Aa @ self.xa + self.Ba @ u_prev
        self.xa = pred + self.L @ (y - self.Ca @ pred)
        return self.x_hat, self.d_hat

    @property
    def x_hat(self) -> np.ndarray:
        return self.xa[: self.n_x]

    @property
    def d_hat(self) -> np.ndarray:
        return self.xa[self.n_x :]

    def reset(self, x0: Optional[np.ndarray] = None) -> None:
        self.xa = np.zeros_like(self.xa) if x0 is None else self._init_state(x0)


class TargetCalculator:
    """Steady-state target (x_ss, u_ss) from (r, d_hat).

    Solves ``[A-I B; C 0] [x_ss; u_ss] = [-Bd d; r - Cd d]`` — exactly when
    ``n_y == n_u`` (the square case), in the least-squares/minimum-norm
    sense otherwise (pseudo-inverse, precomputed once).
    """

    def __init__(self, A, B, C, Bd, Cd):
        A = np.asarray(A, dtype=np.float64)
        B = np.asarray(B, dtype=np.float64)
        C = np.asarray(C, dtype=np.float64)
        self.Bd = np.asarray(Bd, dtype=np.float64)
        self.Cd = np.asarray(Cd, dtype=np.float64)
        n_x = A.shape[0]
        n_u = B.shape[1]
        M = np.block([[A - np.eye(n_x), B], [C, np.zeros((C.shape[0], n_u))]])
        self.n_x, self.n_u = n_x, n_u
        self.M_pinv = np.linalg.pinv(M)
        # warn-worthy ill-posedness shows up as a rank drop
        self.rank = np.linalg.matrix_rank(M)

    def __call__(self, r: np.ndarray, d_hat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        r = np.asarray(r, dtype=np.float64).reshape(-1)
        d = np.asarray(d_hat, dtype=np.float64).reshape(-1)
        rhs = np.concatenate([-self.Bd @ d, r - self.Cd @ d])
        sol = self.M_pinv @ rhs
        return sol[: self.n_x], sol[self.n_x :]


class OffsetFreeController:
    """Output-feedback MPC with zero steady-state offset.

    Wraps a ``Controller(tracking=True, input_reference=True)`` with a
    disturbance-augmented Kalman filter and a steady-state target
    calculator. Per sample: ``u = step(y, r)`` — measurement in, applied
    move out. The plant model mismatch absorbed by the disturbance
    estimate is re-targeted every sample, which is what removes the offset
    the reference's state-feedback loop would exhibit. ``controller_kw``
    go to the ``Controller`` (``device`` among them: the card by default).

    ``disturbance``: ``"input"`` (``Bd = B, Cd = 0`` — unmeasured actuator
    bias; needs ``n_u <= n_y``), ``"output"`` (``Bd = 0, Cd = I`` —
    measurement/output bias), or an explicit ``(Bd, Cd)`` tuple.
    """

    def __init__(
        self,
        problem: LinearMPCProblem,
        C: np.ndarray,
        disturbance: str | tuple[np.ndarray, np.ndarray] = "output",
        W: Optional[np.ndarray] = None,
        V: Optional[np.ndarray] = None,
        iterations: int = 100,
        config: Optional[SolverConfig] = None,
        x0: Optional[np.ndarray] = None,
        **controller_kw,
    ):
        if problem.is_ltv:
            raise ValueError(
                "OffsetFreeController estimates against a time-invariant "
                "model; re-linearize and rebuild for LTV plants"
            )
        C = np.atleast_2d(np.asarray(C, dtype=np.float64))
        n_y = C.shape[0]
        if disturbance == "input":
            Bd = np.asarray(problem.B, dtype=np.float64)
            Cd = np.zeros((n_y, problem.n_u))
        elif disturbance == "output":
            Bd = np.zeros((problem.n_x, n_y))
            Cd = np.eye(n_y)
        else:
            Bd, Cd = disturbance
        self.filter = KalmanFilter(problem.A, problem.B, C, Bd, Cd, W=W, V=V, x0=x0)
        self.target = TargetCalculator(problem.A, problem.B, C, Bd, Cd)
        self.controller = Controller(
            problem,
            iterations=iterations,
            config=config,
            tracking=True,
            input_reference=True,
            process_disturbance=True,
            **controller_kw,
        )
        self._Bd = np.asarray(Bd, dtype=np.float64)
        self.problem = problem
        self._u_last = np.zeros(problem.n_u)
        self.last_target: tuple[np.ndarray, np.ndarray] | None = None

    def step(self, y: np.ndarray, r: np.ndarray) -> np.ndarray:
        """Measurement ``y`` + output setpoint ``r`` -> applied move ``u``."""
        x_hat, d_hat = self.filter.update(y, self._u_last)
        x_ss, u_ss = self.target(r, d_hat)
        self.last_target = (x_ss, u_ss)
        u = self.controller.step(
            x_hat.astype(np.float32),
            x_ref=x_ss.astype(np.float32),
            u_ref=u_ss.astype(np.float32),
            d=(self._Bd @ d_hat).astype(np.float32),
        )
        self._u_last = np.asarray(u, dtype=np.float64).reshape(-1)
        return u

    def reset(self, x0: Optional[np.ndarray] = None) -> None:
        self.filter.reset(x0)
        self.controller.reset()
        self._u_last = np.zeros(self.problem.n_u)

    @property
    def x_hat(self) -> np.ndarray:
        return self.filter.x_hat

    @property
    def d_hat(self) -> np.ndarray:
        return self.filter.d_hat


class ExtendedKalmanFilter:
    """Time-varying EKF for nonlinear dynamics: the estimation side of
    output-feedback NMPC (as ``tpu_gpad.estimator.ExtendedKalmanFilter``).

    Model: ``x+ = f(x, u) (+ w)``, ``y = h(x) (+ v)`` with ``f``/``h``
    torch functions of 1-d float32 tensors; per sample the Jacobians come
    from ``torch.func.jacfwd`` on ``device`` (the card by default) and the
    covariance recursion runs in host float64 (Joseph-form correction for
    symmetry). Unlike ``KalmanFilter`` (steady-state gain, linear,
    disturbance-augmented) the EKF re-linearizes at the current estimate::

        x_hat = ekf.update(y, u_prev)
        u     = nmpc.step(x_hat, x_ref)

    ``W``/``V``: process/measurement noise covariances (defaults
    1e-3 I / 1e-4 I, matching ``KalmanFilter``).
    """

    def __init__(
        self,
        f,
        h,
        n_x: int,
        n_y: int,
        W: Optional[np.ndarray] = None,
        V: Optional[np.ndarray] = None,
        x0: Optional[np.ndarray] = None,
        P0: Optional[np.ndarray] = None,
        device="cuda",
    ):
        self.f, self.h = f, h
        self.n_x, self.n_y = n_x, n_y
        self.device = torch.device(device)
        self.W = (
            np.eye(n_x) * 1e-3 if W is None else np.asarray(W, dtype=np.float64)
        )
        self.V = (
            np.eye(n_y) * 1e-4 if V is None else np.asarray(V, dtype=np.float64)
        )
        self.x = (
            np.zeros(n_x)
            if x0 is None
            else np.asarray(x0, dtype=np.float64).reshape(n_x)
        )
        self.P = (
            np.eye(n_x) if P0 is None else np.asarray(P0, dtype=np.float64)
        )
        self._x0, self._P0 = self.x.copy(), self.P.copy()

    def _value_and_jac(self, fn, *args):
        """``fn(*args)`` and its Jacobian in the first argument, as float64
        NumPy. TF32 stays off for the user's products and their jacfwd
        duals (the JAX package forces "highest" precision here: a coarse
        Jacobian corrupts the float64 covariance recursion it feeds)."""
        t = [torch.as_tensor(np.asarray(a, np.float32).reshape(-1),
                             device=self.device) for a in args]
        with tf32_matmuls(False):
            val = fn(*t)
            jac = torch.func.jacfwd(fn, argnums=0)(*t)
        return (val.detach().cpu().double().numpy(),
                jac.detach().cpu().double().numpy())

    def update(self, y: np.ndarray, u_prev: np.ndarray) -> np.ndarray:
        """One EKF step: predict through ``f`` with ``u_prev``, correct
        with the measurement ``y``. Returns the state estimate."""
        y = np.asarray(y, dtype=np.float64).reshape(self.n_y)
        x_pred, F = self._value_and_jac(self.f, self.x, u_prev)
        F = F.reshape(self.n_x, self.n_x)
        P_pred = F @ self.P @ F.T + self.W
        hx, H = self._value_and_jac(self.h, x_pred)
        H = H.reshape(self.n_y, self.n_x)
        S = H @ P_pred @ H.T + self.V
        K = np.linalg.solve(S.T, (P_pred @ H.T).T).T  # P H' S^-1
        self.x = x_pred.reshape(self.n_x) + K @ (y - hx.reshape(self.n_y))
        IKH = np.eye(self.n_x) - K @ H
        self.P = IKH @ P_pred @ IKH.T + K @ self.V @ K.T  # Joseph form
        return self.x.copy()

    def reset(self, x0: Optional[np.ndarray] = None) -> None:
        self.x = (
            self._x0.copy()
            if x0 is None
            else np.asarray(x0, dtype=np.float64).reshape(self.n_x)
        )
        self.P = self._P0.copy()
