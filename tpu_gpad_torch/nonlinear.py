"""Successive-linearization nonlinear MPC (SL-NMPC) on the LTV condenser,
the counterpart of ``tpu_gpad.nonlinear``.

It turns torch dynamics ``f(x, u) -> x_next`` (a callable on (n_x,) and
(n_u,) tensors that ``torch.func`` transforms accept) into a
receding-horizon controller. Per sample:

1. roll the nominal trajectory from the measured state under the previous
   plan, shifted by one stage (a loop over the N stages on the device);
2. linearize per stage with ``torch.func.vmap(torch.func.jacfwd(f))``,
   giving LTV matrices (A_k, B_k) and the affine residual
   ``c_k = f(xbar_k, ubar_k) - A_k xbar_k - B_k ubar_k`` that makes the
   linear model exact at the nominal trajectory (float32, TF32 off);
3. condense and dualize the affine-LTV QP, on the host in float64
   (``condense``/``dualize``) or with ``device_condense=True`` on the
   device in float32 (``device_condense.dualize_ltv``), and solve it with
   ``solve_batch`` (on the card, the dual kernel under the default
   restart configuration);
4. repeat ``sqp_iters`` times before applying the first move.

With ``device_condense=True`` one pass (rollout, Jacobians, condensation,
dualization, solve) stays on the card from the state to the plan, with the
dual warm start threaded through; ``simulate_nonlinear_device`` runs a
whole closed loop so and copies the trajectory to the host once, at the
end. ``engine="stagewise"`` solves each pass with the O(N) stage-wise
engine (``build_stagewise`` on the host, ``solve_stagewise`` on the card).
``plan_batch`` plans B scenarios, each linearized along its own
trajectory, through ``solver.multi.solve_multi`` (one solve per scenario).

Every entry point takes ``device``, the card by default.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tpu_gpad_torch.closed_loop import pad_reference
from tpu_gpad_torch.condense import condense, dualize
from tpu_gpad_torch.device_condense import (
    dualize_ltv,
    dualize_scenario,
    ltv_constants,
    scenario_constants,
)
from tpu_gpad_torch.solver import SolverConfig, solve_batch
from tpu_gpad_torch.solver.core import tf32_matmuls
from tpu_gpad_torch.solver.multi import solve_multi, stack_data
from tpu_gpad_torch.types import LinearMPCProblem

F32 = torch.float32


def rk4(f: Callable, dt: float) -> Callable:
    """Discretize continuous dynamics ``xdot = f(x, u)`` with one classical
    RK4 step of length ``dt`` (zero-order-hold input)."""

    def step(x, u):
        k1 = f(x, u)
        k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u)
        k4 = f(x + dt * k3, u)
        return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    return step


def _over_leading(f: Callable, n_lead: int) -> Callable:
    """``f`` of one (x, u) pair mapped over ``n_lead`` leading dimensions."""
    for _ in range(n_lead):
        f = torch.func.vmap(f)
    return f


def rollout(f: Callable, x0: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """Roll ``x_{k+1} = f(x_k, u_k)`` from ``x0`` (..., n_x) under the plan
    ``us`` (..., N, n_u); returns the successor states x_1..x_N (..., N,
    n_x). Leading dimensions are scenarios (``torch.func.vmap``)."""
    fb = _over_leading(f, x0.ndim - 1)
    x, xs = x0, []
    with tf32_matmuls(False):
        for k in range(us.shape[-2]):
            x = fb(x, us[..., k, :])
            xs.append(x)
    return torch.stack(xs, dim=-2)


def linearize(f: Callable, xs: torch.Tensor, us: torch.Tensor):
    """Per-stage linearization of ``f`` along a nominal trajectory.

    ``xs`` (..., N, n_x): the linearization states xbar_0..xbar_{N-1};
    ``us`` (..., N, n_u): the nominal inputs. Returns ``(A, B, c)`` of
    shapes (..., N, n_x, n_x), (..., N, n_x, n_u), (..., N, n_x) with
    ``x_{k+1} = A_k x_k + B_k u_k + c_k`` exact at the nominal. One
    vmapped forward-mode sweep; the residual's products run in float32
    with TF32 off (a coarse product would bake a model error into every
    linearization)."""
    lead = xs.shape[:-1]
    n_x, n_u = xs.shape[-1], us.shape[-1]
    xf, uf = xs.reshape(-1, n_x), us.reshape(-1, n_u)
    with tf32_matmuls(False):
        # float32 Jacobians: forward-mode tangents of a product with a
        # Python float may come back in float64 on some torch builds
        A, B = (J.to(xf.dtype) for J in torch.func.vmap(
            torch.func.jacfwd(f, argnums=(0, 1)))(xf, uf))
        fx = torch.func.vmap(f)(xf, uf)
        c = fx - (A @ xf[:, :, None])[:, :, 0] - (B @ uf[:, :, None])[:, :, 0]
    return (A.reshape(*lead, n_x, n_x), B.reshape(*lead, n_x, n_u),
            c.reshape(*lead, n_x))


def _linearize_along(f: Callable, x: torch.Tensor, us: torch.Tensor):
    """Rollout of ``us`` from ``x`` and the linearization along it (the
    front half of every SQP pass); leading dimensions are scenarios."""
    xs_next = rollout(f, x, us)
    xs_lin = torch.cat([x[..., None, :], xs_next[..., :-1, :]], dim=-2)
    return linearize(f, xs_lin, us)


def _host(*tensors):
    """Tensors as float64 NumPy on the host."""
    return [t.detach().cpu().double().numpy() for t in tensors]


def _card_or_raise(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA device and none is "
            "available; pass device='cpu' to run on the host")
    return device


def _with_iterations(config: Optional[SolverConfig], iterations: int):
    """The NMPC default: restart on, the budget ``iterations``."""
    if config is None:
        return SolverConfig(iterations=iterations, restart=True)
    if config.iterations is None:
        return dataclasses.replace(config, iterations=iterations)
    return config


class NMPC:
    """Receding-horizon successive-linearization controller, as
    ``tpu_gpad.nonlinear.NMPC``.

    ``f``: torch discrete dynamics ``f(x, u) -> x_next`` (``rk4(f_cont,
    dt)`` for continuous models). Cost ``sum (x_k - x_ref)' Q (x_k - x_ref)
    + u_k' R u_k`` (plus ``Q_terminal`` at stage N); ``x_ref`` is a per-call
    argument, or with ``preview`` an (N, n_x) window of per-stage
    references. ``sqp_iters`` linearize-solve passes per sample (1: the
    real-time iteration), each moving the plan by ``damping`` of the step.

    The host path condenses each pass in float64 (``lipschitz`` picks the
    bound); ``device_condense=True`` condenses on ``device`` in float32
    (input boxes required; fixed-iteration mode); ``engine="stagewise"``
    solves with the O(N) stage-wise engine (no rate limits, no soft
    state). The solver config defaults to ``SolverConfig(iterations,
    restart=True)``: on the card, the dual kernel. ``plan_batch`` /
    ``step_batch`` plan B scenarios with their own warm starts."""

    def __init__(
        self,
        f: Callable,
        n_x: int,
        n_u: int,
        horizon: int,
        Q: np.ndarray,
        R: np.ndarray,
        Q_terminal: Optional[np.ndarray] = None,
        x_min: Optional[np.ndarray] = None,
        x_max: Optional[np.ndarray] = None,
        u_min: Optional[np.ndarray] = None,
        u_max: Optional[np.ndarray] = None,
        du_min: Optional[np.ndarray] = None,
        du_max: Optional[np.ndarray] = None,
        H_x: Optional[np.ndarray] = None,
        h_x: Optional[np.ndarray] = None,
        H_u: Optional[np.ndarray] = None,
        h_u: Optional[np.ndarray] = None,
        soft_state: Optional[float] = None,
        iterations: int = 200,
        config: Optional[SolverConfig] = None,
        sqp_iters: int = 1,
        damping: float = 1.0,
        lipschitz: str = "spectral_dual",
        warm_start: bool = True,
        preview: bool = False,
        device_condense: bool = False,
        engine: str = "condensed",
        name: str = "nmpc",
        device="cuda",
    ):
        config = _with_iterations(config, iterations)
        if not 0.0 < damping <= 1.0:
            raise ValueError(f"damping must be in (0, 1]: {damping}")
        if sqp_iters < 1:
            raise ValueError(f"sqp_iters must be >= 1: {sqp_iters}")
        self.f = f
        self.n_x, self.n_u, self.horizon = n_x, n_u, horizon
        self.Q = np.asarray(Q, dtype=np.float64)
        self.R = np.asarray(R, dtype=np.float64)
        self.Q_terminal = Q_terminal
        self.bounds = dict(
            x_min=x_min, x_max=x_max, u_min=u_min, u_max=u_max,
            du_min=du_min, du_max=du_max,
            H_x=H_x, h_x=h_x, H_u=H_u, h_u=h_u,
        )
        self.rate = du_min is not None or du_max is not None
        self.soft_state = soft_state
        self.config = config
        self.sqp_iters = sqp_iters
        self.damping = damping
        self.lipschitz = lipschitz
        self.warm_start = warm_start
        self.preview = preview
        self.name = name
        self.device = _card_or_raise(device)
        self._us = None  # previous plan (N, n_u), on the device
        self._y = None  # previous dual iterate (warm start)
        self._u_prev = None  # last applied move (n_u,)
        self._us_b = None  # batch-mode plan (B, N, n_u)
        self._y_b = None
        self._u_prev_b = None
        self.last_result = None

        self.engine = engine
        if engine not in ("condensed", "stagewise"):
            raise ValueError(
                f"engine must be 'condensed' or 'stagewise': {engine!r}")
        if engine == "stagewise":
            if device_condense:
                raise ValueError(
                    "engine='stagewise' and device_condense are exclusive")
            if soft_state is not None:
                raise ValueError(
                    "engine='stagewise' does not take soft_state (a "
                    "condensation-path feature)")
            if self.rate:
                raise ValueError(
                    "engine='stagewise' does not take rate limits (they "
                    "couple adjacent stages; condensation-path feature)")
        self.device_condense = device_condense
        self._consts = None
        if device_condense:
            if u_min is None or u_max is None:
                raise ValueError("device_condense=True needs input boxes")
            if (x_min is None) != (x_max is None):
                raise ValueError(
                    "device_condense=True needs both state bounds or neither"
                )
            if (du_min is None) != (du_max is None):
                raise ValueError(
                    "device_condense=True needs both rate bounds or neither "
                    "(the host path supports one-sided du)"
                )
            if config.mode != "fixed":
                raise ValueError(
                    "device_condense=True supports fixed-iteration mode"
                )
            # everything of the pass but the linearization, uploaded once
            self._consts = ltv_constants(
                horizon, n_x, n_u, self.Q, self.R, u_min, u_max,
                config.iterations, Q_terminal=Q_terminal,
                soft_state=soft_state, preview=preview, name=name,
                device=self.device,
                **{k: v for k, v in self.bounds.items()
                   if k not in ("u_min", "u_max")})
            # the paired dual's rows (polytope rows precede the identity
            # block), read off the constants so they cannot drift apart
            self._m_h = self._consts.m_half

    def _tensor(self, a, shape) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = np.array(a, dtype=np.float32)  # a writable copy
        return torch.as_tensor(a, dtype=F32, device=self.device).reshape(shape)

    def _ref_width(self) -> int:
        return self.horizon * self.n_x if self.preview else self.n_x

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=F32, device=self.device)

    def _device_pass(self, x, us, p, y0):
        """One SQP pass on the device of ``x``: rollout, Jacobians, device
        condensation and dualization, solve with the warm start ``y0``.
        ``x`` (n_x,) and ``us`` (N, n_u) for one plant (``solve_batch``),
        or with a leading scenario axis (``solve_multi``, one solve per
        scenario). Returns (the new plan, the dual iterate, the result);
        nothing leaves the card."""
        A, B, c = _linearize_along(self.f, x, us)
        data = dualize_ltv(self._consts, A, B, c)
        nz = self.n_u * self.horizon
        if x.ndim == 1:
            res = solve_batch(data, p[None], config=self.config, y0=y0[None])
            return res.z[0, :nz].reshape(self.horizon, self.n_u), res.y[0], res
        res = solve_multi(data, p[:, None], config=self.config,
                          y0=y0[:, None])
        return (res.z[:, 0, :nz].reshape(-1, self.horizon, self.n_u),
                res.y[:, 0], res)

    def _problem(self, A, B, c) -> LinearMPCProblem:
        return LinearMPCProblem(
            A=A, B=B, Q=self.Q, R=self.R, horizon=self.horizon,
            Q_terminal=self.Q_terminal, c=c, name=self.name, **self.bounds,
        )

    def _linearized_problem(self, us, x) -> LinearMPCProblem:
        """Linearize along the rollout of ``us`` from ``x`` (the shared front
        half of every host SQP pass: condensed, stage-wise and batch)."""
        return self._problem(*_host(*_linearize_along(self.f, x, us)))

    def _dualize(self, problem: LinearMPCProblem):
        """The host path's float64 condensation and dualization, emitted on
        the controller's device."""
        qp = condense(
            problem,
            tracking="preview" if self.preview else True,
            soft_state=self.soft_state,
        )
        return dualize(
            qp,
            iterations=self.config.iterations,
            paired="auto",
            lipschitz=self.lipschitz,
            device=self.device,
        )

    def _parameter(self, x, x_ref, u_prev):
        """The QP parameter [x; r] (+ u_prev with rate limits)."""
        p = torch.cat([x, x_ref], dim=-1)
        if self.rate:
            p = torch.cat([p, u_prev], dim=-1)
        return p

    def plan(self, x, x_ref=None) -> np.ndarray:
        """Full receding-horizon plan (N, n_u) at state ``x`` (n_x,).

        Runs ``sqp_iters`` linearize-condense-solve passes seeded from the
        previous sample's plan shifted by one stage (hold-last)."""
        x = self._tensor(x, self.n_x)
        x_ref = (self._zeros(self._ref_width()) if x_ref is None
                 else self._tensor(x_ref, self._ref_width()))
        if self._us is None:
            us = self._zeros(self.horizon, self.n_u)
        else:  # shift the previous plan: drop u_0, hold the last move
            us = torch.cat([self._us[1:], self._us[-1:]], dim=0)
        u_prev = self._zeros(self.n_u) if self._u_prev is None else self._u_prev
        p = self._parameter(x, x_ref, u_prev)
        res = None
        if self.device_condense:
            # the dual threads across passes and samples only with
            # warm_start; else every pass starts from zeros
            y = (self._y if self.warm_start and self._y is not None
                 else self._zeros(2, self._m_h))
            y_new = y
            for _ in range(self.sqp_iters):
                us_new, y_new, res = self._device_pass(x, us, p, y)
                if self.warm_start:
                    y = y_new
                us = us + self.damping * (us_new - us)
            self._y = y_new
        elif self.engine == "stagewise":
            from tpu_gpad_torch.stagewise import build_stagewise, solve_stagewise

            ref_bake = x_ref.reshape(-1, self.n_x).cpu().numpy()
            if not self.preview:
                ref_bake = ref_bake[0]
            for _ in range(self.sqp_iters):
                data = build_stagewise(
                    self._linearized_problem(us, x),
                    iterations=self.config.iterations, x_ref=ref_bake,
                    device=self.device)
                res = solve_stagewise(
                    data, x[None], y0=self._y if self.warm_start else None,
                    config=self.config)
                self._y = res.y
                us_new = res.z[0].reshape(self.horizon, self.n_u)
                us = us + self.damping * (us_new - us)
        else:
            for _ in range(self.sqp_iters):
                data = self._dualize(self._linearized_problem(us, x))
                res = solve_batch(data, p[None], config=self.config,
                                  y0=self._y if self.warm_start else None)
                self._y = res.y
                us_new = res.z[0, : self.n_u * self.horizon].reshape(
                    self.horizon, self.n_u)
                us = us + self.damping * (us_new - us)
        self._us = us
        self.last_result = res
        if self.rate:
            self._u_prev = us[0]
        return us.cpu().numpy()

    def step(self, x, x_ref=None) -> np.ndarray:
        """Applied move u_0 (n_u,) at state ``x``; see ``plan``."""
        return self.plan(x, x_ref)[0]

    def _batch_refs(self, x_ref, B: int) -> np.ndarray:
        """(B, ref width) references: none (zeros), one shared setpoint or
        window, or one per scenario (leading B)."""
        width = self._ref_width()
        if x_ref is None:
            return np.zeros((B, width), dtype=np.float32)
        x_ref = np.asarray(x_ref, dtype=np.float32)
        return np.broadcast_to(
            x_ref.reshape(-1, width) if x_ref.size == B * width
            else x_ref.reshape(width),
            (B, width),
        ).astype(np.float32)

    def _batch_start(self, X):
        """The batch's states, its shifted plans (zeros after a batch-size
        change, which also drops the warm starts)."""
        X = self._tensor(X, (-1, self.n_x))
        B = X.shape[0]
        if self._us_b is None or self._us_b.shape[0] != B:
            self._y_b = None
            self._u_prev_b = None
            return X, self._zeros(B, self.horizon, self.n_u)
        return X, torch.cat([self._us_b[:, 1:], self._us_b[:, -1:]], dim=1)

    def plan_batch(self, X, x_ref=None) -> np.ndarray:
        """Batch of B independent scenarios: plans of shape (B, N, n_u).

        Each scenario linearizes along its own nominal trajectory (rollout
        and Jacobians batched on the device); the host path condenses each
        on the host, the device path all B at once on the device; all B
        QPs then solve through ``solve_multi`` (one ``solve_batch`` per
        scenario: on the card, one dual-kernel launch each). Keeps its own
        warm starts, separate from ``plan``'s; a batch-size change resets
        them."""
        if self.engine == "stagewise":
            return self._plan_batch_stagewise(X, x_ref)
        X, us = self._batch_start(X)
        B = X.shape[0]
        refs = torch.as_tensor(self._batch_refs(x_ref, B), device=self.device)
        u_prev = (self._zeros(B, self.n_u) if self._u_prev_b is None
                  else self._u_prev_b)
        P = self._parameter(X, refs, u_prev)
        res = None
        if self.device_condense:
            y = (self._y_b if self.warm_start and self._y_b is not None
                 else self._zeros(B, 2, self._m_h))
            y_new = y
            for _ in range(self.sqp_iters):
                us_new, y_new, res = self._device_pass(X, us, P, y)
                if self.warm_start:
                    y = y_new
                us = us + self.damping * (us_new - us)
            self._y_b = y_new
        else:
            for _ in range(self.sqp_iters):
                A, Bm, c = _host(*_linearize_along(self.f, X, us))
                datas = [self._dualize(self._problem(A[b], Bm[b], c[b]))
                         for b in range(B)]
                res = solve_multi(stack_data(datas), P[:, None],
                                  config=self.config,
                                  y0=self._y_b if self.warm_start else None)
                self._y_b = res.y
                us_new = res.z[:, 0, : self.n_u * self.horizon].reshape(
                    B, self.horizon, self.n_u)
                us = us + self.damping * (us_new - us)
        self._us_b = us
        self.last_result = res
        if self.rate:
            self._u_prev_b = us[:, 0]
        return us.cpu().numpy()

    def _plan_batch_stagewise(self, X, x_ref) -> np.ndarray:
        """``plan_batch`` on the stage-wise engine: each scenario linearizes
        along its own trajectory, the B stage-wise builds stack
        (``stack_stagewise``) and solve in one ``solve_stagewise_multi``
        call. References are baked per scenario."""
        from tpu_gpad_torch.stagewise import (
            build_stagewise,
            solve_stagewise_multi,
            stack_stagewise,
        )

        X, us = self._batch_start(X)
        B = X.shape[0]
        refs = self._batch_refs(x_ref, B)
        res = None
        for _ in range(self.sqp_iters):
            A, Bm, c = _host(*_linearize_along(self.f, X, us))
            datas = [build_stagewise(
                self._problem(A[b], Bm[b], c[b]),
                iterations=self.config.iterations,
                x_ref=(refs[b].reshape(self.horizon, self.n_x)
                       if self.preview else refs[b]),
                device=self.device) for b in range(B)]
            res = solve_stagewise_multi(
                stack_stagewise(datas), X,
                y0=self._y_b if self.warm_start else None, config=self.config)
            self._y_b = res.y
            us_new = res.z.reshape(B, self.horizon, self.n_u)
            us = us + self.damping * (us_new - us)
        self._us_b = us
        self.last_result = res
        return us.cpu().numpy()

    def step_batch(self, X, x_ref=None) -> np.ndarray:
        """Applied moves (B, n_u) for a batch of states; see ``plan_batch``."""
        return self.plan_batch(X, x_ref)[:, 0]

    def reset(self, u_prev=None) -> None:
        """Drop the plan and dual warm starts (plant or setpoint
        discontinuity). ``u_prev``: for rate-limited problems, the
        actuator's current position (default zeros)."""
        self._us = None
        self._y = None
        self._us_b = None
        self._y_b = None
        self._u_prev_b = None
        self._u_prev = None if u_prev is None else self._tensor(u_prev, self.n_u)


class RobustNMPC:
    """Multi-model successive-linearization NMPC, as
    ``tpu_gpad.nonlinear.RobustNMPC``: one applied move optimal against S
    nonlinear model realizations at once.

    Per SQP pass every model ``f_s`` rolls out and linearizes along its own
    tail plan, the S affine-LTV QPs stack with the shared-first-move
    selector (``robust.scenario_qp`` on the host, or with
    ``device_condense=True`` ``device_condense.dualize_scenario`` on the
    device), and one GPAD solve returns u_0 and the S tails.
    ``engine="stagewise"`` solves the block-plant twin
    (``robust.scenario_stagewise_problem``) instead. Cost and constraints
    are shared; ``weights`` are the scenario probabilities. ``step``
    returns the applied move; ``plans`` then holds the (S, N, n_u)
    per-scenario plans (NumPy)."""

    def __init__(
        self,
        models,
        n_x: int,
        n_u: int,
        horizon: int,
        Q: np.ndarray,
        R: np.ndarray,
        weights=None,
        Q_terminal: Optional[np.ndarray] = None,
        x_min: Optional[np.ndarray] = None,
        x_max: Optional[np.ndarray] = None,
        u_min: Optional[np.ndarray] = None,
        u_max: Optional[np.ndarray] = None,
        soft_state: Optional[float] = None,
        iterations: int = 200,
        config: Optional[SolverConfig] = None,
        sqp_iters: int = 1,
        damping: float = 1.0,
        lipschitz: str = "spectral_dual",
        warm_start: bool = True,
        preview: bool = False,
        device_condense: bool = False,
        engine: str = "condensed",
        name: str = "robust_nmpc",
        device="cuda",
    ):
        if len(models) < 1:
            raise ValueError("need at least one model realization")
        if engine not in ("condensed", "stagewise"):
            raise ValueError(
                f"engine must be 'condensed' or 'stagewise': {engine!r}")
        if engine == "stagewise":
            if device_condense:
                raise ValueError(
                    "engine='stagewise' and device_condense are exclusive")
            if soft_state is not None:
                raise ValueError(
                    "engine='stagewise' does not take soft_state "
                    "(dual-damped rows are a condensation-path feature)")
            if len(models) < 2:
                raise ValueError(
                    "the stage-wise scenario stack needs >= 2 models")
        self.engine = engine
        config = _with_iterations(config, iterations)
        self.models = list(models)
        self.S = len(self.models)
        self.weights = weights
        self.n_x, self.n_u, self.horizon = n_x, n_u, horizon
        self.Q = np.asarray(Q, dtype=np.float64)
        self.R = np.asarray(R, dtype=np.float64)
        self.Q_terminal = Q_terminal
        self.bounds = dict(x_min=x_min, x_max=x_max, u_min=u_min, u_max=u_max)
        self.soft_state = soft_state
        self.config = config
        self.sqp_iters = sqp_iters
        self.damping = damping
        self.lipschitz = lipschitz
        self.warm_start = warm_start
        self.preview = preview
        self.name = name
        self.device = _card_or_raise(device)
        self.plans: np.ndarray | None = None  # (S, N, n_u) scenario plans
        self._y = None
        self.last_result = None
        self.device_condense = device_condense
        self._consts = None
        if device_condense:
            if u_min is None or u_max is None:
                raise ValueError("device_condense=True needs input boxes")
            if (x_min is None) != (x_max is None):
                raise ValueError(
                    "device_condense=True needs both state bounds or neither"
                )
            if config.mode != "fixed":
                raise ValueError(
                    "device_condense=True supports fixed-iteration mode"
                )
            self._consts = scenario_constants(
                self.S, horizon, n_x, n_u, self.Q, self.R, u_min, u_max,
                config.iterations, weights=weights, Q_terminal=Q_terminal,
                x_min=x_min, x_max=x_max, soft_state=soft_state,
                preview=preview, name=name, device=self.device)
            self._m_h = self._consts.m_half

    def _linearized(self, x, Us):
        """Each model's linearization along its own plan: (A, B, c) stacked
        over the S models, on the device."""
        lins = [_linearize_along(f_s, x, Us[s])
                for s, f_s in enumerate(self.models)]
        return [torch.stack(t) for t in zip(*lins)]

    def _device_pass(self, x, Us, p, y0):
        """One robust SQP pass on the card: S rollouts and linearizations,
        the scenario stack condensed and dualized on the device, one solve.
        Returns (the S plans, the dual iterate, the result)."""
        data = dualize_scenario(self._consts, *self._linearized(x, Us))
        res = solve_batch(data, p[None], config=self.config, y0=y0[None])
        z = res.z[0]
        N, n_u = self.horizon, self.n_u
        tail = n_u * (N - 1)
        plans = [torch.cat([z[:n_u], z[n_u + s * tail: n_u + (s + 1) * tail]])
                 for s in range(self.S)]
        return torch.stack(plans).reshape(self.S, N, n_u), res.y[0], res

    def _problems(self, x, Us):
        A, B, c = _host(*self._linearized(x, torch.as_tensor(
            Us, dtype=F32, device=self.device)))
        return [LinearMPCProblem(
            A=A[s], B=B[s], Q=self.Q, R=self.R, horizon=self.horizon,
            Q_terminal=self.Q_terminal, c=c[s], name=f"{self.name}_s{s}",
            **self.bounds) for s in range(self.S)]

    def plan(self, x, x_ref=None) -> np.ndarray:
        """One robust receding-horizon pass; returns scenario 0's plan (its
        first move is the applied move)."""
        from tpu_gpad_torch.robust import scenario_plan, scenario_qp

        dev = self.device
        x_np = np.array(x, dtype=np.float32).reshape(self.n_x)
        ref_width = self.horizon * self.n_x if self.preview else self.n_x
        x_ref = (
            np.zeros(ref_width, dtype=np.float32)
            if x_ref is None
            else np.asarray(x_ref, dtype=np.float32).reshape(ref_width)
        )
        N, n_u, S = self.horizon, self.n_u, self.S
        if self.plans is None:
            Us = np.zeros((S, N, n_u), dtype=np.float32)
        else:  # shift every scenario's plan, hold-last
            Us = np.concatenate([self.plans[:, 1:], self.plans[:, -1:]], axis=1)
            # after the shift the first slots hold per-scenario second
            # moves: share their mean, so that the damped update keeps every
            # scenario's first move identical
            Us[:, 0] = Us[:, 0].mean(axis=0)
        x = torch.as_tensor(x_np, device=dev)
        p = torch.as_tensor(np.concatenate([x_np, x_ref]), device=dev)
        res = None
        if self.device_condense:
            y = (self._y if self.warm_start and self._y is not None
                 else torch.zeros((2, self._m_h), dtype=F32, device=dev))
            Us_t = torch.as_tensor(Us, device=dev)
            y_new = y
            for _ in range(self.sqp_iters):
                new, y_new, res = self._device_pass(x, Us_t, p, y)
                if self.warm_start:
                    y = y_new
                Us_t = Us_t + self.damping * (new - Us_t)
            Us = Us_t.cpu().numpy()
            self._y = y_new
        elif self.engine == "stagewise":
            from tpu_gpad_torch.robust import (
                scenario_stagewise_plans,
                scenario_stagewise_problem,
                scenario_stagewise_x0,
            )
            from tpu_gpad_torch.stagewise import build_stagewise, solve_stagewise

            ref_tiled = (np.tile(x_ref.reshape(N, self.n_x), (1, S))
                         if self.preview else np.tile(x_ref, S))
            x0 = torch.as_tensor(scenario_stagewise_x0(x_np, S)[None],
                                 dtype=F32, device=dev)
            for _ in range(self.sqp_iters):
                swp = scenario_stagewise_problem(self._problems(x, Us),
                                                 weights=self.weights)
                data = build_stagewise(swp, iterations=self.config.iterations,
                                       x_ref=ref_tiled, device=dev)
                res = solve_stagewise(data, x0,
                                      y0=self._y if self.warm_start else None,
                                      config=self.config)
                self._y = res.y
                new = scenario_stagewise_plans(res.z[0], S, n_u, N)
                Us = (Us + self.damping * (new - Us)).astype(np.float32)
        else:
            for _ in range(self.sqp_iters):
                qps = [condense(pr, tracking="preview" if self.preview else True,
                                soft_state=self.soft_state)
                       for pr in self._problems(x, Us)]
                data = dualize(
                    scenario_qp(qps, weights=self.weights),
                    iterations=self.config.iterations, paired="auto",
                    lipschitz=self.lipschitz, device=dev)
                y0 = self._y if self.warm_start else None
                if y0 is not None and y0.shape[-1] * 2 != data.m:
                    y0 = None  # the dedupe changed the stack between passes
                res = solve_batch(data, p[None], config=self.config, y0=y0)
                self._y = res.y
                z = res.z[0].cpu().numpy()
                new = np.stack([scenario_plan(z, s, n_u, N, S)
                                for s in range(S)])
                Us = Us + self.damping * (new - Us)
        self.plans = Us
        self.last_result = res
        return Us[0]

    def step(self, x, x_ref=None) -> np.ndarray:
        """The applied move u_0 (shared across every realization)."""
        return self.plan(x, x_ref)[0]

    def reset(self) -> None:
        self.plans = None
        self._y = None


def simulate_nonlinear_device(
    plant: Callable,
    controller: NMPC,
    x0: np.ndarray,
    n_steps: int,
    x_ref=None,
) -> tuple[np.ndarray, np.ndarray]:
    """The whole nonlinear closed loop on the card, as
    ``tpu_gpad.nonlinear.simulate_nonlinear_device``.

    Needs ``controller.device_condense``: each sample's SQP passes
    (rollout, Jacobians, condensation, dualization, solve) run on the
    controller's device, and the state, the plan, the dual iterate and the
    previous move stay there from sample to sample; the trajectory comes
    to the host once, at the end. Plan and dual warm starts carry over
    exactly as ``simulate_nonlinear`` threads them; the first slew limit
    is taken against ``controller.reset(u_prev=...)``'s move. The
    controller's own state is left as it was.

    ``plant`` (a torch callable) may differ from the controller's model.
    For ``preview`` controllers ``x_ref`` is a full (T, n_x) reference
    trajectory (receding windows of it, the final row held); otherwise a
    fixed setpoint (n_x,). Returns ``(X, U)`` of shapes (n_steps + 1, n_x)
    / (n_steps, n_u) as NumPy."""
    if not controller.device_condense:
        raise ValueError(
            "simulate_nonlinear_device needs NMPC(device_condense=True); "
            "use simulate_nonlinear for host-condensed controllers"
        )
    c = controller
    N, n_x, n_u = c.horizon, c.n_x, c.n_u
    x = c._tensor(x0, n_x)
    if c.preview:
        traj = c._tensor(pad_reference(
            np.zeros((1, n_x), np.float32) if x_ref is None else x_ref,
            n_steps + N + 1), (n_steps + N + 1, n_x))

        def ref_at(t):
            return traj[t + 1: t + 1 + N].reshape(N * n_x)
    else:
        setpoint = (c._zeros(n_x) if x_ref is None
                    else c._tensor(x_ref, n_x))

        def ref_at(t):
            return setpoint

    us = c._zeros(N, n_u)
    y_cold = c._zeros(2, c._m_h)
    y = y_cold
    u_prev = c._zeros(n_u) if c._u_prev is None else c._u_prev
    X, U = [x], []
    for t in range(n_steps):
        us = torch.cat([us[1:], us[-1:]], dim=0)  # hold-last shift
        p = c._parameter(x, ref_at(t), u_prev)
        # warm_start=False cold-starts the dual every pass (the plan
        # still threads), as the host loop's y0=None does
        y_in = y if c.warm_start else y_cold
        for _ in range(c.sqp_iters):
            us_new, y_next, _ = c._device_pass(x, us, p, y_in)
            if c.warm_start:
                y_in = y_next
            us = us + c.damping * (us_new - us)
        u = us[0]
        x = plant(x, u)
        if c.warm_start:
            y = y_next
        u_prev = u
        X.append(x)
        U.append(u)
    out = torch.cat([torch.stack(X).reshape(-1),
                     torch.stack(U).reshape(-1)]).cpu().numpy()
    cut = (n_steps + 1) * n_x
    return out[:cut].reshape(n_steps + 1, n_x), out[cut:].reshape(n_steps, n_u)


def simulate_nonlinear(
    plant: Callable,
    controller,
    x0: np.ndarray,
    n_steps: int,
    x_ref=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Closed loop: ``u = controller.step(x, x_ref)``, ``x+ = plant(x, u)``
    on the controller's device, one sample at a time (each sample
    re-linearizes and re-condenses). For a ``preview`` controller
    ``x_ref`` is a full reference trajectory (T, n_x): sample t previews
    ``x_ref[t+1 : t+N+1]``, the final row held once it runs out. Returns
    ``(X, U)`` with shapes (n_steps + 1, n_x) and (n_steps, n_u)."""
    dev = controller.device
    x = np.array(x0, dtype=np.float32).reshape(controller.n_x)
    traj = None
    if controller.preview and x_ref is not None:
        traj = pad_reference(x_ref, n_steps + controller.horizon + 1)
    X, U = [x], []
    for t in range(n_steps):
        ref = (traj[t + 1: t + 1 + controller.horizon] if traj is not None
               else x_ref)
        u = controller.step(x, ref)
        x = plant(torch.as_tensor(x, device=dev),
                  torch.as_tensor(u, device=dev)).cpu().numpy()
        X.append(x)
        U.append(u)
    return np.stack(X), np.stack(U)
