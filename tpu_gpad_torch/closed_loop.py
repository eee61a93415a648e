"""Closed-loop MPC: the serving ``Controller`` and batched ``simulate``.

The counterpart of ``tpu_gpad.closed_loop``. Condensation and dualization
happen once; each sample is one ``solve_batch`` on the data's device,
warm-started from the previous sample's dual. ``simulate`` is a Python loop
over ``solve_batch`` (the JAX package traces it into one ``lax.scan``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tpu_gpad_torch.condense import condense, dualize
from tpu_gpad_torch.diff import feedback_gain
from tpu_gpad_torch.solver.core import SolverConfig, solve_batch
from tpu_gpad_torch.solver.qp import polish_batch
from tpu_gpad_torch.tracing import span
from tpu_gpad_torch.types import CondensedQP, GPADData, LinearMPCProblem


@dataclass(frozen=True)
class ClosedLoopResult:
    """Trajectories of a closed-loop run: ``X`` (T+1, B, n_x) states with
    X[0] = x0, ``U`` (T, B, n_u) applied first moves, ``residual`` and
    ``iterations`` (T, B) per-sample solver diagnostics."""

    X: torch.Tensor
    U: torch.Tensor
    residual: torch.Tensor
    iterations: torch.Tensor


def _with_iterations(config: SolverConfig | None, iterations: int) -> SolverConfig:
    if config is None:
        return SolverConfig(iterations=iterations)
    if config.iterations is None:
        return dataclasses.replace(config, iterations=iterations)
    return config


def pad_reference(x_ref, need: int) -> np.ndarray:
    """Hold-last padding of a reference trajectory to ``need`` rows."""
    R = np.atleast_2d(np.asarray(x_ref, dtype=np.float32))
    if R.shape[0] < need:
        R = np.concatenate(
            [R, np.repeat(R[-1:], need - R.shape[0], axis=0)], axis=0
        )
    return R[:need]


def simulate(
    problem: LinearMPCProblem,
    x0,
    n_steps: int = 1000,
    config: SolverConfig = SolverConfig(),
    data: GPADData | None = None,
    iterations: int = 100,
    warm_start: bool = False,
    paired: bool | str = "auto",
    x_ref=None,
    u_prev0=None,
    preview: bool = False,
    device="cuda",
) -> ClosedLoopResult:
    """Run the closed loop: condense once, then solve -> actuate ->
    propagate ``n_steps`` times. Arguments as ``tpu_gpad.closed_loop.
    simulate``; ``device`` places the data, the card by default (ignored
    when ``data`` is given: the loop then runs on the data's device)."""
    if preview and x_ref is None:
        raise ValueError("preview=True requires an x_ref trajectory")
    if problem.is_ltv or problem.c is not None:
        raise ValueError(
            "simulate propagates a time-invariant offset-free plant; LTV "
            "or affine-offset problems are for receding-horizon prediction "
            "(Controller / solve_batch) — step your own plant"
        )
    if data is None:
        data = dualize(
            condense(
                problem,
                tracking="preview" if preview else x_ref is not None,
            ),
            iterations=max(iterations, config.iterations or 0),
            paired=paired,
            device=device,
        )
    config = _with_iterations(config, iterations)
    dev = data.device
    f32 = dict(dtype=torch.float32, device=dev)
    X0 = torch.atleast_2d(torch.as_tensor(x0, **f32))
    batch = X0.shape[0]
    X_ref = R_traj = None
    if preview:
        R_traj = torch.as_tensor(
            pad_reference(x_ref, n_steps + problem.horizon + 1), **f32
        )
    elif x_ref is not None:
        X_ref = torch.as_tensor(x_ref, **f32).expand(X0.shape)
    u_prev = None
    if problem.du_max is not None or problem.du_min is not None:
        u_prev = torch.zeros((batch, problem.n_u), **f32)
        if u_prev0 is not None:
            u_prev = torch.as_tensor(u_prev0, **f32).expand(u_prev.shape).clone()
    A = torch.as_tensor(problem.A, **f32)
    B = torch.as_tensor(problem.B, **f32)
    dual_shape = (batch, 2, data.m_half) if data.paired else (batch, data.m)
    y_ws = torch.zeros(dual_shape, **f32)

    x = X0
    Xs, Us, Rs, Its = [], [], [], []
    for t in range(n_steps):
        p = x
        if X_ref is not None:
            p = torch.cat([x, X_ref], dim=-1)
        elif R_traj is not None:
            win = R_traj[t + 1 : t + 1 + data.horizon].reshape(-1)
            p = torch.cat([x, win.expand(batch, win.shape[0])], dim=-1)
        if u_prev is not None:
            p = torch.cat([p, u_prev], dim=-1)
        res = solve_batch(data, p, config=config,
                          y0=y_ws if warm_start else None)
        u = res.u
        Xs.append(x)
        Us.append(u)
        Rs.append(res.residual)
        Its.append(res.iterations)
        x = x @ A.T + u @ B.T
        y_ws = res.y
        if u_prev is not None:
            u_prev = u
    return ClosedLoopResult(
        X=torch.stack(Xs + [x]),
        U=torch.stack(Us),
        residual=torch.stack(Rs),
        iterations=torch.stack(Its),
    )


class Controller:
    """Stateful embedded-MPC controller: condense once, then ``step(x) -> u``.

    ``step`` accepts one state (n_x,) or a batch (B, n_x) of plants as
    NumPy, solves on ``device``, and returns the first move(s) as float32
    NumPy; each step warm-starts from the previous sample's dual
    (``warm_start=True``). ``config`` takes any ``SolverConfig``: e.g.
    ``SolverConfig(iterations=60, restart=True)`` serves through the dual
    kernel on a CUDA device, and ``mode="eps"`` stops each sample at its
    tolerance. ``reset()`` drops the warm start. ``polish=True`` refines
    each step's u* to the exact QP optimum on the host
    (``solver.qp.polish_batch``, float64 NumPy), as ``tpu_gpad`` does;
    ``gain`` differentiates u* through the solve (``diff.py``).
    ``from_qp`` serves a prebuilt ``CondensedQP``, e.g. a
    ``robust.scenario_qp`` stack."""

    def __init__(
        self,
        problem: LinearMPCProblem,
        iterations: int = 100,
        config: SolverConfig | None = None,
        warm_start: bool = True,
        paired: bool | str = "auto",
        data: GPADData | None = None,
        soft_state: float | None = None,
        tracking: bool | str = False,
        input_reference: bool = False,
        process_disturbance: bool = False,
        polish: bool = False,
        device="cuda",
    ):
        config = _with_iterations(config, iterations)
        if data is not None and (
            soft_state is not None or tracking or input_reference
            or process_disturbance
        ):
            raise ValueError(
                "pass either a prebuilt `data` or soft_state/tracking, not "
                "both: the controller cannot soften or re-parametrize a QP "
                "that is already dualized"
            )
        if data is not None and polish:
            raise ValueError(
                "polish=True needs the controller's own condensed QP; with "
                "a prebuilt `data` (e.g. move-blocked) the internally "
                "condensed QP would not match the solved one: polish the "
                "results yourself with solver.qp.polish_batch and the "
                "matching QP"
            )
        self.qp = condense(
            problem,
            soft_state=soft_state,
            tracking=tracking,
            input_reference=input_reference,
            process_disturbance=process_disturbance,
        )
        self.tracking = tracking
        self.preview = tracking == "preview"
        self.input_reference = input_reference
        self.process_disturbance = process_disturbance
        self.rate = problem.du_max is not None or problem.du_min is not None
        if data is None:
            data = dualize(self.qp, iterations=config.iterations,
                           paired=paired, device=device)
        self.problem = problem
        self.data = data
        self.config = config
        self.warm_start = warm_start
        self.polish = polish
        self._y = None
        self._u_prev = None  # last applied move (rate-limited problems)
        self.last_result = None

    @classmethod
    def from_qp(
        cls,
        qp: CondensedQP,
        iterations: int = 100,
        config: SolverConfig | None = None,
        warm_start: bool = True,
        paired: bool | str = "auto",
        tracking: bool | str = False,
        input_reference: bool = False,
        process_disturbance: bool = False,
        rate: bool = False,
        problem: LinearMPCProblem | None = None,
        polish: bool = False,
        device="cuda",
    ) -> "Controller":
        """Serve a prebuilt ``CondensedQP`` (e.g. a ``robust.scenario_qp``
        stack) with the full Controller contract: dual warm starts across
        samples, batching, optional active-set polish. As
        ``tpu_gpad.Controller.from_qp``; ``device`` places the data, the
        card by default.

        The flags describe how the QP's parameter is laid out and must
        match how it was condensed: ``tracking``/``input_reference``/
        ``process_disturbance`` append [r], [u_ref], [d] as in
        ``condense``; ``rate`` appends the previous applied move (its size
        comes off the dualized data). ``tracking="preview"`` and
        ``process_disturbance`` need ``problem`` (e.g. the per-scenario
        nominal) for the stage and state dimensions."""
        config = _with_iterations(config, iterations)
        if problem is None and (tracking == "preview" or process_disturbance):
            raise ValueError(
                "tracking='preview' and process_disturbance need `problem` "
                "for the stage/state dimensions"
            )
        self = cls.__new__(cls)
        self.qp = qp
        self.tracking = tracking
        self.preview = tracking == "preview"
        self.input_reference = input_reference
        self.process_disturbance = process_disturbance
        self.rate = rate
        self.data = dualize(qp, iterations=config.iterations, paired=paired,
                            device=device)
        self.problem = problem
        self.config = config
        self.warm_start = warm_start
        self.polish = polish
        self._y = None
        self._u_prev = None
        self.last_result = None
        return self

    def _parameter(self, x: np.ndarray, x_ref, u_ref, d) -> np.ndarray:
        """The QP parameter [x; r?; u_ref?; d?] for the configured layout."""
        if self.preview:
            N, n_x = self.problem.horizon, self.problem.n_x
            if x_ref is None:
                flat = np.zeros(x.shape[:-1] + (N * n_x,), dtype=np.float32)
            else:
                x_ref = np.asarray(x_ref, dtype=np.float32)
                if x_ref.shape[-2:] != (N, n_x):
                    raise ValueError(
                        f"preview x_ref must end in shape ({N}, {n_x}); "
                        f"got {x_ref.shape}"
                    )
                flat = np.broadcast_to(
                    x_ref.reshape(x_ref.shape[:-2] + (N * n_x,)),
                    x.shape[:-1] + (N * n_x,),
                )
            x = np.concatenate([x, flat], axis=-1)
        elif self.tracking:
            if x_ref is None:
                x_ref = np.zeros_like(x)
            x_ref = np.broadcast_to(np.asarray(x_ref, dtype=np.float32), x.shape)
            x = np.concatenate([x, x_ref], axis=-1)
        elif x_ref is not None:
            raise ValueError("x_ref requires a tracking controller")
        if self.input_reference:
            n_u = self.data.n_u
            if u_ref is None:
                u_ref = np.zeros(x.shape[:-1] + (n_u,), dtype=np.float32)
            u_ref = np.broadcast_to(
                np.asarray(u_ref, dtype=np.float32), x.shape[:-1] + (n_u,)
            )
            x = np.concatenate([x, u_ref], axis=-1)
        elif u_ref is not None:
            raise ValueError("u_ref requires input_reference=True")
        if self.process_disturbance:
            n_x = self.problem.n_x
            if d is None:
                d = np.zeros(x.shape[:-1] + (n_x,), dtype=np.float32)
            d = np.broadcast_to(
                np.asarray(d, dtype=np.float32), x.shape[:-1] + (n_x,)
            )
            x = np.concatenate([x, d], axis=-1)
        elif d is not None:
            raise ValueError("d requires process_disturbance=True")
        return x

    def step(self, x, x_ref=None, u_ref=None, d=None) -> np.ndarray:
        """Solve the MPC QP at state ``x`` and return u* (the applied move).

        Output shape mirrors the input: (n_u,) for a single (n_x,) state,
        (B, n_u) for a (B, n_x) batch. ``x_ref``/``u_ref``/``d`` are the
        tracking setpoint (or (N, n_x) preview), input target and
        disturbance offset of the configured parameter layout. For
        rate-limited problems the previous step's move is threaded into
        the parameter (zeros on the first step or after ``reset``)."""
        with span("step"):
            return self._step(x, x_ref, u_ref, d)

    def _step(self, x, x_ref, u_ref, d) -> np.ndarray:
        """``step`` inside its span."""
        dev = self.data.device
        single = np.ndim(x) == 1
        with span("step.parameter"):
            p = self._parameter(np.asarray(x, dtype=np.float32), x_ref, u_ref,
                                d)
            # a pageable copy, which waits on the card
            with span("step.h2d", sync=dev):
                p = torch.atleast_2d(
                    torch.as_tensor(p, dtype=torch.float32, device=dev))
            if self.rate:
                p = torch.cat([p, self._last_move(p.shape[0])], dim=-1)
        y0 = self._y if self.warm_start else None
        if y0 is not None and y0.shape[0] != p.shape[0]:
            y0 = None  # batch size changed: the warm start no longer applies
        res = solve_batch(self.data, p, config=self.config, y0=y0)
        self._y = res.y
        self.last_result = res
        u_applied = res.u
        if self.polish:  # the exact optimum, refined on the host in float64
            with span("step.polish"):
                # every copy between host and card waits on the card
                with span("step.wait", sync=dev):
                    P = p.cpu().numpy()
                with span("step.wait", sync=dev):
                    Z0 = res.z.cpu().numpy()
                Z, _ = polish_batch(self.qp, P, Z0)
                with span("step.h2d", sync=dev):
                    u_applied = torch.as_tensor(Z[:, : self.data.n_u],
                                                dtype=torch.float32,
                                                device=dev)
        with span("step.wait", sync=dev):  # u* back on the host
            u = u_applied.cpu().numpy().astype(np.float32)
        if self.rate:
            self._u_prev = u_applied
        return u[0] if single else u

    def _last_move(self, batch: int) -> torch.Tensor:
        """The previous step's move for each of ``batch`` plants, the last
        entry of a rate-limited controller's parameter."""
        u_prev = self._u_prev
        if u_prev is None:
            return torch.zeros((batch, self.data.n_u), dtype=torch.float32,
                               device=self.data.device)
        if u_prev.shape[0] != batch:
            # a stored single move broadcasts (one actuator state for
            # every plant); any other batch change is ambiguous and
            # would silently re-base the slew limit
            if u_prev.shape[0] != 1:
                raise ValueError(
                    f"rate-limited controller: batch size changed "
                    f"{u_prev.shape[0]} -> {batch} mid-run; the "
                    f"stored previous move is ambiguous. Call "
                    f"reset(u_prev=...) with the actuator state first."
                )
            u_prev = u_prev.expand(batch, self.data.n_u)
        return u_prev

    def gain(self, tol: float = 1e-7, ridge: float = 0.0) -> np.ndarray:
        """Local feedback gain du*/dp at the last ``step``'s solution, as
        ``tpu_gpad.Controller.gain``: the explicit-MPC gain of the active
        region that solve landed in (``diff.sensitivity``), p the whole QP
        parameter as configured. (n_u, n_p) after a one-plant step,
        (B, n_u, n_p) batched. Raises before any ``step``."""
        if self.last_result is None:
            raise ValueError("gain() needs a prior step() call")
        K = feedback_gain(self.data, self.last_result, tol=tol,
                          ridge=ridge).cpu().numpy()
        return K[0] if K.shape[0] == 1 else K

    def reset(self, u_prev=None) -> None:
        """Drop the warm-start state (e.g. after a setpoint change).

        ``u_prev``: for rate-limited problems, the actuator's current
        position to rate-limit the next move against (default: zeros)."""
        self._y = None
        self._u_prev = None
        if u_prev is not None:
            self._u_prev = torch.atleast_2d(torch.as_tensor(
                u_prev, dtype=torch.float32, device=self.data.device))


def plot_closed_loop(result: ClosedLoopResult, scenario: int = 0,
                     path: str | None = None):
    """The reference's two trajectory plots (``gpad.m:98-114``): per-cell SoC
    and balancing currents over time. Returns the matplotlib figure, or None
    if matplotlib is unavailable (it is not a hard dependency)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    X = result.X[:, scenario, :].cpu().numpy()
    U = result.U[:, scenario, :].cpu().numpy()
    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for i in range(X.shape[1]):
        ax0.plot(X[:, i], label=f"cell {i + 1}")
    ax0.set_ylabel("state of charge")
    ax0.legend(loc="best", fontsize=8)
    ax0.set_title("closed-loop SoC trajectories")
    for i in range(U.shape[1]):
        ax1.plot(U[:, i], label=f"cell {i + 1}")
    ax1.set_ylabel("balancing current [A]")
    ax1.set_xlabel("sample")
    ax1.set_title("applied first moves u*")
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=120)
    return fig
