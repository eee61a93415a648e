"""tpu_gpad_torch: the GPAD engine for condensed linear MPC on PyTorch/CUDA.

The port of ``tpu_gpad`` (JAX on TPU) to PyTorch on an NVIDIA H100, slice
by slice. It carries the condensed serving path:

- offline condensation of LTI plants into the dual-QP constants (NumPy
  float64, emitted as float32 tensors on a chosen device),
- the batched GPAD solve, fixed-budget or eps-terminated, with optional
  adaptive restart, as a loop of torch ops (``engine="torch"``) or as
  hand-written CUDA kernels for the flat paired, full paired, dense
  (unpaired) and dual forms (``engine="cuda"``), routed by
  ``engine="auto"``; ``solve_to_accuracy``; ``solver.multi.solve_multi``
  over a stack of different plants,
- the reference's dataset files and the native ``.npz`` format
  (``tpu_gpad_torch.io``), and the checkpointed scenario sweep
  (``tpu_gpad_torch.sweep``),
- the warm-started serving ``Controller`` and batched ``simulate``;
  ``Controller.from_qp`` serves a prebuilt QP,
- robust MPC (``robust``: the ``scenario_qp`` stack of model
  realizations, its stage-wise twin, tube tightening with ``lqr_gain``),
- estimation (``estimator``: Kalman filter, steady-state targets,
  offset-free output-feedback control, the EKF; ``mhe``: the
  ``MovingHorizonEstimator``, condensed or stage-wise),
- the stage-wise O(N) engine past the condensation wall
  (``build_stagewise``, ``solve_stagewise``, ``StagewiseController``,
  ``auto_solver``): a loop of torch ops and two CUDA kernels, one with the
  whole solve's state in shared memory and one that streams the dual
  iterates through device memory; ``stack_stagewise`` and
  ``solve_stagewise_multi`` solve plants with different dynamics in one
  call,
- successive-linearization nonlinear MPC (``nonlinear``: ``NMPC``,
  ``RobustNMPC``, ``rk4``, ``simulate_nonlinear``): each sample's
  linearization (``torch.func.jacfwd``) condensed on the host in float64,
  or with ``device_condense=True`` on the card in float32
  (``dualize_ltv_device``), so that a pass, and with
  ``simulate_nonlinear_device`` a whole closed loop, stays on the card;
  the pendulum and point-mass plants in ``problems``,
- per-iteration convergence traces (``analysis``) and checked solves
  (``utils.debug``),
- implicit differentiation through the solve (``diff``: ``sensitivity``,
  ``feedback_gain``, ``Controller.gain``, and ``torch.autograd.Function``s
  whose forward is the production solve, condensed or stage-wise, and
  whose backward is one masked KKT solve; ``dualize_ltv_device`` takes
  tensor cost weights, so a loss reaches them),
- the ``solve`` (``--dataset`` and ``--engine stagewise`` included),
  ``sweep`` and ``export`` CLI commands.

Entry points place their data on the card unless the caller passes
``device="cpu"``. It imports no jax and no tpu_gpad.
"""

from tpu_gpad_torch.types import LinearMPCProblem, CondensedQP, GPADData, SolveResult
from tpu_gpad_torch.condense import condense, dualize
from tpu_gpad_torch.schedule import momentum_schedule
from tpu_gpad_torch import io, problems
from tpu_gpad_torch.solver import SolverConfig, solve, solve_batch, solve_to_accuracy
from tpu_gpad_torch.solver.qp import polish, polish_batch
from tpu_gpad_torch.closed_loop import Controller, simulate
from tpu_gpad_torch.nonlinear import (
    NMPC,
    RobustNMPC,
    rk4,
    simulate_nonlinear,
    simulate_nonlinear_device,
)
from tpu_gpad_torch.device_condense import dualize_ltv_device
from tpu_gpad_torch.stagewise import (
    StagewiseController,
    StagewiseData,
    auto_solver,
    build_stagewise,
    solve_stagewise,
    solve_stagewise_multi,
    stack_stagewise,
    stagewise_compatible,
    stagewise_preferred,
)
from tpu_gpad_torch.robust import (
    lqr_gain,
    scenario_plan,
    scenario_problem_variants,
    scenario_qp,
    tube_tightened_problem,
)
from tpu_gpad_torch.mhe import MovingHorizonEstimator
from tpu_gpad_torch.estimator import (
    ExtendedKalmanFilter,
    KalmanFilter,
    OffsetFreeController,
    TargetCalculator,
    kalman_gain,
)
from tpu_gpad_torch.diff import (
    feedback_gain,
    make_data_differentiable_solver,
    make_differentiable_solver,
    sensitivity,
)
from tpu_gpad_torch.convert import (
    gpad_data_from_numpy,
    solve_result_to_numpy,
    stagewise_data_from_numpy,
)

__all__ = [
    "LinearMPCProblem",
    "CondensedQP",
    "GPADData",
    "SolveResult",
    "condense",
    "dualize",
    "momentum_schedule",
    "io",
    "problems",
    "SolverConfig",
    "solve",
    "solve_batch",
    "solve_to_accuracy",
    "Controller",
    "simulate",
    "NMPC",
    "RobustNMPC",
    "rk4",
    "simulate_nonlinear",
    "simulate_nonlinear_device",
    "dualize_ltv_device",
    "polish",
    "polish_batch",
    "StagewiseData",
    "auto_solver",
    "StagewiseController",
    "build_stagewise",
    "solve_stagewise",
    "solve_stagewise_multi",
    "stack_stagewise",
    "stagewise_compatible",
    "stagewise_preferred",
    "scenario_qp",
    "scenario_plan",
    "scenario_problem_variants",
    "tube_tightened_problem",
    "lqr_gain",
    "MovingHorizonEstimator",
    "ExtendedKalmanFilter",
    "KalmanFilter",
    "OffsetFreeController",
    "TargetCalculator",
    "kalman_gain",
    "sensitivity",
    "feedback_gain",
    "make_differentiable_solver",
    "make_data_differentiable_solver",
    "gpad_data_from_numpy",
    "solve_result_to_numpy",
    "stagewise_data_from_numpy",
]
