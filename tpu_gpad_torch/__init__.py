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
- the warm-started serving ``Controller`` and batched ``simulate``,
- the stage-wise O(N) engine past the condensation wall
  (``build_stagewise``, ``solve_stagewise``, ``StagewiseController``,
  ``auto_solver``): a loop of torch ops and two CUDA kernels, one with the
  whole solve's state in shared memory and one that streams the dual
  iterates through device memory,
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
from tpu_gpad_torch.closed_loop import Controller, simulate
from tpu_gpad_torch.stagewise import (
    StagewiseController,
    StagewiseData,
    auto_solver,
    build_stagewise,
    solve_stagewise,
    stagewise_compatible,
    stagewise_preferred,
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
    "StagewiseData",
    "auto_solver",
    "StagewiseController",
    "build_stagewise",
    "solve_stagewise",
    "stagewise_compatible",
    "stagewise_preferred",
    "gpad_data_from_numpy",
    "solve_result_to_numpy",
    "stagewise_data_from_numpy",
]
