"""tpu_gpad_torch: the GPAD engine for condensed linear MPC on PyTorch/CUDA.

The port of ``tpu_gpad`` (JAX on TPU) to PyTorch on an NVIDIA H100, slice
by slice. This slice carries the condensed serving path:

- offline condensation of LTI plants into the dual-QP constants (NumPy
  float64, emitted as float32 tensors on a chosen device),
- the batched fixed-iteration GPAD solve, as a loop of torch ops
  (``engine="torch"``) or as one hand-written CUDA kernel launch for the
  flat paired form (``engine="cuda"``), routed by ``engine="auto"``,
- the warm-started serving ``Controller`` and batched ``simulate``,
- the ``solve`` CLI command.

It imports no jax and no tpu_gpad.
"""

from tpu_gpad_torch.types import LinearMPCProblem, CondensedQP, GPADData, SolveResult
from tpu_gpad_torch.condense import condense, dualize
from tpu_gpad_torch.schedule import momentum_schedule
from tpu_gpad_torch import problems
from tpu_gpad_torch.solver import SolverConfig, solve, solve_batch
from tpu_gpad_torch.closed_loop import Controller, simulate
from tpu_gpad_torch.convert import gpad_data_from_numpy, solve_result_to_numpy

__all__ = [
    "LinearMPCProblem",
    "CondensedQP",
    "GPADData",
    "SolveResult",
    "condense",
    "dualize",
    "momentum_schedule",
    "problems",
    "SolverConfig",
    "solve",
    "solve_batch",
    "Controller",
    "simulate",
    "gpad_data_from_numpy",
    "solve_result_to_numpy",
]
