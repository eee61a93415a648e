"""Online GPAD solvers.

- ``reference``: pure-NumPy oracle (float32 GPAD loop on raw dual constants).
- ``core``: the batched solver (fixed and eps modes, restart) and its
  routing; the "torch" engine is a Python loop of tensor ops.
- ``kernels``: the hand-written CUDA kernels of the flat paired, full
  paired and dense (unpaired) solves and their plain torch versions, and
  the "cuda" engine's entry.
- ``dual_kernels``: the hand-written CUDA kernels of the dual form (whole
  solve, and one eps check window), their plain versions, and the eps
  loop.
- ``multi``: ``stack_data`` and ``solve_multi``, different plants in one
  call (one ``solve_batch`` per plant).
"""

from tpu_gpad_torch.solver.core import (
    SolverConfig,
    solve,
    solve_batch,
    solve_to_accuracy,
)
from tpu_gpad_torch.solver.multi import solve_multi, stack_data

__all__ = ["SolverConfig", "solve", "solve_batch", "solve_multi",
           "solve_to_accuracy", "stack_data"]
