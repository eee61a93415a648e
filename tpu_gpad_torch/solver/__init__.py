"""Online GPAD solvers.

- ``reference``: pure-NumPy oracle (float32 GPAD loop on raw dual constants).
- ``core``: the batched fixed-mode solver and its routing; the "torch"
  engine is a Python loop of tensor ops.
- ``kernels``: the hand-written CUDA kernel of the flat paired solve (the
  "cuda" engine) and its plain torch version.
"""

from tpu_gpad_torch.solver.core import SolverConfig, solve, solve_batch

__all__ = ["SolverConfig", "solve", "solve_batch"]
