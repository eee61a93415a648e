"""AOT solver export: serialized ``torch.export`` artifacts for serving.

The counterpart of ``tpu_gpad.aot``. The reference ships a prebuilt solver
binary (``build/main``, SURVEY.md C10) compiled for one GPU architecture;
here ``torch.export`` traces the batched solve once, with the problem
constants (``GPADData`` or ``StagewiseData``) baked in, and
``torch.export.save`` writes the ``ExportedProgram`` (a ``.pt2`` archive).
``load_solver`` reloads it in a process that re-traces nothing. One
artifact = one deployed controller.

Two batch conventions, as in ``tpu_gpad.aot``:

- ``batch_size=None`` (default): the batch dimension is exported SYMBOLIC
  (any batch size at call time). The kernels' launch plans need a
  concrete batch, so the artifact pins the torch engine (and, stage-wise,
  its sequential sweeps). It holds no op of this package: it loads and
  runs with ``torch`` alone.
- ``batch_size=B``: concrete shapes; routing resolves exactly as a live
  ``solve_batch`` / ``solve_stagewise`` would on the exporting device. On
  the card that is a graph of one kernel op (``torch.ops.tpu_gpad_torch``,
  one launch per call, or one per check window in eps mode) and the torch
  ops around it. The route and the launch plan are fixed at export for
  that card (its SM count included), so such an artifact serves the card
  type it was exported on, at that one batch size.

The solver's loops export as one body each (a ``scan`` over the schedule,
a ``while_loop`` over eps check windows), so an artifact's graph does not
grow with the iteration budget. The callable returns the ``SolveResult``
fields as a plain dict.

A precision tier (``SolverConfig.precision``, ``matmul_dtype``) exports
as the ops that the graph holds: on the torch engine the bf16 casts and
the 3xTF32 split; on a kernel route the kernel op with its ``tier``
argument, the ops around it fp32. The TF32 switch is process state, not a
graph op, so the artifact records its tier in the archive
(``gpad_tier.json``: TF32 on for the torch engine's "high" and "default",
off for a kernel route, whose kernel runs its tier itself) and
``load_solver``'s callable runs under the same scoped switch
(``solver.core.tf32_matmuls``).
"""

from __future__ import annotations

import dataclasses
import io
import json
from pathlib import Path

import torch

from tpu_gpad_torch.solver import core
from tpu_gpad_torch.solver.core import SolverConfig, solve_batch
from tpu_gpad_torch.types import GPAD_TENSOR_FIELDS, GPADData

_RESULT_KEYS = ("u", "z", "y", "iterations", "residual", "gap", "converged")
# the archive entry that records the tier an artifact's products run at
_TIER_FILE = "gpad_tier.json"


class _Solve(torch.nn.Module):
    """A batched solve over constants held as the module's buffers, so that
    export bakes them into the artifact's state."""

    def __init__(self, data, fields, solve):
        super().__init__()
        self._data, self._fields, self._solve = data, [], solve
        for f in fields:
            if getattr(data, f) is not None:
                self.register_buffer(f, getattr(data, f))
                self._fields.append(f)

    def forward(self, x0):
        data = dataclasses.replace(
            self._data, **{f: getattr(self, f) for f in self._fields})
        res = self._solve(data, x0)
        return {k: getattr(res, k) for k in _RESULT_KEYS}


def _refuse_axes(config: SolverConfig) -> None:
    if config.model_axis is not None or config.collective_axes:
        raise ValueError(
            "model_axis and collective_axes name process groups of a sharded "
            "solve, which an artifact cannot carry; export the unsharded "
            "solve")


def _tier_record(config: SolverConfig, kernel: bool = False) -> dict:
    """The tier an artifact's products run at, as ``load_solver`` reads it;
    on a ``kernel`` route the ops around the launch hold TF32 off, as the
    live call's do."""
    return {"precision": config.precision, "matmul_dtype": config.matmul_dtype,
            "tier": core.tier(config),
            "tf32": core._tf32(config) and not kernel}


def _export(module, data, batch_size, path, tier: dict) -> bytes:
    """Trace ``module`` on an ``x0`` of (batch_size or a symbolic b, n_x)
    float32 on the data's device; save with its ``tier`` record, write to
    ``path``, return bytes."""
    if batch_size is None:
        B, dynamic = 2, ({0: torch.export.Dim("b")},)
    else:
        B, dynamic = batch_size, None
    x0 = torch.zeros((B, data.n_x), dtype=torch.float32, device=data.device)
    program = torch.export.export(module, (x0,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_TIER_FILE: json.dumps(tier)})
    blob = buf.getvalue()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


def export_solver(
    data: GPADData,
    config: SolverConfig = SolverConfig(),
    batch_size: int | None = None,
    path: str | Path | None = None,
) -> bytes:
    """Serialize a batched solve for this problem (``solve_batch``).

    The returned bytes (also written to ``path`` if given) reload with
    :func:`load_solver`. All problem constants (``GPADData``) are baked
    into the artifact; the only runtime input is ``x0`` of shape (B, n_x)
    float32, on the data's device. ``batch_size=None`` exports a symbolic
    batch on the torch engine; a concrete one routes as a live solve on
    the exporting device and serves that card type only (see the module
    docstring). Under a tier other than fp32 "highest" a concrete batch
    routes as the live call too: its kernel runs it at the tier."""
    _refuse_axes(config)
    core._check_config(config)
    if batch_size is None:
        config = dataclasses.replace(config, engine="torch")
    kernel = core.resolve_engine(data, config, batch_size or 1) == "cuda"
    module = _Solve(data, GPAD_TENSOR_FIELDS,
                    lambda d, x0: solve_batch(d, x0, config=config))
    return _export(module, data, batch_size, path,
                   _tier_record(config, kernel))


def load_solver(src: bytes | str | Path):
    """Deserialize an :func:`export_solver` (or
    :func:`export_stagewise_solver`) artifact into a callable.

    Returns ``solve(x0) -> dict`` with the ``SolveResult`` fields; ``x0``
    (a NumPy array or a tensor) is moved to the artifact's device. The
    launcher modules are imported first: deserialization resolves the
    kernel ops (``torch.ops.tpu_gpad_torch.*``) a concrete artifact holds.
    No re-trace happens; a symbolic artifact would load with
    ``torch.export.load`` alone. Each call runs with TF32 set as the
    artifact's tier sets it (off for fp32 "highest" and for an archive
    that records no tier), and the caller's setting restored after it."""
    from tpu_gpad_torch import stagewise_kernel, stagewise_stream  # noqa: F401
    from tpu_gpad_torch.solver import dual_kernels, kernels  # noqa: F401

    if not isinstance(src, (bytes, bytearray)):
        src = Path(src).read_bytes()
    extra = {_TIER_FILE: ""}
    program = torch.export.load(io.BytesIO(bytes(src)), extra_files=extra)
    tf32 = bool(json.loads(extra[_TIER_FILE] or "{}").get("tf32", False))
    device = next(iter(program.state_dict.values())).device
    module = program.module()

    def solve(x0):
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
        with core.tf32_matmuls(tf32):
            return module(x0)

    return solve


def export_stagewise_solver(
    data,
    config: SolverConfig = SolverConfig(),
    batch_size: int | None = None,
    path: str | Path | None = None,
) -> bytes:
    """:func:`export_solver` for the STAGE-WISE engine: one deployable
    long-horizon controller artifact with the O(N) Riccati constants
    baked in (``StagewiseData`` from ``build_stagewise``).

    Same two batch conventions: a symbolic batch pins the torch engine with
    sequential sweeps (the kernels' launches and the routing rules need a
    concrete B); a concrete ``batch_size`` resolves routing exactly as a
    live ``solve_stagewise`` would on the exporting device. The stage-wise
    engine runs fp32 "highest" whatever the config's tier, as
    ``tpu_gpad.stagewise`` does, and its artifact records that."""
    from tpu_gpad_torch.stagewise import (STAGEWISE_TENSOR_FIELDS,
                                          solve_stagewise)

    _refuse_axes(config)
    engine, scan = "auto", "auto"
    if batch_size is None:
        engine, scan = "torch", "sequential"
    module = _Solve(data, STAGEWISE_TENSOR_FIELDS,
                    lambda d, x0: solve_stagewise(d, x0, config=config,
                                                  engine=engine, scan=scan))
    return _export(module, data, batch_size, path,
                   _tier_record(SolverConfig()))
