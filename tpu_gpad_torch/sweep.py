"""Large scenario sweeps with checkpoint/resume; the counterpart of
``tpu_gpad.sweep``.

The reference has no persistence: solver state lives only in device memory
for the 100-iteration run. For sweeps of 100k+ scenarios a preempted run
must not restart from scratch, so this runner processes the scenario batch
in fixed-size chunks, writes the results to an on-disk ``.npz`` checkpoint
after every chunk (atomically: a temporary file, then a rename), and
resumes from the first unfinished chunk, but only when the checkpoint's
fingerprint (batch, chunking, problem, solver config, scenarios) matches.
State is host-side NumPy; the solver is stateless between chunks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tpu_gpad_torch.solver.core import SolverConfig, solve_batch
from tpu_gpad_torch.types import GPADData


@dataclass
class SweepResult:
    U: np.ndarray  # (B, n_u)
    residual: np.ndarray  # (B,)
    iterations: np.ndarray  # (B,)
    converged: np.ndarray  # (B,)
    chunks_done: int
    total_chunks: int
    wall_s: float


def _ckpt_paths(checkpoint: str | Path):
    checkpoint = Path(checkpoint)
    return checkpoint, checkpoint.with_suffix(".meta.json")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_sweep(
    data: GPADData,
    X0: np.ndarray,
    config: SolverConfig = SolverConfig(),
    chunk_size: int = 4096,
    checkpoint: str | Path | None = None,
    solve_fn=None,
    progress: bool = False,
) -> SweepResult:
    """Solve ``X0`` (B, n_x) scenarios in chunks, checkpointing after each.

    ``solve_fn(data, x0_chunk, config) -> SolveResult`` defaults to the
    port's ``solve_batch`` on the data's device (the chunk is moved
    there). If ``checkpoint`` exists with a matching fingerprint, finished
    chunks are loaded and skipped (resume). The final checkpoint holds the
    full result arrays.
    """
    X0 = np.asarray(X0, dtype=np.float32)
    B = X0.shape[0]
    n_chunks = (B + chunk_size - 1) // chunk_size
    if solve_fn is None:
        solve_fn = lambda d, x, c: solve_batch(d, x, config=c)

    U = np.zeros((B, data.n_u), dtype=np.float32)
    residual = np.zeros(B, dtype=np.float32)
    iterations = np.zeros(B, dtype=np.int32)
    converged = np.zeros(B, dtype=bool)
    start_chunk = 0

    # a checkpoint is only resumable for the same scenarios, problem,
    # batch, chunking, and solver config: anything else would silently
    # mix stale rows in
    cfg_fp = json.dumps(dataclasses.asdict(config), sort_keys=True, default=str)
    x0_fp = hashlib.sha256(np.ascontiguousarray(X0).tobytes()).hexdigest()
    ck, meta_p = _ckpt_paths(checkpoint) if checkpoint else (None, None)
    if ck is not None and ck.exists() and meta_p.exists():
        meta = json.loads(meta_p.read_text())
        if (
            meta["batch"] == B
            and meta["chunk_size"] == chunk_size
            and meta.get("problem") == data.name
            and meta.get("config") == cfg_fp
            and meta.get("x0_sha256") == x0_fp
        ):
            with np.load(ck) as f:
                U, residual = f["U"], f["residual"]
                iterations, converged = f["iterations"], f["converged"]
            start_chunk = meta["chunks_done"]

    t0 = time.perf_counter()
    for c in range(start_chunk, n_chunks):
        lo, hi = c * chunk_size, min((c + 1) * chunk_size, B)
        res = solve_fn(data, X0[lo:hi], config)
        U[lo:hi] = _host(res.u)
        residual[lo:hi] = _host(res.residual)
        iterations[lo:hi] = _host(res.iterations)
        converged[lo:hi] = _host(res.converged)
        if ck is not None:
            tmp = ck.with_suffix(".tmp.npz")
            np.savez(tmp, U=U, residual=residual, iterations=iterations,
                     converged=converged)
            tmp.replace(ck)
            meta_p.write_text(json.dumps(dict(
                batch=B, chunk_size=chunk_size, chunks_done=c + 1,
                n_chunks=n_chunks, problem=data.name, config=cfg_fp,
                x0_sha256=x0_fp,
            )))
        if progress:
            print(f"chunk {c + 1}/{n_chunks} done "
                  f"({hi}/{B} scenarios)", flush=True)
    return SweepResult(
        U=U, residual=residual, iterations=iterations, converged=converged,
        chunks_done=n_chunks, total_chunks=n_chunks,
        wall_s=time.perf_counter() - t0,
    )
