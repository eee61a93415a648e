"""The readings that a cell's limits are set from, on the card.

    python3 gpad_bench/control.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 21,22,23 [--reference-seeds 31,32,33] --seconds <s>

runs the cell's driver once a seed in this one process (the kernels are
built once): sound runs of the program as the configuration states it,
and two controls one precision below float32 with TF32 off. The first is
the program with its TF32 path switched on (``precision="default"``);
the second is the plain reference put in the program's place, its loop
in float32 with every product's operands rounded to TF32
(``reference_in_place``). Each run prints one JSON line with its
compared numbers; the last line gives, for each number, the largest
sound reading and the smallest reading of each control. The benchmark's
own runs never run a control.
"""

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL_PRECISION = "default"


def reference_in_place(config: dict, device):
    """A wrapper of ``solve_batch`` that answers with the plain reference
    in float32 and TF32 products instead, warm-started from its own duals
    (on a CUDA device one graph a batch size, as the reference's replay)."""
    import torch

    import tpu_gpad_torch as tg
    from gpad_bench import harness
    from gpad_bench.reference.gpad import Gpad

    _, _, qp = harness.reference_qp(config)
    ref = Gpad(qp, config["solver"]["iterations"], device, tf32=True)
    graphs = {}

    def wrap(solve):
        def in_place(data, x0, config=tg.SolverConfig(), y0=None):
            X0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
            B = X0.shape[0]
            if y0 is None:
                y0 = torch.zeros((B, ref.MG_T.shape[0]), dtype=torch.float32,
                                 device=device)
            key = (B, config.restart)
            if key not in graphs:
                graphs[key] = ref.replayed(B, config.restart, device)
            z, y = (t.clone() for t in graphs[key](X0, y0.expand(B, -1)))
            nan = torch.full((B,), float("nan"), device=device)
            return tg.SolveResult(
                u=z[:, :data.n_u], z=z, y=y,
                iterations=torch.full((B,), ref.iterations, dtype=torch.int32,
                                      device=device),
                residual=nan, gap=nan,
                converged=torch.ones(B, dtype=torch.bool, device=device))
        return in_place
    return wrap


@contextlib.contextmanager
def solve_replaced(fault):
    """``solve_batch`` wrapped by ``fault`` where the drivers reach it."""
    import tpu_gpad_torch as tg
    import tpu_gpad_torch.closed_loop as closed_loop

    saved = tg.solve_batch, closed_loop.solve_batch
    tg.solve_batch = fault(saved[0])
    closed_loop.solve_batch = fault(saved[1])
    try:
        yield
    finally:
        tg.solve_batch, closed_loop.solve_batch = saved


def run_one(workload: str, seed: int, seconds: float, control=None,
            device=None, **overrides):
    """One run of the cell's driver, its compared numbers filled in:
    sound (``control`` None), the program's TF32 path (``"program"``) or
    the TF32 reference in the program's place (``"reference"``)."""
    import torch

    from gpad_bench import harness

    device = device or torch.device("cuda", 0)
    cell = harness.load_cell(workload)
    if control == "program":
        solver = {**cell.config["solver"], "precision": CONTROL_PRECISION}
        cell = dataclasses.replace(cell, config={**cell.config, "solver": solver})
    replaced = (solve_replaced(reference_in_place(cell.config, device))
                if control == "reference" else contextlib.nullcontext())
    with replaced:
        return harness.drive(cell, seed, seconds, False, device,
                             time.perf_counter(), **overrides)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--reference-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    plan = [(int(s), kind) for kind, seeds in (
        (None, args.seeds), ("program", args.control_seeds),
        ("reference", args.reference_seeds)) for s in seeds.split(",") if s]
    sound, least = {}, {"program": {}, "reference": {}}
    for seed, control in plan:
        r = run_one(args.workload, seed, args.seconds, control)
        values = {k: c["value"] for k, c in r.checks.items()}
        for k, v in values.items():
            if control is None:
                sound[k] = max(sound.get(k, v), v)
            else:
                least[control][k] = min(least[control].get(k, v), v)
        print(json.dumps({"seed": seed, "control": control,
                          "correct": r.correct, "attempted": r.attempted,
                          "checks": values, "info": r.info}), flush=True)
    print(json.dumps({"workload": args.workload, "sound_max": sound,
                      "control_min": least["program"],
                      "reference_control_min": least["reference"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
