"""Run one cell of the tpu_gpad_torch benchmark on a CUDA card.

    python3 gpad_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up the cell named in BENCHMARK.json
(the program's condensation and kernels, the seeded inputs, every shape
warmed up), measures for ``--seconds``, checks the answers of the window
against the plain reference and prints one JSON line last on standard
output: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics from a profiled sub-window (``--trace 1``). Earlier lines (``info
{...}``) carry what the line cannot: the card and its power limit, the
route, launches, build seconds, percentiles. The numbers compared with
the reference, each beside its limit, are the last lines on standard
error and the last key of the line. Without a card it exits with 2 and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def result_line(run, trace: bool, kind: str) -> dict:
    """The contract's last line for a finished run."""
    from gpad_bench import harness

    if trace:
        metrics = harness.per_layer_values(run)
    else:
        values = {**run.e2e, "setup_s": run.window_start - run.t_start}
        missing = [m["name"] for m in run.cell.end_to_end
                   if m["name"] not in values]
        if missing:
            raise RuntimeError(f"the driver reported no {missing}")
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in run.cell.end_to_end}
    device = {"platform": "gpu", "kind": kind,
              "count": run.cell.workload["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        tr = run.readings.get("trace")
        if tr is None or tr["busy_s"] <= 0:
            raise RuntimeError("the traced run read no device operation")
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = run.checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gpad_bench import harness

    t_torch = time.perf_counter()
    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the CUDA context
    t_context = time.perf_counter()
    run = harness.drive(cell, args.seed, args.seconds, bool(args.trace), dev,
                        T_START)
    from tpu_gpad_torch import cuda_build

    run.info.update(
        card=harness.nvidia_smi(), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc_s=dict(cuda_build.BUILD_SECONDS),
        setup_s=run.window_start - T_START, import_torch_s=t_torch - T_START,
        cuda_context_s=t_context - t_torch, dualize_s=run.readings.get("dualize_s"),
        memory_peak_bytes=run.memory_peak_bytes, seed=args.seed)
    line = result_line(run, bool(args.trace), torch.cuda.get_device_name(dev))
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print("info " + json.dumps(run.info), flush=True)
    print(json.dumps(line), flush=True)
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
