"""What every cell shares: finding its files by name, seeds, the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its files are
found by name: the configuration's ``file``, ``traffic/<traffic>.json``
(whose ``driver`` names ``drivers/<driver>.py``), ``limits/<cell>.json``
(the limits of the numbers that decide ``correct``), the plant's plain
reference ``reference/<plant>.py`` (the configuration's ``plant``), and
one reader ``metrics/<metric>.py`` for each per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_gpad"}


def load_module(path: Path, name: str | None = None):
    """Import a file of the benchmark by its path (its name may hold dots)."""
    name = name or "gpad_bench_" + path.stem.replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with every file it names."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in spec["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(it has {sorted(workloads)})")
    w = workloads[name]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name, w, config, traffic, limits, e2e, per_layer)


def seeded(seed: int, stream: int) -> np.random.Generator:
    """An independent NumPy generator for each of a run's streams; any
    whole number is a seed."""
    return np.random.default_rng([seed % 2**64, stream])


@dataclass
class Run:
    """A driver's inputs and what it hands back to ``run.py``."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_start: float  # the process's first clock reading: set-up counts from it
    overrides: dict = field(default_factory=dict)
    # filled by the driver
    window_start: float = math.nan
    attempted: int = 0
    failed: int = 0
    e2e: dict = field(default_factory=dict)
    readings: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)
    info: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0

    @property
    def traffic(self) -> dict:
        return {**self.cell.traffic, **self.overrides}

    def check(self, name: str, value: float) -> None:
        """A compared number beside its limit: correct while value <= limit
        (a NaN is never correct)."""
        self.checks[name] = {"value": float(value),
                             "limit": float(self.cell.limits[name])}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks.values())


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device,
          t_start: float, **overrides) -> Run:
    """One run of the cell's driver (set-up, window, check) on ``device``,
    the reference beside it; the look for a card is the caller's."""
    run = Run(cell, seed, seconds, trace, device, t_start, overrides=overrides)
    load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py").run(run)
    return run


def per_layer_values(run: Run) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in run.cell.per_layer:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py")
        value = reader.read(run.readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & FORBIDDEN)


def nvidia_smi() -> str:
    """The card's name, power limit, clocks and temperature, as read."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def quantile(values, q: float) -> float:
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


# -- the program's side: what a configuration asks of tpu_gpad_torch ------

def program_problem(tg, config: dict):
    """The plant as the program builds it, from the configuration's
    parameters (``tpu_gpad_torch.problems.<plant>``)."""
    return getattr(tg.problems, config["plant"])(**config["problem"])


def solver_config(tg, config: dict, traffic: dict):
    """The deployment's precision and the mix's solver options."""
    s = config["solver"]
    return tg.SolverConfig(precision=s["precision"],
                           matmul_dtype=s["matmul_dtype"],
                           **traffic.get("solver", {}))


def reference_qp(config: dict):
    """The plant's condensed QP by the plain reference, and its plant."""
    plant_ref = load_module(BENCH / "reference" / f"{config['plant']}.py")
    plant = plant_ref.plant(config["problem"])
    return plant_ref, plant, plant_ref.condense(plant)


def launch_counts() -> dict:
    """The program's kernel launch counters (module integers)."""
    from tpu_gpad_torch.solver import dual_kernels, kernels

    return {f"{mod.__name__.rsplit('.', 1)[-1]}.{k}": v
            for mod in (kernels, dual_kernels)
            for k, v in vars(mod).items()
            if k.endswith("_LAUNCHES") and isinstance(v, int)}


def launches_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()
            if v != before.get(k, 0)}


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated(device))


def release(device) -> None:
    """Hand the freed program state's blocks back before the reference."""
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def max_gap(a, b) -> float:
    """max |a - b|, infinite where either holds a NaN or an infinity."""
    import torch

    d = (a.to(b.dtype) - b).abs()
    return float(d.max()) if bool(torch.isfinite(d).all()) else math.inf
