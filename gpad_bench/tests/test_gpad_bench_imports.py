"""What a run loads: no JAX and no JAX package, and a reference that
takes nothing of the program. Each in a fresh interpreter, comparing
whole top-level module names (``tpu_gpad_torch`` begins with
``tpu_gpad``)."""

import json
import os
import subprocess
import sys

import pytest

from gpad_bench import harness

ROOT = str(harness.ROOT)


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_drivers_load_no_jax():
    loaded = _loaded(
        "import runpy; runpy.run_path('gpad_bench/run.py', run_name='x')\n"
        "import sys; sys.path.insert(0, '.')\n"
        "from gpad_bench import harness\n"
        "for d in ('fleet', 'serve'):\n"
        "    harness.load_module(harness.BENCH / 'drivers' / f'{d}.py')\n"
        "import tpu_gpad_torch, tpu_gpad_torch.closed_loop\n"
        "import tpu_gpad_torch.solver.kernels, tpu_gpad_torch.solver.dual_kernels")
    assert "tpu_gpad_torch" in loaded
    assert not loaded & harness.FORBIDDEN


def test_reference_takes_nothing_of_the_program():
    loaded = _loaded(
        "import sys; sys.path.insert(0, '.')\n"
        "import gpad_bench.reference.gpad, gpad_bench.reference.battery\n"
        "import gpad_bench.work")
    assert not loaded & (harness.FORBIDDEN | {"tpu_gpad_torch"})


@pytest.mark.parametrize("workload", ["battery_n3_N10.fleet"])
def test_no_card_no_result(workload):
    """Without a card run.py exits with 2 and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "gpad_bench/run.py", "--workload", workload,
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
