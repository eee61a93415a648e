"""On the card: each cell's run through run.py, and its control.

Skipped without a CUDA device (decided inside each test); run on the
machine with the card:

    python -m pytest gpad_bench/tests/test_gpad_bench_card.py -q -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest

from gpad_bench import control, harness

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_run_prints_a_correct_line(cell, trace):
    _card()
    out = subprocess.run(
        [sys.executable, "gpad_bench/run.py", "--workload", cell, "--seed",
         str(2**31 + 3), "--seconds", "2", "--trace", str(trace)],
        cwd=str(harness.ROOT), capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for m in line["metrics"]:
            if "roofline" in m:
                assert 0 < line["metrics"][m]["value"] <= 105


@pytest.mark.parametrize("kind", ["program", "reference"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, kind):
    """Either control fails the cell's limits: the program with its TF32
    path on, and the TF32 reference in the program's place. The same seed
    as the configuration states it passes."""
    _card()
    assert control.run_one(cell, 17, 1.0).correct
    assert not control.run_one(cell, 17, 1.0, control=kind).correct
