"""The port and chip_smoke.py import neither jax nor tpu_gpad (the machine
with the card has no jax), and chip_smoke.py refuses to run without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import tpu_gpad_torch
names = [m.name for m in pkgutil.walk_packages(tpu_gpad_torch.__path__,
                                               "tpu_gpad_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "tpu_gpad"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "tpu_gpad_torch.solver.kernels" in out["imported"]
    assert "tpu_gpad_torch.cuda_build" in out["imported"]
    assert out["bad"] == []


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
