"""The port and chip_smoke.py import neither jax nor tpu_gpad (the machine
with the card has no jax), chip_smoke.py refuses to run without a card,
and the port exports every public name of tpu_gpad that it has ported."""

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
    for name in ("stagewise", "stagewise_kernel", "stagewise_stream", "io",
                 "solver.multi", "sweep", "robust", "estimator", "mhe",
                 "analysis", "utils.debug", "nonlinear", "device_condense",
                 "problems.pendulum", "problems.point_mass", "diff",
                 "parallel", "parallel.distrib", "parallel.mp_worker", "aot",
                 "utils.timing"):
        assert f"tpu_gpad_torch.{name}" in out["imported"]
    assert out["bad"] == []


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


# Public names of tpu_gpad that the port does not carry yet, each with the
# module (ROADMAP Queue 1) that brings it; the set shrinks with each slice.
UNPORTED = {
    # no counterpart: the port runs eagerly (tpu_gpad_torch/stagewise.py)
    "solve_stagewise_jit": "none, eager port",
}


def test_port_exports_what_tpu_gpad_exports():
    """Every name in the __all__ of tpu_gpad, tpu_gpad.solver,
    tpu_gpad.utils, tpu_gpad.problems and tpu_gpad.parallel is in the
    port's counterpart, or in UNPORTED; nothing in UNPORTED is exported by
    the port already."""
    import importlib

    missing, stale = {}, set()
    for sub in ("", ".solver", ".utils", ".problems", ".parallel"):
        ref = importlib.import_module("tpu_gpad" + sub)
        port = importlib.import_module("tpu_gpad_torch" + sub)
        gap = set(ref.__all__) - set(port.__all__)
        missing[sub] = sorted(gap - set(UNPORTED))
        stale |= set(UNPORTED) & set(port.__all__)
        for name in port.__all__:
            assert hasattr(port, name), f"tpu_gpad_torch{sub}.{name}"
    assert all(not v for v in missing.values()), missing
    assert not stale, stale
    from tpu_gpad_torch import polish, polish_batch  # noqa: F401
    from tpu_gpad_torch.solver import solve_multi, stack_data  # noqa: F401
    from tpu_gpad_torch.parallel import solve_stagewise_multi_sharded  # noqa: F401
    import tpu_gpad.parallel as jpar
    import tpu_gpad_torch.parallel as tpar

    assert tpar.__all__ == jpar.__all__
