"""``python -m tpu_gpad_torch solve`` against ``python -m tpu_gpad solve``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_gpad.cli import main as jax_main

import tpu_gpad_torch as tg
from tpu_gpad_torch import aot

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _torch_cli(*argv):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "tpu_gpad_torch", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )


def test_solve_matches_jax_cli(capsys):
    argv = ["solve", "--batch", "16"]
    proc = _torch_cli(*argv, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    (out_t,) = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    assert jax_main(argv) == 0
    (out_j,) = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert set(out_t) == set(out_j) | {"engine", "device"}
    assert out_t["engine"] == "torch" and out_t["device"] == "cpu"
    for key in ("problem", "n_u", "horizon", "n_z", "m", "batch", "iterations",
                "converged_all"):
        assert out_t[key] == out_j[key], key
    np.testing.assert_allclose(out_t["u_star"], out_j["u_star"], atol=2e-5, rtol=0)
    assert abs(out_t["residual_max"] - out_j["residual_max"]) < 2e-5


def test_sweep_sharded_one_rank_equals_sweep(tmp_path):
    """Started alone, ``sweep --sharded`` runs a one-rank group on
    --device (as tpu_gpad's make_mesh() takes the devices of its one
    process), the ragged last chunk padded to the mesh and sliced back:
    the same U as the unsharded sweep (tests/test_cli.py's check)."""
    argv = ["sweep", "--cells", "3", "--horizon", "4", "--iterations", "40",
            "--batch", "44", "--chunk-size", "16", "--device", "cpu"]
    outs = {}
    for name, extra in (("sharded", ["--sharded"]), ("direct", [])):
        path = tmp_path / f"{name}.npz"
        proc = _torch_cli(*argv, *extra, "--out", str(path))
        assert proc.returncode == 0, proc.stderr
        (summary, saved) = [json.loads(ln) for ln in
                            proc.stdout.strip().splitlines()]
        assert summary["scenarios"] == 44 and summary["chunks"] == 3
        assert saved == {"results": str(path)}
        with np.load(path) as f:
            outs[name] = f["U"]
    assert outs["sharded"].shape == (44, 3)
    np.testing.assert_array_equal(outs["sharded"], outs["direct"])


@pytest.mark.parametrize("batch", [None, 5], ids=["symbolic", "batch5"])
def test_export_aot_artifact(tmp_path, batch):
    """``export --aot`` (tests/test_cli.py's case) writes a torch.export
    artifact with tpu_gpad's keys plus ``device`` and ``route``; it reloads
    and solves, equal to the live solve, symbolic at any batch or at the
    ``--aot-batch`` it was exported for."""
    path = tmp_path / "solver.pt2"
    argv = ["export", "--cells", "3", "--horizon", "4", "--iterations", "40",
            "--aot", "--out", str(path), "--device", "cpu"]
    if batch is not None:
        argv += ["--aot-batch", str(batch)]
    proc = _torch_cli(*argv)
    assert proc.returncode == 0, proc.stderr
    (out,) = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    assert set(out) == {"artifact", "bytes", "batch", "n_x", "n_u", "device",
                        "route"}
    assert out["bytes"] == path.stat().st_size > 0
    assert out["batch"] == (batch or "symbolic")
    assert (out["n_x"], out["n_u"], out["device"], out["route"]) == (
        3, 3, "cpu", "torch")
    res = aot.load_solver(path)(np.zeros((batch or 5, 3), dtype=np.float32))
    assert res["u"].shape == (batch or 5, 3)
    data = tg.dualize(tg.condense(tg.problems.battery(3, 4)), 40,
                      paired="auto", device="cpu")
    live = tg.solve_batch(data, np.zeros((batch or 5, 3), np.float32),
                          tg.SolverConfig(iterations=40))
    assert torch.equal(res["u"], live.u)


def test_time_needs_a_card():
    """--time measures device time; without a card it fails, never falls
    back to the host clock."""
    proc = _torch_cli("solve", "--batch", "2", "--iterations", "5", "--time",
                      "--device", "cpu")
    assert proc.returncode != 0 and "CUDA" in proc.stderr
