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
    proc = _torch_cli(*argv)
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


@pytest.mark.parametrize(
    "argv,msg",
    [(["solve", "--dataset", "x.txt"], "--dataset"),
     (["solve", "--engine", "stagewise"], "stagewise"),
     (["info", "--cells", "3"], "`info`"),
     (["closedloop"], "`closedloop`")],
    ids=["dataset", "stagewise", "info", "closedloop"],
)
def test_unported_commands_say_so(argv, msg):
    from tpu_gpad_torch.cli import main

    with pytest.raises(SystemExit, match="not yet ported") as exc:
        main(argv)
    assert msg in str(exc.value)


def test_time_needs_a_card():
    """--time measures device time; without a card it fails, never falls
    back to the host clock."""
    proc = _torch_cli("solve", "--batch", "2", "--iterations", "5", "--time")
    assert proc.returncode != 0 and "CUDA" in proc.stderr
