"""The port's entry points place their data on the card unless the caller
asks for the CPU: without a CUDA device, a call that names no device raises
PyTorch's own error instead of running on the host. With a card, the same
call lands there. Whether a card is present is decided inside each test."""

import json

import numpy as np
import pytest
import torch

import tpu_gpad_torch as tg
from tpu_gpad_torch import cli
from tpu_gpad_torch import problems as tp

torch.set_num_threads(2)


def _small():
    return tp.battery(3, 4)


def _dualize():
    return tg.dualize(tg.condense(_small()), iterations=5).MG_T


def _simulate():
    return tg.simulate(_small(), np.zeros((2, 3), np.float32), n_steps=2,
                       iterations=5).U


def _controller():
    return tg.Controller(_small(), iterations=5).data.MG_T


def _build_stagewise():
    return tg.build_stagewise(_small(), iterations=5).E


def _stagewise_controller():
    return tg.StagewiseController(_small(), iterations=5).data.E


def _auto_solver():
    return tg.auto_solver(_small(), iterations=5)[1].L


def _cli(*extra):
    def run(capsys):
        cli.main(["solve", "--batch", "2", "--iterations", "5", "--horizon",
                  "4", *extra])
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["device"]
    return run


ENTRY_POINTS = {
    "dualize": _dualize,
    "simulate": _simulate,
    "Controller": _controller,
    "build_stagewise": _build_stagewise,
    "StagewiseController": _stagewise_controller,
    "auto_solver": _auto_solver,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    call = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        call()


@pytest.mark.parametrize("engine", ["auto", "stagewise"])
def test_cli_solve_defaults_to_the_card(engine, capsys):
    run = _cli("--engine", engine)
    if torch.cuda.is_available():
        assert run(capsys).startswith("cuda")
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        run(capsys)
