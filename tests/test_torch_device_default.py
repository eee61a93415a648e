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
from tpu_gpad_torch.stagewise import STAGEWISE_META_FIELDS, STAGEWISE_TENSOR_FIELDS
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

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


def _from_qp():
    from tpu_gpad_torch.robust import scenario_problem_variants, scenario_qp

    variants = scenario_problem_variants(
        _small(), B_list=[_small().B * s for s in (0.8, 1.2)])
    qp = scenario_qp([tg.condense(p) for p in variants])
    return tg.Controller.from_qp(qp, iterations=5).data.MG_T


_MHE = dict(A=np.array([[1.0, 0.1], [0.0, 0.97]]), B=np.array([[0.005], [0.1]]),
            C=np.array([[1.0, 0.0]]), window=4, w_max=np.ones(2))


def _mhe(engine):
    def call():
        est = tg.MovingHorizonEstimator(**_MHE, iterations=5, engine=engine)
        return est.data.E if engine == "stagewise" else est.data.MG_T
    return call


def _offset_free():
    problem = tp.double_integrator(horizon=4)
    off = tg.OffsetFreeController(problem, np.array([[1.0, 0.0]]),
                                  disturbance="input", iterations=5)
    return off.controller.data.MG_T


def _ekf():
    ekf = tg.ExtendedKalmanFilter(lambda x, u: x + u, lambda x: x[:1], n_x=1,
                                  n_y=1)
    ekf.update(np.zeros(1), np.zeros(1))  # its Jacobians run on ekf.device
    return torch.empty(0, device=ekf.device)


def _nmpc(device_condense):
    def call():
        ctrl = tg.NMPC(lambda x, u: x + 0.1 * u, 1, 1, 4, np.eye(1), np.eye(1),
                       u_min=-np.ones(1), u_max=np.ones(1), iterations=5,
                       device_condense=device_condense)
        ctrl.step(np.ones(1))
        return ctrl._us
    return call


def _robust_nmpc():
    f = lambda x, u: x + 0.1 * u
    ctrl = tg.RobustNMPC([f, f], 1, 1, 4, np.eye(1), np.eye(1),
                         u_min=-np.ones(1), u_max=np.ones(1), iterations=5,
                         device_condense=True)
    ctrl.step(np.ones(1))
    return ctrl._y


def _gpad_data_from_numpy():
    d = tg.dualize(tg.condense(_small()), iterations=5, device="cpu")
    fields = {k: None if getattr(d, k) is None else getattr(d, k).numpy()
              for k in GPAD_TENSOR_FIELDS}
    return tg.gpad_data_from_numpy(
        fields, {k: getattr(d, k) for k in GPAD_META_FIELDS}).MG_T


def _stagewise_data_from_numpy():
    d = tg.build_stagewise(_small(), iterations=5, device="cpu")
    fields = {k: getattr(d, k).numpy() for k in STAGEWISE_TENSOR_FIELDS}
    return tg.stagewise_data_from_numpy(
        fields, {k: getattr(d, k) for k in STAGEWISE_META_FIELDS}).E


def _dataset(tmp):
    path = tmp / "input_1.txt"
    cli.main(["export", "--out", str(path), "--horizon", "4", "--iterations",
              "5", "--device", "cpu"])
    return path


def _dataset_to_gpad_data(tmp):
    from tpu_gpad_torch import io

    return io.dataset_to_gpad_data(io.read_solver_dataset(_dataset(tmp))).MG_T


def _load_gpad_data(tmp):
    from tpu_gpad_torch import io

    path = tmp / "data.npz"
    io.save_gpad_data(path, tg.dualize(tg.condense(_small()), iterations=5,
                                       device="cpu"))
    return io.load_gpad_data(path).MG_T


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
    "gpad_data_from_numpy": _gpad_data_from_numpy,
    "stagewise_data_from_numpy": _stagewise_data_from_numpy,
    "Controller.from_qp": _from_qp,
    "MovingHorizonEstimator": _mhe("condensed"),
    "MovingHorizonEstimator_stagewise": _mhe("stagewise"),
    "OffsetFreeController": _offset_free,
    "ExtendedKalmanFilter": _ekf,
    "NMPC": _nmpc(False),
    "NMPC_device_condense": _nmpc(True),
    "RobustNMPC": _robust_nmpc,
}
# entry points that read a file, written on the CPU into the test's tmp_path
FILE_ENTRY_POINTS = {
    "dataset_to_gpad_data": _dataset_to_gpad_data,
    "load_gpad_data": _load_gpad_data,
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


@pytest.mark.parametrize("name", list(FILE_ENTRY_POINTS))
def test_file_entry_point_defaults_to_the_card(name, tmp_path, capsys):
    call = FILE_ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert call(tmp_path).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        call(tmp_path)


@pytest.mark.parametrize("command", ["dataset", "sweep", "export"])
def test_cli_commands_default_to_the_card(command, tmp_path, capsys):
    argv = {
        "dataset": ["solve", "--dataset", str(_dataset(tmp_path))],
        "sweep": ["sweep", "--batch", "4", "--iterations", "5", "--horizon",
                  "4"],
        "export": ["export", "--out", str(tmp_path / "out.txt"),
                   "--iterations", "5", "--horizon", "4"],
    }[command]
    capsys.readouterr()

    def run():
        cli.main(argv)
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["device"]
    if torch.cuda.is_available():
        assert run().startswith("cuda")
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        run()
