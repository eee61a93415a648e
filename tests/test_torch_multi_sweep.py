"""``solve_multi``, ``run_sweep`` and the dataset CLI of the port against
``tpu_gpad``'s, on the same numpy inputs; and the slice as a whole: a
dataset that the JAX ``export`` writes, solved by the port's ``solve
--dataset``, against the JAX CLI and the NumPy oracle."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.cli import main as jax_main
from tpu_gpad.solver import SolverConfig as JConfig
from tpu_gpad.solver import solve_multi as j_solve_multi
from tpu_gpad.sweep import run_sweep as j_run_sweep

import tpu_gpad_torch as tg
from tpu_gpad_torch import cli
from tpu_gpad_torch.io import read_solver_dataset
from tpu_gpad_torch.solver import SolverConfig
from tpu_gpad_torch.solver.multi import solve_multi, stack_data
from tpu_gpad_torch.solver.reference import gpad_solve
from tpu_gpad_torch.sweep import run_sweep

torch.set_num_threads(2)

ITERS = 60
TOL = 1e-5  # fp32 sums in another order than XLA's over 60-100 iterations
ORACLE_TOL = 1e-4  # |u* - NumPy oracle|: the gate of bench.py


def _battery(pkg, capacity, limit, N=4):
    return pkg.problems.battery(3, N, cell_capacity_ah=capacity,
                                current_limit=limit)


# three plants of one shape: other cell capacities and current limits
PLANTS = ((0.11, 0.3), (0.08, 0.2), (0.15, 0.4))


def _stacks(paired):
    datas_j = [tpu_gpad.dualize(tpu_gpad.condense(_battery(tpu_gpad, c, lim)),
                                iterations=ITERS, paired=paired)
               for c, lim in PLANTS]
    datas_t = [tg.dualize(tg.condense(_battery(tg, c, lim)), iterations=ITERS,
                          paired=paired, device="cpu")
               for c, lim in PLANTS]
    return datas_j, datas_t


@pytest.mark.parametrize("paired", [False, "auto"], ids=["dense", "paired"])
def test_solve_multi_matches_jax(paired):
    datas_j, datas_t = _stacks(paired)
    X0 = np.random.default_rng(0).uniform(-0.4, 0.4, (3, 5, 3)).astype(np.float32)
    res_j = j_solve_multi(datas_j, X0, config=JConfig(iterations=ITERS))
    res_t = solve_multi(datas_t, X0, config=SolverConfig(iterations=ITERS))
    assert tuple(res_t.u.shape) == (3, 5, 3)
    for name in ("u", "z", "y", "residual"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)),
                                   atol=TOL, rtol=0, err_msg=name)
    # the limits genuinely differ: each plant's u* respects its own box
    u = res_t.u.numpy()
    for p, (_, lim) in enumerate(PLANTS):
        assert np.abs(u[p]).max() <= lim + 1e-2
    # warm start with the plant axis first, against per-plant solves
    stacked = stack_data(datas_t)
    warm = solve_multi(stacked, X0, config=SolverConfig(iterations=ITERS),
                       y0=res_t.y)
    for p, d in enumerate(datas_t):
        single = tg.solve_batch(d, X0[p], SolverConfig(iterations=ITERS),
                                y0=res_t.y[p])
        np.testing.assert_array_equal(warm.u[p].numpy(), single.u.numpy())


def test_stack_data_validates():
    short = tg.dualize(tg.condense(tg.problems.battery(3, 4)), iterations=ITERS,
                       device="cpu")
    longer = tg.dualize(tg.condense(tg.problems.battery(3, 5)),
                        iterations=ITERS, device="cpu")
    with pytest.raises(ValueError, match="horizon"):
        stack_data([short, longer])
    with pytest.raises(ValueError, match="at least one"):
        stack_data([])
    other = tg.dualize(tg.condense(tg.problems.battery(3, 4)), iterations=80,
                       device="cpu")
    with pytest.raises(ValueError, match="theta"):
        stack_data([short, other])
    soft = dataclasses.replace(short, soft_damp=torch.zeros(short.m))
    with pytest.raises(ValueError, match="soft"):
        stack_data([short, soft])
    paired = tg.dualize(tg.condense(tg.problems.battery(3, 4)),
                        iterations=ITERS, paired="auto", device="cpu")
    with pytest.raises(ValueError, match="D"):
        stack_data([paired, dataclasses.replace(paired, D=None)])
    with pytest.raises(ValueError, match="plants"):
        solve_multi([short, short], np.zeros((3, 2, 3), np.float32))


def _sweep_data():
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 6)),
                           iterations=ITERS, paired=False)
    d_t = tg.dualize(tg.condense(tg.problems.battery(3, 6)), iterations=ITERS,
                     paired=False, device="cpu")
    X0 = np.random.default_rng(11).uniform(-0.4, 0.4, (50, 3)).astype(np.float32)
    return d_j, d_t, X0


def test_run_sweep_matches_jax_and_resumes(tmp_path):
    d_j, d_t, X0 = _sweep_data()
    out_j = j_run_sweep(d_j, X0, JConfig(iterations=ITERS), chunk_size=16)
    calls = []

    def counting(d, x, c):
        calls.append(x.shape[0])
        return tg.solve_batch(d, x, config=c)

    ck = tmp_path / "sweep.npz"
    cfg = SolverConfig(iterations=ITERS)
    full = run_sweep(d_t, X0, cfg, chunk_size=16, checkpoint=ck,
                     solve_fn=counting)
    assert calls == [16, 16, 16, 2] and full.chunks_done == full.total_chunks == 4
    np.testing.assert_allclose(full.U, out_j.U, atol=TOL, rtol=0)
    np.testing.assert_allclose(full.residual, out_j.residual, atol=TOL, rtol=0)
    np.testing.assert_array_equal(full.iterations, out_j.iterations)
    np.testing.assert_array_equal(full.converged, out_j.converged)
    # a finished checkpoint resumes with no solve at all
    calls.clear()
    again = run_sweep(d_t, X0, cfg, chunk_size=16, checkpoint=ck,
                      solve_fn=counting)
    assert calls == []
    np.testing.assert_array_equal(again.U, full.U)
    # preempted after 2 chunks: only the unfinished ones run again
    meta_p = ck.with_suffix(".meta.json")
    meta = json.loads(meta_p.read_text())
    meta["chunks_done"] = 2
    meta_p.write_text(json.dumps(meta))
    resumed = run_sweep(d_t, X0, cfg, chunk_size=16, checkpoint=ck,
                        solve_fn=counting)
    assert calls == [16, 2]
    np.testing.assert_array_equal(resumed.U, full.U)
    # another fingerprint (config, scenarios) starts from scratch
    calls.clear()
    run_sweep(d_t, X0, SolverConfig(iterations=ITERS - 10), chunk_size=16,
              checkpoint=ck, solve_fn=counting)
    assert len(calls) == 4
    calls.clear()
    run_sweep(d_t, X0[::-1].copy(), SolverConfig(iterations=ITERS - 10),
              chunk_size=16, checkpoint=ck, solve_fn=counting)
    assert len(calls) == 4


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_dataset_slice_matches_jax_cli(tmp_path, capsys):
    """JAX's export writes the reference's dataset; the port's solve
    --dataset on the CPU reports JAX's keys (plus engine and device), u*
    within TOL of JAX's and within ORACLE_TOL of the NumPy oracle on the
    file's own constants and schedule."""
    path = tmp_path / "input_1.txt"
    assert jax_main(["export", "--out", str(path), "--seed", "3"]) == 0
    capsys.readouterr()
    argv = ["solve", "--dataset", str(path), "--iterations", "200"]
    assert jax_main(argv) == 0
    out_j = _last_json(capsys)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out_t = _last_json(capsys)
    assert set(out_t) == set(out_j) | {"engine", "device"}
    assert out_t["engine"] == "torch" and out_t["device"] == "cpu"
    for key in ("problem", "n_u", "horizon", "n_z", "m", "batch", "iterations",
                "converged_all"):
        assert out_t[key] == out_j[key], key
    assert out_t["iterations"] == 100  # clipped to the file's schedule
    np.testing.assert_allclose(out_t["u_star"], out_j["u_star"], atol=TOL, rtol=0)
    assert abs(out_t["residual_max"] - out_j["residual_max"]) < TOL
    ds = read_solver_dataset(path)
    ref = gpad_solve(ds.M_G, ds.g_P, ds.G_L, ds.p_D, ds.n_u,
                     iterations=ds.num_iterations, theta=ds.theta, beta=ds.beta)
    np.testing.assert_allclose(out_t["u_star"], ref.u, atol=ORACLE_TOL, rtol=0)


def test_export_matches_jax(tmp_path, capsys):
    argv = ["export", "--seed", "3", "--iterations", "50"]
    assert jax_main(argv + ["--out", str(tmp_path / "jax.txt")]) == 0
    out_j = _last_json(capsys)
    assert cli.main(argv + ["--out", str(tmp_path / "torch.txt"),
                            "--device", "cpu"]) == 0
    out_t = _last_json(capsys)
    assert set(out_t) == set(out_j) | {"device"}
    for key in ("n_u", "N", "m", "iterations", "x0"):
        assert out_t[key] == out_j[key], key
    a = read_solver_dataset(tmp_path / "torch.txt")
    b = read_solver_dataset(tmp_path / "jax.txt")
    assert (a.n_u, a.N, a.m, a.num_iterations) == (b.n_u, b.N, b.m, b.num_iterations)
    np.testing.assert_allclose(a.L, b.L, rtol=1e-6)
    for name in ("M_G", "g_P", "G_L", "p_D", "theta", "beta"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                   atol=1e-7, rtol=0, err_msg=name)


def test_sweep_cli_matches_jax(tmp_path, capsys):
    argv = ["sweep", "--batch", "40", "--chunk-size", "16", "--iterations", "60",
            "--paired", "off"]
    assert jax_main(argv + ["--out", str(tmp_path / "jax.npz")]) == 0
    lines_j = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    ck = tmp_path / "ck.npz"
    assert cli.main(argv + ["--out", str(tmp_path / "torch.npz"), "--device",
                            "cpu", "--checkpoint", str(ck)]) == 0
    lines_t = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert set(lines_t[0]) == set(lines_j[0]) | {"engine", "device"}
    for key in ("problem", "scenarios", "chunks", "converged_all"):
        assert lines_t[0][key] == lines_j[0][key], key
    assert lines_t[0]["checkpoint"] == str(ck) and ck.exists()
    with np.load(tmp_path / "jax.npz") as fj, np.load(tmp_path / "torch.npz") as ft:
        np.testing.assert_allclose(ft["U"], fj["U"], atol=TOL, rtol=0)


def test_sweep_sharded_cli_matches_jax(tmp_path, capsys):
    """``sweep --sharded`` in this process (a one-rank group on the CPU,
    made and destroyed by the command) against tpu_gpad's ``sweep
    --sharded`` over its virtual 8-device mesh, a ragged last chunk on
    both."""
    import torch.distributed as dist

    argv = ["sweep", "--batch", "44", "--chunk-size", "16", "--iterations",
            "40", "--cells", "3", "--horizon", "4", "--sharded"]
    assert jax_main(argv + ["--out", str(tmp_path / "jax.npz")]) == 0
    capsys.readouterr()
    assert cli.main(argv + ["--out", str(tmp_path / "torch.npz"), "--device",
                            "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert summary["scenarios"] == 44 and summary["chunks"] == 3
    assert not dist.is_initialized()  # the command's group is gone
    with np.load(tmp_path / "jax.npz") as fj, np.load(tmp_path / "torch.npz") as ft:
        assert ft["U"].shape == (44, 3)
        np.testing.assert_allclose(ft["U"], fj["U"], atol=TOL, rtol=0)


@pytest.mark.parametrize(
    "argv,msg",
    [(["solve", "--engine", "stagewise", "--dataset", "x.txt"],
      "not supported by `solve --dataset`")],
    ids=["dataset_stagewise"],
)
def test_unported_options_say_so(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        cli.main(argv + ["--device", "cpu"])
