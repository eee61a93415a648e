"""``tpu_gpad_torch.io`` against ``tpu_gpad.io``: the reference's text
formats read and written bit for bit by both packages, the ``M_G`` sign
convention, and ``.npz`` files that load in either package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import io as jio
from tpu_gpad import problems as jp
from tpu_gpad.condense import lipschitz_constant
from tpu_gpad.schedule import momentum_schedule

import tpu_gpad_torch as tg
from tpu_gpad_torch import io as tio
from tpu_gpad_torch.solver.reference import gpad_solve
from tpu_gpad_torch.types import GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 60
_ARRAYS = ("M_G", "g_P", "G_L", "p_D", "theta", "beta")


def _dataset(cls, n=3, N=4, seed=1):
    """A reference-format dataset of battery(n, N) at a seeded x0, as the
    reference's MATLAB generator builds it (canonical M_G sign)."""
    qp = tpu_gpad.condense(jp.battery(n_cells=n, horizon=N))
    x0 = np.random.default_rng(seed).uniform(-0.4, 0.4, n)
    L = lipschitz_constant(qp)
    b = qp.b0 + qp.E @ x0
    theta, beta = momentum_schedule(ITERS)
    return cls(
        n_u=n, N=N, m=qp.m, num_iterations=ITERS, L=L,
        M_G=np.linalg.solve(qp.H, qp.G.T).astype(np.float32),
        g_P=np.linalg.solve(qp.H, qp.F.T @ x0).astype(np.float32),
        G_L=(qp.G / L).astype(np.float32),
        p_D=(-b / L).astype(np.float32),
        theta=theta, beta=beta,
    )


def _assert_same(a, b):
    assert (a.n_u, a.N, a.m, a.num_iterations, a.L) == (
        b.n_u, b.N, b.m, b.num_iterations, b.L)
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), name)


@pytest.mark.parametrize("negated_mg", [True, False], ids=["negated", "canonical"])
def test_dataset_round_trip(tmp_path, negated_mg):
    ds = _dataset(tio.SolverDataset)
    path = tmp_path / "input_1.txt"
    tio.write_solver_dataset(path, ds, negated_mg=negated_mg)
    back = tio.read_solver_dataset(path, negated_mg=negated_mg)
    assert (back.n_u, back.N, back.m, back.num_iterations) == (
        ds.n_u, ds.N, ds.m, ds.num_iterations)
    for name in _ARRAYS:
        np.testing.assert_allclose(getattr(back, name), getattr(ds, name),
                                   atol=1e-7, rtol=0, err_msg=name)
    # a second pass through the text is exact
    tio.write_solver_dataset(tmp_path / "again.txt", back, negated_mg=negated_mg)
    _assert_same(tio.read_solver_dataset(tmp_path / "again.txt", negated_mg),
                 back)


def test_jax_written_dataset_reads_bit_for_bit(tmp_path):
    path = tmp_path / "input_2.txt"
    jio.write_solver_dataset(path, _dataset(jio.SolverDataset))
    _assert_same(tio.read_solver_dataset(path), jio.read_solver_dataset(path))
    # and the port writes the same text
    tio.write_solver_dataset(tmp_path / "port.txt", tio.read_solver_dataset(path))
    assert (tmp_path / "port.txt").read_text() == path.read_text()


def test_mg_sign_convention(tmp_path):
    """The file stores M_G negated (the CUDA kernel's zhat = +M_G w - g_P);
    read with the default, it is canonical again, and read raw it
    reproduces the canonical solve under the CUDA sign."""
    ds = _dataset(tio.SolverDataset)
    path = tmp_path / "input_3.txt"
    tio.write_solver_dataset(path, ds)
    first = float(path.read_text().split()[5])
    np.testing.assert_allclose(first, -ds.M_G.reshape(-1)[0], atol=1e-7)
    raw = tio.read_solver_dataset(path, negated_mg=False)
    canon = tio.read_solver_dataset(path)
    np.testing.assert_array_equal(raw.M_G, -canon.M_G)
    r_canon = gpad_solve(canon.M_G, canon.g_P, canon.G_L, canon.p_D, canon.n_u,
                         iterations=ITERS, theta=canon.theta, beta=canon.beta)
    r_cuda = gpad_solve(raw.M_G, raw.g_P, raw.G_L, raw.p_D, raw.n_u,
                        iterations=ITERS, theta=raw.theta, beta=raw.beta,
                        negated_mg=True)
    np.testing.assert_array_equal(r_canon.u, r_cuda.u)


def test_dataset_to_gpad_data_matches_jax(tmp_path):
    path = tmp_path / "input_4.txt"
    tio.write_solver_dataset(path, _dataset(tio.SolverDataset))
    d_j = jio.dataset_to_gpad_data(jio.read_solver_dataset(path))
    d_t = tio.dataset_to_gpad_data(tio.read_solver_dataset(path), device="cpu")
    assert not d_t.paired and d_t.n_x == 1 and d_t.name == d_j.name
    assert d_t.max_iters == ITERS
    for name in GPAD_TENSOR_FIELDS:
        a = getattr(d_j, name)
        if a is None:
            assert getattr(d_t, name) is None, name
            continue
        np.testing.assert_array_equal(getattr(d_t, name).numpy(), np.asarray(a),
                                      err_msg=name)
    res = tg.solve_batch(d_t, np.zeros((1, 1), np.float32))
    ref = tpu_gpad.solve_batch(d_j, jnp.zeros((1, 1)))
    np.testing.assert_allclose(res.u.numpy(), np.asarray(ref.u), atol=1e-5, rtol=0)


@pytest.mark.parametrize("paired", [False, "auto"], ids=["dense", "paired"])
def test_npz_loads_in_either_package(tmp_path, paired):
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 4)),
                           iterations=ITERS, paired=paired)
    d_t = tg.dualize(tg.condense(tg.problems.battery(3, 4)), iterations=ITERS,
                     paired=paired, device="cpu")
    jio.save_gpad_data(tmp_path / "jax.npz", d_j)
    tio.save_gpad_data(tmp_path / "torch.npz", d_t)
    with np.load(tmp_path / "jax.npz") as fj, np.load(tmp_path / "torch.npz") as ft:
        assert sorted(fj.files) == sorted(ft.files)
    from_jax = tio.load_gpad_data(tmp_path / "jax.npz", device="cpu")
    from_torch = jio.load_gpad_data(tmp_path / "torch.npz")
    for back, src in ((from_jax, d_j), (from_torch, d_t)):
        assert (back.n_u, back.n_x, back.horizon, back.name, back.paired) == (
            src.n_u, src.n_x, src.horizon, src.name, src.paired)
        assert back.n_struct is None  # neither file format records it
    for name in GPAD_TENSOR_FIELDS:
        a = getattr(d_j, name)
        if a is None:
            assert getattr(from_jax, name) is None, name
            continue
        np.testing.assert_array_equal(getattr(from_jax, name).numpy(),
                                      np.asarray(a), err_msg=name)
        np.testing.assert_array_equal(np.asarray(getattr(from_torch, name)),
                                      getattr(d_t, name).numpy(), err_msg=name)
    own = tio.load_gpad_data(tmp_path / "torch.npz", device="cpu")
    x0 = np.random.default_rng(2).uniform(-0.4, 0.4, (4, 3)).astype(np.float32)
    np.testing.assert_array_equal(tg.solve_batch(own, x0).u.numpy(),
                                  tg.solve_batch(dataclasses.replace(
                                      d_t, n_struct=None), x0).u.numpy())


def test_step3_fixture_reads_like_jax(tmp_path):
    n_u, N, m, theta = 2, 3, 30, 0.75
    vals = np.random.default_rng(3).normal(size=2 * n_u * N).astype(np.float32)
    (tmp_path / "input.txt").write_text(
        f"{n_u} {N} {m} {theta}\n" + "\n".join(f"{v:.8f}" for v in vals))
    np.savetxt(tmp_path / "output.txt", vals[: n_u * N] * 0.5)
    a, b = tio.read_step3_fixture(tmp_path), jio.read_step3_fixture(tmp_path)
    assert (a.n_u, a.N, a.m, a.theta) == (b.n_u, b.N, b.m, b.theta)
    for name in ("z_prev", "zhat", "expected_z"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), name)
    (tmp_path / "output.txt").write_text("1.0\n")
    with pytest.raises(ValueError, match="output.txt"):
        tio.read_step3_fixture(tmp_path)
