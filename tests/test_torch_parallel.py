"""``tpu_gpad_torch.parallel`` in one process, against ``tpu_gpad.parallel``:
the inert dual-row padding bit for bit, the sharding specs field by
field, the errors, and a one-rank gloo group on the CPU in which the
sharded solves equal the unsharded ones. The collectives across ranks are
tested in ``test_torch_multiprocess.py``."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.parallel import distrib as jdist
from tpu_gpad.solver import SolverConfig as JConfig

import tpu_gpad_torch as tg
from tpu_gpad_torch import parallel
from tpu_gpad_torch.convert import gpad_data_from_numpy
from tpu_gpad_torch.parallel import distrib
from tpu_gpad_torch.solver import SolverConfig, solve_batch
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 100


def _jax_data(paired):
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=4))  # m 56
    return tpu_gpad.dualize(qp, iterations=400, paired=paired)


def _port(d_j):
    """tpu_gpad's data as the port's, bit for bit."""
    fields = {f: None if getattr(d_j, f) is None else np.asarray(getattr(d_j, f))
              for f in GPAD_TENSOR_FIELDS}
    meta = {k: getattr(d_j, k) for k in GPAD_META_FIELDS}
    return gpad_data_from_numpy(fields, meta, device="cpu")


def _x0(B=32):
    return np.random.default_rng(7).uniform(-0.5, 0.5, (B, 3)).astype(np.float32)


@pytest.mark.parametrize("paired", [False, True], ids=["dense", "paired"])
def test_pad_dual_rows_bit_for_bit(paired):
    d_j = _jax_data(paired)
    pad_j = jdist.pad_dual_rows(d_j, 5)
    pad_t = distrib.pad_dual_rows(_port(d_j), 5)
    assert pad_t.n_struct is None and pad_j.n_struct is None
    for f in GPAD_TENSOR_FIELDS:
        a, b = getattr(pad_j, f), getattr(pad_t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
            assert b.dtype == torch.float32, f
    assert distrib.pad_dual_rows(_port(d_j), 0).n_struct == d_j.n_struct


def test_pad_dual_rows_is_inert():
    """Identical u/z/residual/gap to the unpadded solve, and the padded
    dual rows stay exactly zero (tests/test_distrib.py's check)."""
    data = _port(_jax_data(True))
    padded = parallel.pad_dual_rows(data, 5)
    assert padded.m_half == data.m_half + 5
    cfg = SolverConfig(iterations=ITERS)
    ref = solve_batch(data, _x0(), cfg)
    out = solve_batch(padded, _x0(), cfg)
    np.testing.assert_allclose(out.u, ref.u, atol=1e-6)
    np.testing.assert_allclose(out.y[..., : data.m_half], ref.y, atol=1e-6)
    assert (out.y[..., data.m_half:] == 0).all()
    np.testing.assert_allclose(out.residual, ref.residual, atol=1e-5)
    np.testing.assert_allclose(out.gap, ref.gap, rtol=1e-5, atol=1e-6)


def _dim(spec, axis):
    """The dimension of a PartitionSpec sharded over ``axis``, or None."""
    if axis is None or axis not in tuple(spec):
        return None
    return tuple(spec).index(axis)


@pytest.mark.parametrize("model_axis", [None, "model"], ids=["dp", "tp"])
@pytest.mark.parametrize("paired", [False, True], ids=["dense", "paired"])
def test_data_specs_match_jax(paired, model_axis):
    d_j = _jax_data(paired)
    spec_j = jdist.data_specs(d_j, model_axis)
    spec_t = parallel.data_specs(_port(d_j), model_axis)
    for f in GPAD_TENSOR_FIELDS:
        ref = getattr(spec_j, f)
        if ref is None:  # an absent optional field
            assert f not in spec_t, f
        else:
            assert spec_t[f] == _dim(ref, model_axis or "model"), f


@pytest.mark.parametrize("paired", [False, True], ids=["dense", "paired"])
def test_result_specs_match_jax(paired):
    for da, ma in (("data", None), ("data", "model"), (None, "model")):
        spec_j = jdist.result_specs(da, ma, paired)
        spec_t = distrib.result_specs(da, ma, paired)
        for f, dims in spec_t.items():
            ref = getattr(spec_j, f)
            assert dims == (_dim(ref, da), _dim(ref, ma)), (f, da, ma)


def test_make_mesh_needs_a_process_group():
    """Without an initialized group make_mesh raises; it never makes a
    mesh of its own on the CPU."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        parallel.make_mesh(device_type="cpu")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group on the CPU, destroyed after the module."""
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield parallel.make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cfg, model_axis", [
    (SolverConfig(iterations=ITERS), None),
    (SolverConfig(iterations=ITERS), "model"),
    (SolverConfig(iterations=ITERS, restart=True), "model"),
    (SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10), None),
    (SolverConfig(mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10,
                  iterations=195, restart=True), "model"),
], ids=["dp_fixed", "tp_fixed", "tp_restart", "dp_eps", "tp_eps_restart"])
def test_one_rank_group_equals_solve_batch(one_rank, cfg, model_axis):
    """On one rank every collective is the identity: the sharded solve,
    sharded X0 or replicated, is the unsharded one in the same form (the
    mvp form without the flat block under ``model_axis``) exactly."""
    mesh = one_rank
    data = _port(_jax_data(True))
    if model_axis is not None:
        cfg = dataclasses.replace(cfg, form="mvp", flat="off")
    ref = solve_batch(data, _x0(), cfg)
    for X0 in (parallel.shard_batch(mesh, _x0()), _x0()):
        out = parallel.solve_batch_sharded(data, X0, cfg, mesh=mesh,
                                           model_axis=model_axis)
        for f in dataclasses.fields(ref):
            got = getattr(out, f.name)
            assert tuple(got.shape) == tuple(getattr(ref, f.name).shape)
            assert torch.equal(got.full_tensor(), getattr(ref, f.name)), f.name


def test_one_rank_group_multi_and_errors(one_rank):
    """solve_multi_sharded equals solve_multi; tpu_gpad's errors."""
    from tpu_gpad_torch.solver.multi import solve_multi, stack_data

    mesh = one_rank
    datas = [tg.dualize(tg.condense(tg.problems.random_lti(
        n_x=3, n_u=2, horizon=6, seed=s)), iterations=60, device="cpu")
        for s in range(2)]
    stacked = stack_data(datas)
    X0 = np.random.default_rng(3).uniform(-0.3, 0.3, (2, 4, 3)).astype(
        np.float32)
    cfg = SolverConfig(iterations=60)
    out = parallel.solve_multi_sharded(stacked, X0, cfg, mesh=mesh)
    assert torch.equal(out.u.full_tensor(), solve_multi(stacked, X0, cfg).u)
    with pytest.raises(ValueError, match="stack_data result"):
        parallel.solve_multi_sharded(datas[0], X0[0], cfg, mesh=mesh)
    with pytest.raises(ValueError, match=r"x0 leading axis 1 != number of "
                                         r"plants 2"):
        parallel.solve_multi_sharded(stacked, X0[:1], cfg, mesh=mesh)
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        parallel.make_mesh(2, device_type="cpu")
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        parallel.make_mesh(1, 2, device_type="cpu")


def test_cuda_engine_refuses_model_axis(one_rank):
    """As tpu_gpad's forced Pallas engine: TP runs the torch engine."""
    from tpu_gpad_torch.solver import core

    data = _port(_jax_data(True))
    cfg = SolverConfig(iterations=ITERS, engine="cuda", model_axis="model")
    with pytest.raises(ValueError, match="tensor parallelism"):
        core.resolve_engine(data, cfg)
    with pytest.raises(ValueError, match="tensor parallelism"):
        parallel.solve_batch_sharded(data, _x0(), cfg, mesh=one_rank,
                                     model_axis="model")
    assert core.cuda_kernel(data, dataclasses.replace(cfg, engine="auto")) is None
    assert core.resolve_engine(data, dataclasses.replace(cfg, engine="auto")) == "torch"


@pytest.mark.parametrize("kw", [dict(model_axis="model"),
                                dict(collective_axes=("data",))],
                         ids=["model_axis", "collective_axes"])
def test_unbound_axis_name_raises(kw):
    """Outside solve_batch_sharded an axis name is bound to nothing: the
    solve raises and names it, never hangs or ignores the name."""
    data = _port(_jax_data(True))
    with pytest.raises(ValueError, match="solve_batch_sharded"):
        solve_batch(data, _x0(), SolverConfig(iterations=10, **kw))


def test_jax_and_port_solve_alike_on_one_rank(one_rank):
    """The one-rank sharded eps solve against tpu_gpad's sharded solve on
    a one-device mesh: the port's counterpart."""
    d_j = _jax_data(False)
    cfg = dict(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10)
    jmesh = jdist.make_mesh(n_data=1, devices=jdist.jax.devices()[:1])
    ref = jdist.solve_batch_sharded(d_j, jnp.asarray(_x0()), JConfig(**cfg),
                                    mesh=jmesh)
    out = parallel.solve_batch_sharded(_port(d_j), _x0(), SolverConfig(**cfg),
                                       mesh=one_rank)
    np.testing.assert_array_equal(out.iterations.full_tensor().numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(out.u.full_tensor().numpy(), np.asarray(ref.u),
                               atol=1e-4)
