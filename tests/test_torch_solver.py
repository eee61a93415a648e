"""Port parity: ``tpu_gpad_torch.solve_batch`` (torch engine) against
``tpu_gpad.solve_batch(engine="xla")`` on the same data and scenarios, plus
u* against the NumPy oracle and the routing/refusal rules."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.solver import SolverConfig as JConfig

import tpu_gpad_torch
from tpu_gpad_torch.convert import gpad_data_from_numpy, solve_result_to_numpy
from tpu_gpad_torch.solver import SolverConfig, core
from tpu_gpad_torch.solver.reference import gpad_solve_qp
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 100
# fp32 sums in another order over 100 iterations. Iterates and the residual
# take tpu_gpad's pallas-vs-xla bound; the gap is O(1e-4) at these states,
# so it gets a bound two orders tighter (measured differences: ~1e-6 on y,
# ~3e-7 on the gap).
TOL = {"u": 2e-5, "z": 2e-5, "y": 2e-5, "residual": 2e-5, "gap": 2e-6}


def _pair(problem, paired):
    qp = tpu_gpad.condense(problem)
    d_j = tpu_gpad.dualize(qp, iterations=ITERS, paired=paired)
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    d_t = gpad_data_from_numpy(fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS},
                               device="cpu")
    return qp, d_j, d_t


@pytest.fixture(scope="module")
def paired_pair():
    return _pair(jp.battery(3, 10), "auto")


@pytest.fixture(scope="module")
def dense_pair():
    return _pair(jp.battery(3, 10), False)


def _x0(n, n_x, seed):
    return np.random.default_rng(seed).uniform(-0.4, 0.4, (n, n_x)).astype(np.float32)


def _compare(res_j, res_t):
    out = solve_result_to_numpy(res_t)
    for name, tol in TOL.items():
        np.testing.assert_allclose(out[name], np.asarray(getattr(res_j, name)),
                                   atol=tol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out["iterations"], np.asarray(res_j.iterations))
    assert out["iterations"].dtype == np.int32 and out["converged"].all()


@pytest.mark.parametrize(
    "form,flat,warm",
    [("mvp", "on", False), ("mvp", "off", False), ("dual", "auto", False),
     ("mvp", "on", True), ("dual", "auto", True)],
)
def test_paired_matches_xla_engine(paired_pair, form, flat, warm):
    qp, d_j, d_t = paired_pair
    X0 = _x0(6, qp.n_x, seed=1)
    y0 = None
    if warm:  # warm start from a short cold solve
        y0 = np.array(tpu_gpad.solve_batch(
            d_j, jnp.asarray(X0), JConfig(iterations=20, engine="xla")).y)
    kw = dict(form=form, flat=flat)
    res_j = tpu_gpad.solve_batch(
        d_j, jnp.asarray(X0), JConfig(engine="xla", **kw),
        y0=None if y0 is None else jnp.asarray(y0))
    res_t = tpu_gpad_torch.solve_batch(
        d_t, X0, SolverConfig(engine="torch", **kw), y0=y0)
    _compare(res_j, res_t)


def test_dense_matches_xla_engine(dense_pair):
    qp, d_j, d_t = dense_pair
    X0 = _x0(5, qp.n_x, seed=2)
    res_j = tpu_gpad.solve_batch(d_j, jnp.asarray(X0), JConfig(engine="xla"))
    res_t = tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig())
    _compare(res_j, res_t)


def test_diagnostics_off_and_batch_dims(paired_pair):
    qp, d_j, d_t = paired_pair
    X0 = _x0(6, qp.n_x, seed=3)
    cfg = SolverConfig(form="mvp", diagnostics=False)
    res = tpu_gpad_torch.solve_batch(d_t, X0.reshape(2, 3, qp.n_x), cfg)
    assert res.u.shape == (2, 3, 3) and res.y.shape == (2, 3, 2, d_t.m_half)
    assert torch.isnan(res.residual).all() and torch.isnan(res.gap).all()
    full = tpu_gpad_torch.solve_batch(d_t, X0, dataclasses.replace(cfg, diagnostics=True))
    torch.testing.assert_close(res.z.reshape(6, -1), full.z, rtol=0, atol=0)


@pytest.mark.parametrize("paired", ["auto", False])
def test_u_star_matches_oracle(paired):
    problem = tpu_gpad_torch.problems.battery(3, 10)
    qp = tpu_gpad_torch.condense(problem)
    data = tpu_gpad_torch.dualize(qp, iterations=ITERS, paired=paired,
                                  device="cpu")
    X0 = _x0(3, qp.n_x, seed=4)
    for form in (("mvp", "dual") if paired else ("mvp",)):
        res = tpu_gpad_torch.solve_batch(data, X0, SolverConfig(form=form))
        for i in range(X0.shape[0]):
            ref = gpad_solve_qp(qp, X0[i].astype(np.float64), iterations=ITERS)
            np.testing.assert_allclose(res.u[i].numpy(), ref.u, atol=1e-4, rtol=0)
    single = tpu_gpad_torch.solve(data, X0[0])
    assert single.u.shape == (1, 3)


def test_routing_on_cpu(paired_pair):
    _, _, d_t = paired_pair
    cfg = SolverConfig()
    assert core.resolve_engine(d_t, cfg) == "torch"
    assert core.resolve_form(d_t, cfg) == "dual"  # as tpu_gpad on CPU
    assert core.resolve_flat(d_t, cfg)
    assert core.resolve_form(d_t, SolverConfig(form="mvp")) == "mvp"
    with pytest.raises(ValueError, match="unknown engine"):
        core.resolve_engine(d_t, SolverConfig(engine="pallas"))


def test_too_many_iterations_raises(paired_pair):
    _, _, d_t = paired_pair
    with pytest.raises(ValueError, match="schedule only has"):
        tpu_gpad_torch.solve_batch(
            d_t, np.zeros((1, 3), np.float32), SolverConfig(iterations=ITERS + 1))


@pytest.fixture(scope="module")
def one_rank_group(tmp_path_factory):
    """A one-rank gloo group on the CPU, destroyed after the module."""
    import torch.distributed as dist

    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize(
    "kw",
    [dict(mode="eps", collective_axes=("data",)),
     dict(restart=True, model_axis="model"),
     dict(model_axis="model"),
     dict(collective_axes=("data",))],
    ids=["eps", "restart", "model_axis", "collective_axes"],
)
def test_sharding_axes_need_a_bound_group(paired_pair, one_rank_group, kw):
    """Mesh axis names reduce over the process group bound to them
    (parallel.solve_batch_sharded binds them): unbound they raise and name
    solve_batch_sharded; bound to a one-rank group every reduction is the
    identity, so the solve equals the unsharded one in its form."""
    _, _, d_t = paired_pair
    x0 = np.random.default_rng(3).uniform(-0.4, 0.4, (8, 3)).astype(np.float32)
    cfg = SolverConfig(**kw)
    with pytest.raises(ValueError, match="solve_batch_sharded"):
        tpu_gpad_torch.solve_batch(d_t, x0, cfg)
    with core.bind_axes({"data": one_rank_group, "model": one_rank_group}):
        got = tpu_gpad_torch.solve_batch(d_t, x0, cfg)
    plain = dataclasses.replace(cfg, model_axis=None, collective_axes=())
    if cfg.model_axis is not None:  # TP runs the mvp form, flat block off
        plain = dataclasses.replace(plain, form="mvp", flat="off")
    ref = tpu_gpad_torch.solve_batch(d_t, x0, plain)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name


@pytest.mark.parametrize(
    "kw, tol",
    # "high" is 3xTF32 on the route and fp32 on the CPU's torch engine;
    # "default" and bf16 round the route's operands where the torch
    # engine's CPU products stay fp32 ("default") or round them itself
    [(dict(precision="high"), 2e-5), (dict(precision="default"), 5e-3),
     (dict(matmul_dtype="bfloat16"), 5e-3)],
    ids=["high", "default", "bfloat16"],
)
def test_forced_dense_route_takes_a_tier(dense_pair, monkeypatch, kw, tol):
    """The dense kernel's route forced under a tier, on CPU tensors (the
    card's routing stood in for): the dense op runs its plain version at
    the tier, u within ``tol`` of the torch engine's at the tier, and the
    tier took effect (y differs from the route's "highest")."""
    from tpu_gpad_torch.solver import kernels

    _, _, d_t = dense_pair
    x0 = np.random.default_rng(4).uniform(-0.4, 0.4, (8, 3)).astype(np.float32)
    ref = tpu_gpad_torch.solve_batch(d_t, x0, SolverConfig(engine="torch",
                                                           **kw))
    monkeypatch.setattr(core, "resolve_engine",
                        lambda data, config, batch=1: "cuda")
    calls = []
    op = kernels.dense_op
    monkeypatch.setattr(kernels, "dense_op", lambda *a: calls.append(a[-1])
                        or op(*a))
    got = tpu_gpad_torch.solve_batch(d_t, x0, SolverConfig(engine="cuda", **kw))
    highest = tpu_gpad_torch.solve_batch(d_t, x0, SolverConfig(engine="cuda"))
    assert calls == [core.tier(SolverConfig(**kw)), "highest"]
    assert (got.u - ref.u).abs().max().item() <= tol
    assert not torch.equal(got.y, highest.y)
