"""AOT export and reload (``tpu_gpad_torch.aot``) on the CPU: the port's
artifacts against the live port solve, and against ``tpu_gpad.aot``'s
artifacts of the same problem on the same seeded NumPy ``x0`` (the four
cases of tests/test_aot.py), the graph's size against the iteration
budget, a symbolic artifact loaded with ``torch`` alone, and the refusal of
mesh axes."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.aot import export_solver as jax_export_solver
from tpu_gpad.aot import export_stagewise_solver as jax_export_stagewise
from tpu_gpad.aot import load_solver as jax_load_solver
from tpu_gpad.solver import SolverConfig as JConfig
from tpu_gpad.stagewise import build_stagewise as jax_build_stagewise

import tpu_gpad_torch as tg
from tpu_gpad_torch import aot
from tpu_gpad_torch.convert import gpad_data_from_numpy, stagewise_data_from_numpy
from tpu_gpad_torch.solver import SolverConfig
from tpu_gpad_torch.stagewise import (STAGEWISE_META_FIELDS,
                                      STAGEWISE_TENSOR_FIELDS, solve_stagewise)
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# A loaded artifact against the live port solve: tpu_gpad's own bound in
# tests/test_aot.py (the artifact runs the live solve's ops: equal so far)
LIVE_TOL = 2e-6
# The port against tpu_gpad: the parity tolerances of
# tests/test_torch_solver.py (u, fp32 sums in another order) and, for eps,
# of tests/test_torch_restart_eps.py (runs may stop one window apart)
U_TOL = 2e-5
EPS_U_TOL = 2e-4
KEYS = ("u", "z", "y", "iterations", "residual", "gap", "converged")


def _port(d_j, fields, meta, convert):
    return convert({k: None if getattr(d_j, k) is None
                    else np.asarray(getattr(d_j, k)) for k in fields},
                   {k: getattr(d_j, k) for k in meta}, device="cpu")


def _condensed(iterations):
    """The problem of tests/test_aot.py (battery n3 N10, paired "auto") in
    tpu_gpad and, bit for bit, in the port."""
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(n_cells=3, horizon=10)),
                           iterations=iterations, paired="auto")
    return d_j, _port(d_j, GPAD_TENSOR_FIELDS, GPAD_META_FIELDS,
                      gpad_data_from_numpy)


def _x0(B, seed, scale=0.4):
    return np.random.default_rng(seed).uniform(-scale, scale, (B, 3)).astype(
        np.float32)


def _same_as_live(out, live):
    """A loaded artifact's dict against the live ``SolveResult``."""
    for k in KEYS:
        got, want = out[k], getattr(live, k)
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if k in ("iterations", "converged"):
            assert torch.equal(got, want), k
        else:
            torch.testing.assert_close(got, want, atol=LIVE_TOL, rtol=0,
                                       msg=k)


def _nodes(blob) -> int:
    """Nodes of an artifact's graph and of every graph nested in it."""
    import io

    program = torch.export.load(io.BytesIO(blob))
    return sum(len(m.graph.nodes) for m in program.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule))


def test_symbolic_batch_roundtrip(tmp_path):
    """tests/test_aot.py's symbolic case: one artifact serves B 1, 4 and
    37, equal to the live torch-engine solve, and to tpu_gpad's artifact."""
    d_j, d_t = _condensed(100)
    path = tmp_path / "solver.pt2"
    blob = aot.export_solver(d_t, SolverConfig(iterations=100), path=path)
    assert path.read_bytes() == blob
    solve = aot.load_solver(path)
    solve_j = jax_load_solver(jax_export_solver(d_j, JConfig(iterations=100)))
    for B in (1, 4, 37):
        X0 = _x0(B, B)
        out = solve(X0)
        _same_as_live(out, tg.solve_batch(
            d_t, X0, SolverConfig(iterations=100, engine="torch")))
        np.testing.assert_allclose(out["u"].numpy(),
                                   np.asarray(solve_j(X0)["u"]), atol=U_TOL,
                                   rtol=0)
    assert out["u"].shape == (37, d_t.n_u)


def test_concrete_batch():
    """tests/test_aot.py's concrete case: B8, routed as the live solve."""
    d_j, d_t = _condensed(100)
    solve = aot.load_solver(aot.export_solver(d_t, SolverConfig(iterations=100),
                                              batch_size=8))
    X0 = _x0(8, 1)
    out = solve(X0)
    _same_as_live(out, tg.solve_batch(d_t, X0, SolverConfig(iterations=100)))
    out_j = jax_load_solver(jax_export_solver(
        d_j, JConfig(iterations=100), batch_size=8))(X0)
    np.testing.assert_allclose(out["u"].numpy(), np.asarray(out_j["u"]),
                               atol=U_TOL, rtol=0)


@pytest.mark.parametrize("check_every", [20, 30], ids=["windows", "partial"])
def test_eps_mode(check_every):
    """tests/test_aot.py's eps case (restart, check_every 20, budget 500),
    and a cadence that leaves a partial last window: iterations and
    converged equal to the live port's, every field within LIVE_TOL of it,
    u within EPS_U_TOL and iterations within one window of tpu_gpad's
    artifact."""
    d_j, d_t = _condensed(500)
    kw = dict(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=check_every,
              iterations=500, restart=True)
    solve = aot.load_solver(aot.export_solver(d_t, SolverConfig(**kw)))
    X0 = _x0(6, 2, 0.3)
    out = solve(X0)
    assert bool(out["converged"].all())
    _same_as_live(out, tg.solve_batch(d_t, X0,
                                      SolverConfig(engine="torch", **kw)))
    out_j = jax_load_solver(jax_export_solver(d_j, JConfig(**kw)))(X0)
    np.testing.assert_allclose(out["u"].numpy(), np.asarray(out_j["u"]),
                               atol=EPS_U_TOL, rtol=0)
    assert (np.abs(out["iterations"].numpy() - np.asarray(out_j["iterations"]))
            .max() <= check_every)


def test_eps_without_restart_holds_every_field():
    """An eps artifact without restart, some scenarios stopping windows
    before others: y, gap, converged and iterations as the live port's."""
    _, d_t = _condensed(300)
    cfg = SolverConfig(mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10,
                       iterations=300)
    solve = aot.load_solver(aot.export_solver(d_t, cfg))
    X0 = _x0(7, 5)
    out = solve(X0)
    live = tg.solve_batch(d_t, X0, cfg)
    assert len(set(live.iterations.tolist())) > 1
    _same_as_live(out, live)


def test_stagewise_export_roundtrip(tmp_path):
    """tests/test_aot.py's stage-wise case (battery n3 N12 x 120): any
    batch after reload, equal to the live sequential torch engine, and to
    tpu_gpad's artifact."""
    prob = jp.battery(n_cells=3, horizon=12)
    d_j = jax_build_stagewise(prob, iterations=120)
    d_t = _port(d_j, STAGEWISE_TENSOR_FIELDS, STAGEWISE_META_FIELDS,
                stagewise_data_from_numpy)
    path = tmp_path / "stagewise.pt2"
    aot.export_stagewise_solver(d_t, SolverConfig(iterations=120), path=path)
    solve = aot.load_solver(path)
    solve_j = jax_load_solver(jax_export_stagewise(d_j, JConfig(iterations=120)))
    for B in (1, 5):
        X0 = _x0(B, 1, 0.3)
        out = solve(X0)
        _same_as_live(out, solve_stagewise(d_t, X0, iterations=120,
                                           engine="torch", scan="sequential"))
        np.testing.assert_allclose(out["u"].numpy(),
                                   np.asarray(solve_j(X0)["u"]), atol=U_TOL,
                                   rtol=0)
    assert out["y"].shape == (5, 12, d_t.m_x + d_t.m_u)


def test_stagewise_concrete_batch_routes_as_live():
    """A concrete stage-wise artifact on the CPU runs what the live solve
    runs there (the torch engine, its sweeps picked by ``resolve_scan``)."""
    d_t = tg.build_stagewise(tg.problems.battery(n_cells=3, horizon=12),
                             iterations=60, device="cpu")
    cfg = SolverConfig(iterations=60)
    solve = aot.load_solver(aot.export_stagewise_solver(d_t, cfg, batch_size=5))
    X0 = _x0(5, 4)
    _same_as_live(solve(X0), solve_stagewise(d_t, X0, config=cfg))


@pytest.mark.parametrize("solver", ["fixed", "eps", "stagewise"])
def test_graph_does_not_grow_with_the_budget(solver):
    """The loops export as one body: the same node count at 40 and 120
    iterations, for the condensed fixed and eps solvers and the stage-wise
    one."""
    counts = []
    for iterations in (40, 120):
        if solver == "stagewise":
            d = tg.build_stagewise(tg.problems.battery(n_cells=3, horizon=6),
                                   iterations=120, device="cpu")
            blob = aot.export_stagewise_solver(
                d, SolverConfig(iterations=iterations))
        else:
            _, d = _condensed(120)
            kw = (dict(mode="eps", check_every=20, restart=True)
                  if solver == "eps" else {})
            blob = aot.export_solver(d, SolverConfig(iterations=iterations,
                                                     **kw))
        counts.append(_nodes(blob))
    assert counts[0] == counts[1], counts


_LOAD_ALONE = r"""
import io, json, sys
import torch
blob = open(sys.argv[1], "rb").read()
solve = torch.export.load(io.BytesIO(blob)).module()
out = solve(torch.full((3, 3), 0.1))
print(json.dumps({"u": out["u"].tolist(),
                  "ported": sorted(m for m in sys.modules
                                   if m.split(".")[0] == "tpu_gpad_torch")}))
"""


def test_symbolic_artifact_loads_with_torch_alone(tmp_path):
    """A symbolic artifact holds no op of the port: a process that imports
    torch alone loads and runs it, and the port's package never enters
    sys.modules."""
    _, d_t = _condensed(40)
    path = tmp_path / "solver.pt2"
    aot.export_solver(d_t, SolverConfig(iterations=40), path=path)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _LOAD_ALONE, str(path)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ported"] == []
    live = tg.solve_batch(d_t, np.full((3, 3), 0.1, np.float32),
                          SolverConfig(iterations=40, engine="torch"))
    np.testing.assert_array_equal(np.asarray(out["u"], np.float32),
                                  live.u.numpy())


@pytest.mark.parametrize("kw", [dict(collective_axes=("data",)),
                                dict(model_axis="model")],
                         ids=["collective_axes", "model_axis"])
def test_mesh_axes_refused(kw):
    """Process groups do not serialize: a config naming mesh axes raises."""
    _, d_t = _condensed(40)
    with pytest.raises(ValueError, match="process groups"):
        aot.export_solver(d_t, SolverConfig(iterations=40, **kw))
    d_s = tg.build_stagewise(tg.problems.battery(n_cells=3, horizon=4),
                             iterations=40, device="cpu")
    with pytest.raises(ValueError, match="process groups"):
        aot.export_stagewise_solver(d_s, SolverConfig(iterations=40, **kw))


# Exports in one fresh process (dynamo's cache empty at its start): a
# stage-wise artifact, then condensed ones; each artifact loaded and run
# against its live solve. Prints the legs that matched, as JSON.
_EXPORT_SEQUENCE = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(2)
import tpu_gpad_torch as tg
from tpu_gpad_torch import aot
from tpu_gpad_torch.solver import SolverConfig

legs = sys.argv[1].split(",")
x0 = np.random.default_rng(0).uniform(-0.4, 0.4, (5, 3)).astype(np.float32)
done = []
for leg in legs:
    if leg == "stagewise":
        data = tg.build_stagewise(tg.problems.battery(3, 12), iterations=200,
                                  device="cpu")
        blob = aot.export_stagewise_solver(data, SolverConfig())
        live = tg.solve_stagewise(data, x0, config=SolverConfig(),
                                  engine="torch", scan="sequential")
    else:
        data = tg.dualize(tg.condense(tg.problems.battery(3, 10)),
                          iterations=100, paired=True, device="cpu")
        cfg = {"mvp_fixed": SolverConfig(form="mvp", flat="on"),
               "mvp_restart": SolverConfig(form="mvp", restart=True),
               "dual_restart": SolverConfig(restart=True)}[leg]
        blob = aot.export_solver(data, cfg)
        live = tg.solve_batch(data, x0, cfg)
    out = aot.load_solver(blob)(x0)
    assert all(torch.equal(out[k], getattr(live, k)) for k in out), leg
    done.append(leg)
print(json.dumps(done))
"""


@pytest.mark.parametrize("legs", [
    ("stagewise", "mvp_fixed", "dual_restart"),
    ("stagewise", "mvp_restart"),
], ids=["fixed_then_dual_restart", "mvp_restart"])
def test_condensed_export_after_stagewise(legs):
    """A condensed export after a stage-wise one in the same process: the
    fixed mvp loop (``core._solve_fixed``) and the restart loops (restart
    runs ``scan`` over placeholders) each export, load and equal their live
    solves. Dynamo caches every ``scan`` body under one frame; two restart
    placeholders that were one tensor failed the cached stage-wise body's
    no-aliasing guard, and dynamo's reason for it evaluated that body's
    guard sources against the condensed body's closure and raised."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _EXPORT_SEQUENCE, ",".join(legs)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == list(legs)
