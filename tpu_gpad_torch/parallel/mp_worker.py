"""Multi-process ``torch.distributed`` check of the sharded solves; the
counterpart of ``tpu_gpad.parallel.mp_worker``.

One process per rank, as on a machine with one card per rank: N fresh
interpreters join one process group through a ``file://`` rendezvous (no
ports, so parallel runs cannot collide), build the same problems from the
same seeds, run a fixed list of sharded solves (a *suite*) and gather the
global results to rank 0, which writes them to ``--out``.

Suites:

- ``small`` (4 ranks, the CPU tests): battery n3 N4 (m 56, paired m_h 28),
  32 scenarios, seed 7, on meshes 4x1 (DP), 1x4 (TP), 2x2, eps with the
  collective exit, eps with restart and a budget of 195, TP where m does
  not divide a 1x3 mesh (dense and paired), ``solve_multi_sharded`` over
  8 plants, ``solve_stagewise_multi_sharded`` over 4 and moving-horizon
  windows through ``solve_batch_sharded``;
- ``headline`` (any ranks): battery n3 N10 at B4096, 100 fixed
  iterations, over every rank on data;
- ``card`` (2 ranks on one card): the headline, then restart, eps (the
  collective exit; the rows in the order of their own eps iterations, so
  the ranks' last scenarios converge in different windows) and eps with
  restart and 195 iterations over 2x1, TP
  over 1x2 at the reference's 30x30 flagship (B256) and at a dense m that
  2 does not divide, and ``solve_multi_sharded`` over the reference's 28
  plants; then the sharded and unsharded solves' times in turns (CUDA
  events on rank 0). With two ranks on one card these times measure the
  collectives' cost, not a speed-up.

Each rank checks its own DP rows against the NumPy oracle; every case
also gathers the reference its caller holds it against (the same solve on
the rank's rows alone, or unsharded on rank 0). Each case's kernel
launches are counted per rank around the sharded call only.

Two entry points:

- ``python -m tpu_gpad_torch.parallel.mp_worker --rank i --world-size n
  --store <file> --device cpu|cuda --backend gloo|nccl --out <npz>
  [--suite small|headline|card]``: one rank;
- ``run_multiprocess_check(...)``: the parent-side launcher, used by
  ``tests/test_torch_multiprocess.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

SUITES = ("small", "headline", "card")
# launch counters of the condensed kernels, by kernel name
COUNTERS = {
    "gpad_paired_flat": ("kernels", "PAIRED_FLAT_LAUNCHES"),
    "gpad_paired": ("kernels", "PAIRED_LAUNCHES"),
    "gpad_dense": ("kernels", "DENSE_LAUNCHES"),
    "gpad_flat_tiled": ("kernels", "FLAT_TILED_LAUNCHES"),
    "gpad_dual": ("dual_kernels", "DUAL_LAUNCHES"),
    "gpad_dual_chunk": ("dual_kernels", "DUAL_CHUNK_LAUNCHES"),
    "gpad_dual_tiled": ("dual_kernels", "DUAL_TILED_LAUNCHES"),
    "gpad_dual_tiled_chunk": ("dual_kernels", "DUAL_TILED_CHUNK_LAUNCHES"),
}
ORACLE_TOL = 1e-4  # |u* - NumPy oracle| of a rank's own rows
HEADLINE = dict(n_cells=3, horizon=10)
HEADLINE_BATCH = 4096
ITERS = 100
ORACLE_SAMPLE = 8  # oracle-checked rows a rank at the headline
FLAGSHIP = dict(n_cells=30, horizon=30)
FLAG_BATCH = 256
MULTI_PLANTS = 28  # the reference's inputs_manysets
MULTI_BATCH = 256
TIMING_ROUNDS = 3


def _counter_modules():
    from tpu_gpad_torch.solver import dual_kernels, kernels

    return {"kernels": kernels, "dual_kernels": dual_kernels}


def _reset_counters() -> None:
    mods = _counter_modules()
    for mod, attr in COUNTERS.values():
        setattr(mods[mod], attr, 0)


def _counts() -> dict:
    mods = _counter_modules()
    got = {k: getattr(mods[m], a) for k, (m, a) in COUNTERS.items()}
    return {k: v for k, v in got.items() if v}


def _part(t):
    """A DTensor's local part with its place: (mesh coordinate, mesh shape,
    the dimension each mesh axis shards or None, the local array)."""
    from torch.distributed.tensor import Shard

    dims = [p.dim if isinstance(p, Shard) else None for p in t.placements]
    return (tuple(t.device_mesh.get_coordinate()), tuple(t.device_mesh.shape),
            dims, t.to_local().detach().cpu().numpy())


def _assemble(parts) -> np.ndarray:
    """The global array from every rank's ``_part``: along each mesh axis
    in turn, the parts of a sharded axis concatenate, a replicated one
    gives its first."""
    grid = {coord: a for coord, _, _, a in parts}
    _, shape, dims, _ = parts[0]

    def build(prefix):
        level = len(prefix)
        if level == len(shape):
            return grid[prefix]
        if dims[level] is None:
            return build(prefix + (0,))
        return np.concatenate([build(prefix + (i,)) for i in range(shape[level])],
                              axis=dims[level])

    return build(())


class _Rank:
    """One rank's run: its process groups, device, gathered results (on
    rank 0) and report."""

    def __init__(self, args):
        import torch
        import torch.distributed as dist

        self.torch, self.dist = torch, dist
        self.rank, self.world = args.rank, args.world_size
        self.device = torch.device(args.device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            idx = self.rank % torch.cuda.device_count()
            self.device = torch.device("cuda", idx)
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            args.backend, init_method=f"file://{Path(args.store).resolve()}",
            rank=self.rank, world_size=self.world,
            timeout=timedelta(seconds=args.timeout))
        # results travel to rank 0 through host copies on a CPU group
        self.host = (dist.new_group(backend="gloo") if args.backend != "gloo"
                     else dist.group.WORLD)
        self.arrays: dict[str, np.ndarray] = {}
        self.launches: dict[str, dict] = {}
        self.ms: dict[str, float] = {}
        self.errors: dict[str, str] = {}  # the ValueErrors a case expects

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def mesh(self, n_data: int, n_model: int = 1):
        from tpu_gpad_torch.parallel import make_mesh

        return make_mesh(n_data, n_model, device_type=self.device.type)

    def counted(self, case: str, fn):
        """Run ``fn`` with every launch count at 0; keep its launches."""
        _reset_counters()
        out = fn()
        self.sync()
        self.launches[case] = _counts()
        return out

    def gather(self, case: str, res, fields) -> None:
        """The global arrays of a sharded result's ``fields`` to rank 0
        (``res`` None on a rank outside the case's mesh)."""
        parts = None if res is None else {f: _part(getattr(res, f))
                                          for f in fields}
        every = [None] * self.world if self.rank == 0 else None
        self.dist.gather_object(parts, every, dst=0, group=self.host)
        if self.rank == 0:
            got = [p for p in every if p is not None]
            for f in fields:
                self.arrays[f"{case}_{f}"] = _assemble([p[f] for p in got])

    def gather_rows(self, key: str, a) -> None:
        """Every rank's rows of ``a`` to rank 0, in rank order."""
        a = None if a is None else self.torch.as_tensor(a).detach().cpu().numpy()
        every = [None] * self.world if self.rank == 0 else None
        self.dist.gather_object(a, every, dst=0, group=self.host)
        if self.rank == 0:
            self.arrays[key] = np.concatenate([p for p in every if p is not None])

    def barrier(self) -> None:
        self.dist.barrier(group=self.host)

    def timed(self, fn, everyone: bool):
        """CUDA-event ms of ``fn`` on rank 0 (None elsewhere); ``everyone``:
        every rank calls it (a sharded solve), else rank 0 alone while the
        others wait."""
        torch = self.torch
        self.barrier()
        ms = None
        if everyone or self.rank == 0:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) if self.rank == 0 else None
        self.barrier()
        return ms

    def finish(self, out: str | None, cases) -> None:
        """Gather the launches to rank 0, which writes the npz; a rank that
        got here ran every case."""
        every = [None] * self.world if self.rank == 0 else None
        self.dist.gather_object(self.launches, every, dst=0, group=self.host)
        if self.rank == 0 and out:
            report = {"world_size": self.world, "cases": list(cases),
                      "launches_by_rank": every, "ms": self.ms,
                      "errors": self.errors}
            np.savez(out, report=np.asarray(json.dumps(report)), **self.arrays)
        self.barrier()
        self.dist.destroy_process_group()


# -- the small suite (CPU tests against tpu_gpad's sharded solves) --------


def _small_data(tg, paired: bool):
    qp = tg.condense(tg.problems.battery(n_cells=3, horizon=4))  # m 56
    return qp, tg.dualize(qp, iterations=400, paired=paired, device="cpu")


def _small_x0():
    return np.random.default_rng(7).uniform(-0.5, 0.5, (32, 3)).astype(np.float32)


def multi_plants(tg, n: int = 8, horizon: int = 8, iterations: int = 200):
    """``tests/test_multi.py``'s random plants, dualized as there."""
    return [tg.dualize(tg.condense(tg.problems.random_lti(
        n_x=3, n_u=2, horizon=horizon, seed=s)), iterations=iterations,
        paired="auto", device="cpu") for s in range(n)]


def stagewise_plants(tg):
    """``tests/test_stagewise.py``'s four random LTV plants."""
    from tpu_gpad_torch.stagewise import build_stagewise

    return [build_stagewise(tg.problems.random_ltv(n_x=3, n_u=2, horizon=6,
                                                   seed=s), iterations=60,
                            device="cpu") for s in range(4)]


MHE_PLANT = dict(A=np.array([[1.0, 0.1], [0.0, 0.97]]),
                 B=np.array([[0.005], [0.1]]), C=np.array([[1.0, 0.0]]))
MHE_KW = dict(window=5, W=np.diag([1e-4, 4e-3]), V=np.array([[1e-2]]),
              w_min=np.full(2, -0.05), w_max=np.full(2, 0.05),
              x0=np.zeros(2), iterations=300)


def mhe_windows(n: int = 16):
    """``tests/test_mhe.py``'s fleet of windows: (x_bar, Y, U)."""
    rng = np.random.default_rng(9)
    xbar = rng.normal(0, 0.1, (n, 2)).astype(np.float32)
    Y = rng.normal(0, 0.1, (n, 5, 1)).astype(np.float32)
    U = rng.normal(0, 0.3, (n, 4, 1)).astype(np.float32)
    return xbar, Y, U


def _suite_small(r: _Rank) -> None:
    import tpu_gpad_torch as tg
    from tpu_gpad_torch.parallel import (shard_batch, solve_batch_sharded,
                                         solve_multi_sharded,
                                         solve_stagewise_multi_sharded)
    from tpu_gpad_torch.solver import SolverConfig
    from tpu_gpad_torch.solver.multi import stack_data
    from tpu_gpad_torch.solver.reference import gpad_solve_qp
    from tpu_gpad_torch.stagewise import stack_stagewise

    qp, dense = _small_data(tg, paired=False)
    _, paired = _small_data(tg, paired=True)
    X0 = _small_x0()
    fixed = SolverConfig(iterations=100)

    mesh = r.mesh(4)
    out = r.counted("dp", lambda: solve_batch_sharded(
        dense, shard_batch(mesh, X0), fixed, mesh=mesh))
    # each rank checks its own rows against the oracle
    u_loc = out.u.to_local().numpy()
    i0 = mesh.get_local_rank("data") * u_loc.shape[0]
    for j, u in enumerate(u_loc):
        ref = gpad_solve_qp(qp, X0[i0 + j].astype(np.float64), iterations=100)
        err = float(np.abs(u - ref.u).max())
        if err > ORACLE_TOL:
            raise AssertionError(f"rank {r.rank} row {i0 + j}: u* vs oracle {err}")
    r.gather("dp", out, ("u", "y"))

    for case, (nd, nm) in (("tp", (1, 4)), ("dptp", (2, 2))):
        mesh = r.mesh(nd, nm)
        out = r.counted(case, lambda: solve_batch_sharded(
            dense, X0, fixed, mesh=mesh, model_axis="model"))
        r.gather(case, out, ("u", "y"))

    mesh = r.mesh(4)
    eps = SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10)
    out = r.counted("eps", lambda: solve_batch_sharded(
        dense, shard_batch(mesh, X0), eps, mesh=mesh))
    r.gather("eps", out, ("u", "iterations", "converged"))
    eps_r = SolverConfig(mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10,
                         iterations=195, restart=True)
    out = r.counted("eps_restart", lambda: solve_batch_sharded(
        paired, shard_batch(mesh, X0), eps_r, mesh=mesh))
    r.gather("eps_restart", out, ("u", "converged"))

    # m 56 and m_h 28 over a 1x3 mesh: the fourth rank sits it out
    for case, data in (("tp_odd_dense", dense), ("tp_odd_paired", paired)):
        mesh = r.mesh(1, 3)
        out = None
        if r.rank < 3:
            out = r.counted(case, lambda: solve_batch_sharded(
                data, X0, fixed, mesh=mesh, model_axis="model"))
        r.gather(case, out, ("u", "y", "residual"))

    mesh = r.mesh(4)
    stacked = stack_data(multi_plants(tg))
    Xm = np.random.default_rng(3).uniform(-0.3, 0.3, (8, 4, 3)).astype(np.float32)
    out = r.counted("multi", lambda: solve_multi_sharded(
        stacked, Xm, SolverConfig(iterations=200), mesh=mesh))
    r.gather("multi", out, ("u", "z"))

    st = stack_stagewise(stagewise_plants(tg))
    Xs = np.random.default_rng(1).uniform(-0.3, 0.3, (4, 2, 3)).astype(np.float32)
    out = r.counted("stagewise_multi", lambda: solve_stagewise_multi_sharded(
        st, Xs, SolverConfig(iterations=60), mesh=mesh))
    r.gather("stagewise_multi", out, ("u", "y"))

    est = tg.MovingHorizonEstimator(**MHE_PLANT, **MHE_KW, device="cpu")
    xbar, Y, U = mhe_windows()
    p = np.concatenate([xbar, Y.reshape(len(xbar), -1),
                        U.reshape(len(xbar), -1)], axis=1)
    out = r.counted("mhe", lambda: solve_batch_sharded(
        est.data, p, est.config, mesh=mesh))
    r.gather("mhe", out, ("z",))

    # what does not divide the mesh raises before any collective
    def raises(key, fn):
        try:
            fn()
        except ValueError as e:
            r.errors[key] = str(e)

    raises("uneven_batch", lambda: solve_batch_sharded(
        dense, X0[:30], fixed, mesh=mesh))
    raises("plant_count", lambda: solve_multi_sharded(
        stack_data(multi_plants(tg, n=3)), np.zeros((3, 2, 3), np.float32),
        mesh=mesh))
    raises("stagewise_plant_count", lambda: solve_stagewise_multi_sharded(
        st, Xs[:3], SolverConfig(iterations=60), mesh=mesh))


# -- the headline and card suites (on the card) ---------------------------


def _headline(tg, device, iterations: int = ITERS):
    qp = tg.condense(tg.problems.battery(**HEADLINE))
    return qp, tg.dualize(qp, iterations, paired="auto", device=device)


def headline_x0(n_x: int = 3):
    return np.random.default_rng(1).uniform(
        -0.4, 0.4, (HEADLINE_BATCH, n_x)).astype(np.float32)


def odd_dense_problem(tg):
    """Battery n3 N11 with a total-charge row a stage: m 165, dense (the
    one-sided row does not pair), so 2 does not divide it."""
    p = tg.problems.battery(n_cells=3, horizon=11)
    return dataclasses.replace(p, H_x=np.ones((1, 3)), h_x=np.array([2.5]))


def multi_qps(tg):
    """The reference's 28 plants: battery n3 N10 with cell capacities and
    current limits differing (chip_smoke.py's multi_path)."""
    caps = np.linspace(0.08, 0.15, MULTI_PLANTS)
    limits = np.linspace(0.2, 0.4, MULTI_PLANTS)
    return [tg.condense(tg.problems.battery(**HEADLINE, cell_capacity_ah=c,
                                            current_limit=lim))
            for c, lim in zip(caps, limits)]


def _dp_case(r: _Rank, case: str, data, X0, cfg, fields, mesh):
    """A DP solve over ``mesh`` and, as its reference, the same solve of
    the rank's rows alone."""
    import tpu_gpad_torch as tg
    from tpu_gpad_torch.parallel import shard_batch, solve_batch_sharded

    Xs = shard_batch(mesh, X0)
    out = r.counted(case, lambda: solve_batch_sharded(data, Xs, cfg,
                                                      mesh=mesh))
    r.gather(case, out, fields)
    alone = tg.solve_batch(data, Xs.to_local(), cfg)
    for f in fields:
        r.gather_rows(f"{case}_{f}_alone", getattr(alone, f))
    return out, Xs


def _suite_headline(r: _Rank):
    import tpu_gpad_torch as tg
    from tpu_gpad_torch.solver import SolverConfig
    from tpu_gpad_torch.solver.reference import gpad_solve_qp

    qp, data = _headline(tg, r.device)
    X0 = headline_x0()
    mesh = r.mesh(r.world)
    out, Xs = _dp_case(r, "dp_fixed", data, X0, SolverConfig(iterations=ITERS),
                       ("u", "y"), mesh)
    # each rank checks a sample of its own rows against the oracle
    u_loc, x_loc = out.u.to_local().cpu().numpy(), Xs.to_local().cpu().numpy()
    for j in np.linspace(0, len(u_loc) - 1, ORACLE_SAMPLE).astype(int):
        ref = gpad_solve_qp(qp, x_loc[j].astype(np.float64), iterations=ITERS)
        err = float(np.abs(u_loc[j] - ref.u).max())
        if err > ORACLE_TOL:
            raise AssertionError(f"rank {r.rank} row {j}: u* vs oracle {err}")
    return data


def _suite_card(r: _Rank) -> None:
    import tpu_gpad_torch as tg
    from tpu_gpad_torch.parallel import (shard_batch, solve_batch_sharded,
                                         solve_multi_sharded)
    from tpu_gpad_torch.solver import SolverConfig
    from tpu_gpad_torch.solver.multi import solve_multi, stack_data

    data = _suite_headline(r)
    _, data200 = _headline(tg, r.device, 200)
    X0 = headline_x0()
    dp = r.mesh(r.world)
    fixed = SolverConfig(iterations=ITERS)
    restart = SolverConfig(iterations=ITERS, restart=True)
    eps = SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10,
                       iterations=200)
    eps_r = dataclasses.replace(eps, iterations=195, restart=True)
    _dp_case(r, "dp_restart", data, X0, restart, ("u",), dp)
    # rows in the order of their own eps iterations: the first rank's last
    # scenario converges windows before the last rank's, so the collective
    # exit keeps the first running past its own
    own = tg.solve_batch(data200, X0, eps).iterations.cpu().numpy()
    Xe = X0[np.argsort(own, kind="stable")]
    _dp_case(r, "dp_eps", data200, Xe, eps, ("u", "iterations", "converged"),
             dp)
    _dp_case(r, "dp_eps_restart", data200, Xe, eps_r, ("u", "converged"), dp)

    # TP on the torch engine: the flagship, then a dense m that 2 does not
    # divide (pad_dual_rows); rank 0 solves each unsharded as reference
    tp = r.mesh(1, r.world)
    flag = tg.dualize(tg.condense(tg.problems.battery(**FLAGSHIP)), ITERS,
                      paired="auto", device=r.device)
    odd = tg.dualize(tg.condense(odd_dense_problem(tg)), ITERS,
                     device=r.device)
    rng = np.random.default_rng(5)
    Xf = rng.uniform(-0.4, 0.4, (FLAG_BATCH, flag.n_x)).astype(np.float32)
    Xo = rng.uniform(-0.4, 0.4, (FLAG_BATCH, odd.n_x)).astype(np.float32)
    torch_engine = SolverConfig(iterations=ITERS, engine="torch")
    for case, d, X in (("tp", flag, Xf), ("tp_odd", odd, Xo)):
        out = r.counted(case, lambda: solve_batch_sharded(
            d, X, fixed, mesh=tp, model_axis="model"))
        r.gather(case, out, ("u", "y"))
        ref = tg.solve_batch(d, X, torch_engine) if r.rank == 0 else None
        r.gather_rows(f"{case}_u_unsharded", None if ref is None else ref.u)

    datas = [tg.dualize(qp, ITERS, paired=False, device=r.device)
             for qp in multi_qps(tg)]
    stacked = stack_data(datas)
    Xm = np.random.default_rng(42).uniform(
        -0.4, 0.4, (MULTI_PLANTS, MULTI_BATCH, 3)).astype(np.float32)
    out = r.counted("multi", lambda: solve_multi_sharded(
        stacked, Xm, fixed, mesh=dp))
    r.gather("multi", out, ("u",))
    ref = solve_multi(stacked, Xm, fixed) if r.rank == 0 else None
    r.gather_rows("multi_u_unsharded", None if ref is None else ref.u)

    # times in turns: sharded (every rank), unsharded (rank 0 alone)
    Xs = shard_batch(dp, X0)
    X0c = r.torch.as_tensor(X0, device=r.device)
    Xfc = r.torch.as_tensor(Xf, device=r.device)
    pairs = {
        "fixed": (lambda: solve_batch_sharded(data, Xs, fixed, mesh=dp),
                  lambda: tg.solve_batch(data, X0c, fixed)),
        "eps": (lambda: solve_batch_sharded(data200, Xs, eps, mesh=dp),
                lambda: tg.solve_batch(data200, X0c, eps)),
        "tp": (lambda: solve_batch_sharded(flag, Xfc, fixed, mesh=tp,
                                           model_axis="model"),
               lambda: tg.solve_batch(flag, Xfc, torch_engine)),
    }
    for name, (sharded, unsharded) in pairs.items():
        r.timed(sharded, everyone=True)  # warm up
        r.timed(unsharded, everyone=False)
        got = {"sharded": [], "unsharded": []}
        for _ in range(TIMING_ROUNDS):
            for kind in ("sharded", "unsharded", "unsharded", "sharded"):
                ms = r.timed(sharded if kind == "sharded" else unsharded,
                             everyone=kind == "sharded")
                if ms is not None:
                    got[kind].append(ms)
        if r.rank == 0:
            for kind, v in got.items():
                r.ms[f"{name}_{kind}"] = float(np.median(v))


RUNS = {"small": _suite_small, "headline": _suite_headline,
        "card": _suite_card}


def _worker(args) -> None:
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    r = _Rank(args)
    RUNS[args.suite](r)
    cases = sorted(r.launches)
    r.finish(args.out, cases)
    print(f"MP_OK rank={args.rank} world={args.world_size} suite={args.suite} "
          f"cases={len(cases)} s={time.perf_counter() - t0:.1f}", flush=True)


def run_multiprocess_check(
    world_size: int = 4,
    suite: str = "small",
    device: str = "cpu",
    backend: str = "gloo",
    out_path: str | None = None,
    timeout_s: float = 120.0,
):
    """Launch ``world_size`` ranks of ``suite``, wait for every one, and
    return (rank 0's arrays, its report). A rank that fails, or a run past
    ``timeout_s``, kills every rank and raises with all their outputs: a
    partial run never counts as a success."""
    if suite not in SUITES:
        raise ValueError(f"unknown suite {suite!r}; one of {SUITES}")
    repo_root = Path(__file__).resolve().parents[2]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory(prefix="gpad_mp_") as tmp:
        out = out_path or os.path.join(tmp, "out.npz")
        logs, procs = [], []
        try:
            for rank in range(world_size):
                log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tpu_gpad_torch.parallel.mp_worker",
                     "--rank", str(rank), "--world-size", str(world_size),
                     "--store", os.path.join(tmp, "store"),
                     "--device", device, "--backend", backend,
                     "--suite", suite, "--out", out,
                     "--timeout", str(max(10.0, timeout_s / 2))],
                    cwd=repo_root, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout_s
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    failed = f"timed out after {timeout_s:.0f} s"
                bad = [i for i, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outputs = []
            for log in logs:
                log.seek(0)
                outputs.append(log.read())
                log.close()
        if failed is None:
            bad = [i for i, (p, o) in enumerate(zip(procs, outputs))
                   if p.returncode != 0 or "MP_OK" not in o]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        if failed is not None:
            raise RuntimeError(
                f"multi-process check ({suite}, {world_size} ranks on "
                f"{device}/{backend}) failed: {failed}\n" + "\n".join(
                    f"--- rank {i} ---\n{o}" for i, o in enumerate(outputs)))
        with np.load(out) as f:
            arrays = {k: f[k] for k in f.files if k != "report"}
            report = json.loads(str(f["report"]))
    report["outputs"] = outputs
    return arrays, report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="One rank of the sharded-solve check (see the module "
                    "docstring).")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world-size", type=int, required=True)
    parser.add_argument("--store", required=True,
                        help="file of the file:// rendezvous, new per run")
    parser.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    parser.add_argument("--backend", default="nccl", choices=["gloo", "nccl"])
    parser.add_argument("--suite", default="card", choices=SUITES)
    parser.add_argument("--out", default=None)
    parser.add_argument("--timeout", type=float, default=60.0,
                        help="seconds a collective may wait")
    _worker(parser.parse_args(argv))


if __name__ == "__main__":
    main()
