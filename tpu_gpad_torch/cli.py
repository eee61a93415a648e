"""Command line: ``python -m tpu_gpad_torch <command>``.

The ``solve``, ``closedloop``, ``sweep``, ``export`` and ``info`` commands
of ``tpu_gpad.cli`` with the same flags and JSON keys, plus ``--device``
(the card by default) and the key ``"device"``; the solving routes also
report ``"engine"``, the engine that ran, and ``info`` the CUDA kernel that
a configuration routes to on the card (``"kernel"``; its solver flags
``--mode``, ``--form``, ``--flat`` and ``--restart`` pick the
configuration). ``solve --dataset`` solves a reference-format dataset file
(``input_%d.txt``, see ``tpu_gpad_torch.io``), ``export`` writes one,
``sweep`` is the checkpointed large-batch runner and ``closedloop`` the
reference's controller loop (``gpad.m``). ``--engine stagewise`` solves on
the stage-wise O(N) engine (``tpu_gpad_torch.stagewise``). ``sweep
--sharded`` spreads each chunk over the ranks of a process group
(``torchrun``), or over a one-rank group on ``--device`` when started
alone. ``export --aot`` writes a ``torch.export`` solver artifact
(``tpu_gpad_torch.aot``) and reports its ``route``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _build_problem(args):
    from tpu_gpad_torch import problems

    if args.problem == "battery":
        return problems.battery(n_cells=args.cells, horizon=args.horizon)
    if args.problem == "double_integrator":
        return problems.double_integrator(horizon=args.horizon)
    if args.problem == "mass_spring":
        return problems.mass_spring(n_masses=args.cells, horizon=args.horizon)
    raise SystemExit(f"unknown problem: {args.problem!r}")


def _add_problem_args(p):
    p.add_argument("--problem", default="battery",
                   choices=["battery", "double_integrator", "mass_spring"])
    p.add_argument("--cells", type=int, default=3,
                   help="n_cells (battery) / n_masses (mass_spring)")
    p.add_argument("--horizon", type=int, default=10, help="prediction horizon N")


def _add_solver_args(p):
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--mode", default="fixed", choices=["fixed", "eps"])
    p.add_argument("--eps-g", type=float, default=1e-6)
    p.add_argument("--eps-v", type=float, default=1e-6)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "torch", "cuda", "stagewise"],
                   help="torch loop, the CUDA kernels, auto routing, or the "
                        "stage-wise O(N) engine")
    p.add_argument("--form", default="auto", choices=["auto", "mvp", "dual"])
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="operand dtype for the hot products")
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "default"])
    p.add_argument("--flat", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--restart", action="store_true")
    p.add_argument("--paired", default="auto", choices=["auto", "on", "off"])


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help='"cuda" (the default), "cuda:N" or "cpu"')


def _paired(args):
    return {"auto": "auto", "on": True, "off": False}[args.paired]


def _reject_stagewise(args, where: str) -> None:
    """A forced ``--engine stagewise`` works or raises; the condensed-only
    routes raise, as ``tpu_gpad.cli`` does."""
    if args.engine == "stagewise":
        raise SystemExit(
            f"--engine stagewise is not supported by `{where}` (it is a "
            "solve-time engine; use `solve --engine stagewise`, or drop "
            "the flag to let the condensed auto engine route)"
        )


def _solver_config(args):
    """A SolverConfig from parsed args; ``info``, which exposes a subset of
    the solver flags, falls back to the defaults, as ``tpu_gpad.cli``."""
    from tpu_gpad_torch.solver import SolverConfig

    engine = getattr(args, "engine", "auto")
    return SolverConfig(
        iterations=args.iterations,
        mode=getattr(args, "mode", "fixed"),
        eps_g=getattr(args, "eps_g", 1e-6),
        eps_V=getattr(args, "eps_v", 1e-6),
        engine="auto" if engine == "stagewise" else engine,
        form=getattr(args, "form", "auto"),
        matmul_dtype=getattr(args, "dtype", "float32"),
        precision=getattr(args, "precision", "highest"),
        flat=getattr(args, "flat", "auto"),
        restart=getattr(args, "restart", False),
    )


def _scenarios(args, n_x: int) -> np.ndarray:
    """(batch, n_x) initial states: file, or seeded random box samples."""
    if args.x0:
        X0 = np.loadtxt(args.x0, dtype=np.float32, ndmin=2)
        if X0.shape[1] != n_x:
            raise SystemExit(f"--x0 file has {X0.shape[1]} columns, expected {n_x}")
        return X0
    rng = np.random.default_rng(args.seed)
    return rng.uniform(-0.4, 0.4, size=(args.batch, n_x)).astype(np.float32)


def cmd_solve(args) -> int:
    import torch

    import tpu_gpad_torch
    from tpu_gpad_torch.solver.core import resolve_engine
    from tpu_gpad_torch.utils import device_time_per_call

    config = _solver_config(args)
    if args.dataset:
        _reject_stagewise(args, "solve --dataset")
        from tpu_gpad_torch.io import dataset_to_gpad_data, read_solver_dataset

        ds = read_solver_dataset(args.dataset)
        if args.iterations > ds.num_iterations:
            config = dataclasses.replace(config, iterations=ds.num_iterations)
        data = dataset_to_gpad_data(ds, device=args.device)
        # the parameter is baked into the file
        X0 = torch.zeros((1, 1), dtype=torch.float32, device=data.device)
    else:
        problem = _build_problem(args)
        if args.engine == "stagewise":
            return _solve_stagewise(args, problem, config)
        data = tpu_gpad_torch.dualize(
            tpu_gpad_torch.condense(problem), iterations=args.iterations,
            paired=_paired(args), device=args.device,
        )
        X0 = torch.as_tensor(_scenarios(args, problem.n_x), device=data.device)
    res = tpu_gpad_torch.solve_batch(data, X0, config=config)
    out = {
        "problem": data.name,
        "n_u": data.n_u, "horizon": data.horizon,
        "n_z": data.n_z, "m": data.m,
        "batch": int(X0.shape[0]),
        "iterations": int(res.iterations.max()),
        "residual_max": float(res.residual.max()),
        "converged_all": bool(res.converged.all()),
        "u_star": res.u[0].cpu().tolist(),
        "engine": resolve_engine(data, config, int(X0.shape[0])),
        "device": str(data.device),
    }
    if args.time:
        t = device_time_per_call(
            lambda: tpu_gpad_torch.solve_batch(data, X0, config=config))
        out["batch_device_us"] = t * 1e6
        out["device_us_per_solve"] = t * 1e6 / X0.shape[0]
        out["device_us_per_iteration"] = t * 1e6 / max(out["iterations"], 1)
        out["solves_per_sec"] = X0.shape[0] / t
        out["device_name"] = torch.cuda.get_device_name(data.device)
    _emit(out)
    return 0


def _solve_stagewise(args, problem, config) -> int:
    import torch

    from tpu_gpad_torch.stagewise import build_stagewise, solve_stagewise
    from tpu_gpad_torch.utils import device_time_per_call

    data = build_stagewise(problem, iterations=args.iterations,
                           device=args.device)
    X0 = torch.as_tensor(_scenarios(args, problem.n_x), device=data.device)
    res = solve_stagewise(data, X0, config=config)
    out = {
        "problem": data.name, "engine": "stagewise",
        "n_u": data.n_u, "horizon": data.horizon, "m": data.m,
        "batch": int(X0.shape[0]),
        "iterations": int(res.iterations.max()),
        "residual_max": float(res.residual.max()),
        "converged_all": bool(res.converged.all()),
        "u_star": res.u[0].cpu().tolist(),
        "device": str(data.device),
    }
    if args.time:
        t = device_time_per_call(lambda: solve_stagewise(data, X0, config=config))
        out["batch_device_us"] = t * 1e6
        out["device_us_per_solve"] = t * 1e6 / X0.shape[0]
        out["solves_per_sec"] = X0.shape[0] / t
        out["device_name"] = torch.cuda.get_device_name(data.device)
    _emit(out)
    return 0


def cmd_closedloop(args) -> int:
    """The reference's controller loop (``gpad.m``): condense once, then
    ``--steps`` samples of solve, actuate and propagate."""
    import tpu_gpad_torch
    from tpu_gpad_torch.closed_loop import plot_closed_loop, simulate
    from tpu_gpad_torch.problems.battery import default_x0
    from tpu_gpad_torch.solver.core import resolve_engine

    _reject_stagewise(args, "closedloop")
    problem = _build_problem(args)
    config = _solver_config(args)
    if args.x0 or args.batch > 1:
        X0 = _scenarios(args, problem.n_x)
    else:
        X0 = (default_x0(args.cells, seed=args.seed)
              if args.problem == "battery"
              else _scenarios(args, problem.n_x)[0])
    # the data simulate would build, kept to report the engine
    data = tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(problem), iterations=args.iterations,
        paired=_paired(args), device=args.device)
    result = simulate(problem, X0, n_steps=args.steps, config=config,
                      data=data, iterations=args.iterations,
                      warm_start=args.warm_start)
    X = result.X.cpu().numpy()
    _emit({
        "problem": problem.name,
        "steps": args.steps,
        "warm_start": args.warm_start,
        "final_state": X[-1].tolist() if X.ndim == 2 else X[-1, 0].tolist(),
        "max_residual": float(result.residual.max()),
        "mean_iterations": float(result.iterations.float().mean()),
        "engine": resolve_engine(data, config,
                                 int(np.prod(np.shape(X0)[:-1]))),
        "device": str(data.device),
    })
    if args.plot:
        plot_closed_loop(result, path=args.plot)
        _emit({"plot": args.plot})
    return 0


@contextlib.contextmanager
def _process_group(device: str):
    """The process group of a sharded sweep: under ``torchrun`` its
    ``env://`` rendezvous (each rank on the card of its ``LOCAL_RANK``),
    started alone a one-rank group on ``device``, as ``tpu_gpad``'s
    ``make_mesh()`` takes every device of its one process. Yields (the
    rank's device, its rank); destroys the group it made."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="gpad_pg_") as tmp:
        if dist.is_initialized():
            yield dev, dist.get_rank()
            return
        torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
        if torchrun:
            init = dict(init_method="env://")
        else:
            init = dict(init_method=f"file://{tmp}/store", rank=0,
                        world_size=1)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                                   if torchrun else torch.cuda.current_device())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, **init)
        try:
            yield dev, dist.get_rank()
        finally:
            dist.destroy_process_group()


def _sharded_solve_fn(device_type: str):
    """``run_sweep``'s ``solve_fn`` over every rank on data: each chunk
    padded to the mesh width (the ragged last one), sharded, solved and
    gathered whole on every rank."""
    from tpu_gpad_torch.parallel import make_mesh, solve_batch_sharded
    from tpu_gpad_torch.types import SolveResult

    mesh = make_mesh(device_type=device_type)
    n_data = mesh.shape[0]

    def solve_fn(d, x, c):
        pad = (-x.shape[0]) % n_data
        xp = np.pad(x, ((0, pad), (0, 0))) if pad else x
        res = solve_batch_sharded(d, xp, c, mesh=mesh)
        return SolveResult(**{
            f.name: getattr(res, f.name).full_tensor()[: x.shape[0]]
            for f in dataclasses.fields(SolveResult)})

    return solve_fn


def cmd_sweep(args) -> int:
    _reject_stagewise(args, "sweep")
    if not args.sharded:
        return _sweep(args, args.device)
    with _process_group(args.device) as (device, rank):
        import torch.distributed as dist

        if dist.get_world_size() > 1 and args.checkpoint:
            # a rank that resumed alone would gather another chunk's rows
            raise SystemExit(
                "sweep --sharded --checkpoint resumes within one process; "
                "drop --checkpoint or run one rank")
        return _sweep(args, device, _sharded_solve_fn(device.type),
                      emit=rank == 0)


def _sweep(args, device, solve_fn=None, emit: bool = True) -> int:
    import tpu_gpad_torch
    from tpu_gpad_torch.solver.core import resolve_engine
    from tpu_gpad_torch.sweep import run_sweep

    problem = _build_problem(args)
    data = tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(problem), iterations=args.iterations,
        paired=_paired(args), device=device)
    X0 = _scenarios(args, problem.n_x)
    config = _solver_config(args)
    out = run_sweep(
        data, X0, config, chunk_size=args.chunk_size,
        checkpoint=args.checkpoint, solve_fn=solve_fn,
        progress=args.progress and emit,
    )
    if not emit:  # the other ranks of a sharded sweep: rank 0 reports
        return 0
    _emit({
        "problem": data.name,
        "scenarios": int(X0.shape[0]),
        "chunks": out.chunks_done,
        "wall_s": round(out.wall_s, 3),
        "solves_per_sec_wall": round(X0.shape[0] / max(out.wall_s, 1e-9), 1),
        "residual_max": float(out.residual.max()),
        "converged_all": bool(out.converged.all()),
        "checkpoint": str(args.checkpoint) if args.checkpoint else None,
        "engine": resolve_engine(data, config,
                                 min(args.chunk_size, int(X0.shape[0]))),
        "device": str(data.device),
    })
    if args.out:
        np.savez(args.out, U=out.U, residual=out.residual,
                 iterations=out.iterations, converged=out.converged)
        _emit({"results": args.out})
    return 0


def cmd_export(args) -> int:
    """Write a reference-format dataset file (``input_%d.txt`` layout) of
    the problem at the first scenario's x0, in the dense layout, or with
    ``--aot`` a serialized solver artifact (``tpu_gpad_torch.aot``): a
    symbolic batch on the torch engine, or ``--aot-batch B`` routed as a
    live solve on ``--device`` (its ``route``: the kernel, or "torch")."""
    import tpu_gpad_torch
    from tpu_gpad_torch.io import SolverDataset, write_solver_dataset
    from tpu_gpad_torch.schedule import momentum_schedule

    problem = _build_problem(args)
    if args.aot:
        from tpu_gpad_torch.aot import export_solver
        from tpu_gpad_torch.solver import SolverConfig, core

        data = tpu_gpad_torch.dualize(
            tpu_gpad_torch.condense(problem), iterations=args.iterations,
            paired="auto", device=args.device)
        config = SolverConfig(iterations=args.iterations)
        blob = export_solver(data, config, batch_size=args.aot_batch,
                             path=args.out)
        route = "torch"
        if args.aot_batch is not None and core.resolve_engine(
                data, config, args.aot_batch) == "cuda":
            route = core.cuda_kernel(data, config, args.aot_batch)
        _emit({"artifact": args.out, "bytes": len(blob),
               "batch": args.aot_batch or "symbolic",
               "n_x": data.n_x, "n_u": data.n_u,
               "device": str(data.device), "route": route})
        return 0
    data = tpu_gpad_torch.dualize(tpu_gpad_torch.condense(problem),
                                  iterations=args.iterations, device=args.device)
    host = {k: getattr(data, k).cpu().numpy()
            for k in ("MG_T", "GL_T", "gP_map", "gP_const", "pD_map",
                      "pD_const")}
    x0 = _scenarios(args, problem.n_x)[0]
    theta, beta = momentum_schedule(args.iterations)
    ds = SolverDataset(
        n_u=problem.n_u, N=problem.horizon, m=data.m,
        num_iterations=args.iterations, L=data.L.item(),
        M_G=host["MG_T"].T, g_P=x0 @ host["gP_map"] + host["gP_const"],
        G_L=host["GL_T"].T, p_D=x0 @ host["pD_map"] + host["pD_const"],
        theta=theta, beta=beta,
    )
    write_solver_dataset(args.out, ds)
    _emit({"dataset": args.out, "n_u": ds.n_u, "N": ds.N, "m": ds.m,
           "iterations": ds.num_iterations, "x0": x0.tolist(),
           "device": str(data.device)})
    return 0


def _devices() -> list:
    import torch

    if torch.cuda.is_available():
        return [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())]
    return ["cpu"]


def cmd_info(args) -> int:
    """Problem dims, L, the routing (engine, form and the CUDA kernel a
    configuration takes on the card), FLOPs per iteration, devices; with
    ``--bound`` the certified iteration bound."""
    import tpu_gpad_torch
    from tpu_gpad_torch.solver.core import (
        cuda_kernel, resolve_engine, resolve_flat, resolve_form)
    from tpu_gpad_torch.utils import solve_flops

    problem = _build_problem(args)
    if args.engine == "stagewise":
        from tpu_gpad_torch.stagewise import (
            build_stagewise, condensed_operand_mb, stagewise_compatible)

        ok, reason = stagewise_compatible(problem)
        if not ok:
            raise SystemExit(f"--engine stagewise: {reason}")
        sw = build_stagewise(problem, iterations=args.iterations,
                             device=args.device)
        tensors = [getattr(sw, f.name) for f in dataclasses.fields(sw)]
        _emit({
            "problem": problem.name,
            "n_x": problem.n_x, "n_u": problem.n_u,
            "horizon": problem.horizon,
            "engine": "stagewise", "m": sw.m, "L": float(sw.L),
            "stagewise_data_mb": round(sum(
                t.numel() * t.element_size() for t in tensors
                if hasattr(t, "element_size")) / 1e6, 4),
            "condensed_operand_mb": round(condensed_operand_mb(problem), 4),
            "devices": _devices(),
            "device": str(sw.device),
        })
        return 0
    qp = tpu_gpad_torch.condense(problem)
    data = tpu_gpad_torch.dualize(qp, iterations=args.iterations,
                                  paired=_paired(args), device=args.device)
    cfg = _solver_config(args)
    form = resolve_form(data, cfg)
    flat = form == "mvp" and data.paired and resolve_flat(data, cfg)
    info = {
        "problem": problem.name,
        "n_x": problem.n_x, "n_u": problem.n_u, "horizon": problem.horizon,
        "n_z": qp.n_z, "m": qp.m,
        "paired": data.paired,
        "n_struct": data.n_struct,
        "L": float(data.L),
        "resolved_engine": resolve_engine(data, cfg, args.batch),
        "resolved_form": form + ("+flat" if flat else ""),
        "flops_per_iteration_dense": int(
            3 * qp.m + 2 * qp.n_z * qp.m + 3 * qp.n_z + 2 * qp.n_z * qp.m),
        "flops_per_iteration_resolved": int(
            solve_flops(data, 2, form, flat=flat)
            - solve_flops(data, 1, form, flat=flat)),
        "devices": _devices(),
        "kernel": cuda_kernel(data, cfg, args.batch),
        "device": str(data.device),
    }
    if args.bound:
        from tpu_gpad_torch.bounds import certify

        box = (np.atleast_2d(problem.x_min)[0] if problem.x_min is not None
               else np.full(problem.n_x, -0.4))
        box_hi = (np.atleast_2d(problem.x_max)[0] if problem.x_max is not None
                  else np.full(problem.n_x, 0.4))
        kw = (dict(n_samples=50, seed=args.seed)
              if args.bound_method == "sampled" else {})
        n_nu, dn, L = certify(qp, 0.8 * box, 0.8 * box_hi,
                              eps_g=args.eps_v, eps_V=args.eps_v,
                              method=args.bound_method, **kw)
        info["certified_iterations"] = int(n_nu)
        info["dual_norm_bound"] = float(dn.delta)
    _emit(info)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu_gpad_torch",
        description="GPAD solver for condensed linear-MPC QPs on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("solve", help="solve a batch of MPC QPs")
    _add_problem_args(p)
    _add_solver_args(p)
    p.add_argument("--dataset", help="reference-format dataset file "
                   "(overrides --problem; x0 is baked into the file)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states, one per row")
    _add_device_arg(p)
    p.add_argument("--time", action="store_true",
                   help="median device time over 20 calls (CUDA events)")
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("closedloop", help="closed-loop MPC simulation")
    _add_problem_args(p)
    _add_solver_args(p)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states")
    p.add_argument("--warm-start", action="store_true")
    p.add_argument("--plot", help="write SoC/current trajectory plot (png)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_closedloop)

    p = sub.add_parser("sweep", help="chunked scenario sweep w/ checkpoint")
    _add_problem_args(p)
    _add_solver_args(p)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states")
    p.add_argument("--chunk-size", type=int, default=4096)
    p.add_argument("--sharded", action="store_true",
                   help="spread each chunk over the ranks of a process "
                        "group (torchrun), or a one-rank group on --device")
    p.add_argument("--checkpoint", help="npz checkpoint path (resume if exists)")
    p.add_argument("--out", help="write result arrays to this npz")
    p.add_argument("--progress", action="store_true")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("export", help="write a reference-format dataset file "
                       "or, with --aot, a solver artifact")
    _add_problem_args(p)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states (first row used)")
    p.add_argument("--batch", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--out", required=True)
    p.add_argument("--aot", action="store_true",
                   help="write a serialized solver artifact (torch.export)")
    p.add_argument("--aot-batch", type=int, default=None,
                   help="concrete batch size for --aot (default: symbolic)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("info", help="problem dims, L, routing, flops, devices")
    _add_problem_args(p)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "torch", "cuda", "stagewise"],
                   help="report the condensed routing (auto/torch/cuda) "
                        "or the stage-wise engine's data/L instead")
    p.add_argument("--mode", default="fixed", choices=["fixed", "eps"])
    p.add_argument("--form", default="auto", choices=["auto", "mvp", "dual"])
    p.add_argument("--flat", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--restart", action="store_true")
    p.add_argument("--paired", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--bound", action="store_true",
                   help="compute the certified iteration bound")
    p.add_argument("--bound-method", default="sampled",
                   choices=["sampled", "milp"],
                   help="Delta bound: vertex/sampling, or the paper's "
                        "exact eq.-(16) MILP")
    p.add_argument("--eps-v", type=float, default=1e-6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=1,
                   help="scenarios a solve would hold (the tiled routes' "
                        "auto edges depend on it)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
