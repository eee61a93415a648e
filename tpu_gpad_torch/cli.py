"""Command line: ``python -m tpu_gpad_torch <command>``.

The ``solve``, ``sweep`` and ``export`` commands of ``tpu_gpad.cli`` with
the same flags and JSON keys, plus ``--device`` (the card by default) and
the key ``"device"``; the solving routes also report ``"engine"``, the
engine that ran. ``solve --dataset`` solves a reference-format dataset file
(``input_%d.txt``, see ``tpu_gpad_torch.io``), ``export`` writes one, and
``sweep`` is the checkpointed large-batch runner. ``--engine stagewise``
solves on the stage-wise O(N) engine (``tpu_gpad_torch.stagewise``).
``export --aot``, ``sweep --sharded`` and the commands ``closedloop`` and
``info`` are not yet ported and say so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

_NOT_PORTED = "is not yet ported to tpu_gpad_torch (see ROADMAP.md Queue 1)"


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
    from tpu_gpad_torch.solver import SolverConfig

    return SolverConfig(
        iterations=args.iterations,
        mode=args.mode,
        eps_g=args.eps_g,
        eps_V=args.eps_v,
        engine="auto" if args.engine == "stagewise" else args.engine,
        form=args.form,
        matmul_dtype=args.dtype,
        precision=args.precision,
        flat=args.flat,
        restart=args.restart,
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
        "engine": resolve_engine(data, config),
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


def cmd_sweep(args) -> int:
    import tpu_gpad_torch
    from tpu_gpad_torch.solver.core import resolve_engine
    from tpu_gpad_torch.sweep import run_sweep

    _reject_stagewise(args, "sweep")
    if args.sharded:
        raise SystemExit(f"sweep --sharded {_NOT_PORTED}")
    problem = _build_problem(args)
    data = tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(problem), iterations=args.iterations,
        paired=_paired(args), device=args.device)
    X0 = _scenarios(args, problem.n_x)
    config = _solver_config(args)
    out = run_sweep(
        data, X0, config, chunk_size=args.chunk_size,
        checkpoint=args.checkpoint, progress=args.progress,
    )
    _emit({
        "problem": data.name,
        "scenarios": int(X0.shape[0]),
        "chunks": out.chunks_done,
        "wall_s": round(out.wall_s, 3),
        "solves_per_sec_wall": round(X0.shape[0] / max(out.wall_s, 1e-9), 1),
        "residual_max": float(out.residual.max()),
        "converged_all": bool(out.converged.all()),
        "checkpoint": str(args.checkpoint) if args.checkpoint else None,
        "engine": resolve_engine(data, config),
        "device": str(data.device),
    })
    if args.out:
        np.savez(args.out, U=out.U, residual=out.residual,
                 iterations=out.iterations, converged=out.converged)
        _emit({"results": args.out})
    return 0


def cmd_export(args) -> int:
    """Write a reference-format dataset file (``input_%d.txt`` layout) of
    the problem at the first scenario's x0, in the dense layout."""
    import tpu_gpad_torch
    from tpu_gpad_torch.io import SolverDataset, write_solver_dataset
    from tpu_gpad_torch.schedule import momentum_schedule

    if args.aot:
        raise SystemExit(f"export --aot {_NOT_PORTED}")
    problem = _build_problem(args)
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


def _not_ported(args) -> int:
    raise SystemExit(f"`{args.command}` {_NOT_PORTED}")


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

    p = sub.add_parser("sweep", help="chunked scenario sweep w/ checkpoint")
    _add_problem_args(p)
    _add_solver_args(p)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states")
    p.add_argument("--chunk-size", type=int, default=4096)
    p.add_argument("--sharded", action="store_true",
                   help="spread each chunk over all visible devices (not "
                        "yet ported)")
    p.add_argument("--checkpoint", help="npz checkpoint path (resume if exists)")
    p.add_argument("--out", help="write result arrays to this npz")
    p.add_argument("--progress", action="store_true")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("export", help="write a reference-format dataset file")
    _add_problem_args(p)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states (first row used)")
    p.add_argument("--batch", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--out", required=True)
    p.add_argument("--aot", action="store_true",
                   help="a serialized solver artifact (not yet ported)")
    p.add_argument("--aot-batch", type=int, default=None,
                   help="concrete batch size for --aot (not yet ported)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_export)

    for name in ("closedloop", "info"):
        sub.add_parser(name, help="not yet ported").set_defaults(fn=_not_ported)

    args, extra = parser.parse_known_args(argv)
    if extra and args.fn is not _not_ported:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
