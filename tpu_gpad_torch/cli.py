"""Command line: ``python -m tpu_gpad_torch solve ...``.

The ``solve`` command of ``tpu_gpad.cli`` with the same flags and JSON keys,
plus ``--device`` (the card by default) and the key ``"device"``; the
condensed route also reports ``"engine"``, the engine that ran. ``--engine
stagewise`` solves on the stage-wise O(N) engine (``tpu_gpad_torch.
stagewise``). ``--dataset`` and the other commands of the JAX CLI are not
yet ported and say so.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_NOT_PORTED = "is not yet ported to tpu_gpad_torch (see ROADMAP.md Queue 1)"


def _build_problem(args):
    from tpu_gpad_torch import problems

    if args.problem == "battery":
        return problems.battery(n_cells=args.cells, horizon=args.horizon)
    if args.problem == "double_integrator":
        return problems.double_integrator(horizon=args.horizon)
    if args.problem == "mass_spring":
        return problems.mass_spring(n_masses=args.cells, horizon=args.horizon)
    raise SystemExit(f"unknown problem: {args.problem!r}")


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

    if args.dataset:
        raise SystemExit(f"solve --dataset {_NOT_PORTED}")
    config = _solver_config(args)
    problem = _build_problem(args)
    if args.engine == "stagewise":
        return _solve_stagewise(args, problem, config)
    data = tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(problem),
        iterations=args.iterations,
        paired={"auto": "auto", "on": True, "off": False}[args.paired],
        device=args.device,
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
    print(json.dumps(out), flush=True)
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
    print(json.dumps(out), flush=True)
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
    p.add_argument("--problem", default="battery",
                   choices=["battery", "double_integrator", "mass_spring"])
    p.add_argument("--cells", type=int, default=3,
                   help="n_cells (battery) / n_masses (mass_spring)")
    p.add_argument("--horizon", type=int, default=10, help="prediction horizon N")
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--mode", default="fixed", choices=["fixed", "eps"])
    p.add_argument("--eps-g", type=float, default=1e-6)
    p.add_argument("--eps-v", type=float, default=1e-6)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "torch", "cuda", "stagewise"],
                   help="torch loop, the CUDA kernel, auto routing, or the "
                        "stage-wise O(N) engine")
    p.add_argument("--form", default="auto", choices=["auto", "mvp", "dual"])
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="operand dtype for the hot products")
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "default"])
    p.add_argument("--flat", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--restart", action="store_true")
    p.add_argument("--paired", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--dataset", help="reference-format dataset file")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states, one per row")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (the default), "cuda:N" or "cpu"')
    p.add_argument("--time", action="store_true",
                   help="median device time over 20 calls (CUDA events)")
    p.set_defaults(fn=cmd_solve)

    for name in ("closedloop", "sweep", "export", "info"):
        sub.add_parser(name, help="not yet ported").set_defaults(fn=_not_ported)

    args, extra = parser.parse_known_args(argv)
    if extra and args.fn is cmd_solve:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
