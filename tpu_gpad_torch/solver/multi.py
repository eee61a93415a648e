"""Multi-plant solving: a stack of DIFFERENT QPs over one call; the
counterpart of ``tpu_gpad.solver.multi``.

The reference solves its 28 ``inputs_manysets`` datasets one file at a time
in a host loop (``main.cu:104-108``). ``stack_data`` stacks the per-plant
constants along a leading plant axis, and ``solve_multi`` solves every
plant over its own scenario batch. The JAX package ``vmap``s the solver
over the plant axis; here each plant's slice is one ``solve_batch``, so on
the card a stack of P plants is P kernel launches (a plant grid axis in
the kernels is later work, ROADMAP Queue 1).

Requirements: all plants share the condensed dimensions (n_z, m, layout,
schedule length). Dynamics, costs, constraint data, and Lipschitz
constants may all differ: they live in the stacked operands.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from tpu_gpad_torch.solver.core import SolverConfig, solve_batch
from tpu_gpad_torch.types import GPADData, SolveResult

_META = ("n_u", "n_x", "horizon", "paired", "n_struct")
_ARRAYS = (
    "MG_T", "GL_T", "gP_map", "gP_const", "pD_map", "pD_const", "L",
    "theta", "beta",
)
_OPTIONAL = ("D", "soft_damp")


def stack_data(datas: Sequence[GPADData]) -> GPADData:
    """Stack per-plant ``GPADData`` along a new leading plant axis.

    All plants must agree on every static field and every tensor shape
    (``dualize`` them with the same ``iterations``) and live on one
    device. The result is a ``GPADData`` whose tensors carry a leading
    ``(n_plants,)`` axis, consumed by :func:`solve_multi`, not by
    ``solve_batch`` directly.
    """
    if len(datas) == 0:
        raise ValueError("stack_data needs at least one GPADData")
    d0 = datas[0]
    for i, d in enumerate(datas[1:], start=1):
        for f in _META:
            if getattr(d, f) != getattr(d0, f):
                raise ValueError(
                    f"plant {i} differs in {f}: "
                    f"{getattr(d, f)!r} != {getattr(d0, f)!r}"
                )
        for f in _ARRAYS:
            if getattr(d, f).shape != getattr(d0, f).shape:
                raise ValueError(
                    f"plant {i} differs in {f} shape: "
                    f"{tuple(getattr(d, f).shape)} != "
                    f"{tuple(getattr(d0, f).shape)}"
                )
        if (d.D is None) != (d0.D is None):
            raise ValueError(
                f"plant {i} mixes paired layouts with/without the dual "
                "Hessian D; re-dualize consistently"
            )
        if (d.soft_damp is None) != (d0.soft_damp is None):
            raise ValueError(
                f"plant {i} mixes soft and hard constraint stacks; "
                "re-dualize consistently"
            )
        if d.device != d0.device:
            raise ValueError(
                f"plant {i} is on {d.device}, plant 0 on {d0.device}"
            )
    stacked = {f: torch.stack([getattr(d, f) for d in datas]) for f in _ARRAYS}
    for f in _OPTIONAL:
        stacked[f] = (None if getattr(d0, f) is None
                      else torch.stack([getattr(d, f) for d in datas]))
    return dataclasses.replace(
        d0, name=f"stack[{','.join(d.name for d in datas)}]", **stacked
    )


def _plant(data: GPADData, p: int) -> GPADData:
    """Plant ``p`` of a stack: its tensors are contiguous views."""
    return dataclasses.replace(data, **{
        f: getattr(data, f)[p] for f in _ARRAYS + _OPTIONAL
        if getattr(data, f) is not None
    })


def solve_multi(
    data: GPADData | Sequence[GPADData],
    x0,
    config: SolverConfig = SolverConfig(),
    y0: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Solve ``P`` different QPs, each over its own scenario batch.

    ``data``: a :func:`stack_data` result (or a sequence, stacked here).
    ``x0``: shape (P, ..., n_x), per-plant scenario batches (the plant
    axis first, then any batch dims); NumPy or a tensor. ``y0``: optional
    warm start with the same leading plant axis. Returns a ``SolveResult``
    whose tensors carry the (P, ...) leading axes.

    Each plant's slice runs ``solve_batch`` with the same routing rules,
    so a stack whose plants a kernel serves makes P launches of it.
    """
    if not isinstance(data, GPADData):
        data = stack_data(list(data))
    n_plants = data.theta.shape[0]
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=data.device)
    if x0.shape[0] != n_plants:
        raise ValueError(
            f"x0 leading axis {x0.shape[0]} != number of plants {n_plants}"
        )
    results = [
        solve_batch(_plant(data, p), x0[p], config=config,
                    y0=None if y0 is None else y0[p])
        for p in range(n_plants)
    ]
    return SolveResult(**{
        f.name: torch.stack([getattr(r, f.name) for r in results])
        for f in dataclasses.fields(SolveResult)
    })
