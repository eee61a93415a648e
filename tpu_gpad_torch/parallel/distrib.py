"""Mesh-sharded GPAD on ``torch.distributed``; the counterpart of
``tpu_gpad.parallel.distrib``.

JAX runs ``shard_map`` over the devices of one process; PyTorch runs one
process (rank) per device. So the mesh is a ``DeviceMesh`` of ranks with
the dimensions ``(data, model)`` over an initialized process group, every
rank runs the same program, and the sharded solves return ``SolveResult``s
of ``DTensor`` fields from which each rank obtains the global arrays
(``.full_tensor()``, or ``.to_local()`` for its own part).

Layouts
-------
- **data** (scenario DP, the workhorse): ``X0`` and all per-scenario state
  shard along the batch axis; the plant matrices replicate. No
  communication in fixed mode; one scalar all-reduce per check window in
  eps mode (the collective all-converged stopping test, ``nmpc12-gpad.pdf``
  Algorithm 1 done fleet-wide).
- **model** (dual-dimension TP, for very large single instances): the
  constraint dimension m shards over the ranks; each holds a row slice of
  ``MG_T``, a column slice of ``GL_T`` and slices of ``p_D``/``y``/``w``.
  Step 2 sums its partial products (one (B, n_z) all-reduce per
  iteration); steps 1/3/4 are local. Residual reductions become MAX/SUM
  all-reduces.

Between cards the collectives are NCCL's, over NVLink or PCIe; on the CPU
(and for tests of several ranks on one card) gloo's. While a rank's local
solve runs, ``SolverConfig.model_axis`` and ``collective_axes`` name mesh
axes that ``core.bind_axes`` binds to the mesh dimension's process group,
as ``shard_map`` binds them for ``lax.psum``.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_gpad_torch.solver.core import SolverConfig, bind_axes, solve_batch
from tpu_gpad_torch.types import GPAD_TENSOR_FIELDS, PAD_BIG, GPADData, SolveResult

MESH_AXES = ("data", "model")


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device_type: str = "cuda"):
    """Build a ``(data, model)`` ``DeviceMesh`` over the first
    ``n_data * n_model`` ranks of the initialized process group. Defaults
    to every rank on data, on the card.

    Each rank is one device, as each JAX device is; every rank calls this
    with the same arguments (the mesh's process groups are made
    collectively)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group (torchrun sets its "
            "environment) on every rank first"
        )
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh(device_type='cuda') needs a CUDA device; a mesh of "
            "CPU ranks takes device_type='cpu'"
        )
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs more than {world} devices")
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_AXES)


def data_specs(like: GPADData, model_axis: str | None = None) -> dict:
    """For each tensor field of ``like``: the dimension that shards over
    ``model_axis``, or None where the field replicates (every field without
    ``model_axis``); the content of ``tpu_gpad``'s PartitionSpecs.

    With ``model_axis`` set, the dual dimension m (m_h paired) of MG_T
    (rows), GL_T (columns), pD_map/pD_const (their last axis), the rows of
    D and soft_damp shards; everything else replicates."""
    dims = {
        "MG_T": 0,  # (m or m_h, n_z): rows
        "GL_T": 1,  # (n_z, m or m_h): columns
        # paired: (n_x, 2, m_h) and (2, m_h); the +/- pair axis replicates
        "pD_map": 2 if like.paired else 1,
        "pD_const": 1 if like.paired else 0,
        "D": 0,  # dual-Hessian rows
        "soft_damp": 0,
    }
    return {f: dims.get(f) if model_axis is not None else None
            for f in GPAD_TENSOR_FIELDS if getattr(like, f) is not None}


def result_specs(data_axis: str | None, model_axis: str | None,
                 paired: bool = False) -> dict:
    """For each ``SolveResult`` field: the dimensions that shard over
    ``data_axis`` and over ``model_axis`` (None: replicated over it). In
    the paired layout ``y`` (B, 2, m_h) shards on its last axis."""
    d = 0 if data_axis is not None else None
    y_model = (2 if paired else 1) if model_axis is not None else None
    specs = {f.name: (d, None) for f in dataclasses.fields(SolveResult)}
    specs["y"] = (d, y_model)
    return specs


def _axis_size(mesh, axis: str | None) -> int:
    return 1 if axis is None else mesh.shape[mesh.mesh_dim_names.index(axis)]


def _axis_rank(mesh, axis: str | None) -> int:
    return 0 if axis is None else mesh.get_local_rank(axis)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_member(mesh) -> None:
    """A rank outside the mesh holds none of its shards."""
    if mesh.get_coordinate() is None:
        import torch.distributed as dist

        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _global(local: torch.Tensor, mesh, shard: dict, shape) -> "DTensor":
    """The DTensor of global ``shape`` whose part on this rank is
    ``local``; ``shard`` maps mesh axis names to the dimension each shards
    (the other axes replicate). No communication."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(shard[a]) if shard.get(a) is not None else Replicate()
                  for a in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def shard_batch(mesh, X0, data_axis: str = "data"):
    """Place a scenario batch sharded along the mesh's data axis: a
    ``DTensor`` on the mesh's device whose rows ``[r b, (r + 1) b)`` live
    on the ranks of data coordinate r. Every rank passes the same ``X0``."""
    _check_member(mesh)
    X0 = torch.as_tensor(X0)
    local = _local_rows(X0, mesh, data_axis, "batch", "data axis")
    return _global(local.to(_mesh_device(mesh)).contiguous(), mesh,
                   {data_axis: 0}, X0.shape)


def _local_rows(x, mesh, axis: str | None, what: str, axis_what: str):
    """This rank's slice of the leading axis of ``x`` over ``axis``: the
    local part of a DTensor sharded so (``shard_batch``), or a slice of a
    tensor or array every rank holds whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n = _axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"{what} {x.shape[0]} not divisible by {axis_what} {n}")
    if isinstance(x, DTensor):
        want = [Shard(0) if a == axis else Replicate()
                for a in mesh.mesh_dim_names]
        if x.device_mesh != mesh or list(x.placements) != want:
            raise ValueError(
                f"a DTensor input must be sharded on its leading axis over "
                f"{axis!r} of this mesh and replicated otherwise "
                f"(shard_batch); got {x.placements}"
            )
        return x.to_local()
    x = torch.as_tensor(x)
    b = x.shape[0] // n
    return x[_axis_rank(mesh, axis) * b:][:b]


def pad_dual_rows(data: GPADData, pad: int) -> GPADData:
    """Append ``pad`` inert dual rows so the dual dimension m divides a
    model (tensor-parallel) mesh axis: the "odd shapes" recipe of
    SURVEY.md section 7.

    A padded row is a vacuous constraint ``0' z <= PAD_BIG * L``: its
    MG_T row / GL_T column (and D row and column) are zero, so it
    contributes nothing to any product, and its p_D constant is
    ``-PAD_BIG`` so its projected dual is exactly 0 at every iteration
    (both signs in the paired layout). Restart inner products, residual
    maxima and the gap sum are all unchanged by identically-zero rows.
    ``n_struct`` is cleared: padding lands after the identity block,
    breaking the "rows [n_struct:] == I" contract (TP never uses the flat
    path anyway)."""
    import torch.nn.functional as F

    if pad <= 0:
        return data

    def pad_last(a, value=0.0):
        return F.pad(a, (0, pad), value=value)

    return dataclasses.replace(
        data,
        MG_T=F.pad(data.MG_T, (0, 0, 0, pad)),  # (m(_h)+pad, n_z)
        GL_T=pad_last(data.GL_T),  # (n_z, m(_h)+pad)
        pD_map=pad_last(data.pD_map),
        pD_const=pad_last(data.pD_const, value=-PAD_BIG),
        D=None if data.D is None else F.pad(data.D, (0, pad, 0, pad)),
        # padded rows are hard (damp 0)
        soft_damp=None if data.soft_damp is None else pad_last(data.soft_damp),
        n_struct=None,
    )


def _shard_data(data: GPADData, mesh, model_axis: str | None) -> GPADData:
    """This rank's slice of every field that ``data_specs`` shards."""
    n, r = _axis_size(mesh, model_axis), _axis_rank(mesh, model_axis)
    upd = {}
    for f, dim in data_specs(data, model_axis).items():
        if dim is not None:
            t = getattr(data, f)
            k = t.shape[dim] // n
            upd[f] = t.narrow(dim, r * k, k).contiguous()
    return dataclasses.replace(data, **upd)


def solve_batch_sharded(
    data: GPADData,
    X0,
    config: SolverConfig = SolverConfig(),
    *,
    mesh,
    data_axis: str | None = "data",
    model_axis: str | None = None,
) -> SolveResult:
    """Mesh-sharded batched solve; every rank of the mesh calls it with the
    same (replicated) ``data`` and ``config``.

    ``X0`` (B, n_x) shards along ``data_axis`` (B must divide evenly):
    a ``shard_batch`` DTensor, or the whole batch on every rank;
    optionally the dual dimension shards along ``model_axis``. A dual
    dimension that does not divide the model axis is padded with inert
    rows (``pad_dual_rows``) and the returned dual ``y`` is sliced back to
    the true m: any m is accepted. In eps mode the loop exits only when
    every scenario on every rank has converged (the all-reduced count).
    Returns a ``SolveResult`` of DTensors laid out as ``result_specs``
    says."""
    _check_member(mesh)
    x_local = _local_rows(X0, mesh, data_axis, "batch", "data axis")
    n_model = _axis_size(mesh, model_axis)
    m_dim = data.m_half if data.paired else data.m
    dual_pad = (-m_dim) % n_model
    if dual_pad:
        data = pad_dual_rows(data, dual_pad)
    axes = tuple(a for a in (data_axis, model_axis) if a is not None)
    inner_cfg = dataclasses.replace(config, model_axis=model_axis,
                                    collective_axes=axes)
    with bind_axes({a: mesh.get_group(a) for a in axes}):
        out = solve_batch(_shard_data(data, mesh, model_axis), x_local,
                          config=inner_cfg)
    if dual_pad:
        # this rank's columns of the true m: those before the padding
        k = out.y.shape[-1]
        keep = max(0, min(k, m_dim - _axis_rank(mesh, model_axis) * k))
        out = dataclasses.replace(out, y=out.y[..., :keep].contiguous())
    fields = {}
    for name, (dd, md) in result_specs(data_axis, model_axis,
                                       data.paired).items():
        t = getattr(out, name)
        shape = [X0.shape[0], *t.shape[1:]]
        if md is not None:
            shape[md] = m_dim
        fields[name] = _global(t, mesh, {data_axis: dd, model_axis: md}, shape)
    return SolveResult(**fields)


def _plant_result(out: SolveResult, mesh, plant_axis: str,
                  n_plants: int) -> SolveResult:
    """Every field sharded on its leading plant axis over ``plant_axis``."""
    return SolveResult(**{
        f.name: _global(getattr(out, f.name), mesh, {plant_axis: 0},
                        (n_plants,) + tuple(getattr(out, f.name).shape[1:]))
        for f in dataclasses.fields(SolveResult)
    })


def _plant_slice(obj, fields, mesh, plant_axis: str):
    """This rank's plants of every tensor field of a stacked build."""
    n, r = _axis_size(mesh, plant_axis), _axis_rank(mesh, plant_axis)
    upd = {}
    for f in fields:
        t = getattr(obj, f)
        if t is not None:
            k = t.shape[0] // n
            upd[f] = t[r * k:(r + 1) * k]
    return dataclasses.replace(obj, **upd)


def solve_multi_sharded(
    data: GPADData,
    x0,
    config: SolverConfig = SolverConfig(),
    *,
    mesh,
    plant_axis: str = "data",
) -> SolveResult:
    """Mesh-sharded multi-plant solve: the plant axis of a ``stack_data``
    result shards over ``plant_axis`` (P must divide evenly), each rank
    solving its local plants with ``solve_multi``: fleets of heterogeneous
    controllers scale across cards with no communication. ``x0``: (P, B,
    n_x) per-plant scenario batches.

    For sharding WITHIN one plant (huge batches or duals), use
    ``solve_batch_sharded`` on that plant instead."""
    from tpu_gpad_torch.solver.multi import _ARRAYS, _OPTIONAL, solve_multi

    _check_member(mesh)
    n_dev = _axis_size(mesh, plant_axis)
    n_plants = data.theta.shape[0]
    if data.theta.ndim < 2:
        raise ValueError("solve_multi_sharded needs a stack_data result")
    if n_plants % n_dev:
        raise ValueError(
            f"plant count {n_plants} not divisible by mesh axis {n_dev}"
        )
    if x0.shape[0] != n_plants:
        raise ValueError(
            f"x0 leading axis {x0.shape[0]} != number of plants {n_plants}"
        )
    local = _plant_slice(data, _ARRAYS + _OPTIONAL, mesh, plant_axis)
    x_local = _local_rows(x0, mesh, plant_axis, "plant count", "mesh axis")
    out = solve_multi(local, x_local, config=config)
    return _plant_result(out, mesh, plant_axis, n_plants)


def solve_stagewise_multi_sharded(
    data,
    x0,
    config: SolverConfig = SolverConfig(),
    *,
    mesh,
    plant_axis: str = "data",
) -> SolveResult:
    """Mesh-sharded multi-plant STAGE-WISE solve: the O(N) twin of
    ``solve_multi_sharded`` for fleets of heterogeneous long-horizon
    controllers. The plant axis of a ``stack_stagewise`` result (P
    different dynamics, Riccati constants and Lipschitz constants) shards
    over ``plant_axis``; each rank runs its local plants' sweeps with no
    communication. ``x0``: (P, n_x) one state per plant, or (P, B, n_x)
    per-plant scenario batches."""
    from tpu_gpad_torch.stagewise import (STAGEWISE_TENSOR_FIELDS,
                                          solve_stagewise_multi)

    _check_member(mesh)
    n_dev = _axis_size(mesh, plant_axis)
    n_plants = x0.shape[0]
    if n_plants % n_dev:
        raise ValueError(
            f"plant count {n_plants} not divisible by mesh axis {n_dev}"
        )
    local = _plant_slice(data, STAGEWISE_TENSOR_FIELDS, mesh, plant_axis)
    x_local = _local_rows(x0, mesh, plant_axis, "plant count", "mesh axis")
    out = solve_stagewise_multi(local, x_local, config=config)
    return _plant_result(out, mesh, plant_axis, n_plants)
