"""Readers/writers for the reference's whitespace-float text formats, and
the native ``.npz`` format of ``GPADData``; the counterpart of
``tpu_gpad.io``.

Two text formats exist in the reference:

1. Per-step golden fixtures (``build/step3/{k}/{input,output}.txt``): header
   ``n_u N m theta`` then the step operands (``step3.cu:58-81``).
2. Full-solver datasets (``build/inputs_manysets/input_%d.txt``): header
   ``n_u N m num_iterations L`` then ``M_G`` ((n_z, m) row-major, stored
   pre-negated in the CUDA convention), ``g_P`` (n_z), ``G_L`` ((m, n_z)
   row-major), ``p_D`` (m), ``theta`` and ``beta`` schedules
   (``main.cu:29-67``).

``save_gpad_data``/``load_gpad_data`` write and read the same ``.npz`` keys
as ``tpu_gpad.io``, so a file written by either package loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from tpu_gpad_torch.types import GPAD_TENSOR_FIELDS, GPADData


@dataclass
class Step3Fixture:
    n_u: int
    N: int
    m: int
    theta: float
    z_prev: np.ndarray  # (n_z,)
    zhat: np.ndarray  # (n_z,)
    expected_z: np.ndarray  # (n_z,)


def read_step3_fixture(directory: str | Path) -> Step3Fixture:
    """Read a ``step3/<k>/`` fixture pair (format per ``step3.cu:58-81``)."""
    directory = Path(directory)
    tokens = (directory / "input.txt").read_text().split()
    n_u, N, m = int(tokens[0]), int(tokens[1]), int(tokens[2])
    theta = float(tokens[3])
    n_z = n_u * N
    vals = np.asarray(tokens[4:], dtype=np.float32)
    if vals.size != 2 * n_z:
        raise ValueError(f"expected {2*n_z} floats in {directory}/input.txt, got {vals.size}")
    expected = np.loadtxt(directory / "output.txt", dtype=np.float32).reshape(-1)
    if expected.size != n_z:
        raise ValueError(f"expected {n_z} floats in {directory}/output.txt")
    return Step3Fixture(
        n_u=n_u, N=N, m=m, theta=theta,
        z_prev=vals[:n_z], zhat=vals[n_z : 2 * n_z], expected_z=expected,
    )


@dataclass
class SolverDataset:
    """A full-solver problem in the reference's dataset format.

    ``M_G`` is stored in the file pre-negated (CUDA convention,
    ``kernel_functions.cu:62`` computes ``+M_G w - g_P``); on read it is
    negated back so this struct always holds the canonical
    ``M_G = H^-1 G'`` unless ``negated_mg`` was False on write.
    """

    n_u: int
    N: int
    m: int
    num_iterations: int
    L: float
    M_G: np.ndarray  # (n_z, m), canonical sign
    g_P: np.ndarray  # (n_z,)
    G_L: np.ndarray  # (m, n_z)
    p_D: np.ndarray  # (m,)
    theta: np.ndarray  # (num_iterations,)
    beta: np.ndarray  # (num_iterations,)


def read_solver_dataset(path: str | Path, negated_mg: bool = True) -> SolverDataset:
    tokens = Path(path).read_text().split()
    n_u, N, m, num_it = (int(t) for t in tokens[:4])
    L = float(tokens[4])
    n_z = n_u * N
    vals = np.asarray(tokens[5:], dtype=np.float32)
    expected = n_z * m + n_z + n_z * m + m + 2 * num_it
    if vals.size != expected:
        raise ValueError(f"{path}: expected {expected} floats, got {vals.size}")
    o = 0

    def take(count, shape):
        nonlocal o
        out = vals[o : o + count].reshape(shape)
        o += count
        return out

    M_G = take(n_z * m, (n_z, m))
    if negated_mg:
        M_G = -M_G
    g_P = take(n_z, (n_z,))
    G_L = take(n_z * m, (m, n_z))
    p_D = take(m, (m,))
    theta = take(num_it, (num_it,))
    beta = take(num_it, (num_it,))
    return SolverDataset(n_u, N, m, num_it, L, M_G, g_P, G_L, p_D, theta, beta)


def write_solver_dataset(path: str | Path, ds: SolverDataset, negated_mg: bool = True) -> None:
    """Write a dataset in the reference's ``input_%d.txt`` format."""
    parts = [f"{ds.n_u} {ds.N} {ds.m} {ds.num_iterations} {ds.L:.9g}"]
    M_G = -ds.M_G if negated_mg else ds.M_G
    for arr in (M_G, ds.g_P, ds.G_L, ds.p_D, ds.theta, ds.beta):
        parts.extend(f"{v:.8f}" for v in np.asarray(arr, dtype=np.float32).reshape(-1))
    Path(path).write_text("\n".join(parts) + "\n")


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)


def dataset_to_gpad_data(ds: SolverDataset, device="cuda") -> GPADData:
    """Bridge a reference-format :class:`SolverDataset` into :class:`GPADData`
    on ``device`` (the card unless the caller asks for "cpu").

    A dataset file bakes the parameter ``x0`` into ``g_P``/``p_D``
    (``main.cu:34-64`` reads them fully formed), so the affine maps here are
    zero and any ``x0`` of shape (n_x=1,) reproduces the shipped constants.
    The layout is the dense (unpaired) stack, and θ/β are the file's own
    schedule. The result runs through the normal ``solve_batch`` path (any
    engine/mode) with ``x0 = zeros((1, 1))``.
    """
    n_z = ds.n_u * ds.N
    return GPADData(
        MG_T=_tensor(ds.M_G.T, device),  # (m, n_z)
        GL_T=_tensor(ds.G_L.T, device),  # (n_z, m)
        gP_map=torch.zeros((1, n_z), dtype=torch.float32, device=device),
        gP_const=_tensor(ds.g_P, device),
        pD_map=torch.zeros((1, ds.m), dtype=torch.float32, device=device),
        pD_const=_tensor(ds.p_D, device),
        L=torch.tensor(ds.L, dtype=torch.float32, device=device),
        theta=_tensor(ds.theta, device),
        beta=_tensor(ds.beta, device),
        n_u=ds.n_u,
        n_x=1,
        horizon=ds.N,
        name=f"dataset_nu{ds.n_u}_N{ds.N}_m{ds.m}",
    )


def save_gpad_data(path: str | Path, data: GPADData) -> None:
    """Native format: one ``.npz`` with the tensor fields (None skipped)
    and the static metadata ``_n_u``, ``_n_x``, ``_horizon``, ``_name`` and
    ``_paired``, the keys ``tpu_gpad.io.save_gpad_data`` writes."""
    arrays = {
        name: getattr(data, name).detach().cpu().numpy()
        for name in GPAD_TENSOR_FIELDS
        if getattr(data, name) is not None
    }
    np.savez(
        path,
        **arrays,
        _n_u=data.n_u,
        _n_x=data.n_x,
        _horizon=data.horizon,
        _name=np.bytes_(data.name.encode()),
        _paired=data.paired,
    )


def load_gpad_data(path: str | Path, device="cuda") -> GPADData:
    """``GPADData`` on ``device`` (the card unless the caller asks for
    "cpu") from a ``.npz`` written by either package. Like
    ``tpu_gpad.io.load_gpad_data``, it leaves ``n_struct`` unset (the file
    does not record it)."""
    with np.load(path) as f:
        kw = {k: torch.as_tensor(f[k], device=device)
              for k in f.files if not k.startswith("_")}
        unknown = set(kw) - set(GPAD_TENSOR_FIELDS)
        if unknown:
            raise ValueError(f"{path}: unknown GPADData fields {sorted(unknown)}")
        return GPADData(
            **kw,
            n_u=int(f["_n_u"]),
            n_x=int(f["_n_x"]),
            horizon=int(f["_horizon"]),
            name=bytes(f["_name"]).decode(),
            paired=bool(f["_paired"]) if "_paired" in f.files else False,
        )
