"""Carry solver data and results across the NumPy boundary.

``gpad_data_from_numpy`` builds the port's ``GPADData`` from the JAX
package's ``GPADData`` fields as NumPy arrays (the caller takes
``np.asarray`` of each leaf, so this module never imports jax), and
``solve_result_to_numpy`` turns a ``SolveResult`` into NumPy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_gpad_torch.types import (
    GPAD_META_FIELDS,
    GPAD_TENSOR_FIELDS,
    GPADData,
    SolveResult,
)


def gpad_data_from_numpy(fields: dict, meta: dict, device="cpu") -> GPADData:
    """``GPADData`` on ``device`` from NumPy ``fields`` (one array, or None
    for the optional ``soft_damp``/``D``, per tensor field) and ``meta``
    (``n_u``, ``n_x``, ``horizon``, ``name``, ``paired``, ``n_struct``).
    Values keep their dtype, so float32 fields arrive bit for bit."""
    missing = set(GPAD_TENSOR_FIELDS) - set(fields) - {"soft_damp", "D"}
    missing |= set(GPAD_META_FIELDS) - set(meta)
    if missing:
        raise ValueError(f"missing GPADData fields: {sorted(missing)}")
    tensors = {
        name: None if fields.get(name) is None
        else torch.from_numpy(np.array(fields[name], order="C")).to(device)
        for name in GPAD_TENSOR_FIELDS
    }
    return GPADData(**tensors, **{k: meta[k] for k in GPAD_META_FIELDS})


def solve_result_to_numpy(res: SolveResult) -> dict:
    """The fields of ``res`` as NumPy arrays on the host."""
    return {
        name: getattr(res, name).detach().cpu().numpy()
        for name in ("u", "z", "y", "iterations", "residual", "gap", "converged")
    }
