"""Core datatypes.

The pipeline has three stages, as in ``tpu_gpad.types``:

  LinearMPCProblem  --condense-->  CondensedQP  --dualize-->  GPADData

``LinearMPCProblem`` and ``CondensedQP`` are NumPy (offline, float64).
``GPADData`` and ``SolveResult`` are dataclasses of torch tensors that live
on one device; ``.to(device)`` moves every tensor field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class LinearMPCProblem:
    """A discrete-time LTI (or LTV) MPC problem; see
    ``tpu_gpad.types.LinearMPCProblem`` for the meaning of every field.

    Dynamics ``x_{k+1} = A x_k + B u_k``; stage cost ``x' Q x + u' R u``
    over ``horizon`` steps; optional state/input boxes, per-stage input
    coupling ``K_u u_k = 0``, input rate limits, general polytopes and a
    known affine dynamics offset ``c``. Stacked (N, n_x, n_x) ``A`` and
    (N, n_x, n_u) ``B`` make the dynamics time-varying."""

    A: np.ndarray
    B: np.ndarray
    Q: np.ndarray
    R: np.ndarray
    horizon: int
    x_min: Optional[np.ndarray] = None
    x_max: Optional[np.ndarray] = None
    Q_terminal: Optional[np.ndarray] = None
    u_min: Optional[np.ndarray] = None
    u_max: Optional[np.ndarray] = None
    K_u: Optional[np.ndarray] = None
    du_min: Optional[np.ndarray] = None
    du_max: Optional[np.ndarray] = None
    H_x: Optional[np.ndarray] = None
    h_x: Optional[np.ndarray] = None
    H_u: Optional[np.ndarray] = None
    h_u: Optional[np.ndarray] = None
    c: Optional[np.ndarray] = None
    name: str = "lti"

    @property
    def n_x(self) -> int:
        return self.A.shape[-1]

    @property
    def n_u(self) -> int:
        return self.B.shape[-1]

    @property
    def n_z(self) -> int:
        return self.n_u * self.horizon

    @property
    def is_ltv(self) -> bool:
        """True when A/B are stacked per-stage (time-varying dynamics)."""
        return np.ndim(self.A) == 3


@dataclass(frozen=True)
class CondensedQP:
    """The condensed primal QP.

    minimize   0.5 z' H z + (F' x0 + g)' z
    subject to G z <= b0 + E x0
    """

    H: np.ndarray  # (n_z, n_z) SPD
    F: np.ndarray  # (n_x, n_z)
    g: np.ndarray  # (n_z,)
    G: np.ndarray  # (m, n_z)
    b0: np.ndarray  # (m,)
    E: np.ndarray  # (m, n_x)
    n_u: int
    n_x: int
    horizon: int
    name: str = "qp"

    @property
    def n_z(self) -> int:
        return self.H.shape[0]

    @property
    def m(self) -> int:
        return self.G.shape[0]


def _move(obj, device):
    """Copy of a tensor dataclass with every tensor field on ``device``."""
    return dataclasses.replace(
        obj,
        **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        },
    )


# Tensor fields of GPADData, in tpu_gpad's pytree order (convert.py reads it).
GPAD_TENSOR_FIELDS = (
    "MG_T", "GL_T", "gP_map", "gP_const", "pD_map", "pD_const",
    "soft_damp", "D", "L", "theta", "beta",
)
GPAD_META_FIELDS = ("n_u", "n_x", "horizon", "name", "paired", "n_struct")


@dataclass(frozen=True)
class GPADData:
    """Everything the online GPAD solver needs, as float32 tensors on one
    device. Same fields and layouts as ``tpu_gpad.types.GPADData``:

        w    = y + beta_k (y - y_prev)
        zhat = -(w @ MG_T) - g_P
        z    = (1 - theta_k) z + theta_k zhat
        y+   = relu(w + zhat @ GL_T + p_D)

    with ``g_P = X0 @ gP_map + gP_const`` and ``p_D = X0 @ pD_map +
    pD_const``. When ``paired`` the operands hold the half stack P
    (``MG_T`` (m_h, n_z), ``GL_T`` (n_z, m_h)) and dual-sized tensors have
    shape (..., 2, m_h): index 0 the +P rows, 1 the -P rows. ``n_struct``
    marks the flat layout: half-stack rows [n_struct:] are exactly I_{n_z}.
    """

    MG_T: torch.Tensor
    GL_T: torch.Tensor
    gP_map: torch.Tensor
    gP_const: torch.Tensor
    pD_map: torch.Tensor
    pD_const: torch.Tensor
    L: torch.Tensor  # () Lipschitz constant
    theta: torch.Tensor  # (max_iters,)
    beta: torch.Tensor  # (max_iters,)
    soft_damp: Optional[torch.Tensor] = None  # (m_h,) soft-row dual damping
    D: Optional[torch.Tensor] = None  # (m_h, m_h) = P H^-1 P' / L
    n_u: int = 0
    n_x: int = 0
    horizon: int = 0
    name: str = "gpad"
    paired: bool = False
    n_struct: Optional[int] = None

    @property
    def n_z(self) -> int:
        return self.MG_T.shape[1]

    @property
    def m(self) -> int:
        """Total number of inequality constraints."""
        return self.MG_T.shape[0] * (2 if self.paired else 1)

    @property
    def m_half(self) -> int:
        if not self.paired:
            raise ValueError("m_half only exists for paired layouts")
        return self.MG_T.shape[0]

    @property
    def max_iters(self) -> int:
        return self.theta.shape[0]

    @property
    def device(self) -> torch.device:
        return self.MG_T.device

    def to(self, device) -> "GPADData":
        return _move(self, device)


@dataclass(frozen=True)
class SolveResult:
    """Output of a GPAD solve (fields as ``tpu_gpad.types.SolveResult``):
    ``u`` first move, ``z`` primal trajectory, ``y`` dual iterate,
    ``iterations`` (int32), ``residual`` primal infeasibility, ``gap`` the
    dual-gap surrogate, ``converged`` (bool)."""

    u: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    iterations: torch.Tensor
    residual: torch.Tensor
    gap: torch.Tensor
    converged: torch.Tensor

    def to(self, device) -> "SolveResult":
        return _move(self, device)
