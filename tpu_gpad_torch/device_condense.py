"""Device-side LTV condensation and dualization, the counterpart of
``tpu_gpad.device_condense``.

The host ``condense``/``dualize`` pair runs float64 NumPy: right for
offline set-up, wrong for the NMPC inner loop, where every SQP pass
re-condenses the successive linearization (``nonlinear.NMPC``). Here the
same algebra runs as float32 torch ops on the device of the (A_k, B_k, c_k)
stacks, so one pass

    rollout -> linearize -> condense -> dualize -> GPAD solve

stays on the card from the measured state to the plan: no host round trip,
no host sync. ``L``, the convergence choice of the power method and the
row layout are tensors or come from shapes; the constants that do not
depend on the linearization (weights, boxes, coupling and rate rows, the
power method's start vector, the momentum schedule) are uploaded once by
``ltv_constants`` / ``scenario_constants`` and reused by every pass
(``dualize_ltv`` / ``dualize_scenario``). ``dualize_ltv_device`` and
``dualize_scenario_device`` keep the JAX package's one-call signatures.

Scope (the NMPC fast path), as in the JAX package: tracking or preview
cost, constant or per-stage Q/R, input boxes (required: they give the
paired [P; -P] stack and the flat identity block), optional state boxes
(constant or per-stage), input rate limits with ``u_prev`` as a trailing
parameter, per-stage input couplings ``K_u u_k = 0``, per-stage affine
offsets ``c``, general polytopes with an inert minus side
(``PAD_BIG``), soft state boxes through ``GPADData.soft_damp``, and
the shared-first-move scenario stack of ``robust.scenario_qp``.

Batches: ``A``/``B``/``c`` may carry leading batch dimensions (B
linearizations of one controller); every tensor of the result then carries
them too, the momentum schedule included, which is the layout
``solver.multi.solve_multi`` takes.

Numerics: float32 with TF32 held off for the whole region (the JAX package
forces "highest" precision; a TF32 product would corrupt the condensed
operands the way a one-pass bf16 one does on a TPU). The linear solves
against H take a Cholesky factor and one step of iterative refinement; L
comes from a fixed-iteration power method on the half-stack dual Hessian
with a 5% margin, or the certified row-sum bound where the iterate has not
converged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tpu_gpad_torch.schedule import momentum_schedule
from tpu_gpad_torch.solver.core import tf32_matmuls
from tpu_gpad_torch.types import PAD_BIG, GPADData


def _prediction(A, B, c):
    """T (..., N n_x, n_x), S (..., N n_x, N n_u) and the cumulative affine
    offsets s_off (..., N n_x) of ``x = T x0 + S z + s_off``, in one forward
    recursion over the stages: [T_i | S_i | off_i] = A_{i-1} [T_{i-1} |
    S_{i-1} | off_{i-1}] + [0 | B_{i-1} in block i-1 | c_{i-1}]."""
    *lead, N, n_x, _ = A.shape
    n_u = B.shape[-1]
    n_z = N * n_u
    width = n_x + n_z + 1
    prev = torch.zeros((*lead, n_x, width), dtype=A.dtype, device=A.device)
    prev[..., :n_x] = torch.eye(n_x, dtype=A.dtype, device=A.device)
    rows = []
    for i in range(N):
        row = A[..., i, :, :] @ prev
        row[..., n_x + i * n_u: n_x + (i + 1) * n_u] += B[..., i, :, :]
        row[..., -1] += c[..., i, :]
        rows.append(row)
        prev = row
    M = torch.stack(rows, dim=-3).reshape(*lead, N * n_x, width)
    return M[..., :n_x], M[..., n_x:n_x + n_z], M[..., -1]


def prediction_matrices_device(A: torch.Tensor, B: torch.Tensor):
    """``condense.prediction_matrices_ltv`` on the device of ``A``: stacked
    (..., N, n_x, n_x) / (..., N, n_x, n_u) -> dense T (..., N n_x, n_x),
    S (..., N n_x, N n_u), float32 with TF32 off."""
    A = A.to(torch.float32)
    with tf32_matmuls(False):
        T, S, _ = _prediction(A, B.to(A), torch.zeros(A.shape[:-1], dtype=A.dtype,
                                                      device=A.device))
    return T, S


def _chol_solve_refined(H, rhs):
    """float32 ``H^-1 rhs`` by a Cholesky factor plus one iterative-refinement
    step (recovers most of the float32 factorization error for the mildly
    conditioned H of successive linearizations). ``cholesky_ex`` leaves
    the factorization's status on the device (``cholesky`` would read it
    back, a host sync a pass); an H that is not positive definite gives
    NaN, as in the JAX package."""
    chol = torch.linalg.cholesky_ex(H).L
    X = torch.cholesky_solve(rhs, chol)
    return X + torch.cholesky_solve(rhs - H @ X, chol)


def power_start(m: int) -> np.ndarray:
    """The power method's start vector: the JAX package's fixed
    pseudo-random one, ``default_rng(0).standard_normal(m)`` normalized,
    never the all-ones vector (a symmetric plant's dominant dual mode is
    often orthogonal to it)."""
    v0 = np.random.default_rng(0).standard_normal(m).astype(np.float32)
    return v0 / np.linalg.norm(v0)


def _power_lmax(M, v0, iters: int = 96):
    """lambda_max of symmetric PSD ``M`` (..., m, m) by ``iters`` power steps
    from ``v0`` (m,), and the relative eigen-residual ||Mv - lam v|| / lam of
    the last iterate: about 0 once it has converged to the dominant
    eigenvector, O(1) when a small eigengap left it short (then the Rayleigh
    quotient may badly underestimate lambda_max)."""
    v = v0.expand(M.shape[:-1])
    for _ in range(iters):
        w = (M @ v[..., None])[..., 0]
        v = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    Mv = (M @ v[..., None])[..., 0]
    lam = torch.sum(v * Mv, dim=-1)
    resid = (torch.linalg.vector_norm(Mv - lam[..., None] * v, dim=-1)
             / torch.clamp_min(lam, 1e-30))
    return lam, resid


def _stage_box(v, N: int, n: int, what: str) -> np.ndarray:
    """Validate constant (n,) or per-stage (N, n) bounds and ravel them to
    the stage-major (N n,) layout of the paired stacks."""
    arr = np.asarray(v, np.float32)
    if arr.ndim == 1:
        arr = np.tile(arr, (N, 1))
    if arr.shape != (N, n):
        raise ValueError(
            f"{what} must be ({n},) or ({N},{n}); got {np.asarray(v).shape}"
        )
    return arr.ravel()


def _stage_weights(Q, R, Q_terminal, N: int, n_x: int, n_u: int, device):
    """Per-stage Q (N, n_x, n_x) with the terminal weight at stage N, and
    the block-diagonal Rbar (N n_u, N n_u), float32 tensors on ``device``;
    Q/R constant or per-stage, shapes checked as the JAX package does.

    Q, R and Q_terminal may be arrays or tensors; a tensor keeps its
    autograd graph, so a loss through the solve reaches learned weights
    (``diff.make_data_differentiable_solver``)."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    Q_t = f32(Q)
    if tuple(Q_t.shape) not in ((n_x, n_x), (N, n_x, n_x)):
        raise ValueError(f"Q must be ({n_x},{n_x}) or ({N},{n_x},{n_x}); "
                         f"got {tuple(Q_t.shape)}")
    Qs = Q_t.broadcast_to((N, n_x, n_x)).clone()
    if Q_terminal is not None:
        Qs[-1] = f32(Q_terminal)
    R_t = f32(R)
    if tuple(R_t.shape) not in ((n_u, n_u), (N, n_u, n_u)):
        raise ValueError(f"R must be ({n_u},{n_u}) or ({N},{n_u},{n_u}); "
                         f"got {tuple(R_t.shape)}")
    return Qs, torch.block_diag(*R_t.broadcast_to((N, n_u, n_u)).unbind(0))


def _check_soft(soft_state, have_xbox: bool) -> None:
    if soft_state is not None:
        if soft_state <= 0:
            raise ValueError("soft_state penalty weight must be positive")
        if not have_xbox:
            raise ValueError("soft_state set but the problem has no state box")


@dataclass(frozen=True)
class LTVConstants:
    """What ``dualize_ltv`` needs besides the linearization, on one device.

    Rows of the paired half stack, in order: state boxes, ``K_u`` coupling,
    rate rows, ``H_x`` polytope, ``H_u`` polytope, the input-box identity
    block last. Fields that a problem lacks are None."""

    N: int
    n_x: int
    n_u: int
    n_p: int
    Qs: torch.Tensor  # (N, n_x, n_x)
    Rbar: torch.Tensor  # (N n_u, N n_u)
    ones_kron: Optional[torch.Tensor]  # (N n_x, n_x) stacked identities; None with preview
    x_max: Optional[torch.Tensor]  # (N n_x,) state box, before the offsets
    x_min: Optional[torch.Tensor]
    K_rows: Optional[torch.Tensor]  # (N n_c, n_z) block-diagonal K_u
    rate: Optional[tuple]  # (Dz, b0+, b0-, E+) of the rate rows
    Hbar_x: Optional[torch.Tensor]  # (N q_x, N n_x)
    h_x: Optional[torch.Tensor]  # (N q_x,)
    Hu_rows: Optional[torch.Tensor]  # (N q_u, n_z)
    h_u: Optional[torch.Tensor]
    u_max: torch.Tensor  # (n_z,)
    u_min: torch.Tensor
    soft_inv_rho: Optional[torch.Tensor]  # (m_h,) 1/rho on soft rows, else 0
    v0: torch.Tensor  # (m_h,) power-method start
    theta: torch.Tensor
    beta: torch.Tensor
    power_iters: int
    name: str

    @property
    def m_half(self) -> int:
        return self.v0.shape[0]


def ltv_constants(
    N: int, n_x: int, n_u: int,
    Q: np.ndarray, R: np.ndarray, u_min: np.ndarray, u_max: np.ndarray,
    iterations: int,
    Q_terminal: Optional[np.ndarray] = None,
    x_min: Optional[np.ndarray] = None,
    x_max: Optional[np.ndarray] = None,
    du_min: Optional[np.ndarray] = None,
    du_max: Optional[np.ndarray] = None,
    K_u: Optional[np.ndarray] = None,
    H_x: Optional[np.ndarray] = None,
    h_x: Optional[np.ndarray] = None,
    H_u: Optional[np.ndarray] = None,
    h_u: Optional[np.ndarray] = None,
    soft_state: Optional[float] = None,
    preview: bool = False,
    schedule: str = "paper",
    power_iters: int = 64,
    name: str = "ltv_device",
    device="cuda",
) -> LTVConstants:
    """Check the static part of a tracking LTV problem (arguments as
    ``dualize_ltv_device``) and upload it to ``device`` once, for any
    number of ``dualize_ltv`` passes. Raises the JAX package's errors."""
    if (x_min is None) != (x_max is None):
        raise ValueError("device path needs both x_min and x_max (or neither)")
    if u_min is None or u_max is None:
        raise ValueError("device path needs input boxes (they form the "
                         "paired stack's identity block)")
    n_z = N * n_u
    Qs, Rbar = _stage_weights(Q, R, Q_terminal, N, n_x, n_u, device)
    have_rate = du_min is not None or du_max is not None
    if (du_min is None) != (du_max is None):
        raise ValueError("device path needs both du_min and du_max "
                         "(or neither)")
    ref_dim = N * n_x if preview else n_x
    n_p = n_x + ref_dim + (n_u if have_rate else 0)
    have_xbox = x_min is not None
    _check_soft(soft_state, have_xbox)
    blocks = []  # (rows, soft) per block, for the damping column
    f = {}
    if have_xbox:
        f["x_max"] = _stage_box(x_max, N, n_x, "x_max")
        f["x_min"] = _stage_box(x_min, N, n_x, "x_min")
        blocks.append((N * n_x, soft_state is not None))
    if K_u is not None:
        K_arr = np.asarray(K_u, np.float32)
        if K_arr.ndim != 2 or K_arr.shape[1] != n_u:
            raise ValueError(f"K_u must be (n_c, {n_u}); got {K_arr.shape}")
        f["K_rows"] = np.kron(np.eye(N, dtype=np.float32), K_arr)
        blocks.append((f["K_rows"].shape[0], False))
    if have_rate:
        # du_min <= u_k - u_{k-1} <= du_max with u_{-1} the previously
        # applied move, a trailing parameter: Dz is the block difference
        # map, and only the first n_u rows see u_prev
        du_max_a = np.asarray(du_max, np.float32)
        du_min_a = np.asarray(du_min, np.float32)
        if du_max_a.shape != (n_u,) or du_min_a.shape != (n_u,):
            raise ValueError(f"du bounds must be ({n_u},) on the device path")
        Dz = np.eye(n_z, dtype=np.float32)
        for k in range(1, N):
            Dz[k * n_u:(k + 1) * n_u, (k - 1) * n_u:k * n_u] = -np.eye(n_u)
        E_rate = np.zeros((n_z, n_p), np.float32)
        E_rate[:n_u, n_x + ref_dim:] = np.eye(n_u)
        f["rate"] = (Dz, np.tile(du_max_a, N), -np.tile(du_min_a, N), E_rate)
        blocks.append((n_z, False))
    if (H_x is None) != (h_x is None):
        raise ValueError("H_x and h_x must be passed together")
    if (H_u is None) != (h_u is None):
        raise ValueError("H_u and h_u must be passed together")
    if H_x is not None:
        Hx = np.asarray(H_x, np.float32)
        if Hx.ndim != 2 or Hx.shape[1] != n_x:
            raise ValueError(f"H_x must be (q_x, {n_x}); got {Hx.shape}")
        f["Hbar_x"] = np.kron(np.eye(N, dtype=np.float32), Hx)
        f["h_x"] = _stage_box(h_x, N, Hx.shape[0], "h_x")
        blocks.append((N * Hx.shape[0], False))
    if H_u is not None:
        Hu = np.asarray(H_u, np.float32)
        if Hu.ndim != 2 or Hu.shape[1] != n_u:
            raise ValueError(f"H_u must be (q_u, {n_u}); got {Hu.shape}")
        f["Hu_rows"] = np.kron(np.eye(N, dtype=np.float32), Hu)
        f["h_u"] = _stage_box(h_u, N, Hu.shape[0], "h_u")
        blocks.append((N * Hu.shape[0], False))
    u_max_t = _stage_box(u_max, N, n_u, "u_max")
    u_min_t = _stage_box(u_min, N, n_u, "u_min")
    blocks.append((n_z, False))
    m_h = sum(n for n, _ in blocks)
    soft = None
    if soft_state is not None:
        soft = np.concatenate([np.full(n, 1.0 / soft_state if s else 0.0,
                                       np.float32) for n, s in blocks])
    theta, beta = momentum_schedule(iterations, schedule)

    def t(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(t(x) for x in a)
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)

    return LTVConstants(
        N=N, n_x=n_x, n_u=n_u, n_p=n_p, Qs=Qs, Rbar=Rbar,
        ones_kron=None if preview else t(np.tile(np.eye(n_x), (N, 1))),
        x_max=t(f.get("x_max")), x_min=t(f.get("x_min")),
        K_rows=t(f.get("K_rows")), rate=t(f.get("rate")),
        Hbar_x=t(f.get("Hbar_x")), h_x=t(f.get("h_x")),
        Hu_rows=t(f.get("Hu_rows")), h_u=t(f.get("h_u")),
        u_max=t(u_max_t), u_min=t(u_min_t), soft_inv_rho=t(soft),
        v0=t(power_start(m_h)), theta=t(theta), beta=t(beta),
        power_iters=power_iters, name=name,
    )


def _qbar(Qs, M):
    """Qbar @ M for the block-diagonal stage weights: (..., N n_x, k)."""
    N, n_x = Qs.shape[0], Qs.shape[1]
    lead = M.shape[:-2]
    return (Qs @ M.reshape(*lead, N, n_x, -1)).reshape(*lead, N * n_x, -1)


def _costs(Qs, Rbar, T, S, s_off, ones_kron):
    """H, F (n_p-rows of the cost's parameter map without the rate part)
    and g = S' Qbar s_off of the condensed tracking cost."""
    QbarS = _qbar(Qs, S)
    St = S.transpose(-1, -2)
    H = St @ QbarS + Rbar
    H = 0.5 * (H + H.transpose(-1, -2))
    F_x0 = T.transpose(-1, -2) @ QbarS
    F_r = -QbarS if ones_kron is None else -(ones_kron.transpose(0, 1) @ QbarS)
    g = (St @ _qbar(Qs, s_off[..., None]))[..., 0]
    return H, torch.cat([F_x0, F_r], dim=-2), g


def dualize_ltv(k: LTVConstants, A, B, c) -> GPADData:
    """Condense and dualize the linearization (``A``, ``B``, ``c``) of shapes
    (..., N, n_x, n_x) / (..., N, n_x, n_u) / (..., N, n_x) on their device,
    with the static part ``k`` from ``ltv_constants``. The result is paired
    and flat, its rows in ``LTVConstants``' order; with leading batch
    dimensions every tensor carries them."""
    dev = A.device
    A, B, c = (t.to(device=dev, dtype=torch.float32) for t in (A, B, c))
    lead = tuple(A.shape[:-3])
    N, n_x, n_u, n_p = k.N, k.n_x, k.n_u, k.n_p
    if tuple(A.shape[-3:]) != (N, n_x, n_x) or tuple(B.shape[-3:]) != (
            N, n_x, n_u) or tuple(c.shape[-2:]) != (N, n_x):
        raise ValueError(
            f"A, B, c must be (..., {N}, {n_x}, {n_x}), (..., {N}, {n_x}, "
            f"{n_u}), (..., {N}, {n_x}); got {tuple(A.shape)}, "
            f"{tuple(B.shape)}, {tuple(c.shape)}")
    n_z = N * n_u
    with tf32_matmuls(False):
        T, S, s_off = _prediction(A, B, c)
        H, F, g = _costs(k.Qs, k.Rbar, T, S, s_off, k.ones_kron)
        ex = lambda t: t.expand(*lead, *t.shape)  # a constant block per batch
        zeros = lambda r: torch.zeros((*lead, r, n_p), dtype=torch.float32,
                                      device=dev)
        P, b0p, b0m, Ep, Em = [], [], [], [], []
        if k.x_max is not None:
            Ex = torch.cat([-T, zeros(N * n_x)[..., n_x:]], dim=-1)
            P.append(S)
            b0p.append(k.x_max - s_off)
            b0m.append(-(k.x_min - s_off))
            Ep.append(Ex)
            Em.append(-Ex)
        if k.K_rows is not None:
            P.append(ex(k.K_rows))
            r = k.K_rows.shape[0]
            zero_b = torch.zeros((*lead, r), dtype=torch.float32, device=dev)
            b0p.append(zero_b)
            b0m.append(zero_b)
            Ep.append(zeros(r))
            Em.append(zeros(r))
        if k.rate is not None:
            Dz, bp, bm, E_rate = k.rate
            P.append(ex(Dz))
            b0p.append(ex(bp))
            b0m.append(ex(bm))
            Ep.append(ex(E_rate))
            Em.append(ex(-E_rate))
        if k.Hbar_x is not None:
            r = k.Hbar_x.shape[0]
            HT = k.Hbar_x @ T
            P.append(k.Hbar_x @ S)
            b0p.append(k.h_x - (k.Hbar_x @ s_off[..., None])[..., 0])
            b0m.append(torch.full((*lead, r), PAD_BIG, dtype=torch.float32,
                                  device=dev))
            Ep.append(torch.cat([-HT, zeros(r)[..., n_x:]], dim=-1))
            Em.append(zeros(r))
        if k.Hu_rows is not None:
            r = k.Hu_rows.shape[0]
            P.append(ex(k.Hu_rows))
            b0p.append(ex(k.h_u))
            b0m.append(torch.full((*lead, r), PAD_BIG, dtype=torch.float32,
                                  device=dev))
            Ep.append(zeros(r))
            Em.append(zeros(r))
        # the input-box identity block, always last (the flat contract)
        P.append(ex(torch.eye(n_z, dtype=torch.float32, device=dev)))
        b0p.append(ex(k.u_max))
        b0m.append(ex(-k.u_min))
        Ep.append(zeros(n_z))
        Em.append(zeros(n_z))
        if k.rate is not None:
            # the cost never sees u_prev: zero parameter rows in F
            F = torch.cat([F, torch.zeros((*lead, n_u, n_z), dtype=torch.float32,
                                          device=dev)], dim=-2)
        return _finish_dualize(
            torch.cat(P, dim=-2), torch.cat(b0p, dim=-1), torch.cat(b0m, dim=-1),
            torch.cat(Ep, dim=-2), torch.cat(Em, dim=-2), H, F, g, k,
            n_u=n_u, horizon=N)


def _finish_dualize(P, b0_plus, b0_minus, E_plus, E_minus, H, F, g_vec, k,
                    *, n_u: int, horizon: int) -> GPADData:
    """Dualize a paired flat half stack (shared by the LTV and scenario
    paths): dual Hessian, a safe Lipschitz bound, the GPAD operands.

    ``P`` is the (..., m_h, n_zt) half stack with the identity block last
    (n_struct = m_h - n_zt rows of structure before it)."""
    lead = tuple(P.shape[:-2])
    n_zt = P.shape[-1]
    n_struct = P.shape[-2] - n_zt
    Pt = P.transpose(-1, -2)
    Hinv_Pt = _chol_solve_refined(H, Pt)  # (..., n_zt, m_h)
    Hd_h = P @ Hinv_Pt  # the half-stack dual Hessian P H^-1 P'
    Hd_h = 0.5 * (Hd_h + Hd_h.transpose(-1, -2))
    # the full stack [P; -P] doubles lambda_max. The Rayleigh quotient is a
    # lower bound, trusted only once the iterate has converged (small
    # eigen-residual); else the certified max-abs-row-sum bound, which is
    # never below lambda_max. The 5% margin costs about 2.5% iterations.
    lam, lam_resid = _power_lmax(Hd_h, k.v0, k.power_iters)
    est = 1.05 * (2.0 * lam)
    cert = 2.0 * torch.amax(torch.sum(torch.abs(Hd_h), dim=-1), dim=-1)
    L = torch.where(lam_resid < 0.02, torch.minimum(est, cert), cert)
    if k.soft_inv_rho is not None:
        # the regularized dual Hessian G H^-1 G' + diag(1/rho): lambda_max
        # grows by at most max 1/rho (0 on hard rows)
        L = L + torch.amax(k.soft_inv_rho)
    Lm = L[..., None, None]
    gP_map = _chol_solve_refined(H, F.transpose(-1, -2)).transpose(-1, -2)
    gP_const = _chol_solve_refined(H, g_vec[..., None])[..., 0]
    pD_map = torch.stack([-E_plus.transpose(-1, -2) / Lm,
                          -E_minus.transpose(-1, -2) / Lm], dim=-2)
    pD_const = torch.stack([-b0_plus / L[..., None], -b0_minus / L[..., None]],
                           dim=-2)
    per = lambda t: t.expand(*lead, *t.shape).contiguous()
    return GPADData(
        MG_T=Hinv_Pt.transpose(-1, -2).contiguous(),
        GL_T=(Pt / Lm).contiguous(),
        gP_map=gP_map.contiguous(),
        gP_const=gP_const.contiguous(),
        pD_map=pD_map.contiguous(),
        pD_const=pD_const.contiguous(),
        soft_damp=None if k.soft_inv_rho is None
        else (k.soft_inv_rho / L[..., None]).contiguous(),
        D=(Hd_h / Lm).contiguous(),
        L=L.contiguous(),
        theta=per(k.theta),
        beta=per(k.beta),
        n_u=n_u,
        n_x=k.n_p,
        horizon=horizon,
        name=k.name,
        paired=True,
        n_struct=n_struct,
    )


def dualize_ltv_device(
    A: torch.Tensor,
    B: torch.Tensor,
    c: torch.Tensor,
    Q: np.ndarray,
    R: np.ndarray,
    u_min: np.ndarray,
    u_max: np.ndarray,
    iterations: int,
    Q_terminal: Optional[np.ndarray] = None,
    x_min: Optional[np.ndarray] = None,
    x_max: Optional[np.ndarray] = None,
    du_min: Optional[np.ndarray] = None,
    du_max: Optional[np.ndarray] = None,
    K_u: Optional[np.ndarray] = None,
    H_x: Optional[np.ndarray] = None,
    h_x: Optional[np.ndarray] = None,
    H_u: Optional[np.ndarray] = None,
    h_u: Optional[np.ndarray] = None,
    soft_state: Optional[float] = None,
    preview: bool = False,
    schedule: str = "paper",
    power_iters: int = 64,
    name: str = "ltv_device",
) -> GPADData:
    """Condense and dualize a tracking LTV MPC problem on the device of
    ``A``, as ``tpu_gpad.device_condense.dualize_ltv_device``.

    ``A``/``B``/``c`` are tensors (..., N, n_x, n_x) / (..., N, n_x, n_u) /
    (..., N, n_x), e.g. straight from ``nonlinear.linearize``; the box
    constants are NumPy; the cost weights ``Q``, ``R``, ``Q_terminal`` are
    NumPy or tensors, and a tensor's autograd graph reaches every operand
    (learned weights: ``diff.make_data_differentiable_solver``). The
    result is a paired, flat ``GPADData`` on that device, rows [state box
    | K_u coupling | rate | H_x | H_u | input box identity]. Parameters ``p = [x0; r]`` (r of n_x or, with
    ``preview``, N n_x entries), plus a trailing ``u_prev`` (n_u) with
    ``du_min``/``du_max``. Matches ``dualize(condense(problem, tracking=...),
    paired=True)`` up to float32 arithmetic and the power-method L.

    One-sided polytope rows (``H_x``/``h_x``, ``H_u``/``h_u``) enter the
    paired stack with an inert minus side (RHS ``PAD_BIG``, zero parameter
    columns), so the flat identity block survives; ``soft_state`` softens
    the state box by the dual damping ``GPADData.soft_damp`` (L gains
    1/rho) instead of slack variables."""
    N, n_x = A.shape[-3], A.shape[-1]
    k = ltv_constants(
        N, n_x, B.shape[-1], Q, R, u_min, u_max, iterations,
        Q_terminal=Q_terminal, x_min=x_min, x_max=x_max, du_min=du_min,
        du_max=du_max, K_u=K_u, H_x=H_x, h_x=h_x, H_u=H_u, h_u=h_u,
        soft_state=soft_state, preview=preview, schedule=schedule,
        power_iters=power_iters, name=name, device=A.device)
    return dualize_ltv(k, A, B, c)


@dataclass(frozen=True)
class ScenarioConstants:
    """What ``dualize_scenario`` needs besides the S linearizations."""

    S: int
    N: int
    n_x: int
    n_u: int
    weights: np.ndarray  # (S,) float32, normalized
    Qs: torch.Tensor
    Rbar: torch.Tensor
    ones_kron: Optional[torch.Tensor]
    x_max: Optional[torch.Tensor]
    x_min: Optional[torch.Tensor]
    b0p_id: torch.Tensor  # (n_tilde,) identity-block bounds on z~
    b0m_id: torch.Tensor
    soft_inv_rho: Optional[torch.Tensor]
    v0: torch.Tensor
    theta: torch.Tensor
    beta: torch.Tensor
    n_p: int
    power_iters: int
    name: str

    @property
    def m_half(self) -> int:
        return self.v0.shape[0]


def scenario_constants(
    S: int, N: int, n_x: int, n_u: int,
    Q: np.ndarray, R: np.ndarray, u_min: np.ndarray, u_max: np.ndarray,
    iterations: int,
    weights=None,
    Q_terminal: Optional[np.ndarray] = None,
    x_min: Optional[np.ndarray] = None,
    x_max: Optional[np.ndarray] = None,
    soft_state: Optional[float] = None,
    preview: bool = False,
    schedule: str = "paper",
    power_iters: int = 64,
    name: str = "scenario_device",
    device="cuda",
) -> ScenarioConstants:
    """Check and upload the static part of an S-scenario robust stack
    (arguments as ``dualize_scenario_device``) once."""
    n_z = N * n_u
    n_tilde = n_u + S * (n_z - n_u)
    if u_min is None or u_max is None:
        raise ValueError("device path needs input boxes (they form the "
                         "paired stack's identity block)")
    if (x_min is None) != (x_max is None):
        raise ValueError("device path needs both x_min and x_max (or neither)")
    have_xbox = x_min is not None
    if weights is None:
        w = np.full(S, 1.0 / S, dtype=np.float32)
    else:
        w = np.asarray(weights, dtype=np.float64)
        if w.shape != (S,) or (w <= 0).any():
            raise ValueError("weights must be S positive floats")
        w = (w / w.sum()).astype(np.float32)
    Qs, Rbar = _stage_weights(Q, R, Q_terminal, N, n_x, n_u, device)
    ref_dim = N * n_x if preview else n_x
    _check_soft(soft_state, have_xbox)
    blocks = []  # (rows, 1/rho_effective) per block
    f = {}
    if have_xbox:
        f["x_max"] = _stage_box(x_max, N, n_x, "x_max")
        f["x_min"] = _stage_box(x_min, N, n_x, "x_min")
        # scenario_qp scales scenario s's (softened) H by w_s, so its slack
        # penalty becomes w_s rho: the damping uses that effective rho
        for s in range(S):
            blocks.append((N * n_x, 0.0 if soft_state is None
                           else 1.0 / (w[s] * soft_state)))
    u_max_t = _stage_box(u_max, N, n_u, "u_max")
    u_min_t = _stage_box(u_min, N, n_u, "u_min")
    # stage-0 bounds once (the shared move), stages 1..N-1 per scenario tail
    b0p_id = np.concatenate([u_max_t[:n_u]] + [u_max_t[n_u:]] * S)
    b0m_id = np.concatenate([-u_min_t[:n_u]] + [-u_min_t[n_u:]] * S)
    blocks.append((n_tilde, 0.0))
    m_h = sum(n for n, _ in blocks)
    soft = None
    if soft_state is not None:
        soft = np.concatenate([np.full(n, v, np.float32) for n, v in blocks])
    theta, beta = momentum_schedule(iterations, schedule)

    def t(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a), dtype=torch.float32, device=device)

    return ScenarioConstants(
        S=S, N=N, n_x=n_x, n_u=n_u, weights=w, Qs=Qs, Rbar=Rbar,
        ones_kron=None if preview else t(np.tile(np.eye(n_x), (N, 1))),
        x_max=t(f.get("x_max")), x_min=t(f.get("x_min")),
        b0p_id=t(b0p_id), b0m_id=t(b0m_id), soft_inv_rho=t(soft),
        v0=t(power_start(m_h)), theta=t(theta), beta=t(beta),
        n_p=n_x + ref_dim, power_iters=power_iters, name=name,
    )


def dualize_scenario(k: ScenarioConstants, A, B, c) -> GPADData:
    """Condense and dualize S per-scenario linearizations (S, N, n_x, n_x) /
    (S, N, n_x, n_u) / (S, N, n_x) into the shared-first-move stack of
    ``robust.scenario_qp`` on their device, with the static part ``k``."""
    dev = A.device
    A, B, c = (t.to(device=dev, dtype=torch.float32) for t in (A, B, c))
    S, N, n_x, n_u, n_p = k.S, k.N, k.n_x, k.n_u, k.n_p
    if tuple(A.shape) != (S, N, n_x, n_x) or tuple(B.shape) != (
            S, N, n_x, n_u) or tuple(c.shape) != (S, N, n_x):
        raise ValueError(
            f"A, B, c must be ({S}, {N}, {n_x}, {n_x}), ({S}, {N}, {n_x}, "
            f"{n_u}), ({S}, {N}, {n_x}); got {tuple(A.shape)}, "
            f"{tuple(B.shape)}, {tuple(c.shape)}")
    n_z = N * n_u
    tail = n_z - n_u
    n_tilde = n_u + S * tail
    w = k.weights
    f32 = dict(dtype=torch.float32, device=dev)
    with tf32_matmuls(False):
        Ts, Ss, s_offs = _prediction(A, B, c)
        Hs, Fs, gs = _costs(k.Qs, k.Rbar, Ts, Ss, s_offs, k.ones_kron)
        # the selector's block structure: z~'s shared block accumulates
        # every scenario's u_0 coupling, each tail block is w_s times that
        # scenario's own blocks (robust.scenario_qp)
        H = torch.zeros((n_tilde, n_tilde), **f32)
        F = torch.zeros((n_p, n_tilde), **f32)
        g = torch.zeros(n_tilde, **f32)
        for s in range(S):
            sl = slice(n_u + s * tail, n_u + (s + 1) * tail)
            H[:n_u, :n_u] += w[s] * Hs[s, :n_u, :n_u]
            H[:n_u, sl] = w[s] * Hs[s, :n_u, n_u:]
            H[sl, :n_u] = w[s] * Hs[s, n_u:, :n_u]
            H[sl, sl] = w[s] * Hs[s, n_u:, n_u:]
            F[:, :n_u] += w[s] * Fs[s, :, :n_u]
            F[:, sl] = w[s] * Fs[s, :, n_u:]
            g[:n_u] += w[s] * gs[s, :n_u]
            g[sl] = w[s] * gs[s, n_u:]
        H = 0.5 * (H + H.T)
        # per-scenario state-box rows (structure), then the z~ identity
        # block last: every decision variable has exactly one box row
        P, b0p, b0m, Ep, Em = [], [], [], [], []
        if k.x_max is not None:
            zeros_ref = torch.zeros((N * n_x, n_p - n_x), **f32)
            for s in range(S):
                off = n_u + s * tail
                row = torch.zeros((N * n_x, n_tilde), **f32)
                row[:, :n_u] = Ss[s, :, :n_u]
                row[:, off:off + tail] = Ss[s, :, n_u:]
                P.append(row)
                b0p.append(k.x_max - s_offs[s])
                b0m.append(-(k.x_min - s_offs[s]))
                Ep.append(torch.cat([-Ts[s], zeros_ref], dim=1))
                Em.append(torch.cat([Ts[s], zeros_ref], dim=1))
        P.append(torch.eye(n_tilde, **f32))
        b0p.append(k.b0p_id)
        b0m.append(k.b0m_id)
        zeros_id = torch.zeros((n_tilde, n_p), **f32)
        Ep.append(zeros_id)
        Em.append(zeros_id)
        horizon = n_tilde // n_u if n_tilde % n_u == 0 else N
        return _finish_dualize(
            torch.cat(P), torch.cat(b0p), torch.cat(b0m), torch.cat(Ep),
            torch.cat(Em), H, F, g, k, n_u=n_u, horizon=horizon)


def dualize_scenario_device(
    A: torch.Tensor,
    B: torch.Tensor,
    c: torch.Tensor,
    Q: np.ndarray,
    R: np.ndarray,
    u_min: np.ndarray,
    u_max: np.ndarray,
    iterations: int,
    weights=None,
    Q_terminal: Optional[np.ndarray] = None,
    x_min: Optional[np.ndarray] = None,
    x_max: Optional[np.ndarray] = None,
    soft_state: Optional[float] = None,
    preview: bool = False,
    schedule: str = "paper",
    power_iters: int = 64,
    name: str = "scenario_device",
) -> GPADData:
    """Condense and dualize a multi-scenario (robust) LTV stack on the
    device of ``A``, as ``tpu_gpad.device_condense.dualize_scenario_device``:
    the device twin of ``robust.scenario_qp`` composed with
    ``condense``/``dualize``.

    ``A``/``B``/``c`` are per-scenario stacks (S, N, n_x, n_x) / (S, N,
    n_x, n_u) / (S, N, n_x). Decision layout ``z~ = [u_0; v^1; ...; v^S]``
    with per-scenario tails of (N-1) n_u entries; cost and boxes are shared
    across scenarios, ``weights`` are the scenario probabilities (default
    uniform). The stack is born flat (per-scenario state boxes, then the
    identity block over z~). Parameters ``p = [x0; r]``."""
    S, N, n_x = A.shape[0], A.shape[1], A.shape[-1]
    k = scenario_constants(
        S, N, n_x, B.shape[-1], Q, R, u_min, u_max, iterations,
        weights=weights, Q_terminal=Q_terminal, x_min=x_min, x_max=x_max,
        soft_state=soft_state, preview=preview, schedule=schedule,
        power_iters=power_iters, name=name, device=A.device)
    return dualize_scenario(k, A, B, c)
