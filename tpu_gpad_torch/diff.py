"""Implicit differentiation through the GPAD solve (MPC as a layer), the
counterpart of ``tpu_gpad.diff``.

Differentiate the solver's fixed point instead of unrolling its
iterations: the backward pass is one masked KKT solve. At the solution of

    min_z 0.5 z'Hz + (F'p + g)'z   s.t.  G z <= b0 + E p

with active set A = {i : y*_i > 0}, eliminating dz gives a dual-space
system in the scaled operands the solver already stores:

    (M Dh M + diag(damp * m) + (I - M)) dy = M r dp

with Dh = ``data.D`` (or ``MG_T @ GL_T``), damp = ``data.soft_damp`` and
the rhs map r(+rows) = (pD_map[+] - gP_map @ GL_T)', r(-rows) =
(-pD_map[-] - gP_map @ GL_T)'; then dz = -MG_T' dy - gP_map' dp. In the
paired [P; -P] layout the system lives on the half stack (at most one side
of a pair is active, or both for an equality pair). It is symmetric, so
the vector-Jacobian product reuses it verbatim.

The forward passes are the production solves (``solve_batch``,
``solve_stagewise``: the card's kernels where they serve the case); the
backward passes are plain products, a batched Cholesky or conjugate
gradients, on the device of the data, with TF32 held off. Each
differentiable solver is a ``torch.autograd.Function``.

Caveats, as in the JAX package: derivatives assume a converged solve and a
strict active set (weakly active rows below ``tol`` count as inactive: the
one-sided derivative from the interior); LICQ-degenerate active sets make
the system singular (``ridge > 0`` regularizes it; Cholesky gives NaN for
a scenario whose system is not positive definite, as JAX's does).
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_gpad_torch.solver import core as _core
from tpu_gpad_torch.solver.core import tf32_matmuls
from tpu_gpad_torch.types import GPAD_TENSOR_FIELDS, GPADData

# method="auto": JAX takes CG on a TPU (batched factorizations measured
# 85-178x its forward there) and Cholesky on other backends. On an H100
# the batched Cholesky won while the (B, S, S) systems it factors held
# fewer than 2^26 elements (256 MB: B1024 up to m_h 210, B4096 at m_h 70)
# and CG from there (B1024 from m_h 280, B4096 from m_h 140), the forward
# and backward of 0.5 |u*|^2 timed in turns (chip_smoke.py diff_timing,
# PERF.md section 5). A routing constant (ROADMAP Queue 1, item 8).
AUTO_CG_MIN_SYSTEM = 1 << 26

# CG iterations run by the masked solves since the caller last set it to 0
# (condensed and stage-wise alike); chip_smoke.py reads it.
CG_ITERATIONS = 0

# the CG exit: a 1e-10 squared relative residual (a 1e-5 reduction). fp32
# CG stagnates below that and can then diverge: tpu_gpad measured a 1e-14
# exit giving 4e5-magnitude gradients at large active sets on its chip
CG_RTOL2 = 1e-10


def _dual_hessian(data: GPADData) -> torch.Tensor:
    """Scaled dual Hessian G H^-1 G'/L on the stored (half-)stack."""
    if data.D is not None:
        return data.D
    return data.MG_T @ data.GL_T


def _rhs_maps(data: GPADData):
    """(r_plus, r_minus) rhs maps, each (S, n_p); r_minus is None dense."""
    cross = (data.gP_map @ data.GL_T).mT
    if data.paired:
        return (data.pD_map[:, 0, :].mT - cross,
                -data.pD_map[:, 1, :].mT - cross)
    return data.pD_map.mT - cross, None


def _cg(mv, rhs, dims, cap: int):
    """Conjugate gradients on the SPD operator ``mv`` for ``rhs``, each
    system reduced over ``dims``, every system stepped until none has a
    squared relative residual above CG_RTOL2 or ``cap`` iterations ran
    (one host sync an iteration for the test)."""
    global CG_ITERATIONS
    X = torch.zeros_like(rhs)
    R, P = rhs, rhs
    rs = torch.sum(R * R, dim=dims, keepdim=True)
    tol2 = CG_RTOL2 * torch.clamp_min(rs, 1e-30)
    i = 0
    while i < cap and bool(torch.any(rs > tol2)):
        Ap = mv(P)
        alpha = rs / (torch.sum(P * Ap, dim=dims, keepdim=True) + 1e-30)
        X = X + alpha * P
        R = R - alpha * Ap
        rs_new = torch.sum(R * R, dim=dims, keepdim=True)
        P = R + (rs_new / (rs + 1e-30)) * P
        rs = rs_new
        i += 1
    CG_ITERATIONS += i
    return X


def resolve_method(data: GPADData, batch: int, method: str = "auto") -> str:
    """The backward's linear solver for ``batch`` masked systems: "chol" or
    "cg" as asked, or for "auto" by the size of the systems Cholesky would
    factor (AUTO_CG_MIN_SYSTEM)."""
    if method == "auto":
        S = data.MG_T.shape[0]
        return "cg" if batch * S * S >= AUTO_CG_MIN_SYSTEM else "chol"
    if method not in ("chol", "cg"):
        raise ValueError(f"unknown method: {method!r}")
    return method


def _solve_masked_system(data: GPADData, m_b, ridge: float, Bmat,
                         method: str = "auto"):
    """Batched solve of the masked KKT system (SPD by construction: masked
    PSD dual Hessian, identity on inactive rows, nonnegative soft and ridge
    diagonal) for ``Bmat`` (..., S, K).

    ``"chol"``: the (..., S, S) systems by a batched Cholesky factor.
    ``"cg"``: matrix-free conjugate gradients against the shared (S, S)
    dual Hessian, capped at S + 8 iterations."""
    method = resolve_method(data, m_b[..., 0].numel(), method)
    Dh = _dual_hessian(data)
    diag = (1.0 - m_b) + ridge * m_b
    if data.soft_damp is not None:
        diag = diag + data.soft_damp * m_b
    if method == "chol":
        A = (m_b[..., :, None] * Dh * m_b[..., None, :]
             + torch.diag_embed(diag))
        chol, info = torch.linalg.cholesky_ex(A)
        chol = torch.where((info == 0)[..., None, None], chol,
                           torch.full_like(chol, float("nan")))
        return torch.cholesky_solve(Bmat, chol)
    mb, dg = m_b[..., None], diag[..., None]
    return _cg(lambda X: mb * torch.matmul(Dh, mb * X) + dg * X, Bmat,
               dims=-2, cap=Dh.shape[0] + 8)


def active_signs(data: GPADData, y, tol: float = 1e-7):
    """Active-set mask (m_b, plus) from the converged dual.

    Paired y (..., 2, m_h): ``m_b`` is 1.0 where either side's dual exceeds
    ``tol``, and ``plus`` selects which side's rhs map applies (the plus
    side where both are active: an equality-encoded pair, whose two maps
    coincide). Dense y (..., m): a 0/1 mask, ``plus`` None."""
    if data.paired:
        sp = y[..., 0, :] > tol
        sm = y[..., 1, :] > tol
        return (sp | sm).to(torch.float32), sp | ~sm
    return (y > tol).to(torch.float32), None


def _masked_rhs_map(data: GPADData, m_b, plus):
    """Per-scenario rhs map (..., S, n_p): side-selected, mask-zeroed."""
    r_plus, r_minus = _rhs_maps(data)
    if data.paired:
        return m_b[..., None] * torch.where(plus[..., None], r_plus, r_minus)
    return m_b[..., None] * r_plus


def sensitivity(data: GPADData, y, tol: float = 1e-7, ridge: float = 0.0,
                method: str = "auto"):
    """Exact local solution sensitivities at a converged solve, as
    ``tpu_gpad.diff.sensitivity``.

    ``y`` is the converged dual (``SolveResult.y``, a tensor or an array).
    Returns ``(K_u, K_z)``: ``K_u`` (B, n_u, n_p) = du*/dp (for p = x0 the
    local MPC feedback gain of the active region) and ``K_z`` (B, n_z,
    n_p); without the batch axis for a single dual."""
    y = torch.as_tensor(y, dtype=torch.float32, device=data.device)
    single = y.ndim == (2 if data.paired else 1)
    if single:
        y = y[None]
    m_b, plus = active_signs(data, y, tol)
    with tf32_matmuls(False):
        R = _masked_rhs_map(data, m_b, plus)
        dY = _solve_masked_system(data, m_b, ridge, R, method)
        K_z = -torch.einsum("sz,bsp->bzp", data.MG_T, dY) - data.gP_map.mT
    K_u = K_z[:, :data.n_u]
    if single:
        return K_u[0], K_z[0]
    return K_u, K_z


def feedback_gain(data: GPADData, result, tol: float = 1e-7,
                  ridge: float = 0.0, method: str = "auto"):
    """Local feedback gain du*/dp at a converged ``SolveResult``."""
    return sensitivity(data, result.y, tol=tol, ridge=ridge,
                       method=method)[0]


def _pad_cotangent(z_bar, n_z: int):
    """z_bar (..., n_keep) zero-padded to the whole trajectory (..., n_z)."""
    full = torch.zeros(z_bar.shape[:-1] + (n_z,), dtype=torch.float32,
                       device=z_bar.device)
    full[..., :z_bar.shape[-1]] = z_bar
    return full


@dataclasses.dataclass
class _Settings:
    """What a differentiable solver fixes when it is made; ``cs`` and
    ``cg_iters`` are the stage-wise adjoint's zeroed constants and CG cap."""

    config: _core.SolverConfig
    tol: float
    ridge: float
    full: bool
    method: str | None = None
    cs: object = None
    cg_iters: int | None = None


class _ParamSolve(torch.autograd.Function):
    """p -> u*(p) (or z*) for fixed data: the production solve forward, the
    masked KKT adjoint backward."""

    @staticmethod
    def forward(ctx, p, data, s):
        res = _core.solve_batch(data, p, config=s.config)
        m_b, plus = active_signs(data, res.y, s.tol)
        ctx.save_for_backward(m_b, plus)
        ctx.data, ctx.s = data, s
        return res.z if s.full else res.u

    @staticmethod
    def backward(ctx, z_bar):
        m_b, plus = ctx.saved_tensors
        data, s = ctx.data, ctx.s
        z_bar_full = _pad_cotangent(z_bar, data.n_z)
        with tf32_matmuls(False):
            R = _masked_rhs_map(data, m_b, plus)  # (..., S, n_p)
            t = z_bar_full @ data.MG_T.mT  # (..., S)
            w = _solve_masked_system(data, m_b, s.ridge, t[..., None],
                                     s.method)[..., 0]
            p_bar = (-torch.einsum("...sp,...s->...p", R, w)
                     - z_bar_full @ data.gP_map.mT)
        return p_bar, None, None


def make_differentiable_solver(
    data: GPADData,
    config: "_core.SolverConfig | None" = None,
    tol: float = 1e-7,
    ridge: float = 0.0,
    full_trajectory: bool = False,
    method: str = "auto",
):
    """A p -> u*(p) function differentiable through the solver, as
    ``tpu_gpad.diff.make_differentiable_solver``.

    Forward: ``solve_batch(data, p, config)`` with the production routing
    (on the card, its kernels). Backward: one batched masked solve against
    the same symmetric system, never unrolling iterations. Gradients flow
    to ``p`` (of any leading batch shape) only; ``data`` is a constant (for
    gradients to the data, see ``make_data_differentiable_solver``).
    ``full_trajectory=True`` returns the whole z* (..., n_z). Converge the
    forward solve (restart, a generous budget) before trusting gradients."""
    s = _Settings(config or _core.SolverConfig(), tol, ridge, full_trajectory,
                  method)

    def solve_u(p):
        p = torch.as_tensor(p, dtype=torch.float32, device=data.device)
        return _ParamSolve.apply(p, data, s)

    return solve_u


class _DataSolve(torch.autograd.Function):
    """(data, p) -> u*: the cotangents of p and of every data leaf that the
    fixed point depends on (``GPAD_TENSOR_FIELDS`` order after p)."""

    @staticmethod
    def forward(ctx, s, data, p, *fields):
        data = dataclasses.replace(data, **dict(zip(GPAD_TENSOR_FIELDS,
                                                    fields)))
        res = _core.solve_batch(data, p, config=s.config)
        m_b, plus = active_signs(data, res.y, s.tol)
        y_eff = res.y[..., 0, :] - res.y[..., 1, :] if data.paired else res.y
        ctx.save_for_backward(p, m_b, plus, y_eff, res.z, *fields)
        ctx.data, ctx.s = data, s
        return res.z if s.full else res.u

    @staticmethod
    def backward(ctx, z_bar):
        p, m_b, plus, y_eff, z_star, *fields = ctx.saved_tensors
        s = ctx.s
        data = dataclasses.replace(ctx.data, **dict(zip(GPAD_TENSOR_FIELDS,
                                                        fields)))
        # flatten any leading batch shape to one axis b
        p_shape, S, n_z = p.shape, m_b.shape[-1], data.n_z
        p = p.reshape(-1, p_shape[-1])
        z_bar_full = _pad_cotangent(z_bar, n_z).reshape(-1, n_z)
        m_b = m_b.reshape(-1, S)
        plus = None if plus is None else plus.reshape(-1, S)
        y_eff = y_eff.reshape(-1, S)
        z_star = z_star.reshape(-1, n_z)
        with tf32_matmuls(False):
            t = z_bar_full @ data.MG_T.mT
            w = m_b * _solve_masked_system(data, m_b, s.ridge, t[..., None],
                                           s.method)[..., 0]
            gP_bar = w @ data.GL_T.mT - z_bar_full  # g_P's cotangent
            MG_bar = y_eff.mT @ gP_bar
            GL_bar = -(z_star.mT @ w)
            gPm_bar = p.mT @ gP_bar
            gPc_bar = gP_bar.sum(dim=0)
            p_bar = gP_bar @ data.gP_map.mT
            if data.paired:
                zero = torch.zeros_like(w)
                w_plus = torch.where(plus, -w, zero)  # s = +pD_plus rows
                w_minus = torch.where(plus, zero, w)  # s = -pD_minus rows
                pDm_bar = torch.stack([p.mT @ w_plus, p.mT @ w_minus], dim=1)
                pDc_bar = torch.stack([w_plus.sum(dim=0), w_minus.sum(dim=0)])
                p_bar = (p_bar + w_plus @ data.pD_map[:, 0].mT
                         + w_minus @ data.pD_map[:, 1].mT)
            else:
                pDm_bar = -(p.mT @ w)
                pDc_bar = -w.sum(dim=0)
                p_bar = p_bar - w @ data.pD_map.mT
            damp_bar = (None if data.soft_damp is None
                        else (w * y_eff).sum(dim=0))
        # theta, beta, L and D get no cotangent by design: the fixed point
        # does not depend on the schedule, a common rescaling by L cancels
        # between GL_T, pD_map and soft_damp, and D == MG_T @ GL_T repeats
        # what the MG_T and GL_T cotangents carry
        grads = dict(MG_T=MG_bar, GL_T=GL_bar, gP_map=gPm_bar,
                     gP_const=gPc_bar, pD_map=pDm_bar, pD_const=pDc_bar,
                     soft_damp=damp_bar)
        return (None, None, p_bar.reshape(p_shape),
                *(grads.get(f) for f in GPAD_TENSOR_FIELDS))


def make_data_differentiable_solver(
    config: "_core.SolverConfig | None" = None,
    tol: float = 1e-7,
    ridge: float = 0.0,
    full_trajectory: bool = False,
    method: str = "auto",
):
    """A (data, p) -> u*(data, p) function differentiable in both, as
    ``tpu_gpad.diff.make_data_differentiable_solver``.

    The implicit-function theorem at the solver's fixed point, written in
    the stored operands: with the adjoint solve w of the same masked
    system,

        gbar_P   = GL_T @ w_masked - z_bar
        MG_T_bar = outer(y, gbar_P);   GL_T_bar = -outer(z*, w_masked)
        pD_bar   = -/+ w_masked on the active side's rows
        damp_bar = w_masked * y   (soft rows)

    ``theta``, ``beta``, ``L`` and ``D`` get none (see ``_DataSolve``).
    Chained after ``device_condense.dualize_ltv_device`` with tensor cost
    weights, ``backward`` reaches the weights and the model matrices
    (learning MPC through the controller)."""
    s = _Settings(config or _core.SolverConfig(), tol, ridge, full_trajectory,
                  method)

    def solve_u(data: GPADData, p):
        p = torch.as_tensor(p, dtype=torch.float32, device=data.device)
        return _DataSolve.apply(s, data, p, *(getattr(data, f)
                                             for f in GPAD_TENSOR_FIELDS))

    return solve_u


# ---------------------------------------------------------------------------
# The stage-wise engine: the same KKT adjoint without condensed operands.
# The masked system only needs two linear maps, and the stage-wise LQR
# oracle is both: Hd v = G H^-1 G' v is one LQR solve from x0 = 0 with
# zeroed affine constants, then the stage-local rows; the x0 map is the
# zeroed closed-loop rollout, transposed by hand (_sw_x0_vjp). Nothing
# O(N^2) is built, so this differentiates past the condensation wall.
# ---------------------------------------------------------------------------


def _sw_zeroed(data):
    """The torch engine's stage constants with dtl, qoff and c zeroed: the
    linear maps v -> -H^-1 G' v and x0 -> the closed-loop rollout."""
    from tpu_gpad_torch.stagewise import _consts

    zero = torch.zeros((data.horizon, 1, data.n_x), dtype=data.E.dtype,
                       device=data.device)
    return _consts(data, zero, zero, zero)


def _sw_gz(cs, xs, us):
    """Stage-local constraint rows G zeta (no -h), (N, B, m_x + m_u)."""
    return torch.cat([xs @ cs.Gx.mT, us @ cs.Gu.mT], dim=-1)


def _sw_lqr(cs, qx, ru):
    """The LQR oracle from x0 = 0 for the stage-major (N, B, .) costs."""
    from tpu_gpad_torch.stagewise import _lqr_solve

    x0 = torch.zeros(qx.shape[1:], dtype=qx.dtype, device=qx.device)
    return _lqr_solve(cs, qx, ru, x0)


def _sw_apply_GHiG(cs, v):
    """G H^-1 G' v for the stage-packed duals v (N, B, m_x + m_u)."""
    xs, us = _sw_lqr(cs, v[..., :cs.m_x] @ cs.Gx, v[..., cs.m_x:] @ cs.Gu)
    return -_sw_gz(cs, xs, us)  # zeta = -H^-1 G'v, so G zeta = -Hd v


def _sw_masked_cg(cs, m_b, ridge: float, rhs, cg_iters: int):
    """Batched matrix-free CG on (M Hd M + (I - M) + ridge M) w = rhs, each
    (N, B, m) stage-major, one LQR solve of the whole batch an iteration;
    the same exit as the condensed CG (CG_RTOL2), capped at ``cg_iters``."""

    def mv(v):
        vm = m_b * v
        return m_b * _sw_apply_GHiG(cs, vm) + (1.0 - m_b) * v + ridge * vm

    return _cg(mv, rhs, dims=(0, -1), cap=cg_iters)


def _sw_x0_vjp(cs, cot_x, cot_u):
    """The transpose of the zeroed closed loop x0 -> (x_1..x_N, u_0..u_{N-1})
    at the cotangents ``cot_x`` (N, B, n) and ``cot_u`` (N, B, p): with kff
    = 0 the rollout is x_{k+1} = x_k E_k' and u_k = -x_k K_k' (row
    vectors), so the cotangent of x_k is a_k = cot_x_{k-1} - cot_u_k K_k +
    a_{k+1} E_k, one backward sweep from a_N = cot_x_{N-1}."""
    N = cot_x.shape[0]
    a = cot_x[N - 1]
    if N > 1:
        b = torch.baddbmm(cot_x[:-1], cot_u[1:], cs.K[1:], alpha=-1.0)
        for k in range(N - 1, 0, -1):
            a = torch.addmm(b[k - 1], a, cs.E[k])
    return a @ cs.E[0] - cot_u[0] @ cs.K[0]


def _sw_vjp(data, cs, m_b, z_bar, ridge: float, full: bool, cg_iters: int):
    """x0's cotangent (B, n_x) for the first-move (B, n_u) or, with
    ``full``, whole-trajectory (B, N n_u) cotangent ``z_bar``, at the
    active mask ``m_b`` (B, N, m)."""
    N, n_u, mx = data.horizon, data.n_u, data.m_x
    B = z_bar.shape[0]
    if full:
        ru_bar = z_bar.reshape(B, N, n_u).transpose(0, 1)
    else:
        ru_bar = torch.zeros((N, B, n_u), dtype=z_bar.dtype,
                             device=z_bar.device)
        ru_bar[0] = z_bar
    mb = m_b.transpose(0, 1)
    with tf32_matmuls(False):
        # t = (dzhat/dw)' zbar = G(-H^-1 zbar): one linear LQR solve
        zero_q = torch.zeros((N, B, data.n_x), dtype=ru_bar.dtype,
                             device=ru_bar.device)
        t = _sw_gz(cs, *_sw_lqr(cs, zero_q, ru_bar))
        w = mb * _sw_masked_cg(cs, mb, ridge, mb * t, cg_iters)
        # the active rows' condition (-Hd y + G zeta_x0 + const)_A = 0
        # gives dy = +Msys^-1 M G zeta_x0(dx): the correction enters
        # positive, x rows Gx' w_x, u rows zbar + Gu' w_u
        return _sw_x0_vjp(cs, w[..., :mx] @ cs.Gx,
                          ru_bar + w[..., mx:] @ cs.Gu)


class _StagewiseSolve(torch.autograd.Function):
    """x0 -> u*(x0) through ``solve_stagewise``: the stage-wise adjoint."""

    @staticmethod
    def forward(ctx, x0, data, s):
        from tpu_gpad_torch.stagewise import solve_stagewise

        res = solve_stagewise(data, x0, config=s.config)
        ctx.save_for_backward((res.y > s.tol).to(res.y.dtype))
        ctx.data, ctx.s = data, s
        return res.z if s.full else res.u

    @staticmethod
    def backward(ctx, z_bar):
        (m_b,) = ctx.saved_tensors
        data, s = ctx.data, ctx.s
        lead = z_bar.shape[:-1]
        x_bar = _sw_vjp(data, s.cs, m_b.reshape((-1,) + m_b.shape[-2:]),
                        z_bar.reshape(-1, z_bar.shape[-1]), s.ridge, s.full,
                        s.cg_iters)
        return x_bar.reshape(*lead, data.n_x), None, None


def _sw_settings(data, config, tol, ridge, full_trajectory, cg_iters):
    # the active set holds at most n_z rows under LICQ, which bounds the
    # Krylov dimension
    return _Settings(config or _core.SolverConfig(), tol, ridge,
                     full_trajectory, cs=_sw_zeroed(data),
                     cg_iters=(cg_iters if cg_iters is not None
                               else data.horizon * data.n_u + 40))


def make_differentiable_stagewise_solver(
    data,
    config=None,
    tol: float = 1e-7,
    ridge: float = 0.0,
    full_trajectory: bool = False,
    cg_iters: "int | None" = None,
):
    """A x0 -> u*(x0) function differentiable through the stage-wise solve,
    as ``tpu_gpad.diff.make_differentiable_stagewise_solver``.

    Forward: ``solve_stagewise`` with ``config`` (on the card, the resident
    or streamed kernel). Backward: the implicit KKT adjoint in stage-packed
    dual space, every operator applied matrix-free through the LQR oracle,
    CG capped at ``cg_iters`` (default N n_u + 40). ``full_trajectory``
    returns the whole input trajectory (B, N n_u)."""
    s = _sw_settings(data, config, tol, ridge, full_trajectory, cg_iters)

    def solve_u(x0):
        x0 = torch.as_tensor(x0, dtype=data.E.dtype, device=data.device)
        return _StagewiseSolve.apply(x0, data, s)

    return solve_u


def stagewise_feedback_gain(data, x0, config=None, tol: float = 1e-7,
                            ridge: float = 0.0, cg_iters=None):
    """Local MPC feedback gain du*/dx0 on the stage-wise engine, (n_u, n_x)
    for one state, (B, n_u, n_x) for a batch: one forward solve, then the
    n_u rows of every scenario's gain as one batched VJP of one-hot
    cotangents (the VJP is linear in them)."""
    from tpu_gpad_torch.stagewise import solve_stagewise

    s = _sw_settings(data, config, tol, ridge, False, cg_iters)
    x0 = torch.as_tensor(x0, dtype=data.E.dtype, device=data.device)
    single = x0.ndim == 1
    xb = torch.atleast_2d(x0)
    B, n_u = xb.shape[0], data.n_u
    res = solve_stagewise(data, xb, config=s.config)
    m_b = (res.y > tol).to(res.y.dtype)  # (B, N, m)
    eye = torch.eye(n_u, dtype=xb.dtype, device=xb.device)
    z_bar = eye[:, None, :].expand(n_u, B, n_u).reshape(n_u * B, n_u)
    m_rep = m_b.expand((n_u,) + m_b.shape).reshape((n_u * B,) + m_b.shape[1:])
    rows = _sw_vjp(data, s.cs, m_rep, z_bar, ridge, False, s.cg_iters)
    K = rows.reshape(n_u, B, data.n_x).transpose(0, 1)
    return K[0] if single else K
