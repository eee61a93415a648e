"""Non-condensed (stage-wise) GPAD: the paper's O(N) variant, in PyTorch.

The counterpart of ``tpu_gpad.stagewise``. The condensed engines pay two
dense products of O(N^2 n_u n_x) per iteration and O(N^2) operand memory;
here the states stay decision variables and the dual-gradient oracle

    zhat(w) = argmin_z  0.5 z' M z + (f + G' w)' z

is a finite-horizon LQR with stage-wise linear cost perturbations, solved by
one backward affine sweep and one forward rollout per iteration. The
quadratic part of the Riccati recursion is w-independent and precomputed
offline (float64 NumPy, as in ``tpu_gpad``): gains ``K_k``, closed-loop
transitions ``E_k = A_k - B_k K_k`` and inverted input Hessians ``Hi_k``.

Executors behind ``solve_stagewise``:

- ``engine="torch"``: a loop of tensor ops with the batch written out
  (JAX vmaps a ``lax.scan``). Everything that does not depend on the
  previous stage is hoisted out of the two sweeps as one batched product.
  ``scan="sequential"`` runs each sweep one ``addmm`` per stage;
  ``scan="associative"`` (JAX's parallel-prefix sweeps) composes the
  sweep's affine stage maps by doubling, ceil(log2 N) rounds of batched
  products; ``scan="auto"`` takes the latter where JAX does (per-stage
  size n_x + n_u <= 24 below a batch of 1024, a TPU-measured rule);
- ``engine="cuda"``: the resident kernel (``stagewise_kernel``, the
  counterpart of JAX's whole-VMEM Pallas kernel, ``engine="pallas"``);
- ``engine="stream"``: the streamed kernel (``stagewise_stream``) for dual
  state too large for one block's shared memory;
- ``engine="auto"``: on a CUDA device, fixed mode without runtime
  ``q_lin``/``c`` takes a kernel: the streamed one where
  ``stagewise_fits_smem`` admits no tile of the resident one, else
  ``stagewise_kernel.resident_preferred`` decides (the resident one where
  its tile could stage the chains in shared memory and its grid runs in
  one wave or holds 8 scenarios a block; after the H100 timings in
  PERF.md, §6). Everything else (eps mode, runtime parameters,
  ``scan="associative"``, CPU data) runs the torch engine, in the data's
  dtype. The kernels take float32: float64 data on a CUDA device raises
  on a kernel route (float64 solves run with ``device="cpu"``).

``stack_stagewise`` stacks same-shape builds along a leading plant axis P
and ``solve_stagewise_multi`` solves them in one call on the torch engine,
batched over P and each plant's batch with batched products; the kernels
assume constants shared by the batch, so no kernel runs there (JAX vmaps
its XLA executors there). ``solve_stagewise_jit`` has no counterpart:
PyTorch runs eagerly, so there is nothing to trace once.

Internally the engine keeps per-stage tensors stage-major, (N, B, ...), so
each stage is a contiguous (B, ...) slice; the public layouts are those of
``tpu_gpad``: ``y`` (..., N, m_x + m_u) with the state rows first.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tpu_gpad_torch.schedule import momentum_schedule
from tpu_gpad_torch.types import LinearMPCProblem, SolveResult, _move


@dataclass(frozen=True)
class StagewiseData:
    """Offline-precomputed constants for the stage-wise GPAD solver, as
    float32 tensors on one device (fields as ``tpu_gpad.stagewise.
    StagewiseData``).

    Shapes: N = horizon, n = n_x, p = n_u; ``m_x`` state-constraint rows
    per stage (stages 1..N), ``m_u`` input rows per stage (stages 0..N-1).
    The backward recursion for the value-function slope is

        stilde_N = qx_N
        stilde_k = qx_k + E_k' stilde_{k+1} - K_k' ru_k      (k = N-1..1)

    and the forward rollout

        u_k = -K_k x_k - Hi_k (B_k' stilde_{k+1} + ru_k)
        x_{k+1} = A_k x_k + B_k u_k.
    """

    A_seq: torch.Tensor  # (N, n, n)
    B_seq: torch.Tensor  # (N, n, p)
    K: torch.Tensor  # (N, p, n) Riccati gains
    Hi: torch.Tensor  # (N, p, p) inverted input Hessians
    E: torch.Tensor  # (N, n, n) closed-loop transitions A_k - B_k K_k
    Gx: torch.Tensor  # (m_x, n) per-stage state rows, stages 1..N
    hx: torch.Tensor  # (N, m_x)
    Gu: torch.Tensor  # (m_u, p) per-stage input rows, stages 0..N-1
    hu: torch.Tensor  # (N, m_u)
    L: torch.Tensor  # () Lipschitz constant of the dual gradient
    theta: torch.Tensor  # (max_iters,)
    beta: torch.Tensor  # (max_iters,)
    c_seq: torch.Tensor  # (N, n) dynamics offsets c_k
    dtl: torch.Tensor  # (N, n) Ptilde_{k+1} c_k
    qoff: torch.Tensor  # (N, n) E'dtl shift + fixed-reference -Q x_ref
    Pt: torch.Tensor  # (N, n, n) Ptilde_{k+1}
    n_x: int = 0
    n_u: int = 0
    horizon: int = 0
    name: str = "stagewise"

    # m_x, m_u and max_iters read trailing dimensions, so they hold on a
    # stack_stagewise build too, whose every tensor has a leading plant axis
    @property
    def m_x(self) -> int:
        return self.Gx.shape[-2]

    @property
    def m_u(self) -> int:
        return self.Gu.shape[-2]

    @property
    def m(self) -> int:
        """Total inequality rows (== the condensed stack's m)."""
        return self.horizon * (self.m_x + self.m_u)

    @property
    def max_iters(self) -> int:
        return self.theta.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.E.device

    def to(self, device) -> "StagewiseData":
        return _move(self, device)


# Tensor and meta fields of StagewiseData, in tpu_gpad's pytree order
# (convert.py reads them).
STAGEWISE_TENSOR_FIELDS = (
    "A_seq", "B_seq", "K", "Hi", "E", "Gx", "hx", "Gu", "hu", "L", "theta",
    "beta", "c_seq", "dtl", "qoff", "Pt",
)
STAGEWISE_META_FIELDS = ("n_x", "n_u", "horizon", "name")


# ---------------------------------------------------------------------------
# offline part: float64 NumPy, the same algebra as tpu_gpad.stagewise
# ---------------------------------------------------------------------------


def _stage_seq(M, N: int, shape: tuple, name: str) -> np.ndarray:
    """Broadcast a constant or stacked per-stage matrix to (N, *shape)."""
    arr = np.asarray(M, dtype=np.float64)
    if arr.shape == shape:
        return np.broadcast_to(arr, (N, *shape)).copy()
    if arr.shape == (N, *shape):
        return arr.copy()
    raise ValueError(f"{name} must be {shape} or {(N, *shape)}; got {arr.shape}")


def _stage_rhs(v, N: int, q: int, name: str) -> np.ndarray:
    arr = np.asarray(v, dtype=np.float64)
    if arr.shape == (q,):
        return np.tile(arr, (N, 1))
    if arr.shape == (N, q):
        return arr.copy()
    raise ValueError(f"{name} must be ({q},) or ({N}, {q}); got {arr.shape}")


def _constraint_rows(problem: LinearMPCProblem):
    """Per-stage constraint rows (Gx, hx, Gu, hu) in float64: the condensed
    stack's constraint set, expressed stage-locally (rows in another order,
    to which GPAD's iterates are equivariant)."""
    n, p, N = problem.n_x, problem.n_u, problem.horizon
    gx_rows, hx_rows = [], []
    if problem.x_max is not None:
        gx_rows.append(np.eye(n))
        hx_rows.append(_stage_rhs(problem.x_max, N, n, "x_max"))
    if problem.x_min is not None:
        gx_rows.append(-np.eye(n))
        hx_rows.append(-_stage_rhs(problem.x_min, N, n, "x_min"))
    if problem.H_x is not None:
        Hx = np.asarray(problem.H_x, dtype=np.float64)
        gx_rows.append(Hx)
        hx_rows.append(_stage_rhs(problem.h_x, N, Hx.shape[0], "h_x"))
    gu_rows, hu_rows = [], []
    if problem.u_max is not None:
        gu_rows.append(np.eye(p))
        hu_rows.append(_stage_rhs(problem.u_max, N, p, "u_max"))
    if problem.u_min is not None:
        gu_rows.append(-np.eye(p))
        hu_rows.append(-_stage_rhs(problem.u_min, N, p, "u_min"))
    if problem.K_u is not None:
        Ku = np.asarray(problem.K_u, dtype=np.float64)
        zeros = np.zeros((N, Ku.shape[0]))
        gu_rows += [Ku, -Ku]
        hu_rows += [zeros, zeros]
    if problem.H_u is not None:
        Hu = np.asarray(problem.H_u, dtype=np.float64)
        gu_rows.append(Hu)
        hu_rows.append(_stage_rhs(problem.h_u, N, Hu.shape[0], "h_u"))
    Gx = np.concatenate(gx_rows, axis=0) if gx_rows else np.zeros((0, n))
    hx = np.concatenate(hx_rows, axis=1) if hx_rows else np.zeros((N, 0))
    Gu = np.concatenate(gu_rows, axis=0) if gu_rows else np.zeros((0, p))
    hu = np.concatenate(hu_rows, axis=1) if hu_rows else np.zeros((N, 0))
    return Gx, hx, Gu, hu


def _riccati_np(A_seq, B_seq, Q_seq, R_seq, Q_terminal):
    """Backward Riccati sweep (float64): gains K, inverses Hi, closed-loop E
    and the value-function Hessians Pt_seq[k] = Ptilde_{k+1}. ``Q_seq[j]``
    weights stage j+1's state; ``Q_terminal`` replaces stage N's weight."""
    N, n, p = A_seq.shape[0], A_seq.shape[1], B_seq.shape[2]
    K = np.zeros((N, p, n))
    Hi = np.zeros((N, p, p))
    E = np.zeros((N, n, n))
    Pt_seq = np.zeros((N, n, n))
    Pt = (Q_terminal if Q_terminal is not None else Q_seq[N - 1]).copy()
    for k in range(N - 1, -1, -1):
        A, B = A_seq[k], B_seq[k]
        Pt_seq[k] = Pt
        Hk = R_seq[k] + B.T @ Pt @ B
        Hk = 0.5 * (Hk + Hk.T)
        BtPtA = B.T @ Pt @ A
        K[k] = np.linalg.solve(Hk, BtPtA)
        Hi[k] = np.linalg.inv(Hk)
        E[k] = A - B @ K[k]
        P = A.T @ Pt @ A - BtPtA.T @ K[k]
        P = 0.5 * (P + P.T)
        if k > 0:
            Pt = Q_seq[k - 1] + P
    return K, Hi, E, Pt_seq


def _lqr_np(mats, qx, ru, x0):
    """NumPy twin of the online LQR solve (offline use: L estimation)."""
    A, B, K, Hi, E, N = mats
    stilde = np.zeros((N, qx.shape[1]))
    s = qx[N - 1]
    stilde[N - 1] = s
    for k in range(N - 1, 0, -1):
        s = qx[k - 1] + E[k].T @ s - K[k].T @ ru[k]
        stilde[k - 1] = s
    x = x0
    xs = np.zeros((N, x0.shape[0]))
    us = np.zeros((N, K.shape[1]))
    for k in range(N):
        kff = Hi[k] @ (B[k].T @ stilde[k] + ru[k])
        u = -K[k] @ x - kff
        x = A[k] @ x + B[k] @ u
        us[k] = u
        xs[k] = x
    return xs, us


def _cert_L_np(A_seq, B_seq, Gx, Gu, R_seq) -> float:
    """Certified upper bound on lambda_max(G M^-1 G') including the
    prediction-map gain: |Gc|_F^2 / lambda_min(R), with |Gc|_F^2 computed
    exactly by the backward Gramian recursion S_s = Gx'Gx + A_s' S_{s+1} A_s
    (see ``tpu_gpad.stagewise._cert_L_np``)."""
    N = A_seq.shape[0]
    lmin_R = min(float(np.linalg.eigvalsh(Rk)[0]) for Rk in R_seq)
    GtG = Gx.T @ Gx
    S = GtG.copy()  # S_N
    fro2 = 0.0
    for j in range(N - 1, -1, -1):
        fro2 += float(np.trace(B_seq[j].T @ S @ B_seq[j]))  # S == S_{j+1}
        if j > 0:
            S = GtG + A_seq[j].T @ S @ A_seq[j]
    fro2 += N * float((Gu * Gu).sum())
    return fro2 / lmin_R


def _power_lmax_np(mats, Gx, Gu, seed: int = 0, iters: int = 500):
    """lambda_max of the dual Hessian G M^-1 G' by power iteration on the
    matrix-free operator v -> -G lqr(G' v, x0=0). Returns (lmax, rel_res)."""
    A, B, K, Hi, E, N = mats
    rng = np.random.default_rng(seed)
    vx = rng.standard_normal((N, Gx.shape[0]))
    vu = rng.standard_normal((N, Gu.shape[0]))
    lam, res = 0.0, np.inf

    def op(vx, vu):
        xs, us = _lqr_np(mats, vx @ Gx, vu @ Gu, np.zeros(A.shape[1]))
        return -(xs @ Gx.T), -(us @ Gu.T)

    for _ in range(iters):
        nrm = float(np.sqrt((vx * vx).sum() + (vu * vu).sum()))
        if nrm == 0.0:
            return 0.0, 0.0
        vx, vu = vx / nrm, vu / nrm
        wx, wu = op(vx, vu)
        lam = float((vx * wx).sum() + (vu * wu).sum())
        res = float(
            np.sqrt(((wx - lam * vx) ** 2).sum() + ((wu - lam * vu) ** 2).sum())
        )
        if lam > 0 and res / lam < 1e-8:
            break
        vx, vu = wx, wu
    return lam, (res / lam if lam > 0 else np.inf)


def stagewise_compatible(problem: LinearMPCProblem) -> tuple:
    """(ok, reason): can ``build_stagewise`` represent this problem? Rate
    limits couple adjacent stages (a condensation-path feature); a problem
    without inequality rows has no dual."""
    if problem.du_min is not None or problem.du_max is not None:
        return False, "rate limits couple adjacent stages"
    has_rows = any(
        getattr(problem, f) is not None
        for f in ("x_min", "x_max", "u_min", "u_max", "K_u", "H_x", "H_u")
    )
    if not has_rows:
        return False, "no inequality constraints to dualize"
    return True, ""


def condensed_operand_mb(problem: LinearMPCProblem) -> float:
    """Projected fp32 bytes (MB) of the two condensed MVP operands
    ``M_G``/``G_L`` at the full (unpaired-equivalent) stack: the O(N^2)
    memory the stage-wise engine avoids. Closed form, nothing built."""
    N, n, p = problem.horizon, problem.n_x, problem.n_u
    m = 0
    for lo, hi, q in (
        (problem.x_min, problem.x_max, n),
        (problem.u_min, problem.u_max, p),
    ):
        m += q * ((lo is not None) + (hi is not None))
    if problem.K_u is not None:
        m += 2 * np.asarray(problem.K_u).shape[0]
    if problem.H_x is not None:
        m += np.asarray(problem.H_x).shape[0]
    if problem.H_u is not None:
        m += np.asarray(problem.H_u).shape[0]
    return 2 * (N * m) * (N * p) * 4 / 1e6


def build_stagewise(
    problem: LinearMPCProblem,
    iterations: int = 100,
    L: Optional[float] = None,
    schedule: str = "paper",
    x_ref=None,
    dtype=torch.float32,
    device="cuda",
) -> StagewiseData:
    """Precompute the stage-wise GPAD constants (float64 offline, emitted as
    ``dtype`` tensors on ``device``); arguments as ``tpu_gpad.stagewise.
    build_stagewise``.

    Affine dynamics offsets (``problem.c``) and a fixed tracking reference
    ``x_ref`` become per-stage constants (``dtl``, ``qoff``). ``L`` left
    None is estimated by power iteration with a margin scaled by its
    residual; when the iteration does not converge, the certified
    backward-Gramian bound (``_cert_L_np``) is taken."""
    if problem.du_min is not None or problem.du_max is not None:
        raise ValueError(
            "rate limits couple adjacent stages; use the condensation path "
            "(condense + dualize), which augments the parameter with u_prev"
        )
    if (problem.H_x is None) != (problem.h_x is None) or (
        problem.H_u is None
    ) != (problem.h_u is None):
        raise ValueError("H_x/h_x and H_u/h_u must be given together")
    N, n, p = problem.horizon, problem.n_x, problem.n_u
    A_seq = _stage_seq(problem.A, N, (n, n), "A")
    B_seq = _stage_seq(problem.B, N, (n, p), "B")
    Q_seq = _stage_seq(problem.Q, N, (n, n), "Q")
    R_seq = _stage_seq(problem.R, N, (p, p), "R")
    Q_term = (
        np.asarray(problem.Q_terminal, dtype=np.float64)
        if problem.Q_terminal is not None
        else None
    )
    K, Hi, E, Pt_seq = _riccati_np(A_seq, B_seq, Q_seq, R_seq, Q_term)
    Gx, hx, Gu, hu = _constraint_rows(problem)
    if Gx.shape[0] == 0 and Gu.shape[0] == 0:
        raise ValueError("problem has no inequality constraints to dualize")

    if L is None:
        mats = (A_seq, B_seq, K, Hi, E, N)
        lam, rel_res = _power_lmax_np(mats, Gx, Gu)
        if rel_res < 1e-6:
            L = lam * 1.01
        elif rel_res < 1e-3:
            L = lam * 1.1
        else:
            # lam (a Rayleigh quotient) is a lower bound on lambda_max; the
            # certified bound is an upper one
            L = max(1.1 * lam, _cert_L_np(A_seq, B_seq, Gx, Gu, R_seq))
    L = float(L)
    if L <= 0:
        raise ValueError(f"Lipschitz constant must be positive; got {L}")

    c_seq = (
        _stage_rhs(problem.c, N, n, "c")
        if problem.c is not None
        else np.zeros((N, n))
    )
    dtl = np.einsum("kij,kj->ki", Pt_seq, c_seq)  # Ptilde_{k+1} c_k
    ecorr = np.einsum("kji,kj->ki", E, dtl)  # E_k' dtl_k
    qoff = np.zeros((N, n))
    qoff[:-1] += ecorr[1:]  # the backward recursion's shift, folded into qx
    if x_ref is not None:
        ref = _stage_rhs(np.asarray(x_ref, dtype=np.float64), N, n, "x_ref")
        for k in range(N):
            Qk = Q_term if (k == N - 1 and Q_term is not None) else Q_seq[k]
            qoff[k] -= Qk @ ref[k]  # linear term of 0.5||x - r||_Q^2

    theta, beta = momentum_schedule(iterations, variant=schedule)

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return StagewiseData(
        A_seq=t(A_seq), B_seq=t(B_seq), K=t(K), Hi=t(Hi), E=t(E),
        Gx=t(Gx), hx=t(hx), Gu=t(Gu), hu=t(hu),
        L=torch.tensor(L, dtype=dtype, device=device), theta=t(theta), beta=t(beta),
        c_seq=t(c_seq), dtl=t(dtl), qoff=t(qoff), Pt=t(Pt_seq),
        n_x=n, n_u=p, horizon=N, name=f"{problem.name}_stagewise",
    )


# ---------------------------------------------------------------------------
# routing constants, carried unchanged from tpu_gpad.stagewise. Each was
# measured on a TPU (STAGEWISE.json, MHE_STAGEWISE.json); none is measured
# on an H100 yet (PERF.md, Open questions).
# ---------------------------------------------------------------------------

# memory backstop (projected condensed MVP operand MB) above which the
# stage-wise engine is always preferred
AUTO_STAGEWISE_ABOVE_MB = 256.0
# horizon from which the stage-wise engine won at any batch
AUTO_STAGEWISE_HORIZON = 170
# large-batch branch: stage-wise from this horizon when batch >= 24 N
AUTO_STAGEWISE_MIN_HORIZON_BATCHED = 60
# the torch engine's scan="auto": parallel-prefix sweeps for per-stage size
# n_x + n_u at most this, below this batch (tpu_gpad.stagewise.
# solve_stagewise's rule, from the TPU's STAGEWISE.json ladder)
AUTO_ASSOC_MAX_STATE = 24
AUTO_ASSOC_MAX_BATCH = 1024


def stagewise_preferred(
    problem: LinearMPCProblem,
    batch_hint: Optional[int] = None,
    threshold_mb: Optional[float] = None,
) -> tuple:
    """(prefer, reason): should auto routing take the stage-wise engine?

    Stage-wise when (a) the projected condensed operands exceed
    ``threshold_mb`` (default ``AUTO_STAGEWISE_ABOVE_MB``), (b) the horizon
    is at least ``AUTO_STAGEWISE_HORIZON``, or (c) ``batch_hint >= 24 N`` at
    ``N >= AUTO_STAGEWISE_MIN_HORIZON_BATCHED``; (b) and (c) only for
    per-stage size n_x + n_u >= 10. The same rule and constants as
    ``tpu_gpad.stagewise.stagewise_preferred``: TPU crossovers, unmeasured
    on an H100."""
    ok, reason = stagewise_compatible(problem)
    if not ok:
        return False, reason
    lim = AUTO_STAGEWISE_ABOVE_MB if threshold_mb is None else threshold_mb
    mb = condensed_operand_mb(problem)
    if mb > lim:
        return True, f"projected condensed operands {mb:.1f} MB > {lim:g} MB"
    N = problem.horizon
    if problem.n_x + problem.n_u < 10:
        return False, (
            "per-stage state too small for the throughput crossover "
            "(TPU-measured); memory backstop only")
    if N >= AUTO_STAGEWISE_HORIZON:
        return True, (
            f"horizon {N} >= {AUTO_STAGEWISE_HORIZON} (TPU-measured "
            "any-batch crossover)")
    if (
        batch_hint is not None
        and N >= AUTO_STAGEWISE_MIN_HORIZON_BATCHED
        and batch_hint >= 24 * N
    ):
        return True, (
            f"batch {batch_hint} >= 24*N at N={N} (TPU-measured "
            "large-batch crossover)")
    return False, "condensed wins at this (N, batch) on the TPU measurements"


def auto_solver(
    problem: LinearMPCProblem,
    iterations: int = 100,
    threshold_mb: Optional[float] = None,
    batch_hint: Optional[int] = None,
    device="cuda",
    **build_kw,
):
    """Problem-level engine routing: returns ``(solve_fn, data, kind)`` with
    ``kind`` in {"condensed", "stagewise"} and ``solve_fn(x0, config=None,
    **kw)`` calling ``solve_batch`` or ``solve_stagewise``. The rule is
    ``stagewise_preferred``; a stage-wise-only build option (``x_ref``)
    forces the stage-wise route. ``device`` places the data."""
    from tpu_gpad_torch.condense import condense, dualize

    prefer, _reason = stagewise_preferred(
        problem, batch_hint=batch_hint, threshold_mb=threshold_mb
    )
    if "x_ref" in build_kw and not prefer:
        ok, reason = stagewise_compatible(problem)
        if not ok:
            raise ValueError(
                f"x_ref is a stage-wise build option but this problem "
                f"cannot route stage-wise: {reason}")
        prefer = True
    if prefer:
        data = build_stagewise(problem, iterations=iterations, device=device,
                               **build_kw)

        def solve_fn(x0, config=None, **kw):
            return solve_stagewise(data, x0, config=config, **kw)

        return solve_fn, data, "stagewise"
    qp = condense(problem)
    build_kw.setdefault("paired", "auto")
    data = dualize(qp, iterations=iterations, device=device, **build_kw)

    def solve_fn(x0, config=None, **kw):
        from tpu_gpad_torch.solver import solve_batch

        if config is None:
            return solve_batch(data, x0, **kw)
        return solve_batch(data, x0, config=config, **kw)

    return solve_fn, data, "condensed"


# ---------------------------------------------------------------------------
# the torch engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Consts:
    """Per-solve stage constants of the torch engine, stage-major. ``dtl``,
    ``qoff`` and ``c`` are (N, 1, n), or (N, B, n) with runtime q_lin/c.
    On a ``stack_stagewise`` build each stage tensor carries the plant axis
    after the stage axis, (N, P, ...), the rows Gx/Gu (P, m, .), and the
    batch of a stage is (P, B); ``theta``/``beta`` are then (iters, P, 1, 1)
    and ``inv_L`` (P, 1, 1), so that they broadcast against it."""

    A: torch.Tensor
    Gx: torch.Tensor
    Gu: torch.Tensor
    hx: torch.Tensor  # (N, 1, m_x)
    hu: torch.Tensor  # (N, 1, m_u)
    E: torch.Tensor
    ET: torch.Tensor  # (N, n, n) E_k'
    K: torch.Tensor
    KT: torch.Tensor  # (N, n, p) K_k'
    HiT: torch.Tensor  # (N, p, p) Hi_k'
    B: torch.Tensor
    BT: torch.Tensor  # (N, p, n) B_k'
    dtl: torch.Tensor
    qoff: torch.Tensor
    c: torch.Tensor
    inv_L: torch.Tensor
    theta: torch.Tensor  # the momentum schedule, indexed by iteration
    beta: torch.Tensor
    m_x: int
    assoc: bool = False  # the sweeps as parallel prefixes (_lqr_solve_assoc)


def _consts(data: StagewiseData, dtl, qoff, c, assoc: bool = False) -> _Consts:
    """The engine's constants of ``data``, a single build or a stack."""
    tr = lambda a: a.transpose(-1, -2).contiguous()
    if data.E.ndim == 4:  # a stack: (P, N, ...) -> stage-major (N, P, ...)
        sm = lambda a: a.transpose(0, 1).contiguous()
        A, E, K, Hi, B = (sm(a) for a in (data.A_seq, data.E, data.K,
                                            data.Hi, data.B_seq))
        hx, hu = sm(data.hx)[:, :, None], sm(data.hu)[:, :, None]
        inv_L = (1.0 / data.L)[:, None, None]
        theta, beta = (a.T[:, :, None, None] for a in (data.theta, data.beta))
    else:
        A, E, K, Hi, B = data.A_seq, data.E, data.K, data.Hi, data.B_seq
        hx, hu = data.hx[:, None], data.hu[:, None]
        inv_L, theta, beta = 1.0 / data.L, data.theta, data.beta
    return _Consts(
        A=A, Gx=data.Gx, Gu=data.Gu, hx=hx, hu=hu, E=E, ET=tr(E), K=K,
        KT=tr(K), HiT=tr(Hi), B=B, BT=tr(B), dtl=dtl, qoff=qoff, c=c,
        inv_L=inv_L, theta=theta, beta=beta, m_x=data.m_x, assoc=assoc,
    )


def _baddbmm(inp, b1, b2, alpha: float = 1.0):
    """inp + alpha * b1 @ b2, batched over the stage axis, and over the
    plant axis after it on a stack (4-d operands, flattened for one
    ``baddbmm``)."""
    if b1.ndim == 3:
        return torch.baddbmm(inp, b1, b2, alpha=alpha)
    lead = b1.shape[:2]
    out = torch.baddbmm(inp.expand(lead + inp.shape[2:]).flatten(0, 1),
                        b1.flatten(0, 1), b2.flatten(0, 1), alpha=alpha)
    return out.view(lead + out.shape[1:])


def _bmm(b1, b2):
    """b1 @ b2 batched as in ``_baddbmm``."""
    if b1.ndim == 3:
        return torch.bmm(b1, b2)
    out = torch.bmm(b1.flatten(0, 1), b2.flatten(0, 1))
    return out.view(b1.shape[:2] + out.shape[1:])


def _addmm(bias, x, M, out):
    """One stage of a sweep into ``out``: bias + x @ M, with x (B, n) and M
    (n, n), or on a stack x (P, B, n) and M (P, n, n)."""
    return (torch.addmm if x.ndim == 2 else torch.baddbmm)(bias, x, M, out=out)


def _lqr_solve(cs: _Consts, qx, ru, x0):
    """The LQR oracle for linear-cost perturbations ``qx`` (N, B, n)
    (``qoff`` included) and ``ru`` (N, B, p) from ``x0`` (B, n): returns
    states x_1..x_N and inputs u_0..u_{N-1}, (N, B, n) and (N, B, p).

    The two sweeps of ``tpu_gpad.stagewise._lqr_solve``, with every product
    that does not depend on the previous stage hoisted out as one batched
    product: the backward sweep is s_k = a_k + s_{k+1} E_{k+1} with
    a_k = qx_k - ru_{k+1} K_{k+1}, the forward one x_{k+1} = x_k E_k' + d_k
    with d_k = c_k - kff_k B_k' (row vectors), one ``addmm`` per stage."""
    N = qx.shape[0]
    st = torch.empty_like(qx)
    st[N - 1] = qx[N - 1]
    if N > 1:
        a = _baddbmm(qx[:-1], ru[1:], cs.K[1:], alpha=-1.0)
        for k in range(N - 2, -1, -1):
            _addmm(a[k], st[k + 1], cs.E[k + 1], out=st[k])
    # the feedforward sees stilde + Ptilde_{k+1} c_k
    kff = _bmm(_baddbmm(ru, st + cs.dtl, cs.B), cs.HiT)
    d = _baddbmm(cs.c.expand_as(st), kff, cs.BT, alpha=-1.0)
    xs = torch.empty_like(st)
    x = x0
    for k in range(N):
        x = _addmm(d[k], x, cs.ET[k], out=xs[k])
    x_lin = torch.cat([x0[None], xs[:-1]], dim=0)
    us = _baddbmm(kff, x_lin, cs.KT).neg_()
    return xs, us


def _affine_prefix(M, b):
    """Inclusive prefixes of the affine maps v -> v @ M_t + b_t (row
    vectors), t = 0..L-1, ``M`` (L, n, n) shared by the batch and ``b``
    (L, B, n): returns (P, c) with v_t = v_{-1} @ P_t + c_t. Hillis-Steele
    doubling, map t composed after map t - d for d = 1, 2, 4, ...: ceil(log2
    L) rounds of two batched products (JAX's ``associative_scan`` over
    ``_affine_combine`` composes the same maps in another tree)."""
    P, c = M, b
    d = 1
    while d < M.shape[0]:
        c = torch.cat([c[:d], _baddbmm(c[d:], c[:-d], P[d:])])
        P = torch.cat([P[:d], torch.matmul(P[:-d], P[d:])])
        d *= 2
    return P, c


def _lqr_solve_assoc(cs: _Consts, qx, ru, x0):
    """``_lqr_solve`` with both sweeps as parallel prefixes (the torch
    counterpart of ``tpu_gpad.stagewise._lqr_solve_assoc``): the backward
    sweep s_k = a_k + s_{k+1} E_{k+1} read from the tail and the forward
    one x_{k+1} = x_k E_k' + d_k are affine recurrences whose stage maps
    compose associatively, so each takes ceil(log2 N) rounds of batched
    products in place of N dependent steps."""
    N = qx.shape[0]
    st = torch.empty_like(qx)
    st[N - 1] = qx[N - 1]
    if N > 1:
        a = _baddbmm(qx[:-1], ru[1:], cs.K[1:], alpha=-1.0)
        P, c = _affine_prefix(cs.E[1:].flip(0), a.flip(0))
        st[:-1] = (torch.matmul(qx[N - 1], P) + c).flip(0)
    kff = _bmm(_baddbmm(ru, st + cs.dtl, cs.B), cs.HiT)
    d = _baddbmm(cs.c.expand_as(st), kff, cs.BT, alpha=-1.0)
    P, c = _affine_prefix(cs.ET, d)
    xs = torch.matmul(x0, P) + c
    x_lin = torch.cat([x0[None], xs[:-1]], dim=0)
    us = _baddbmm(kff, x_lin, cs.KT).neg_()
    return xs, us


def _oracle(cs: _Consts, w, x0):
    """zhat(w) and the dual gradient g(w) = G zhat - h, stage-major:
    returns (xs, us, g) with g (N, B, m_x + m_u)."""
    qx = torch.matmul(w[..., :cs.m_x], cs.Gx) + cs.qoff
    ru = torch.matmul(w[..., cs.m_x:], cs.Gu)
    xs, us = (_lqr_solve_assoc if cs.assoc else _lqr_solve)(cs, qx, ru, x0)
    return xs, us, _rows(cs, xs, us)


def _rows(cs: _Consts, xs, us):
    """G z - h per stage, (N, B, m_x + m_u), state rows first."""
    # transpose(), not .mT: a loop body that torch.export traces may not
    # read a view of its constants as an input of its own
    gx = torch.matmul(xs, cs.Gx.transpose(-1, -2)) - cs.hx
    gu = torch.matmul(us, cs.Gu.transpose(-1, -2)) - cs.hu
    return torch.cat([gx, gu], dim=-1)


def _max_rows(g):
    """max over every stage row of each scenario: (B,), or (P, B)."""
    return torch.amax(g, dim=(0, -1))


def _restart_reset(th, th_prev, y, y_next, w):
    """O'Donoghue-Candes adaptive restart per scenario (as
    ``tpu_gpad.stagewise._restart_reset``): reset the momentum recursion iff
    (w - y+) . (y+ - y) > 0. Returns (y_prev', th', th_prev')."""
    r = torch.sum((w - y_next) * (y_next - y), dim=(0, -1))
    mask = r > 0.0
    th_next = torch.where(mask, 1.0, th * (torch.sqrt(th * th + 4.0) - th) * 0.5)
    th_prev_next = torch.where(mask, 1.0, th)
    y_prev = torch.where(mask[None, ..., None], y_next, y)
    return y_prev, th_next, th_prev_next


class _State:
    """The loop state of a batch, stage-major; ``batch`` is (B,), or (P, B)
    on a stack."""

    FIELDS = ("y", "y_prev", "zx", "zu", "th", "th_prev")

    def __init__(self, y, N, batch, n, p):
        like = dict(dtype=y.dtype, device=y.device)
        self.y = y
        self.y_prev = y
        self.zx = torch.zeros((N, *batch, n), **like)
        self.zu = torch.zeros((N, *batch, p), **like)
        self.th = torch.ones(batch, **like)
        self.th_prev = torch.ones(batch, **like)

    @classmethod
    def of(cls, values) -> "_State":
        """A state from ``values()``'s tuple (a loop's carry)."""
        st = cls.__new__(cls)
        for f, v in zip(cls.FIELDS, values):
            setattr(st, f, v)
        return st

    def values(self) -> tuple:
        return tuple(getattr(self, f) for f in self.FIELDS)


def _iteration(data, cs, st: _State, x0, theta_k, beta_k, restart: bool):
    """One GPAD iteration of the whole batch, in place on ``st``, at the
    schedule's (theta_k, beta_k) (unused under restart, whose momentum
    ``st`` carries); returns the oracle's (w, xs, us, g) for the eps
    test."""
    if restart:
        th = st.th[None, ..., None]
        b = (st.th * (1.0 / st.th_prev - 1.0))[None, ..., None]
    else:
        th, b = theta_k, beta_k
    w = st.y + b * (st.y - st.y_prev)
    xs, us, g = _oracle(cs, w, x0)
    st.zx = (1.0 - th) * st.zx + th * xs
    st.zu = (1.0 - th) * st.zu + th * us
    y_next = torch.clamp_min(w + cs.inv_L * g, 0.0)
    if restart:
        st.y_prev, st.th, st.th_prev = _restart_reset(
            st.th, st.th_prev, st.y, y_next, w)
    else:
        st.y_prev = st.y
    st.y = y_next
    return w, xs, us, g


def _schedule_at(cs: _Consts, k: int, restart: bool):
    """The schedule's (theta_k, beta_k); none under restart (its budget may
    pass the schedule)."""
    return (None, None) if restart else (cs.theta[k], cs.beta[k])


def _solve_fixed(data, cs, x0, y, n_iters: int, restart: bool):
    """Fixed budget; diagnostics on the averaged primal (zx, zu)."""
    from tpu_gpad_torch.solver.core import _export_scan, _unaliased

    batch = tuple(x0.shape[:-1])
    st = _State(y, data.horizon, batch, data.n_x, data.n_u)
    if torch.compiler.is_exporting():
        def body(carry, x):
            st = _State.of(carry)
            _iteration(data, cs, st, x0, *x, restart)
            return _unaliased(st.values(), carry), []

        st = _State.of(_export_scan(body, st.values(), cs.theta, cs.beta, 0,
                                    n_iters, restart))
    else:
        for k in range(n_iters):
            _iteration(data, cs, st, x0, *_schedule_at(cs, k, restart),
                       restart)
    g = _rows(cs, st.zx, st.zu)
    residual = torch.clamp_min(_max_rows(g), 0.0)
    gap = -torch.sum(st.y * g, dim=(0, -1))
    conv = torch.ones(batch, dtype=torch.bool, device=x0.device)
    iters = torch.full(batch, n_iters, dtype=torch.int32, device=x0.device)
    return st.zu, st.y, iters, residual, gap, conv, st.zu[0]


def _rollout(cs: _Consts, us, x0):
    """States x_1..x_N from inputs ``us`` (N, B, p): x_{k+1} = A_k x_k +
    B_k u_k + c_k, exact (as ``tpu_gpad.stagewise._rollout``)."""
    xs = torch.empty(us.shape[:-1] + (x0.shape[-1],), dtype=us.dtype,
                     device=us.device)
    bu = _baddbmm(cs.c.expand_as(xs), us, cs.BT)
    AT = cs.A.mT
    x = x0
    for k in range(us.shape[0]):
        x = _addmm(bu[k], x, AT[k], out=xs[k])
    return xs


def _solve_eps(data, cs, x0, y, n_iters: int, restart: bool, eps_g: float,
               eps_V: float, check_every: int):
    """Algorithm-1 eps termination (as ``tpu_gpad.stagewise._solve_one_eps``)
    with per-scenario convergence. The test runs every ``check_every``
    iterations and at the budget's end; a scenario that converged stops
    (its state is frozen, as under JAX's vmapped ``while_loop``) and keeps
    the point it converged at. The host learns "all converged" with one
    sync per check and then stops."""
    from tpu_gpad_torch.solver.core import (_export_scan, _export_windows,
                                            _unaliased)

    batch, dev = tuple(x0.shape[:-1]), x0.device
    st = _State(y, data.horizon, batch, data.n_x, data.n_u)
    conv = torch.zeros(batch, dtype=torch.bool, device=dev)
    it = torch.full(batch, n_iters, dtype=torch.int32, device=dev)
    zu_out = torch.zeros_like(st.zu)

    def test(k_now, st, window, w, us, g, conv, it, zu_out):
        """Freeze, in place on ``st``, the scenarios that had converged
        before this window (``window``: the state at its start), then the
        test at iteration ``k_now``: the updated (conv, it, zu_out)."""
        live = ~conv
        for f, old in zip(st.FIELDS, window):
            new = getattr(st, f)
            m = live if new.ndim == live.ndim else live[None, ..., None]
            setattr(st, f, torch.where(m, new, old))
        viol_zhat = _max_rows(g)
        gap = -torch.sum(w * g, dim=(0, -1))
        viol_z = _max_rows(_rows(cs, st.zx, st.zu))
        ok_z = viol_z <= eps_g
        ok = ok_z | ((viol_zhat <= eps_g) & (gap <= eps_V))
        newly = ok & live
        it = torch.where(newly, k_now, it)
        zu_sel = torch.where(ok_z[None, ..., None], st.zu, us)
        zu_out = torch.where(newly[None, ..., None], zu_sel, zu_out)
        return conv | ok, it, zu_out

    if torch.compiler.is_exporting():
        def body(carry, x):
            st = _State.of(carry[:6])
            w, _, us, g = _iteration(data, cs, st, x0, *x, restart)
            return _unaliased((*st.values(), w, us, g), carry), []

        def window(k0, chunk, state):
            start = state[:6]
            y = start[0]
            oracle = (torch.zeros_like(y), torch.zeros_like(start[3]),
                      torch.zeros_like(y))
            carry = _export_scan(body, (*start, *oracle), cs.theta, cs.beta,
                                 k0, chunk, restart)
            st = _State.of(carry[:6])
            out = test(k0 + chunk, st, start, *carry[6:], *state[6:])
            return (*st.values(), *out)

        C = max(min(check_every, n_iters), 1)
        n_full, rem = divmod(n_iters, C)
        state = _export_windows(window, (*st.values(), conv, it, zu_out), 6,
                                n_full, C, rem)
        st, (conv, it, zu_out) = _State.of(state[:6]), state[6:]
    else:
        window = st.values()
        for k in range(n_iters):
            w, xs, us, g = _iteration(data, cs, st, x0,
                                      *_schedule_at(cs, k, restart), restart)
            if not ((k + 1) % check_every == 0 or k + 1 == n_iters):
                continue
            conv, it, zu_out = test(k + 1, st, window, w, us, g, conv, it,
                                    zu_out)
            window = st.values()
            if k + 1 < n_iters and bool(conv.all()):
                break
    zu_f = torch.where(conv[None, ..., None], zu_out, st.zu)
    g = _rows(cs, _rollout(cs, zu_f, x0), zu_f)
    residual = torch.clamp_min(_max_rows(g), 0.0)
    gap = -torch.sum(st.y * g, dim=(0, -1))
    return zu_f, st.y, it, residual, gap, conv, zu_f[0]


def _runtime_consts(data: StagewiseData, B: int, batch_shape, q_lin, c):
    """(dtl, qoff, c) stage-major with runtime ``q_lin``/``c`` folded in
    per scenario, as ``tpu_gpad`` folds them: dtl_k += Ptilde_{k+1} c_k,
    qoff_k += E_{k+1}' dtl_{k+1} + q_lin_k, c_k += c."""
    N, n = data.horizon, data.n_x
    dev, dt = data.device, data.E.dtype

    def bt(a):
        a = torch.as_tensor(a, dtype=dt, device=dev)
        return a.broadcast_to((*batch_shape, N, n)).reshape(B, N, n)

    zeros = torch.zeros((B, N, n), dtype=dt, device=dev)
    ce = bt(c) if c is not None else zeros
    qe = bt(q_lin) if q_lin is not None else zeros
    dtl_e = torch.einsum("kij,bkj->bki", data.Pt, ce)
    qoff_b = data.qoff[None] + qe
    qoff_b[:, :-1] += torch.einsum("kji,bkj->bki", data.E[1:], dtl_e[:, 1:])
    c_b = data.c_seq[None] + ce
    dtl_b = data.dtl[None] + dtl_e
    sm = lambda a: a.transpose(0, 1).contiguous()  # (N, B, n)
    return sm(dtl_b), sm(qoff_b), sm(c_b)


def _kernel_route(data: StagewiseData, B: int, engine: str):
    """"cuda", "stream" or None: the kernel that serves a fixed-mode solve
    without runtime parameters. Forced engines raise where their kernel
    cannot take the data."""
    from tpu_gpad_torch import stagewise_kernel, stagewise_stream

    ok, why = stagewise_kernel.stagewise_kernel_compatible(data)
    ok_st, why_st = stagewise_stream.stagewise_stream_compatible(data)
    if engine in ("cuda", "stream") and data.device.type != "cuda":
        raise ValueError(
            f"engine={engine!r} needs the data on a CUDA device; got "
            f"{data.device} (engine='torch' runs anywhere)")
    if data.device.type == "cuda" and data.E.dtype != torch.float32:
        raise ValueError(
            f"the stagewise kernels take float32 data; got {data.E.dtype} on "
            f"{data.device} (float64 solves run with device='cpu')")
    if engine == "cuda":
        if not ok:
            raise ValueError(f"stagewise kernel cannot take this: {why}")
        return "cuda"
    if engine == "stream":
        if not ok_st:
            raise ValueError(f"stagewise stream kernel cannot take this: {why_st}")
        return "stream"
    if data.device.type != "cuda":
        return None
    if ok and (not ok_st or stagewise_kernel.resident_preferred(
            data, B, stagewise_kernel.sm_count(data.device))):
        return "cuda"
    return "stream" if ok_st else None


def resolve_stagewise_engine(data: StagewiseData, B: int, engine: str = "auto",
                             mode: str = "fixed", runtime: bool = False,
                             scan: str = "auto") -> str:
    """The executor ``solve_stagewise`` runs: "cuda" (resident kernel),
    "stream" (streamed kernel) or "torch"."""
    if engine == "torch" or mode != "fixed" or runtime or scan == "associative":
        return "torch"
    return _kernel_route(data, B, engine) or "torch"


def resolve_scan(data: StagewiseData, B: int, scan: str = "auto") -> str:
    """The torch engine's sweeps: "associative" or "sequential"; "auto"
    takes the parallel prefixes for n_x + n_u <= AUTO_ASSOC_MAX_STATE below
    a batch of AUTO_ASSOC_MAX_BATCH, as ``tpu_gpad`` does (TPU-measured)."""
    if scan != "auto":
        return scan
    small = data.n_x + data.n_u <= AUTO_ASSOC_MAX_STATE
    return "associative" if small and B < AUTO_ASSOC_MAX_BATCH else "sequential"


def _settings(data: StagewiseData, config, iterations, mode, eps_g, eps_V,
              check_every, restart, scan) -> tuple:
    """The solve's settings, a ``SolverConfig``'s where one is given, each
    checked: (iteration budget, mode, eps_g, eps_V, check_every, restart).
    The budget is ``iterations`` or the shipped schedule's length; past it
    only under restart (schedule-free momentum)."""
    if config is not None:
        iterations, mode = config.iterations, config.mode
        eps_g, eps_V = config.eps_g, config.eps_V
        check_every, restart = config.check_every, config.restart
    if scan not in ("auto", "sequential", "associative"):
        raise ValueError(
            f"scan must be 'auto', 'sequential' or 'associative': {scan!r}")
    if mode not in ("fixed", "eps"):
        raise ValueError(f"mode must be 'fixed' or 'eps': {mode!r}")
    n_iters = int(iterations) if iterations is not None else data.max_iters
    if n_iters > data.max_iters and not restart:
        raise ValueError(
            f"asked for {n_iters} iterations but the shipped schedule has "
            f"{data.max_iters}; rebuild with a longer one (or use "
            f"restart=True, whose momentum recursion is schedule-free)"
        )
    return n_iters, mode, eps_g, eps_V, check_every, restart


def solve_stagewise(
    data: StagewiseData,
    x0,
    iterations: Optional[int] = None,
    y0=None,
    scan: str = "auto",
    mode: str = "fixed",
    eps_g: float = 1e-6,
    eps_V: float = 1e-6,
    check_every: int = 10,
    restart: bool = False,
    unroll: int = 1,
    engine: str = "auto",
    config=None,
    q_lin=None,
    c=None,
) -> SolveResult:
    """Solve a batch of MPC QPs by stage-wise GPAD; ``x0`` is (..., n_x).
    Arguments and result as ``tpu_gpad.stagewise.solve_stagewise``.

    ``mode``: "fixed" (the budget) or "eps" (Algorithm-1 exit every
    ``check_every`` iterations). ``restart``: adaptive momentum restart.
    A ``SolverConfig`` as ``config`` supplies iterations/mode/eps_g/eps_V/
    check_every/restart, and its ``engine`` when ``engine`` is "auto".
    ``y0`` warm-starts the dual: broadcastable to (..., N, m_x + m_u).

    ``engine``: "auto" | "torch" | "cuda" (the resident kernel) | "stream"
    (the streamed kernel); see the module docstring for the routing. The
    kernels take fixed mode without runtime parameters on CUDA data;
    forcing one elsewhere raises. ``scan`` picks the torch engine's sweeps:
    "sequential" (one step per stage), "associative" (parallel prefixes;
    it implies the torch engine, and a forced kernel raises) or "auto"
    (``resolve_scan``). ``unroll`` is accepted for parity and has no
    effect.

    ``q_lin`` / ``c`` (broadcastable to (..., N, n_x)) are per-solve runtime
    parameters: a linear state-cost term per stage and an affine dynamics
    offset, composed with the build-time constants."""
    if (config is not None and engine == "auto"
            and config.engine in ("torch", "cuda", "stream")):
        engine = config.engine
    if engine not in ("auto", "torch", "cuda", "stream"):
        raise ValueError(
            f"engine must be 'auto', 'torch', 'cuda' or 'stream': {engine!r}")
    if scan == "associative" and engine in ("cuda", "stream"):
        raise ValueError("stagewise kernels imply sequential scan")
    if data.E.ndim == 4:
        raise ValueError("a stack_stagewise build is solved by "
                         "solve_stagewise_multi")
    n_iters, mode, eps_g, eps_V, check_every, restart = _settings(
        data, config, iterations, mode, eps_g, eps_V, check_every, restart,
        scan)
    dev, dt = data.device, data.E.dtype
    x0 = torch.as_tensor(x0, dtype=dt, device=dev)
    batch_shape = tuple(x0.shape[:-1])
    xb = x0.reshape(-1, data.n_x).contiguous()
    B = xb.shape[0]
    N, m = data.horizon, data.m_x + data.m_u
    if y0 is not None:
        y0 = torch.as_tensor(y0, dtype=dt, device=dev)
        y0 = y0.broadcast_to((*batch_shape, N, m)).reshape(B, N, m)

    has_runtime = q_lin is not None or c is not None
    if engine in ("cuda", "stream") and has_runtime:
        raise ValueError(
            "stagewise kernels do not take runtime q_lin/c parameters; "
            "they ride the torch engine (engine='torch'/'auto')")
    if engine in ("cuda", "stream") and mode != "fixed":
        raise ValueError(
            "stagewise kernels cover mode='fixed' only; eps mode rides the "
            "torch engine (engine='torch'/'auto')")
    route = resolve_stagewise_engine(data, B, engine, mode, has_runtime, scan)
    rs = lambda a: a.reshape(batch_shape + tuple(a.shape[1:]))
    if route in ("cuda", "stream"):
        from tpu_gpad_torch import stagewise_kernel, stagewise_stream

        fn = (stagewise_kernel.solve_stagewise_cuda if route == "cuda"
              else stagewise_stream.solve_stagewise_stream)
        y0k = None if y0 is None else y0.contiguous()
        u0, zu, y, residual, gap = fn(data, xb, iterations=n_iters,
                                      restart=restart, y0=y0k)
        return SolveResult(
            u=rs(u0), z=rs(zu.reshape(B, -1)), y=rs(y),
            iterations=rs(torch.full((B,), n_iters, dtype=torch.int32,
                                     device=dev)),
            residual=rs(residual), gap=rs(gap),
            converged=rs(torch.ones((B,), dtype=torch.bool, device=dev)),
        )

    if has_runtime:
        dtl, qoff, cc = _runtime_consts(data, B, batch_shape, q_lin, c)
    else:
        dtl, qoff, cc = (a[:, None] for a in (data.dtl, data.qoff, data.c_seq))
    cs = _consts(data, dtl, qoff, cc,
                 assoc=resolve_scan(data, B, scan) == "associative")
    y = (torch.zeros((N, B, m), dtype=dt, device=dev) if y0 is None
         else y0.transpose(0, 1).contiguous())
    if mode == "eps":
        out = _solve_eps(data, cs, xb, y, n_iters, restart, eps_g, eps_V,
                         check_every)
    else:
        out = _solve_fixed(data, cs, xb, y, n_iters, restart)
    zu, y, iters, residual, gap, conv, u0 = out
    bm = lambda a: a.transpose(0, 1)  # (N, B, .) -> (B, N, .)
    return SolveResult(
        u=rs(u0), z=rs(bm(zu).reshape(B, -1)), y=rs(bm(y).contiguous()),
        iterations=rs(iters), residual=rs(residual), gap=rs(gap),
        converged=rs(conv),
    )


def stack_stagewise(datas) -> StagewiseData:
    """Stack same-shape ``StagewiseData`` builds along a leading plant axis
    (as ``tpu_gpad.stagewise.stack_stagewise``, the stage-wise twin of
    ``solver.multi.stack_data``): every tensor gains a leading P dimension,
    the Lipschitz constants too; the meta fields are the first build's.
    Consumed by ``solve_stagewise_multi``: plants with different dynamics
    solved in one call."""
    if len(datas) == 0:
        raise ValueError("stack_stagewise needs at least one build")
    d0 = datas[0]
    key = lambda d: (d.n_x, d.n_u, d.horizon, d.m_x, d.m_u, d.max_iters)
    for d in datas[1:]:
        if key(d) != key(d0):
            raise ValueError(
                f"stack_stagewise needs identical shapes: {d.name} "
                f"{key(d)} vs {d0.name} {key(d0)} (n_x, n_u, horizon, m_x, "
                "m_u, max_iters)")
    return dataclasses.replace(d0, **{
        f: torch.stack([getattr(d, f) for d in datas])
        for f in STAGEWISE_TENSOR_FIELDS})


def solve_stagewise_multi(
    data: StagewiseData,
    x0,
    iterations: Optional[int] = None,
    y0=None,
    scan: str = "auto",
    mode: str = "fixed",
    eps_g: float = 1e-6,
    eps_V: float = 1e-6,
    check_every: int = 10,
    restart: bool = False,
    config=None,
) -> SolveResult:
    """Solve P stage-wise problems with different dynamics and costs (one
    ``stack_stagewise`` build) in one call, as
    ``tpu_gpad.stagewise.solve_stagewise_multi``.

    ``x0`` is (P, n_x), one state per plant, or (P, B, n_x) for a batch per
    plant; ``y0`` broadcasts to (P[, B], N, m_x + m_u). The torch engine
    runs over P and the batch with batched products (the kernels assume
    constants shared by the batch); ``scan="auto"`` follows
    ``resolve_scan`` with the per-plant batch. A ``SolverConfig`` as
    ``config`` supplies iterations/mode/eps_g/eps_V/check_every/restart."""
    if data.E.ndim != 4:
        raise ValueError("solve_stagewise_multi takes a stack_stagewise build")
    n_iters, mode, eps_g, eps_V, check_every, restart = _settings(
        data, config, iterations, mode, eps_g, eps_V, check_every, restart,
        scan)
    dev, dt = data.device, data.E.dtype
    x0 = torch.as_tensor(x0, dtype=dt, device=dev)
    P = data.E.shape[0]
    if x0.ndim < 2 or x0.shape[0] != P:
        raise ValueError(
            f"x0 must be (P, n_x) or (P, B, n_x) with P = {P}; got "
            f"{tuple(x0.shape)}")
    inner = tuple(x0.shape[1:-1])
    N, m = data.horizon, data.m_x + data.m_u
    xb = x0.reshape(P, -1, data.n_x)
    B = xb.shape[1]
    if y0 is None:
        y = torch.zeros((N, P, B, m), dtype=dt, device=dev)
    else:
        y0 = torch.as_tensor(y0, dtype=dt, device=dev)
        y0 = y0.broadcast_to((P, *inner, N, m)).reshape(P, B, N, m)
        y = y0.permute(2, 0, 1, 3).contiguous()
    dtl, qoff, c = (a.transpose(0, 1)[:, :, None]
                    for a in (data.dtl, data.qoff, data.c_seq))
    cs = _consts(data, dtl, qoff, c,
                 assoc=resolve_scan(data, B, scan) == "associative")
    if mode == "eps":
        out = _solve_eps(data, cs, xb, y, n_iters, restart, eps_g, eps_V,
                         check_every)
    else:
        out = _solve_fixed(data, cs, xb, y, n_iters, restart)
    zu, y, iters, residual, gap, conv, u0 = out
    pm = lambda a: a.permute(1, 2, 0, 3)  # (N, P, B, .) -> (P, B, N, .)
    rs = lambda a: a.reshape((P, *inner) + tuple(a.shape[2:]))
    return SolveResult(
        u=rs(u0), z=rs(pm(zu).reshape(P, B, -1)), y=rs(pm(y).contiguous()),
        iterations=rs(iters), residual=rs(residual), gap=rs(gap),
        converged=rs(conv),
    )


class StagewiseController:
    """Stateful long-horizon MPC controller on the stage-wise engine: build
    once, then ``step(x) -> u`` with dual warm starts (as
    ``tpu_gpad.stagewise.StagewiseController``).

    ``step`` accepts one state (n_x,) or a batch (B, n_x) of plants and
    returns the first move(s) as float32 NumPy; on a CUDA device each
    fixed-budget step is one kernel launch. A change of batch shape drops
    the warm start, as does ``reset()``."""

    def __init__(
        self,
        problem: LinearMPCProblem,
        iterations: int = 100,
        config=None,
        warm_start: bool = True,
        L: Optional[float] = None,
        schedule: str = "paper",
        device="cuda",
    ):
        from tpu_gpad_torch.solver import SolverConfig

        if config is None:
            config = SolverConfig(iterations=iterations)
        if config.iterations is None:
            config = dataclasses.replace(config, iterations=iterations)
        self.problem = problem
        self.data = build_stagewise(problem, iterations=config.iterations, L=L,
                                    schedule=schedule, device=device)
        self.config = config
        self.warm_start = warm_start
        self._y = None
        self.last_result = None

    def reset(self) -> None:
        self._y = None

    def step(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        single = x.ndim == 1
        xb = x[None, :] if single else x
        y0 = self._y if self.warm_start else None
        if y0 is not None and tuple(y0.shape[: xb.ndim - 1]) != xb.shape[:-1]:
            y0 = None  # batch shape changed: the stored dual no longer applies
            self._y = None
        res = solve_stagewise(self.data, xb, y0=y0, config=self.config)
        if self.warm_start:
            self._y = res.y
        self.last_result = res
        u = res.u.cpu().numpy().astype(np.float32)
        return u[0] if single else u
