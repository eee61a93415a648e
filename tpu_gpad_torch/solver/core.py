"""GPAD solver in PyTorch (the online layer): fixed-budget and eps modes.

The counterpart of ``tpu_gpad.solver.core``. The JAX package traces the
iteration into one ``lax.fori_loop`` (``lax.while_loop`` in eps mode);
here the loop is a Python loop of tensor ops (``engine="torch"``, the XLA
engine's counterpart) or hand-written CUDA kernels (``engine="cuda"``, the
Pallas engine's counterpart, ``solver/kernels.py`` and
``solver/dual_kernels.py``).

Routing (``engine="auto"``) keys on the device of the data tensors. On a
CUDA device: fixed flat paired mvp solves launch the flat kernel; other
fixed paired mvp solves (``form="mvp"``, ``flat="off"``, or no identity
block) the full paired kernel; fixed dense (unpaired) solves without soft
rows the dense kernel; fixed dual-form solves (restart, ``form="dual"``,
``flat="off"``) the dual kernel; eps solves in the dual form the chunked
dual kernel, one launch per check window. Each only where its state fits
one block's shared memory. Past it (the reference's 30x30 flagship),
dual-form solves read D from device memory in the tiled dual kernels,
fixed or one eps window at a time (eps only with ``flat="off"`` or a
forced ``engine="cuda"``), a fixed flat solve (the default at the
flagship) reads its operands so in the flat tiled kernel, the full paired
loop in the same kernel at every row, and a dense solve in the tiled
dense kernel (each under ``auto`` below its work edge,
``kernels.tiled_auto``). Soft (dual-damped) rows ride every
paired and dual kernel, resident or tiled, as the JAX package's resident
kernels carry them; only the dense layout, which has none, refuses them.
Everything else (flat-on eps past shared memory, unpaired restart or
eps, the tiled flat, paired and dense routes past their work edge under
``auto``) runs the torch engine, as the JAX package sends what its
kernels do not serve to XLA.

Eps mode (Algorithm 1) checks the stopping test every ``check_every``
iterations and once more at a budget that is not a multiple of it; the
loop stops when every scenario has converged, which the host learns with
one sync per check.

Sharded solves (``tpu_gpad_torch.parallel``) run this module on each
rank's rows and dual slice. ``SolverConfig.model_axis`` and
``collective_axes`` stay mesh axis names, as in the JAX package, where
``lax.psum`` resolves them inside ``shard_map``: ``bind_axes`` binds each
name to its process group while the sharded solve runs, and the
reductions here look the name up (``_all_reduce``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from dataclasses import dataclass

import torch

from tpu_gpad_torch.types import GPADData, SolveResult


@dataclass(frozen=True)
class SolverConfig:
    """Runtime solver configuration; the same fields as
    ``tpu_gpad.solver.SolverConfig``.

    ``engine``: "auto" | "torch" | "cuda". "auto" launches a CUDA kernel
    when the data lives on a CUDA device and a kernel serves the case (see
    the module docstring) and runs the torch loop otherwise. Forcing
    "cuda" where no kernel serves the case, or on CPU tensors, raises.

    ``restart``: O'Donoghue-Candes adaptive restart, per scenario; theta
    and beta are computed on the fly, so the budget may exceed the shipped
    schedule.

    ``model_axis`` (the dual dimension sharded over that mesh axis) and
    ``collective_axes`` (the axes the eps loop's all-converged count is
    summed over) name axes that ``parallel.solve_batch_sharded`` binds;
    outside it they raise ``ValueError``. The torch engine serves
    ``model_axis``, as XLA does in the JAX package.

    ``precision`` ("highest" | "high" | "default") and ``matmul_dtype``
    ("float32" | "bfloat16") set the torch engine's hot products, as the
    JAX package's ``_make_matmul`` does (``_Matmul`` here): "highest" is
    IEEE fp32 with TF32 held off, "high" 3xTF32 (each operand split into a
    TF32-exact part and its remainder, three products), "default" one TF32
    product, "bfloat16" bf16 operands accumulated and returned in fp32; on
    the CPU the TF32 tiers compute in fp32. The CUDA kernels of the
    condensed solve (paired flat, paired, dense, dual, dual chunk and the
    tiled dual, dual chunk and flat ones) run their products at the tier on
    the tensor cores (``csrc/mma_product.cuh``: "high" 3xTF32, "default"
    one TF32 ``mma.sync``, "bfloat16" bf16 operands with fp32
    accumulation), and the products around their launch (relu offsets,
    primal recovery, residuals) in fp32 with TF32 held off, where the JAX
    package runs those at the tier too. Routing is the same under every
    tier.
    A solve sets TF32 for its own scope through torch's one
    process-wide switch (``tf32_matmuls``), so the tiers are not
    thread-safe: solves under different tiers in concurrent threads of one
    process can run each other's products under the wrong setting;
    serialize them. ``unroll`` is accepted for parity and has no effect on
    the eager loop.
    """

    iterations: int | None = None  # None: the full shipped schedule
    mode: str = "fixed"  # "fixed" | "eps"
    eps_g: float = 1e-6
    eps_V: float = 1e-6
    check_every: int = 10
    engine: str = "auto"  # "auto" | "torch" | "cuda"
    form: str = "auto"  # "auto" | "mvp" | "dual"
    matmul_dtype: str = "float32"
    precision: str = "highest"  # true fp32 products: no TF32 anywhere
    collective_axes: tuple = ()
    model_axis: str | None = None
    unroll: int = 1
    flat: str = "auto"  # "auto" | "on" | "off"
    diagnostics: bool = True  # False: residual/gap come back NaN
    restart: bool = False


# The process group bound to each mesh axis name while a sharded solve
# runs: the counterpart of shard_map's axis environment.
_AXIS_GROUPS: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "gpad_axis_groups", default={})


@contextlib.contextmanager
def bind_axes(groups: dict):
    """Bind mesh axis names to ``torch.distributed`` process groups for the
    solves inside the block (``parallel.solve_batch_sharded`` binds its
    mesh's ``data`` and ``model`` axes)."""
    token = _AXIS_GROUPS.set({**_AXIS_GROUPS.get(), **groups})
    try:
        yield
    finally:
        _AXIS_GROUPS.reset(token)


def _check_axes(config: SolverConfig) -> None:
    """Raise for an axis name that no sharded solve has bound: a solve that
    ignored it would give a wrong answer, one that waited for it would hang."""
    names = tuple(config.collective_axes)
    if config.model_axis is not None:
        names += (config.model_axis,)
    unbound = [n for n in names if n not in _AXIS_GROUPS.get()]
    if unbound:
        raise ValueError(
            f"mesh axis {unbound} is not bound: model_axis and "
            "collective_axes name axes of a mesh, which "
            "parallel.solve_batch_sharded binds to their process groups "
            "while its local solve runs; call solve_batch_sharded"
        )


def _all_reduce(t, axis, op: str = "sum"):
    """``lax.psum`` (``op="sum"``) or ``lax.pmax`` (``"max"``) of ``t`` over
    the named mesh axis, in place; ``axis=None`` returns ``t`` as it is."""
    if axis is None:
        return t
    import torch.distributed as dist

    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    dist.all_reduce(t, op=red, group=_AXIS_GROUPS.get()[axis])
    return t


def _all_converged(converged, config: SolverConfig) -> bool:
    """Whether every scenario has converged on every rank: the unconverged
    count summed over each of ``config.collective_axes``, so that every
    rank takes the same branch (a rank that left the loop alone would hang
    the others at their next collective)."""
    n = (~converged).sum()
    for axis in config.collective_axes:
        n = _all_reduce(n, axis)
    return int(n) == 0


PRECISIONS = ("highest", "high", "default")
MATMUL_DTYPES = ("float32", "bfloat16")


def _check_config(config: SolverConfig) -> None:
    """Raise for a mode, engine, precision or matmul dtype that no engine
    knows."""
    if config.mode not in ("fixed", "eps"):
        raise ValueError(f"unknown mode: {config.mode!r}")
    if config.precision not in PRECISIONS:
        raise ValueError(f"unknown precision: {config.precision!r} "
                         f"(one of {PRECISIONS})")
    if config.matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(f"unknown matmul_dtype: {config.matmul_dtype!r} "
                         f"(one of {MATMUL_DTYPES})")
    if config.engine not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown engine: {config.engine!r}")


def tier(config: SolverConfig) -> str:
    """The tier of the hot products: "bfloat16" (the operand dtype decides,
    as ``tpu_gpad.utils.matmul_peak_tflops`` applies ``precision`` to fp32
    operands only), else the precision."""
    return "bfloat16" if config.matmul_dtype == "bfloat16" else config.precision


@contextlib.contextmanager
def tf32_matmuls(on: bool):
    """TF32 on (or held off) for CUDA fp32 products in the block, and the
    caller's setting restored after it, also after an exception. The switch
    is process-global, not per thread: a scope in one thread sets it for
    every thread's products until it exits. Every scope in the port goes
    through ``torch.backends.cuda.matmul.allow_tf32`` (mixing it with the
    newer ``fp32_precision`` API can raise)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _split_tf32(a):
    """(hi, lo): ``hi`` is ``a`` with the low 13 of its 23 mantissa bits
    cleared, exact in TF32; ``lo = a - hi`` is exact in fp32."""
    hi = (a.view(torch.int32) & -(1 << 13)).view(torch.float32)
    return hi, a - hi


def _round_tf32(a):
    """``a`` (float32) rounded to TF32, to nearest with ties away from zero,
    as the kernels' ``cvt.rna.tf32.f32`` rounds it: half a TF32 unit (bit
    12) added to the magnitude, the low 13 mantissa bits cleared. Inf and
    NaN pass unchanged."""
    bits = (a.view(torch.int32) + (1 << 12)) & -(1 << 13)
    return torch.where(torch.isfinite(a), bits.view(torch.float32), a)


def _split_tf32_rna(a):
    """(hi, lo) of the kernels' 3xTF32 product: ``hi = rna(a)`` and ``lo =
    rna(a - hi)`` (``_round_tf32``; ``a - hi`` is exact in fp32)."""
    hi = _round_tf32(a)
    return hi, _round_tf32(a - hi)


def _round_bf16(a):
    """``a`` rounded to bf16 (to nearest even, as ``__float2bfloat16_rn``)
    and back to float32."""
    return a.to(torch.bfloat16).to(torch.float32)


def _fp32(config: SolverConfig) -> SolverConfig:
    """``config`` at fp32 "highest": the tier of the products a kernel route
    runs around its launch (the dual kernels' relu offsets, the primal
    recovery, the residuals), whatever the tier of the kernel's own."""
    return dataclasses.replace(config, precision="highest",
                               matmul_dtype="float32")


def _tf32(config: SolverConfig) -> bool:
    """Whether ``config``'s products run with TF32 on ("high", "default")."""
    return tier(config) in ("high", "default")


class _Matmul:
    """The hot products of one solve at its config's tier: the counterpart
    of ``tpu_gpad.solver.core._make_matmul``'s closure. ``mm(a, b)`` takes
    an fp32 ``a`` of any leading shape and a constant operand ``b``
    prepared by ``mm.prep`` (split once for "high", cast once for
    "bfloat16", as ``tpu_gpad/solver/kernels.py:198-233`` pre-splits its
    constants), and returns fp32. With ``data``, the constants of the
    loop's form are prepared once, outside the loop: ``mm.MG_T``, then
    ``mm.GL_s`` (the structural columns ``GL_T[:, :n_struct]``) for a
    ``flat`` loop or ``mm.GL_T`` for another, and ``mm.D`` for the
    ``dual`` form; the others are None.

    ===========  ==========================  ==============================
    tier         on the card                 on the CPU
    ===========  ==========================  ==============================
    highest      IEEE fp32, TF32 held off    fp32
    high         3xTF32: hi.hi + hi.lo +     the same split algebra in fp32
                 lo.hi, TF32 on
    default      one TF32 product            fp32
    bfloat16     bf16 operands, fp32         bf16-rounded operands
                 accumulation and output     multiplied in fp32
    ===========  ==========================  ==============================

    ``route`` is the bf16 product, chosen by device type: "out_dtype"
    (``torch.mm(..., out_dtype=torch.float32)``) on a CUDA device, "upcast"
    on the CPU, whose torch has no such kernel. ``tf32`` is the TF32
    setting the products run under (``tf32_matmuls``)."""

    def __init__(self, config: SolverConfig, data: GPADData | None = None, *,
                 device=None, flat: bool = False, dual: bool = False):
        self.tier = tier(config)
        self.tf32 = _tf32(config)
        device = torch.device(device if data is None else data.device)
        self.route = "out_dtype" if device.type == "cuda" else "upcast"
        if data is not None:
            ns = data.n_struct if flat else None
            self.MG_T = self.prep(data.MG_T)
            self.GL_T = None if flat else self.prep(data.GL_T)
            self.GL_s = self.prep(data.GL_T[:, :ns]) if ns else None
            self.D = self.prep(data.D) if dual else None

    def prep(self, b):
        """A constant operand in the form ``__call__`` multiplies by."""
        if self.tier == "high":
            return _split_tf32(b)
        if self.tier == "bfloat16":
            b = b.to(torch.bfloat16)
            return b if self.route == "out_dtype" else b.float()
        return b

    def __call__(self, a, b):
        if self.tier == "high":
            (a_hi, a_lo), (b_hi, b_lo) = _split_tf32(a), b
            return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
        if self.tier == "bfloat16":
            a = a.to(torch.bfloat16)
            if self.route == "out_dtype":  # mm takes 2-D operands only
                out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                               out_dtype=torch.float32)
                return out.reshape(*a.shape[:-1], out.shape[-1])
            return a.float() @ b
        return a @ b


def affine_params(data: GPADData, x0: torch.Tensor):
    """Per-scenario dual constants g_P(x0), p_D(x0).

    In the paired layout ``p_D`` has shape (..., 2, m_h)."""
    g_P = torch.tensordot(x0, data.gP_map, dims=1) + data.gP_const
    p_D = torch.tensordot(x0, data.pD_map, dims=1) + data.pD_const
    return g_P, p_D


def resolve_flat(data: GPADData, config: SolverConfig) -> bool:
    """Whether the mvp iteration exploits the input-box identity block."""
    avail = (
        data.paired
        and data.n_struct is not None
        and config.model_axis is None
    )
    if config.flat == "auto":
        return avail
    if config.flat == "on":
        if not avail:
            raise ValueError(
                "flat='on' needs paired data with a detected identity block "
                "(GPADData.n_struct) and no model-axis sharding"
            )
        return True
    if config.flat == "off":
        return False
    raise ValueError(f"unknown flat: {config.flat!r}")


def _step4_product(data: GPADData, zhat, flat: bool, mm: _Matmul):
    """q = zhat @ GL_T for the paired layout; with ``flat`` the box columns
    of GL_T are exactly I/L and cost a division instead of a product."""
    if not flat:
        return mm(zhat, mm.GL_T)
    ns = data.n_struct
    if ns == 0:
        return zhat / data.L
    q_s = mm(zhat, mm.GL_s)
    return torch.cat([q_s, zhat / data.L], dim=-1)


def _pm(q):
    """Stack a half-stack vector with both signs: (..., m_h) -> (..., 2, m_h)."""
    return torch.stack([q, -q], dim=-2)


def _expand_to(v, like):
    """Append trailing singleton dims so ``v`` broadcasts against ``like``."""
    return v.reshape(tuple(v.shape) + (1,) * (like.ndim - v.ndim))


def _iteration(data: GPADData, g_P, p_D, theta_k, beta_k, y, y_prev, z,
               mm: _Matmul, flat: bool = False, model_axis=None):
    """One GPAD iteration (steps 1-4), batched, its products ``mm``'s.
    ``theta_k``/``beta_k`` are schedule scalars, or per-scenario rows under
    restart. With the dual dimension sharded over ``model_axis``, step 2's
    partial product is summed over it before ``g_P`` enters (once, not once
    a rank)."""
    w = y + _expand_to(beta_k, y) * (y - y_prev)
    if data.paired:
        zhat_partial = mm(w[..., 0, :] - w[..., 1, :], mm.MG_T)
    else:
        zhat_partial = mm(w, mm.MG_T)
    zhat = -_all_reduce(zhat_partial, model_axis) - g_P
    theta_z = _expand_to(theta_k, z)
    z = (1.0 - theta_z) * z + theta_z * zhat
    w_s = w if data.soft_damp is None else w * (1.0 - data.soft_damp)
    if data.paired:
        q = _step4_product(data, zhat, flat, mm)
        y_next = torch.clamp_min(w_s + _pm(q) + p_D, 0.0)
    else:
        y_next = torch.clamp_min(w_s + mm(zhat, mm.GL_T) + p_D, 0.0)
    return w, zhat, z, y_next


def _residuals(data: GPADData, g_P, p_D, z, zhat, w, mm: _Matmul,
               flat: bool = False, y=None, model_axis=None):
    """Primal violation max(G z - b) and gap surrogate -w' g(zhat),
    recovered from the scaled operands as g(z) = L (G_L z + p_D); soft rows
    are measured against the recovered slack (see tpu_gpad.solver.core).
    With the dual dimension sharded over ``model_axis``, the maxima are
    taken and the gap summed over it."""
    if data.paired:
        gz = data.L * (_pm(_step4_product(data, z, flat, mm)) + p_D)
        gzh = data.L * (_pm(_step4_product(data, zhat, flat, mm)) + p_D)
    else:
        gz = data.L * (mm(z, mm.GL_T) + p_D)
        gzh = data.L * (mm(zhat, mm.GL_T) + p_D)
    if data.soft_damp is not None:
        if y is not None:
            gz = gz - (data.L * data.soft_damp) * y
        gzh = gzh - (data.L * data.soft_damp) * w
    dims = (-2, -1) if data.paired else (-1,)
    viol_z = _all_reduce(torch.amax(gz, dim=dims), model_axis, "max")
    viol_zhat = _all_reduce(torch.amax(gzh, dim=dims), model_axis, "max")
    gap = -_all_reduce(torch.sum(w * gzh, dim=dims), model_axis)
    return viol_z, viol_zhat, gap


def _momentum(config: SolverConfig, data: GPADData, k, th, th_prev):
    """(theta_k, beta_k): the shipped schedule's scalars, or under restart
    the per-scenario recursion carried in (th, th_prev)."""
    if not config.restart:
        return data.theta[k], data.beta[k]
    return th, th * (1.0 / th_prev - 1.0)


def _schedule_at(data: GPADData, config: SolverConfig, k: int):
    """The shipped schedule's (theta_k, beta_k) for a loop's step; none
    under restart, whose momentum the step carries itself (and whose budget
    may pass the schedule)."""
    return (None, None) if config.restart else (data.theta[k], data.beta[k])


def _restart_update(th, th_prev, y, y_next, w, model_axis=None):
    """Advance the momentum recursion, resetting the scenarios whose
    momentum opposes the projected-gradient step (O'Donoghue-Candes):
    restart iff (w - y+) . (y+ - y) > 0, the product summed over
    ``model_axis`` where the dual is sharded. Returns (y_prev', th',
    th_prev')."""
    r = _all_reduce(torch.sum((w - y_next) * (y_next - y),
                              dim=tuple(range(th.ndim, y.ndim))), model_axis)
    mask = r > 0.0
    th_next = torch.where(mask, 1.0, th * (torch.sqrt(th * th + 4.0) - th) * 0.5)
    th_prev_next = torch.where(mask, 1.0, th)
    y_prev_next = torch.where(_expand_to(mask, y), y_next, y)
    return y_prev_next, th_next, th_prev_next


def _schedule_window(theta, beta, k0, n: int):
    """The schedule's entries k0 .. k0 + n - 1: sliced for an integer
    ``k0``, gathered on the device for a tensor one (a window of a loop
    that torch.export traces)."""
    if isinstance(k0, torch.Tensor):
        idx = k0 + torch.arange(n, device=k0.device)
        return theta.index_select(0, idx), beta.index_select(0, idx)
    return theta[k0:k0 + n], beta[k0:k0 + n]


def _export_scan(body, carry, theta, beta, k0, iterations: int,
                 restart: bool):
    """``iterations`` turns of a loop from schedule index ``k0`` as
    torch.export traces them: one ``scan`` of ``body(carry, (theta_k,
    beta_k)) -> (carry, [])`` over the schedule's window (under restart,
    whose momentum is the carry's own, over placeholders, since the budget
    may pass the schedule), so that the graph holds one copy of the body
    whatever the budget.

    Each call site defines its own ``body`` (its carry passed through
    ``_unaliased``) and it reaches ``scan`` as it is. ``scan`` compiles
    every body through one cached frame, and dynamo checks the guards of
    each body compiled before against the next: two inputs that are one
    tensor where the cached body had two fail its no-aliasing guard, and
    dynamo then evaluates that body's guard sources against the new one's
    captured state, which raises where the two capture different things
    (a condensed export after a stage-wise one). So no two inputs here are
    one tensor: the restart placeholders are two."""
    from torch._higher_order_ops import scan

    if restart:
        theta, beta = (torch.zeros(iterations, dtype=torch.float32,
                                   device=carry[0].device) for _ in range(2))
    else:
        theta, beta = _schedule_window(theta, beta, k0, iterations)
    carry, _ = scan(body, _unaliased(carry), (theta, beta))
    return carry


def _unaliased(outs, ins=()) -> tuple:
    """``outs`` with each tensor that is one of ``ins`` or an earlier one of
    ``outs`` cloned (y_prev = y, a momentum that does not move): a
    higher-order op's body may not return its inputs, and its tracer would
    merge two carries that start as one tensor."""
    res = []
    for o in outs:
        if any(o is t for t in (*ins, *res)):
            o = o.clone()
        res.append(o)
    return tuple(res)


def _export_windows(window, state, converged_at: int, n_full: int, C: int,
                    rem: int):
    """An eps solve's check windows as torch.export traces them:
    ``window(k0, chunk, state) -> state`` for the full windows of ``C``
    iterations in a ``while_loop`` (``k0`` a tensor there), then the
    partial window of ``rem`` in a second one of at most one turn; each
    leaves once every scenario has converged (``state[converged_at]``), at
    the same check as the eager loop."""
    from torch._higher_order_ops import while_loop

    def cond(i, *s):
        return (i < n_full) & ~s[converged_at].all()

    def body(i, *s):
        return (i + 1, *_unaliased(window(i * C, C, s), s))

    start = torch.zeros((), dtype=torch.int64, device=state[0].device)
    _, *state = while_loop(cond, body, (start, *_unaliased(state)))
    if rem:
        def cond_rem(i, *s):
            return (i < 1) & ~s[converged_at].all()

        def body_rem(i, *s):
            return (i + 1, *_unaliased(window(n_full * C, rem, s), s))

        _, *state = while_loop(cond_rem, body_rem, (start, *state))
    return tuple(state)


def _init_y(data: GPADData, batch_shape, y0, device):
    """Initial dual iterate: zeros, or ``y0`` broadcast to the batch."""
    dual_shape = (2, data.m_half) if data.paired else (data.m,)
    shape = tuple(batch_shape) + dual_shape
    if y0 is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
    return y0.expand(shape).clone()


def _init_state(data: GPADData, batch_shape, y0=None):
    """Initial iterates; ``y0`` warm-starts the dual (both y and y_prev, so
    the first extrapolation step is momentum-free from the warm point)."""
    y = _init_y(data, batch_shape, y0, data.device)
    z = torch.zeros(tuple(batch_shape) + (data.n_z,), dtype=torch.float32,
                    device=data.device)
    return y, y, z, torch.zeros_like(y), torch.zeros_like(z)


def _finish(data: GPADData, g_P, p_D, z, zhat, w, y, config, flat,
            mm: _Matmul):
    """Residual/gap recovery and the SolveResult of a fixed-budget solve,
    its products ``mm``'s."""
    batch_shape = g_P.shape[:-1]
    if config.diagnostics:
        viol_z, _, gap = _residuals(data, g_P, p_D, z, zhat, w, mm, flat, y=y,
                                    model_axis=config.model_axis)
        residual = torch.clamp_min(viol_z, 0.0)
    else:
        residual = torch.full(batch_shape, float("nan"), dtype=torch.float32,
                              device=z.device)
        gap = residual
    return SolveResult(
        u=z[..., : data.n_u],
        z=z,
        y=y,
        iterations=torch.full(batch_shape, config.iterations,
                              dtype=torch.int32, device=z.device),
        residual=residual,
        gap=gap,
        converged=torch.ones(batch_shape, dtype=torch.bool, device=z.device),
    )


def _mvp_step(data: GPADData, g_P, p_D, config: SolverConfig, flat: bool,
              mm: _Matmul, carry, theta_k, beta_k):
    """One iteration of the mvp loop on its carry (y, y_prev, z, w, zhat,
    th, th_prev), at the schedule's (theta_k, beta_k) or, under restart,
    the carry's own momentum: the body both the eager loop and the loop
    torch.export traces run."""
    y, y_prev, z, w, zhat, th, th_prev = carry
    ma = config.model_axis
    if config.restart:
        theta_k, beta_k = th, th * (1.0 / th_prev - 1.0)
    w, zhat, z, y_next = _iteration(
        data, g_P, p_D, theta_k, beta_k, y, y_prev, z, mm, flat, ma
    )
    if config.restart:
        y_prev, th, th_prev = _restart_update(th, th_prev, y, y_next, w, ma)
    else:
        y_prev = y
    return y_next, y_prev, z, w, zhat, th, th_prev


def _solve_fixed(data: GPADData, g_P, p_D, config: SolverConfig,
                 y0=None) -> SolveResult:
    """Fixed-budget mvp loop (flat or dense products, paired or dense)."""
    flat = resolve_flat(data, config)
    mm = _Matmul(config, data, flat=flat)
    y, y_prev, z, w, zhat = _init_state(data, g_P.shape[:-1], y0)
    th = th_prev = torch.ones(g_P.shape[:-1], dtype=torch.float32,
                              device=g_P.device)

    def step(carry, theta_k, beta_k):
        return _mvp_step(data, g_P, p_D, config, flat, mm, carry, theta_k,
                         beta_k)

    carry = (y, y_prev, z, w, zhat, th, th_prev)
    if torch.compiler.is_exporting():
        def body(c, x):
            return _unaliased(step(c, *x), c), []

        carry = _export_scan(body, carry, data.theta, data.beta, 0,
                             config.iterations, config.restart)
    else:
        for k in range(config.iterations):
            carry = step(carry, *_schedule_at(data, config, k))
    y, _, z, w, zhat, _, _ = carry
    return _finish(data, g_P, p_D, z, zhat, w, y, config, flat, mm)


def _solve_fixed_dual(data: GPADData, g_P, p_D, config: SolverConfig,
                      y0=None) -> SolveResult:
    """Dual-only fixed-budget loop: one (m_h, m_h) product per iteration
    against D; the primal is recovered after the loop from the running
    momentum combination s of the w differences:
    z_K = -(s_K @ MG_T) - a_K g_P with a_K = 1 - prod_k (1 - theta_k).
    theta_0 = 1 makes a_K = 1 under restart too."""
    batch_shape = g_P.shape[:-1]
    y = _init_y(data, batch_shape, y0, g_P.device)
    w = torch.zeros_like(y)
    s = torch.zeros(tuple(batch_shape) + (data.m_half,), dtype=torch.float32,
                    device=g_P.device)
    th = th_prev = torch.ones(batch_shape, dtype=torch.float32, device=g_P.device)
    mm = _Matmul(config, data, dual=True)
    e = mm(g_P, mm.GL_T)  # (B, m_h), hoisted out of the loop

    def step(carry, theta_k, beta_k):
        y, y_prev, w, s, th, th_prev = carry
        if config.restart:
            theta_k, beta_k = th, th * (1.0 / th_prev - 1.0)
        w = y + _expand_to(beta_k, y) * (y - y_prev)
        wd = w[..., 0, :] - w[..., 1, :]
        q = -mm(wd, mm.D) - e
        w_s = w if data.soft_damp is None else w * (1.0 - data.soft_damp)
        y_next = torch.clamp_min(w_s + _pm(q) + p_D, 0.0)
        theta_s = _expand_to(theta_k, s)
        s = (1.0 - theta_s) * s + theta_s * wd
        if config.restart:
            y_prev, th, th_prev = _restart_update(th, th_prev, y, y_next, w)
        else:
            y_prev = y
        return y_next, y_prev, w, s, th, th_prev

    carry = (y, y, w, s, th, th_prev)
    if torch.compiler.is_exporting():
        def body(c, x):
            return _unaliased(step(c, *x), c), []

        carry = _export_scan(body, carry, data.theta, data.beta, 0,
                             config.iterations, config.restart)
    else:
        for k in range(config.iterations):
            carry = step(carry, *_schedule_at(data, config, k))
    y, _, w, s, _, _ = carry
    a = 1.0 - torch.prod(1.0 - data.theta[: config.iterations])
    z = -mm(s, mm.MG_T) - a * g_P
    wd = w[..., 0, :] - w[..., 1, :]
    zhat = -mm(wd, mm.MG_T) - g_P
    return _finish(data, g_P, p_D, z, zhat, w, y, config, False, mm)


def _eps_test(data: GPADData, g_P, p_D, config: SolverConfig, k_now: int,
             z, zhat, w, y, converged, iters, z_out, flat: bool,
             mm: _Matmul):
    """Algorithm 1's test at iteration ``k_now``: capture each newly
    converged scenario's eps-optimal point (z on the primal branch, zhat on
    the gap branch, where zhat is exactly optimal for the Lagrangian at w
    while the averaged z may still be infeasible). Returns the updated
    (converged, iters, z_out); the products are ``mm``'s."""
    viol_z, viol_zhat, gap = _residuals(data, g_P, p_D, z, zhat, w, mm, flat,
                                        y=y, model_axis=config.model_axis)
    ok_z = viol_z <= config.eps_g
    ok = ok_z | ((viol_zhat <= config.eps_g) & (gap <= config.eps_V))
    newly = ok & ~converged
    z_sel = torch.where(ok_z[..., None], z, zhat)
    return (converged | ok, iters.masked_fill(newly, k_now),
            torch.where(newly[..., None], z_sel, z_out))


def _eps_result(data: GPADData, g_P, p_D, z, zhat, w, y, converged, iters,
               z_out, flat: bool, model_axis, mm: _Matmul) -> SolveResult:
    """The SolveResult of an eps solve: the captured point where a scenario
    converged, the last iterate elsewhere; its products ``mm``'s."""
    z_final = torch.where(converged[..., None], z_out, z)
    viol_z, _, gap = _residuals(data, g_P, p_D, z_final, zhat, w, mm, flat,
                                y=y, model_axis=model_axis)
    return SolveResult(
        u=z_final[..., : data.n_u], z=z_final, y=y, iterations=iters,
        residual=torch.clamp_min(viol_z, 0.0), gap=gap, converged=converged,
    )


def _solve_eps(data: GPADData, g_P, p_D, config: SolverConfig,
               y0=None) -> SolveResult:
    """Eps-terminated mvp loop (Algorithm 1), checked every
    ``check_every`` iterations and at the budget's end. The loop leaves
    once every scenario has converged: one host sync per check, none in
    between."""
    flat = resolve_flat(data, config)
    batch_shape = g_P.shape[:-1]
    y, y_prev, z, w, zhat = _init_state(data, batch_shape, y0)
    th = th_prev = torch.ones(batch_shape, dtype=torch.float32, device=g_P.device)
    converged = torch.zeros(batch_shape, dtype=torch.bool, device=g_P.device)
    iters = torch.full(batch_shape, config.iterations, dtype=torch.int32,
                       device=g_P.device)
    mm = _Matmul(config, data, flat=flat)

    def step(carry, theta_k, beta_k):
        return _mvp_step(data, g_P, p_D, config, flat, mm, carry, theta_k,
                         beta_k)

    def test(k_now, carry, converged, iters, z_out):
        y, _, z, w, zhat, _, _ = carry
        return _eps_test(data, g_P, p_D, config, k_now, z, zhat, w, y,
                         converged, iters, z_out, flat, mm)

    carry = (y, y_prev, z, w, zhat, th, th_prev)
    if torch.compiler.is_exporting():
        def body(c, x):
            return _unaliased(step(c, *x), c), []

        def window(k0, chunk, state):
            carry = _export_scan(body, state[:7], data.theta, data.beta, k0,
                                 chunk, config.restart)
            return (*carry, *test(k0 + chunk, carry, *state[7:]))

        C = max(min(config.check_every, config.iterations), 1)
        n_full, rem = divmod(config.iterations, C)
        state = _export_windows(window, (*carry, converged, iters, z), 7,
                                n_full, C, rem)
        carry, (converged, iters, z_out) = state[:7], state[7:]
    else:
        z_out = z
        for k in range(config.iterations):
            carry = step(carry, *_schedule_at(data, config, k))
            if (k + 1) % config.check_every and k + 1 < config.iterations:
                continue
            converged, iters, z_out = test(k + 1, carry, converged, iters,
                                           z_out)
            if k + 1 < config.iterations and _all_converged(converged, config):
                break
    y, _, z, w, zhat, _, _ = carry
    return _eps_result(data, g_P, p_D, z, zhat, w, y, converged, iters, z_out,
                      flat, config.model_axis, mm)


def cuda_kernel(data: GPADData, config: SolverConfig,
                batch: int = 1) -> str | None:
    """The CUDA kernel that serves this (data, config) on the card, device
    aside: "paired_flat", "paired", "dense", "dual", "dual_tiled",
    "flat_tiled", "paired_tiled", "dense_tiled", "dual_chunk" or
    "dual_tiled_chunk" (eps mode), or None.
    Follows ``tpu_gpad.solver.core.resolve_engine`` and
    ``solve_batch_pallas``; like them, independent of ``diagnostics``, so
    the flag never changes which loop runs. A flat fixed solve past the
    flat kernel's shared memory takes the flat tiled kernel, under
    ``engine="auto"`` too, as JAX's auto takes its streamed kernel in the
    mid band, there up to its measured work edge (``kernels.tiled_auto``
    with ``flat``: on an H100 it beat the torch engine 13.0 against 22-51
    ms at the 30x30 flagship B256 and lost at B1024; PERF.md §5).
    ``engine="auto"`` and a forced ``"cuda"`` part ways
    where the JAX package's do: an eps solve past shared memory with the
    flat block on (auto: the torch engine; forced: the tiled chunk
    kernel). Past the resident paired and dense kernels' shared memory the
    full paired loop takes the flat tiled kernel at n_s = m_h
    ("paired_tiled") and the dense loop the tiled dense kernel
    ("dense_tiled"): a forced ``"cuda"`` wherever its plan fits,
    ``"auto"`` where it beat the torch engine at the solve's ``batch``
    scenarios (``kernels.tiled_auto``; the only route that depends on the
    batch). Soft rows take the route hard rows take at the same shape:
    every paired and dual kernel, resident or tiled, carries the damp
    column, so the guards alone decide; only the dense kernels refuse
    them, as tpu_gpad's dense kernel does."""
    from tpu_gpad_torch.solver import dual_kernels, kernels

    if config.model_axis is not None:
        return None  # a sharded dual dimension rides the torch engine
    forced = config.engine == "cuda"
    dual_ok = data.paired and data.D is not None and config.form != "mvp"
    if config.restart and not dual_ok:
        return None  # the restart recursion rides the dual kernels only
    if config.mode == "eps":
        if not dual_ok:
            return None
        if dual_kernels.dual_fits_smem(data):
            return "dual_chunk"
        # tpu_gpad's auto keeps the XLA mvp+flat eps loop where the flat
        # block is on (measured faster on a TPU; core.py:397-406)
        flat_on = data.n_struct is not None and config.flat != "off"
        if dual_kernels.dual_tiled_fits(data) and (forced or not flat_on):
            return "dual_tiled_chunk"
        return None
    if resolve_form(data, config, on_card=True) == "dual":
        if dual_kernels.dual_fits_smem(data):
            return "dual"
        return "dual_tiled" if dual_kernels.dual_tiled_fits(data) else None
    flat = resolve_flat(data, config)
    if flat and kernels.flat_fits_smem(data):
        return "paired_flat"
    if flat and kernels.flat_tiled_fits(data):
        # auto: where it beat the torch engine at this batch
        if forced or kernels.tiled_auto(data, batch, flat=True):
            return "flat_tiled"
        return None
    tiled = forced or kernels.tiled_auto(data, batch)
    if data.paired:
        if kernels.paired_fits_smem(data):
            return "paired"
        if tiled and kernels.paired_tiled_fits(data):
            return "paired_tiled"
        return None
    # the dense kernels decline soft rows (dense_fits_smem), as tpu_gpad's
    if kernels.dense_fits_smem(data):
        return "dense"
    return "dense_tiled" if tiled and kernels.dense_tiled_fits(data) else None


def resolve_engine(data: GPADData, config: SolverConfig,
                   batch: int = 1) -> str:
    """Pick the execution engine: "cuda" (a kernel) or "torch".

    "auto" keys on the device of the data tensors (the counterpart of the
    JAX package's ``jax.default_backend() == "tpu"`` test); a warm start
    never changes the choice. A sharded dual dimension (``model_axis``)
    runs the torch engine, as it runs XLA in the JAX package. Forcing
    "cuda" where no kernel serves the case raises. The tier never changes
    the choice either (JAX's routing ignores it): under every tier each
    kernel serves what it serves at fp32 "highest", its products at the
    tier. ``batch`` is the solve's scenarios (``cuda_kernel``)."""
    if config.engine == "torch":
        return "torch"
    if config.engine == "cuda":
        kernel = cuda_kernel(data, config, batch)
        if config.model_axis is not None:
            raise ValueError(
                "engine='cuda' does not support dual-dimension tensor "
                "parallelism; use engine='torch' for model-axis sharding"
            )
        if data.device.type != "cuda":
            raise ValueError(
                "engine='cuda' needs the data on a CUDA device; got "
                f"{data.device}"
            )
        if kernel is None:
            raise ValueError(
                "engine='cuda' serves fixed mvp solves without restart "
                "(paired, soft rows or not: kernels.flat_fits_smem, "
                "flat_tiled_fits, paired_fits_smem or paired_tiled_fits; "
                "unpaired without soft rows: kernels.dense_fits_smem or "
                "dense_tiled_fits), and the dual form with D, fixed or eps, "
                "restart or not, soft rows or not "
                "(dual_kernels.dual_fits_smem or dual_tiled_fits); use "
                "engine='torch' here"
            )
        return "cuda"
    if config.engine != "auto":
        raise ValueError(f"unknown engine: {config.engine!r}")
    if (data.device.type == "cuda"
            and cuda_kernel(data, config, batch) is not None):
        return "cuda"
    return "torch"


def resolve_form(data: GPADData, config: SolverConfig,
                 on_card: bool | None = None) -> str:
    """Pick the iteration algebra for this (data, config) combination.

    "auto" picks the flat mvp form on a CUDA device whenever the identity
    block is available (the kernel's form) and the dual form elsewhere,
    as the JAX package does on TPU and CPU; a forced ``engine="cuda"``
    takes the dual form where the flat kernel's shared memory declines, as
    tpu_gpad's forced Pallas engine does past VMEM. ``on_card`` overrides
    the data's device (``cuda_kernel`` asks what the card would run)."""
    dual_ok = (
        data.paired
        and data.D is not None
        and config.mode == "fixed"
        and config.model_axis is None
    )
    if config.form == "auto":
        flat_avail = (
            dual_ok
            and data.n_struct is not None
            and config.flat != "off"
            and not config.restart
            and (data.device.type == "cuda" if on_card is None else on_card)
        )
        if flat_avail:
            from tpu_gpad_torch.solver import kernels

            if config.engine != "cuda" or kernels.flat_fits_smem(data):
                return "mvp"
        return "dual" if dual_ok else "mvp"
    if config.form == "dual":
        if not dual_ok:
            raise ValueError(
                "form='dual' needs paired data with D, fixed mode, and no "
                "model-axis sharding"
            )
        return "dual"
    if config.form == "mvp":
        return "mvp"
    raise ValueError(f"unknown form: {config.form!r}")


def solve_batch(
    data: GPADData,
    x0: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    y0: torch.Tensor | None = None,
) -> SolveResult:
    """Solve a batch of MPC QPs: ``x0`` has shape (..., n_x).

    All scenarios share the plant; per-scenario constants are the affine
    maps of x0. ``x0`` (and ``y0``) may be NumPy arrays or tensors; they
    are moved to the data's device. ``y0`` warm-starts the dual iterate
    and must broadcast to (..., 2, m_half) (paired) or (..., m).

    The products run at the config's tier (``SolverConfig``) with TF32 set
    for the call's scope alone (``tf32_matmuls``): held off under "highest"
    and for the affine maps of x0, whatever the caller's process set. A
    kernel route runs under TF32 held off too: around its launch it
    multiplies in torch (the dual kernels' ``e = g_P GL_T``, the primal
    recovery, the residuals), all fp32 "highest"."""
    n_iters = (
        config.iterations if config.iterations is not None else data.max_iters
    )
    if n_iters > data.max_iters and not config.restart:
        # restart computes theta/beta on the fly and ignores the schedule
        raise ValueError(
            f"config asks for {n_iters} iterations but the shipped momentum "
            f"schedule only has {data.max_iters}; re-dualize with a longer one"
        )
    config = dataclasses.replace(config, iterations=n_iters)
    if not config.diagnostics and config.mode != "fixed":
        raise ValueError(
            "diagnostics=False requires mode='fixed' (the eps termination "
            "test needs the residual/gap diagnostics)"
        )
    _check_config(config)
    _check_axes(config)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=data.device)
    if y0 is not None:
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=data.device)
    with tf32_matmuls(False):
        g_P, p_D = affine_params(data, x0)
        if resolve_engine(data, config, math.prod(x0.shape[:-1])) == "cuda":
            from tpu_gpad_torch.solver import kernels

            return kernels.solve_batch_cuda(data, g_P, p_D, config, y0=y0)
    form = resolve_form(data, config)  # in eps mode: validates the form
    with tf32_matmuls(_tf32(config)):
        if config.mode == "eps":
            return _solve_eps(data, g_P, p_D, config, y0)
        if form == "dual":
            return _solve_fixed_dual(data, g_P, p_D, config, y0)
        return _solve_fixed(data, g_P, p_D, config, y0)


def solve(
    data: GPADData,
    x0: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    y0: torch.Tensor | None = None,
) -> SolveResult:
    """Single-scenario solve: ``x0`` of shape (n_x,)."""
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=data.device)
    if y0 is not None:
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=data.device)
        if y0.ndim in (1, 2):
            y0 = y0[None]
    return solve_batch(data, x0[None, :], config=config, y0=y0)


def solve_to_accuracy(
    data: GPADData,
    x0: torch.Tensor,
    tol: float = 1e-5,
    max_iterations: int = 2000,
    check_every: int = 10,
    y0: torch.Tensor | None = None,
    **config_kw,
) -> SolveResult:
    """Solve until eps-optimality ``tol`` (primal infeasibility and duality
    gap) with adaptive restart on: ``solve_batch`` in ``mode="eps"``.
    Check ``result.converged`` for scenarios that hit ``max_iterations``
    first. ``x0`` may be (n_x,) or (B, n_x)."""
    # a check cadence longer than the budget shrinks to one window rather
    # than inflating the budget
    check_every = max(min(check_every, max_iterations), 1)
    config = SolverConfig(
        mode="eps", eps_g=tol, eps_V=tol, check_every=check_every,
        iterations=max_iterations, restart=True, **config_kw,
    )
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=data.device)
    if x0.ndim == 1:
        return solve(data, x0, config=config, y0=y0)
    return solve_batch(data, x0, config=config, y0=y0)
