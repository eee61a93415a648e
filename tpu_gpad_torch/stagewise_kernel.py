"""The resident stage-wise GPAD kernel (CUDA C++ for Hopper), its packing,
shared-memory guard and plain version.

``solve_stagewise_cuda`` runs a whole fixed-budget stage-wise solve in one
launch of ``gpad_stagewise_resident_kernel`` (``csrc/gpad_stagewise.cu``),
the counterpart of ``tpu_gpad.stagewise_kernel.solve_stagewise_pallas``:
all dual and plan state of a tile of scenarios stays in shared memory for
the whole solve. ``stagewise_stream.solve_stagewise_stream`` runs the other
kernel of the same source, for state too large for that. On CUDA tensors the
wrappers launch their kernel or raise; on CPU tensors they run
``stagewise_plain``, the kernels' algebra in torch ops, which is also what
the tests and ``chip_smoke.py`` hold the kernels against.

The packed algebra is the TPU kernels' contract (``tpu_gpad.stagewise_
kernel.pack_stagewise_constants``): R = [E' | -K'], HB = [Hi B' | Hi],
M = [[E, -B], [-K, -I]] per stage and the block-diagonal G = diag(Gx, Gu).
The layout is this port's own: no (8, 128) padding, no scenario-minor
transpose (the kernels read and write the public (B, N, .) layouts), and R,
HB, M stored transposed so that a thread computing row i of a product reads
consecutive words.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from tpu_gpad_torch.solver import kernels

# Launches of the resident kernel in this process; a run resets it to 0 to
# show that a path went through the kernel.
STAGEWISE_LAUNCHES = 0

_WARPS = 8  # kWarps of csrc/gpad_stagewise.cu
# At most 2**3 = 8 scenarios per block: one warp per scenario runs the two
# chains of an iteration, and a phase keeps the tile's values in registers.
_MAX_LOG2_TILE = 3
_MAX_STATE = 32  # n_x, n_u <= 32: a chain keeps one row per lane of a warp
# An H100 SM's shared memory (228 KB), of which the runtime keeps 1 KB per
# resident block, and the blocks per SM the kernels' launch bounds allow
# (256 threads of at most 128 registers).
_SM_SMEM_BYTES = 228 * 1024
_BLOCK_RESERVED_BYTES = 1024
_MAX_BLOCKS_PER_SM = 2
# The streamed kernel's chain ring (kRing of csrc/gpad_stagewise.cu): 16
# mbarriers (full and empty per slot), 8 slots of 32 x 32 floats, and 8
# addend rows of 32 per chain warp (one per scenario).
_RING_SLOTS = 8


@dataclass(frozen=True)
class StagewisePack:
    """The kernels' per-stage constants, float32 on the data's device:
    ``RT`` (N, n+p, n) = R', ``HBT`` (N, n+p, p) = HB', ``MT`` (N, n+p,
    n+p) = M', the diagonal blocks ``Gx`` (m_x, n) and ``Gu`` (m_u, p) of
    G, ``h`` (N, m_x + m_u) = [hx | hu], ``V`` (N, 3, n) = [dtl; qoff; c],
    the schedule and ``L``."""

    RT: torch.Tensor
    HBT: torch.Tensor
    MT: torch.Tensor
    Gx: torch.Tensor
    Gu: torch.Tensor
    h: torch.Tensor
    V: torch.Tensor
    theta: torch.Tensor
    beta: torch.Tensor
    L: torch.Tensor

    @property
    def N(self) -> int:
        return self.RT.shape[0]

    @property
    def n(self) -> int:
        return self.RT.shape[2]

    @property
    def p(self) -> int:
        return self.HBT.shape[2]

    @property
    def m_x(self) -> int:
        return self.Gx.shape[0]

    @property
    def m(self) -> int:
        return self.h.shape[1]


def pack_stagewise_constants(data) -> StagewisePack:
    """Pack a ``StagewiseData``'s per-stage constants for the kernels (and
    ``stagewise_plain``), on the data's device."""
    E, K, Hi, Bm = data.E, data.K, data.Hi, data.B_seq
    N, p = data.horizon, data.n_u
    tr = lambda a: a.transpose(1, 2)
    HiBt = torch.matmul(Hi, tr(Bm))  # (N, p, n)
    eye = torch.eye(p, dtype=E.dtype, device=E.device).expand(N, p, p)
    R = torch.cat([tr(E), -tr(K)], dim=2)  # (N, n, n+p)
    HB = torch.cat([HiBt, Hi], dim=2)  # (N, p, n+p)
    M = torch.cat([torch.cat([E, -Bm], dim=2),
                   torch.cat([-K, -eye], dim=2)], dim=1)  # (N, n+p, n+p)
    c = lambda a: tr(a).contiguous()
    return StagewisePack(
        RT=c(R), HBT=c(HB), MT=c(M),
        Gx=data.Gx.contiguous(), Gu=data.Gu.contiguous(),
        h=torch.cat([data.hx, data.hu], dim=1).contiguous(),
        V=torch.stack([data.dtl, data.qoff, data.c_seq], dim=1).contiguous(),
        theta=data.theta, beta=data.beta, L=data.L.reshape(1),
    )


def _up4(x: int) -> int:
    return (x + 3) // 4 * 4


def _smem_floats(data, T: int) -> tuple:
    """(shared, aux, dual) floats of the csrc carve-up for a tile of T: the
    G blocks (rows padded to an odd stride), x0, one scratch row block per
    warp, two per-warp partials and (theta, beta, reset) per scenario; the
    st, zu, ru, kff slabs; one of y, y_prev. Each region 16-byte aligned."""
    N, n, p = data.horizon, data.n_x, data.n_u
    m_x, m_u = data.m_x, data.m_u
    m = m_x + m_u
    shared = (_up4(m_x * (n | 1)) + _up4(m_u * (p | 1)) + _up4(n * T)
              + _up4(_WARPS * max(m, p) * T) + _up4(2 * _WARPS * T)
              + _up4(3 * T))
    aux = _up4(N * n * T) + 3 * _up4(N * p * T)
    return shared, aux, _up4(N * m * T)


def _smem_bytes(data, T: int, y_in_smem: bool, aux_in_smem: bool) -> int:
    """Shared memory of one block of either kernel: the stage-invariant
    part, then the st/zu/ru/kff slabs (``aux_in_smem``) and y, y_prev
    (``y_in_smem``: the resident kernel) or the chains' ring (the streamed
    kernel)."""
    shared, aux, dual = _smem_floats(data, T)
    ring = (_up4(4 * _RING_SLOTS) + _RING_SLOTS * 32 * 32
            + _RING_SLOTS * 32 * T)
    return 4 * (shared + (aux if aux_in_smem else 0)
                + (2 * dual if y_in_smem else ring))


def stagewise_fits_smem(data, tile: int) -> bool:
    """Does a block of the resident kernel with ``tile`` scenarios (all of
    their state in shared memory) fit one block's shared memory? The same
    carve-up as the launch, so routing and launch agree."""
    return _smem_bytes(data, tile, True, True) <= kernels.SMEM_LIMIT_BYTES


def _pick_log2_tile(data, B: int) -> int | None:
    """log2 of the tile, a power of two at most 8 and at most B rounded up:
    the widest whose block leaves room for a second on its SM, else the
    widest that ``stagewise_fits_smem`` admits; None when not even one
    fits. Two blocks per SM overlap one block's chains with the other's
    phases (PERF.md, stage-wise tile sweep on an H100: at n8 N60, 4 per block
    beat 8)."""
    fits = [log2 for log2 in range(min(_MAX_LOG2_TILE,
                                       max(B - 1, 0).bit_length()), -1, -1)
            if stagewise_fits_smem(data, 1 << log2)]
    for log2 in fits:
        if blocks_per_sm(_smem_bytes(data, 1 << log2, True, True)) \
                == _MAX_BLOCKS_PER_SM:
            return log2
    return fits[0] if fits else None


def blocks_per_sm(smem_bytes: int) -> int:
    """Blocks of either kernel an SM holds at once with ``smem_bytes`` of
    shared memory each."""
    return min(_MAX_BLOCKS_PER_SM,
               _SM_SMEM_BYTES // (smem_bytes + _BLOCK_RESERVED_BYTES))


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def resident_preferred(data, B: int, sms: int) -> bool:
    """Should a batch of B that both kernels take ride the resident kernel?
    Yes when its blocks all run in one wave on ``sms`` SMs, or when an SM
    holds at least as many of its scenarios at once as of the streamed
    kernel's; else the streamed kernel, whose smaller blocks put more
    scenarios on each SM (an iteration's two stage chains, not its bytes,
    bound both kernels: PERF.md, §6)."""
    from tpu_gpad_torch import stagewise_stream

    T = 1 << _pick_log2_tile(data, B)
    per_sm = blocks_per_sm(_smem_bytes(data, T, True, True))
    if -(-B // T) <= sms * per_sm:
        return True
    log2_s, _, smem_s = stagewise_stream.stream_layout(data, B, sms)
    return T * per_sm >= (1 << log2_s) * blocks_per_sm(smem_s)


def _shape_ok(data) -> tuple:
    if data.m_x == 0 or data.m_u == 0:
        return False, "kernels need m_x > 0 and m_u > 0"
    if data.n_x > _MAX_STATE or data.n_u > _MAX_STATE:
        return False, (f"kernels take n_x, n_u <= {_MAX_STATE} (one row per "
                       "lane of a warp)")
    return True, ""


def stagewise_kernel_compatible(data) -> tuple:
    """(ok, reason): can this ``StagewiseData`` ride the resident kernel?"""
    ok, why = _shape_ok(data)
    if not ok:
        return ok, why
    if not stagewise_fits_smem(data, 1):
        return False, ("one scenario's state exceeds a block's shared memory "
                       f"({kernels.SMEM_LIMIT_BYTES} bytes)")
    return True, ""


def stagewise_plain(pack: StagewisePack, x0, y0=None, *, iterations: int,
                    restart: bool = False):
    """The kernels' function in torch ops, on any device, phase for phase
    (see ``csrc/gpad_stagewise.cu``): returns (u0, zu, y, residual, gap) as
    the wrappers do. ``x0`` (B, n); ``y0`` broadcastable to (B, N, m).
    It computes in ``x0``'s dtype: float32 as the kernels do, or float64
    (with a float64 pack) as a referee for decisions float32 rounding may
    flip."""
    N, n, m_x = pack.N, pack.n, pack.m_x
    B = x0.shape[0]
    like = dict(dtype=x0.dtype, device=x0.device)
    if y0 is None:
        y = torch.zeros((B, N, pack.m), **like)
    else:
        y = y0.broadcast_to((B, N, pack.m)).clone()
    yp = y
    zu = torch.zeros((B, N, pack.p), **like)
    th = torch.ones((B,), **like)
    thp = torch.ones((B,), **like)
    reset = torch.zeros((B,), dtype=torch.bool, device=x0.device)
    inv_L = 1.0 / pack.L[0]
    dtl, qoff, c = pack.V[:, 0], pack.V[:, 1], pack.V[:, 2]
    colT = lambda MatT, v: torch.einsum("kji,bkj->bki", MatT, v)
    for it in range(iterations):
        if restart:
            theta_k = th[:, None, None]
            beta_k = (th * (1.0 / thp - 1.0))[:, None, None]
        else:
            theta_k, beta_k = pack.theta[it], pack.beta[it]
        w = y + beta_k * (y - torch.where(reset[:, None, None], y, yp))
        # P1, P2: st = qx + qoff + R [0; ru_{k+1}]
        st = w[..., :m_x] @ pack.Gx + qoff
        ru = w[..., m_x:] @ pack.Gu
        st[:, :-1] += colT(pack.RT[1:, n:], ru[:, 1:])
        # CB: st_k += R_{k+1} [st_{k+1}; 0]
        for k in range(N - 2, -1, -1):
            st[:, k] = st[:, k] + st[:, k + 1] @ pack.RT[k + 1, :n]
        # P3: kff = HB [st + dtl; ru], d = M [0; kff]_top + c
        kff = colT(pack.HBT, torch.cat([st + dtl, ru], dim=-1))
        d = c + colT(pack.MT[:, n:, :n], kff)
        # CF: x_{k+1} = M_k [x_k; 0]_top + d_k
        xs = torch.empty_like(d)
        x = x0
        for k in range(N):
            x = d[:, k] + x @ pack.MT[k, :n, :n]
            xs[:, k] = x
        # P4: u = M [x; kff]_bottom, averaging, dual step
        x_lin = torch.cat([x0[:, None], xs[:, :-1]], dim=1)
        u = colT(pack.MT[:, :, n:], torch.cat([x_lin, kff], dim=-1))
        zu = (1.0 - theta_k) * zu + theta_k * u
        g = torch.cat([xs @ pack.Gx.T, u @ pack.Gu.T], dim=-1) - pack.h
        y_next = torch.clamp_min(w + g * inv_L, 0.0)
        if restart:
            r = torch.sum((w - y_next) * (y_next - y), dim=(1, 2))
            reset = r > 0.0
            th, thp = (torch.where(reset, 1.0,
                                   th * (torch.sqrt(th * th + 4.0) - th) * 0.5),
                       torch.where(reset, 1.0, th))
        yp, y = y, y_next
    # epilogue: roll zu through the dynamics, kff = -(u + K x)
    xs = torch.empty((B, N, n), **like)
    x = x0
    for k in range(N):
        kff = x @ pack.MT[k, :n, n:] - zu[:, k]
        x = c[k] + x @ pack.MT[k, :n, :n] + kff @ pack.MT[k, n:, :n]
        xs[:, k] = x
    g = torch.cat([xs @ pack.Gx.T, zu @ pack.Gu.T], dim=-1) - pack.h
    residual = torch.clamp_min(torch.amax(g, dim=(1, 2)), 0.0)
    gap = -torch.sum(y * g, dim=(1, 2))
    return zu[:, 0].contiguous(), zu, y, residual, gap


def _launch_fns(defines: tuple = ()):
    """The kernels' C launchers, built and loaded at first use (``defines``:
    a build of its own, e.g. ``("GPAD_SW_PROFILE",)``)."""
    from tpu_gpad_torch import cuda_build

    lib = cuda_build.load("gpad_stagewise", defines)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    head = [P] * 12 + [LL] + [I] * 9
    resident, stream = lib.gpad_stagewise_launch, lib.gpad_stagewise_stream_launch
    resident.argtypes = head + [P] * 4 + [I, P]
    stream.argtypes = [P] + head + [P] * 7 + [I, P]  # chainE first
    resident.restype = stream.restype = I
    return resident, stream


def check_inputs(data, x0, y0, iterations: int, restart: bool):
    """Raise on what the kernels (and their plain version) do not take;
    return ``y0`` as (rows, N, m) with rows 1 (shared) or B, or None."""
    if x0.ndim != 2 or x0.shape[1] != data.n_x or x0.shape[0] < 1:
        raise ValueError(f"x0 must be (B, {data.n_x}) with B >= 1; got "
                         f"{tuple(x0.shape)}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0; got {iterations}")
    if iterations > data.max_iters and not restart:
        raise ValueError(f"{iterations} iterations exceed the schedule's "
                         f"{data.max_iters}")
    N, m = data.horizon, data.m_x + data.m_u
    if y0 is not None:
        if y0.ndim == 2:
            y0 = y0[None]
        if y0.ndim != 3 or tuple(y0.shape[1:]) != (N, m) \
                or y0.shape[0] not in (1, x0.shape[0]):
            raise ValueError(f"y0 of shape {tuple(y0.shape)} does not "
                             f"broadcast to ({x0.shape[0]}, {N}, {m})")
    kernels._check_tensors(
        [x0, y0, data.E, data.K, data.Hi, data.B_seq, data.Gx, data.Gu,
         data.hx, data.hu, data.L, data.theta, data.beta, data.c_seq,
         data.dtl, data.qoff], x0.device)
    return y0


def on_card(x0) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x0.device}")
    return x0.device.type == "cuda"


def launch_head(pack: StagewisePack, data, x0, y0, iterations: int,
                restart: bool, log2_tile: int):
    """The arguments both C launchers share, in order."""
    ptr = kernels._ptr
    y0_stride = 0 if y0 is None or y0.shape[0] == 1 else data.horizon * (
        data.m_x + data.m_u)
    return (ptr(pack.RT), ptr(pack.HBT), ptr(pack.MT), ptr(pack.Gx),
            ptr(pack.Gu), ptr(pack.h), ptr(pack.V), ptr(pack.theta),
            ptr(pack.beta), ptr(pack.L), ptr(x0), ptr(y0), y0_stride,
            x0.shape[0], data.horizon, data.n_x, data.n_u, data.m_x,
            data.m_u, iterations, int(restart), log2_tile)


def solve_stagewise_cuda(data, x0, iterations: int, restart: bool = False,
                         y0=None, log2_tile: int | None = None):
    """Fixed-budget stage-wise GPAD for a batch on the resident kernel.

    ``x0`` (B, n_x), optional warm start ``y0`` (B, N, m_x + m_u), or one
    (N, m_x + m_u) dual shared by every scenario. Returns (u0 (B, n_u),
    zu (B, N, n_u), y (B, N, m_x + m_u), residual (B,), gap (B,)), the
    contract of ``tpu_gpad.stagewise_kernel.solve_stagewise_pallas``.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``stagewise_plain``. ``log2_tile`` overrides the tile (for sweeps)."""
    global STAGEWISE_LAUNCHES
    y0 = check_inputs(data, x0, y0, iterations, restart)
    pack = pack_stagewise_constants(data)
    if not on_card(x0):
        return stagewise_plain(pack, x0, y0, iterations=iterations,
                               restart=restart)
    ok, why = stagewise_kernel_compatible(data)
    if not ok:
        raise ValueError(f"stagewise kernel cannot take this: {why}")
    B, N = x0.shape[0], data.horizon
    if log2_tile is None:
        log2_tile = _pick_log2_tile(data, B)
    smem = _smem_bytes(data, 1 << log2_tile, True, True)
    if smem > kernels.SMEM_LIMIT_BYTES:
        raise ValueError(f"tile 2**{log2_tile} needs {smem} bytes of shared "
                         "memory")
    resident, _ = _launch_fns()
    f32 = dict(dtype=torch.float32, device=x0.device)
    y = torch.empty((B, N, data.m_x + data.m_u), **f32)
    zu = torch.empty((B, N, data.n_u), **f32)
    residual = torch.empty((B,), **f32)
    gap = torch.empty((B,), **f32)
    ptr = kernels._ptr
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = resident(*launch_head(pack, data, x0, y0, iterations, restart,
                                    log2_tile),
                       ptr(y), ptr(zu), ptr(residual), ptr(gap), smem, stream)
    if err != 0:
        raise RuntimeError(f"gpad_stagewise launch failed: CUDA error {err}")
    STAGEWISE_LAUNCHES += 1
    return zu[:, 0].contiguous(), zu, y, residual, gap
