"""The resident stage-wise GPAD kernel (CUDA C++ for Hopper), its packing,
shared-memory carve-up and plain version.

``solve_stagewise_cuda`` runs a whole fixed-budget stage-wise solve in one
launch of ``gpad_stagewise_resident_kernel`` (``csrc/gpad_stagewise.cu``),
the counterpart of ``tpu_gpad.stagewise_kernel.solve_stagewise_pallas``:
all dual and plan state of a tile of scenarios stays in shared memory for
the whole solve, each warp owns a run of stages, and the two chains of an
iteration run as segmented chains over every warp. ``stagewise_stream.
solve_stagewise_stream`` runs the other kernel of the same source, for state
too large for that. On CUDA tensors the wrappers launch their kernel or
raise; on CPU tensors they run ``stagewise_plain``, the kernels' algebra in
torch ops, which is also what the tests and ``chip_smoke.py`` hold the
kernels against (``warps=`` runs its chains segment by segment, as the
resident kernel does).

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
from typing import Optional

import torch
from torch import Tensor

from tpu_gpad_torch.solver import kernels
from tpu_gpad_torch.solver.kernels import on_card

# Launches of the resident kernel in this process; a run resets it to 0 to
# show that a path went through the kernel.
STAGEWISE_LAUNCHES = 0

_WARPS = 8  # kWarps of csrc/gpad_stagewise.cu: the streamed kernel's block
# At most 2**3 = 8 scenarios per block: a phase keeps the tile's values in
# registers.
_MAX_LOG2_TILE = 3
_MAX_STATE = 32  # n_x, n_u <= 32: a chain keeps one row per lane of a warp
# An H100 SM's shared memory (228 KB), of which the runtime keeps 1 KB per
# resident block, and the warps an SM holds at the kernels' launch bounds
# (at most 128 registers a thread): two streamed blocks of 8 warps, one
# resident block of 16 or two of 8.
_SM_SMEM_BYTES = 228 * 1024
_SM_L1_SMEM_BYTES = 256 * 1024  # an SM's L1 and shared memory together
_BLOCK_RESERVED_BYTES = 1024
_SM_WARPS = 16
_MAX_BLOCKS_PER_SM = _SM_WARPS // _WARPS
# The resident kernel's blocks, the most warps that fit first: W warps, warp w
# owning the stages [w N / W, (w + 1) N / W) and one segment of each chain
# (resident_iterations in csrc/gpad_stagewise.cu).
_RES_WARPS = (16, 8)
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
    """(shared, aux, dual) floats of the streamed kernel's carve-up for a
    tile of T: the G blocks (rows padded to an odd stride), x0, one scratch
    row block per warp, two per-warp partials and (theta, beta, reset) per
    scenario; the st, zu, ru, kff slabs; one of y, y_prev. Each region
    16-byte aligned."""
    N, n, p = data.horizon, data.n_x, data.n_u
    m_x, m_u = data.m_x, data.m_u
    m = m_x + m_u
    shared = (_up4(m_x * (n | 1)) + _up4(m_u * (p | 1)) + _up4(n * T)
              + _up4(_WARPS * max(m, p) * T) + _up4(2 * _WARPS * T)
              + _up4(3 * T))
    aux = _up4(N * n * T) + 3 * _up4(N * p * T)
    return shared, aux, _up4(N * m * T)


def _smem_bytes(data, T: int, aux_in_smem: bool) -> int:
    """Shared memory of one block of the streamed kernel: the
    stage-invariant part, the st/zu/ru/kff slabs (``aux_in_smem``) and the
    chains' ring."""
    shared, aux, _ = _smem_floats(data, T)
    ring = (_up4(4 * _RING_SLOTS) + _RING_SLOTS * 32 * 32
            + _RING_SLOTS * 32 * T)
    return 4 * (shared + (aux if aux_in_smem else 0) + ring)


def _dims(data) -> tuple:
    return data.horizon, data.n_x, data.n_u, data.m_x, data.m_u


def _resident_floats(dims: tuple, T: int, W: int, chains_in_smem: bool) -> int:
    """Floats of a resident block's shared memory (csrc res_floats) for
    ``dims`` = (N, n, p, m_x, m_u), a tile of T and W warps: the G blocks
    (rows padded to an odd stride), x0, W scratch blocks of max(m, max(p,
    n) + n) rows, two per-warp partials per scenario; with
    ``chains_in_smem`` both chains' segment products (W of n x n each) and
    W staging blocks of ceil(N / W) step matrices; then the st, zu, ru
    slabs (kff over ru) and y, y_prev. Each region 16-byte aligned."""
    N, n, p, m_x, m_u = dims
    m = m_x + m_u
    wb = max(m, max(p, n) + n) * T
    f = (_up4(m_x * (n | 1)) + _up4(m_u * (p | 1)) + _up4(n * T)
         + _up4(W * wb) + _up4(2 * W * T))
    if chains_in_smem:
        f += _up4(2 * W * n * n) + _up4(W * -(-N // W) * n * n)
    return (f + _up4(N * n * T) + 2 * _up4(N * p * T)
            + 2 * _up4(N * m * T))


@dataclass(frozen=True)
class ResidentLayout:
    """A launch of the resident kernel: 2**log2_tile scenarios per block of
    ``warps`` warps, the chains' matrices staged in shared memory or read
    from device memory, and the block's shared memory in bytes."""

    log2_tile: int
    warps: int
    chains_in_smem: bool
    smem: int


def resident_layouts(data, log2_tile: int) -> list:
    """Every (warps, chains_in_smem) launch of a tile that fits one block's
    shared memory: 16 warps before 8, the chains on chip before in device
    memory."""
    T, dims = 1 << log2_tile, _dims(data)
    out = []
    for W in _RES_WARPS:
        for cs in (True, False):
            smem = 4 * _resident_floats(dims, T, W, cs)
            if smem <= kernels.SMEM_LIMIT_BYTES:
                out.append(ResidentLayout(log2_tile, W, cs, smem))
    return out


def _stage_chains(data, dev: ResidentLayout) -> bool:
    """Should a launch stage its chains' matrices in shared memory rather
    than read them from device memory (``dev``, the same tile and warps)?
    Yes where the stage constants every phase reads each iteration (RT,
    HBT, MT: 2 N (n + p)^2 floats, the chains' matrices among them) do not
    fit the L1 cache that ``dev``'s blocks leave an SM. The rule fits the
    sweep at 16 warps (``chip_smoke.py --sweep stagewise``, H100 80GB HBM3,
    700 W, ms at B1024): n8 N60 (123 KB) read device memory faster at 1, 2
    and 4 scenarios a block (162-230 KB of L1 left; 13.82 against 14.64 at
    2), staged faster at 8 (63 KB left; 5.12 against 6.09); n8 N200 (410
    KB) staged faster at 2 (35.78 against 39.77), within 1.2% at 1."""
    N, n, p = data.horizon, data.n_x, data.n_u
    left = _SM_L1_SMEM_BYTES - blocks_per_sm(dev.smem, dev.warps) * (
        dev.smem + _BLOCK_RESERVED_BYTES)
    return 4 * 2 * N * (n + p) ** 2 > left


def resident_layout(data, B: int, sms: int, log2_tile: int | None = None,
                    warps: int | None = None,
                    chains_in_smem: bool | None = None):
    """The resident launch for B scenarios on ``sms`` SMs, or None where no
    block fits: the most warps any tile admits; of their tiles the
    narrowest whose grid still runs in one wave (a narrower tile shortens
    each stage's work), else the widest (the most scenarios an SM holds);
    at that tile the chains staged or in device memory by
    ``_stage_chains``. The arguments force a tile, a block or a placement
    (sweeps)."""
    top = min(_MAX_LOG2_TILE, max(B - 1, 0).bit_length())
    tiles = range(0, top + 1) if log2_tile is None else (log2_tile,)
    fits = [lay for log2 in tiles for lay in resident_layouts(data, log2)
            if (warps is None or lay.warps == warps)
            and (chains_in_smem is None or lay.chains_in_smem == chains_in_smem)]
    if not fits:
        return None
    W = max(lay.warps for lay in fits)

    def at(log2):  # the tile's launch, its placement picked
        lays = [lay for lay in fits if (lay.log2_tile, lay.warps) == (log2, W)]
        if len(lays) == 1:
            return lays[0]
        staged, dev = lays
        return staged if _stage_chains(data, dev) else dev

    tiles = sorted({lay.log2_tile for lay in fits if lay.warps == W})
    for log2 in tiles:
        lay = at(log2)
        if -(-B // (1 << log2)) <= sms * blocks_per_sm(lay.smem, lay.warps):
            return lay
    return at(tiles[-1])


def stagewise_fits_smem(data, tile: int) -> bool:
    """Does a block of the resident kernel with ``tile`` scenarios (all of
    their state in shared memory) fit one block's shared memory, in any of
    its launches? The same carve-up as the launch, so routing and launch
    agree."""
    return bool(resident_layouts(data, tile.bit_length() - 1))


def blocks_per_sm(smem_bytes: int, warps: int = _WARPS) -> int:
    """Blocks of ``warps`` warps with ``smem_bytes`` of shared memory each
    that an SM holds at once."""
    return min(_SM_WARPS // warps,
               _SM_SMEM_BYTES // (smem_bytes + _BLOCK_RESERVED_BYTES))


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def resident_preferred(data, B: int, sms: int) -> bool:
    """Should a batch of B that both kernels take ride the resident kernel?
    Yes where its tile could stage the chains in shared memory and its
    launch either runs the grid in one wave or holds 8 scenarios a block
    (every lane of a chain warp carrying two chains at n <= 8). Measured
    on an H100 80GB HBM3 at 700 W (``chip_smoke.py --sweep stagewise``,
    both kernels at their picks, x 100, PERF.md section 6): the resident
    kernel won at n8 N60 B256 (one wave), B1024 and B4096 (8 a block), and
    at n8 N200 B256 (one wave); the streamed one at n8 N200 B1024 and B4096
    (2 a block over 4 and 16 waves) and at n24 N60 B256, B1024 and B4096
    (no tile stages its chains)."""
    lay = resident_layout(data, B, sms)
    staged = any(l.chains_in_smem and l.warps == lay.warps
                 for l in resident_layouts(data, lay.log2_tile))
    one_wave = -(-B // (1 << lay.log2_tile)) <= sms * blocks_per_sm(
        lay.smem, lay.warps)
    return staged and (one_wave or lay.log2_tile == _MAX_LOG2_TILE)


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


def segment_bounds(N: int, warps: int) -> list:
    """The resident kernel's stage runs: warp w owns [w N / W, (w + 1) N /
    W) in every phase and one segment of each chain (empty where N < W)."""
    return [(w * N // warps, (w + 1) * N // warps) for w in range(warps)]


def segment_products(mats, N: int, warps: int, backward: bool) -> dict:
    """Each segment's product of step matrices in the row-vector form of
    ``chain_segmented`` (v_end = l + v_entry @ Q), for the segments whose
    entry is carried: backward, steps k < min(k1, N - 1) of every segment
    but the last, Q = mats[k1 - 1] @ ... @ mats[k0]; forward, every
    segment but the one from x0, Q = mats[k0] @ ... @ mats[k1 - 1]."""
    out = {}
    for j, (k0, k1) in enumerate(segment_bounds(N, warps)):
        if k0 == k1 or (k1 == N if backward else k0 == 0):
            continue
        steps = range(min(k1, N - 1) - 1, k0 - 1, -1) if backward \
            else range(k0, k1)
        Q = None
        for k in steps:
            Q = mats[k] if Q is None else Q @ mats[k]
        out[j] = Q
    return out


def chain_segmented(a, mats, warps: int | None = None, backward: bool = True,
                    entry=None):
    """One chain of the stage-wise iteration on ``a`` (B, N, n) in place:
    backward v_k = a_k + v_{k+1} @ mats[k] for k = N-2..0 from v_{N-1} =
    a_{N-1} (CB, mats[k] = R'_{k+1}'s E' block); forward v_k = a_k +
    v_{k-1} @ mats[k] for k = 0..N-1 from v_{-1} = ``entry`` (CF, mats[k] =
    M'_k's E block). With ``warps`` it runs as the resident kernel does:
    each warp's segment from a zero entry (the one whose entry is known
    from it), the entries carried across the segments through
    ``segment_products``, then each segment again from its entry."""
    N = a.shape[1]
    if warps is None:
        if backward:
            for k in range(N - 2, -1, -1):
                a[:, k] = a[:, k] + a[:, k + 1] @ mats[k]
        else:
            x = entry
            for k in range(N):
                x = a[:, k] + x @ mats[k]
                a[:, k] = x
        return a
    bounds = segment_bounds(N, warps)
    Q = segment_products(mats, N, warps, backward)

    def steps(k0, k1):
        return range(min(k1, N - 1) - 1, k0 - 1, -1) if backward \
            else range(k0, k1)

    def run(k0, k1, v, store):
        for k in steps(k0, k1):
            v = a[:, k] + v @ mats[k]
            if store:
                a[:, k] = v
        return v

    ends = {}  # pass 1: each segment's last value
    for j, (k0, k1) in enumerate(bounds):
        if k0 < k1:
            known = k1 == N if backward else k0 == 0
            v0 = (a[:, N - 1] if backward else entry) if known \
                else torch.zeros_like(a[:, 0])
            ends[j] = run(k0, k1, v0, known)
    order = range(warps - 1, -1, -1) if backward else range(warps)
    e = None  # passes 2 and 3: carry each entry, rerun the segment from it
    for j in order:
        if j not in ends:
            continue
        if j in Q:
            k0, k1 = bounds[j]
            run(k0, k1, e, True)
            e = ends[j] + e @ Q[j]
        else:
            e = ends[j]
    return a


def stagewise_plain(pack: StagewisePack, x0, y0=None, *, iterations: int,
                    restart: bool = False, warps: int | None = None):
    """The kernels' function in torch ops, on any device, phase for phase
    (see ``csrc/gpad_stagewise.cu``): returns (u0, zu, y, residual, gap) as
    the wrappers do. ``x0`` (B, n); ``y0`` broadcastable to (B, N, m).
    It computes in ``x0``'s dtype: float32 as the kernels do, or float64
    (with a float64 pack) as a referee for decisions float32 rounding may
    flip. ``warps`` runs the two chains segmented over that many warps, as
    the resident kernel does (``chain_segmented``); None runs them stage
    after stage."""
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
    e_cb = pack.RT[1:, :n]  # CB's step k: the E' block of R'_{k+1}
    e_cf = pack.MT[:, :n, :n]  # CF's step k: the E block of M'_k
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
        chain_segmented(st, e_cb, warps, backward=True)
        # P3: kff = HB [st + dtl; ru], d = M [0; kff]_top + c
        kff = colT(pack.HBT, torch.cat([st + dtl, ru], dim=-1))
        d = c + colT(pack.MT[:, n:, :n], kff)
        # CF: x_{k+1} = M_k [x_k; 0]_top + d_k, over d
        xs = chain_segmented(d, e_cf, warps, backward=False, entry=x0)
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
    # warps, chains_in_smem, qscratch, then the outputs
    resident.argtypes = head + [I, I] + [P] * 5 + [I, P]
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


def launch_head(pack: StagewisePack, x0, y0, iterations: int, restart: bool,
                log2_tile: int):
    """The arguments both C launchers share, in order."""
    ptr = kernels._ptr
    y0_stride = 0 if y0 is None or y0.shape[0] == 1 else pack.N * pack.m
    return (ptr(pack.RT), ptr(pack.HBT), ptr(pack.MT), ptr(pack.Gx),
            ptr(pack.Gu), ptr(pack.h), ptr(pack.V), ptr(pack.theta),
            ptr(pack.beta), ptr(pack.L), ptr(x0), ptr(y0), y0_stride,
            x0.shape[0], pack.N, pack.n, pack.p, pack.m_x,
            pack.m - pack.m_x, iterations, int(restart), log2_tile)


def _outputs(pack: StagewisePack, x0):
    """Empty (zu, y, residual, gap) of a launch."""
    B, f32 = x0.shape[0], dict(dtype=torch.float32, device=x0.device)
    return (torch.empty((B, pack.N, pack.p), **f32),
            torch.empty((B, pack.N, pack.m), **f32),
            torch.empty((B,), **f32), torch.empty((B,), **f32))


def plain_op(pack: StagewisePack, x0, y0, iterations: int, restart: bool):
    """The CPU implementation of both kernels' ops: ``stagewise_plain``'s
    (zu, y, residual, gap), none an alias of an input."""
    _, zu, y, residual, gap = stagewise_plain(pack, x0, y0,
                                              iterations=iterations,
                                              restart=restart)
    return kernels._fresh((zu, y, residual, gap), (x0, y0))


# The resident kernel as the op tpu_gpad_torch::stagewise_resident (see the
# note above kernels._register): the CPU implementation is the plain
# version; the CUDA one launches the layout the wrapper picked and counts.
def _resident_cpu(RT: Tensor, HBT: Tensor, MT: Tensor, Gx: Tensor, Gu: Tensor,
                  h: Tensor, V: Tensor, theta: Tensor, beta: Tensor, L: Tensor,
                  x0: Tensor, y0: Optional[Tensor], iterations: int,
                  restart: bool, log2_tile: int, warps: int,
                  chains_in_smem: bool, smem: int,
                  ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    pack = StagewisePack(RT, HBT, MT, Gx, Gu, h, V, theta, beta, L)
    return plain_op(pack, x0, y0, iterations, restart)


def _resident_cuda(RT, HBT, MT, Gx, Gu, h, V, theta, beta, L, x0, y0,
                   iterations, restart, log2_tile, warps, chains_in_smem,
                   smem):
    global STAGEWISE_LAUNCHES
    pack = StagewisePack(RT, HBT, MT, Gx, Gu, h, V, theta, beta, L)
    zu, y, residual, gap = _outputs(pack, x0)
    # the segment products of both chains, per block, where they are not
    # in shared memory
    B, n = x0.shape[0], pack.n
    qscratch = None if chains_in_smem else torch.empty(
        (-(-B // (1 << log2_tile)) * _up4(2 * warps * n * n),),
        dtype=torch.float32, device=x0.device)
    resident, _ = _launch_fns()
    ptr = kernels._ptr
    kernels._launch("gpad_stagewise", resident, x0.device,
                    *launch_head(pack, x0, y0, iterations, restart,
                                 log2_tile),
                    warps, int(chains_in_smem), ptr(qscratch), ptr(y),
                    ptr(zu), ptr(residual), ptr(gap), smem)
    STAGEWISE_LAUNCHES += 1
    return zu, y, residual, gap


def fake_outputs(RT, HBT, MT, Gx, Gu, h, V, theta, beta, L, x0, *_):
    """Both stage-wise ops' fake implementation: the outputs' shapes."""
    return _outputs(StagewisePack(RT, HBT, MT, Gx, Gu, h, V, theta, beta, L),
                    x0)


resident_op = kernels._register("stagewise_resident", _resident_cpu,
                                _resident_cuda, fake_outputs)


def pack_args(pack: StagewisePack) -> tuple:
    """A pack's tensors in the ops' argument order."""
    return (pack.RT, pack.HBT, pack.MT, pack.Gx, pack.Gu, pack.h, pack.V,
            pack.theta, pack.beta, pack.L)


def solve_stagewise_cuda(data, x0, iterations: int, restart: bool = False,
                         y0=None, log2_tile: int | None = None,
                         warps: int | None = None,
                         chains_in_smem: bool | None = None):
    """Fixed-budget stage-wise GPAD for a batch on the resident kernel.

    ``x0`` (B, n_x), optional warm start ``y0`` (B, N, m_x + m_u), or one
    (N, m_x + m_u) dual shared by every scenario. Returns (u0 (B, n_u),
    zu (B, N, n_u), y (B, N, m_x + m_u), residual (B,), gap (B,)), the
    contract of ``tpu_gpad.stagewise_kernel.solve_stagewise_pallas``.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``stagewise_plain`` (the op ``tpu_gpad_torch::stagewise_resident``).
    ``log2_tile``, ``warps`` and ``chains_in_smem`` force the launch
    (sweeps); else ``resident_layout`` picks it."""
    y0 = check_inputs(data, x0, y0, iterations, restart)
    pack = pack_stagewise_constants(data)
    lay = ResidentLayout(0, 0, False, 0)
    if on_card(x0):
        ok, why = stagewise_kernel_compatible(data)
        if not ok:
            raise ValueError(f"stagewise kernel cannot take this: {why}")
        lay = resident_layout(data, x0.shape[0], sm_count(x0.device),
                              log2_tile, warps, chains_in_smem)
        if lay is None:
            raise ValueError(f"no resident block of tile 2**{log2_tile}, "
                             f"{warps} warps, chains_in_smem={chains_in_smem} "
                             "fits shared memory")
    zu, y, residual, gap = resident_op(
        *pack_args(pack), x0, y0, iterations, restart, lay.log2_tile,
        lay.warps, lay.chains_in_smem, lay.smem)
    return zu[:, 0].contiguous(), zu, y, residual, gap
