"""The streamed stage-wise GPAD kernel (CUDA C++ for Hopper).

``solve_stagewise_stream`` runs a whole fixed-budget stage-wise solve in one
launch of ``gpad_stagewise_stream_kernel`` (``csrc/gpad_stagewise.cu``), the
counterpart of ``tpu_gpad.stagewise_stream.solve_stagewise_stream``: for
shapes whose dual state is too large for shared memory (battery n30 N200:
about 195 KB of y and y_prev per scenario). The dual iterates y and y_prev
live in device memory, two slabs updated in place (stage k alone touches its
rows in the forward pass, so the TPU kernel's three-slot HBM rotation is not
needed); the slope, plan and feedforward slabs stay in shared memory where
that costs no occupancy, else in device memory too. Same contract as the
resident kernel's wrapper, same plain version
(``stagewise_kernel.stagewise_plain``) on CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from tpu_gpad_torch import stagewise_kernel as sk
from tpu_gpad_torch.solver import kernels

# Launches of the streamed kernel in this process; a run resets it to 0 to
# show that a path went through the kernel.
STAGEWISE_STREAM_LAUNCHES = 0


def stream_layout(data, B: int, sms: int, log2_tile: int | None = None):
    """(log2_tile, aux_in_smem, smem_bytes) of a launch for B scenarios on
    ``sms`` SMs. The tile is the widest (at most 8) that still gives every
    SM a block: a wider tile reads each stage's constants once for more
    scenarios, but a grid short of the SMs leaves some idle. The slope/plan/
    feedforward slabs go to shared memory where the grid still runs in one
    wave with them (two blocks on an SM, or one where the grid has no more
    blocks than SMs); else to device memory (PERF.md, stage-wise tile sweep
    on an H100 80GB HBM3 at 700 W, n30 N200 B1024 x 200: 4 per block 340 ms,
    2 per block 577 ms, 1 per block with the slabs in shared memory 958
    ms)."""
    if log2_tile is None:
        log2_tile = sk._MAX_LOG2_TILE
        while log2_tile > 0 and -(-B // (1 << log2_tile)) < sms:
            log2_tile -= 1
    T = 1 << log2_tile
    smem = sk._smem_bytes(data, T, True)
    if smem <= kernels.SMEM_LIMIT_BYTES and (
            sk.blocks_per_sm(smem) == sk._MAX_BLOCKS_PER_SM
            or -(-B // T) <= sms * sk.blocks_per_sm(smem)):
        return log2_tile, True, smem
    return log2_tile, False, sk._smem_bytes(data, T, False)


def stagewise_stream_compatible(data) -> tuple:
    """(ok, reason): can this ``StagewiseData`` ride the streamed kernel?"""
    ok, why = sk._shape_ok(data)
    if not ok:
        return ok, why
    if sk._smem_bytes(data, 1, False) > kernels.SMEM_LIMIT_BYTES:
        return False, "the constraint blocks exceed a block's shared memory"
    return True, ""


# The streamed kernel as the op tpu_gpad_torch::stagewise_stream (see the
# note above kernels._register).
def _stream_cpu(RT: Tensor, HBT: Tensor, MT: Tensor, Gx: Tensor, Gu: Tensor,
                h: Tensor, V: Tensor, theta: Tensor, beta: Tensor, L: Tensor,
                x0: Tensor, y0: Optional[Tensor], iterations: int,
                restart: bool, log2_tile: int, aux_in_smem: bool, smem: int,
                aux_floats: int, dual_floats: int,
                ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    pack = sk.StagewisePack(RT, HBT, MT, Gx, Gu, h, V, theta, beta, L)
    return sk.plain_op(pack, x0, y0, iterations, restart)


def _stream_cuda(RT, HBT, MT, Gx, Gu, h, V, theta, beta, L, x0, y0,
                 iterations, restart, log2_tile, aux_in_smem, smem,
                 aux_floats, dual_floats):
    global STAGEWISE_STREAM_LAUNCHES
    pack = sk.StagewisePack(RT, HBT, MT, Gx, Gu, h, V, theta, beta, L)
    N, n = pack.N, pack.n
    T = 1 << log2_tile
    blocks = -(-x0.shape[0] // T)
    f32 = dict(dtype=torch.float32, device=x0.device)
    # the kernel's own work layout: one region per block of T scenarios
    y_work = torch.empty((blocks * dual_floats,), **f32)
    yp_work = torch.empty((blocks * dual_floats,), **f32)
    aux = None if aux_in_smem else torch.empty((blocks * aux_floats,), **f32)
    zu, y, residual, gap = sk._outputs(pack, x0)
    # the chains' matrices, rows padded to 128 bytes for the bulk copies:
    # [0][k] the E' rows of R'_{k+1}, [1][k] the E rows of M'_k
    chain_e = torch.zeros((2, N, n, 32), **f32)
    chain_e[0, :N - 1, :, :n] = RT[1:, :n]
    chain_e[1, :, :, :n] = MT[:, :n, :n]
    _, stream_fn = sk._launch_fns()
    ptr = kernels._ptr
    kernels._launch("gpad_stagewise_stream", stream_fn, x0.device,
                    ptr(chain_e),
                    *sk.launch_head(pack, x0, y0, iterations, restart,
                                    log2_tile),
                    ptr(y_work), ptr(yp_work), ptr(aux), ptr(y), ptr(zu),
                    ptr(residual), ptr(gap), smem)
    STAGEWISE_STREAM_LAUNCHES += 1
    return zu, y, residual, gap


stream_op = kernels._register("stagewise_stream", _stream_cpu, _stream_cuda,
                              sk.fake_outputs)


def solve_stagewise_stream(data, x0, iterations: int, restart: bool = False,
                           y0=None, log2_tile: int | None = None):
    """Fixed-budget stage-wise GPAD for a batch on the streamed kernel; the
    contract of ``stagewise_kernel.solve_stagewise_cuda``: returns (u0, zu,
    y, residual, gap). CUDA tensors launch the kernel (or raise); CPU
    tensors run ``stagewise_kernel.stagewise_plain`` (the op
    ``tpu_gpad_torch::stagewise_stream``)."""
    y0 = sk.check_inputs(data, x0, y0, iterations, restart)
    pack = sk.pack_stagewise_constants(data)
    layout = (0, False, 0, 0, 0)
    if sk.on_card(x0):
        ok, why = stagewise_stream_compatible(data)
        if not ok:
            raise ValueError(f"stagewise stream kernel cannot take this: {why}")
        log2_tile, aux_in_smem, smem = stream_layout(
            data, x0.shape[0], sk.sm_count(x0.device), log2_tile)
        if smem > kernels.SMEM_LIMIT_BYTES:
            raise ValueError(f"tile 2**{log2_tile} needs {smem} bytes of "
                             "shared memory")
        # the kernel's work regions, per block
        _, aux_floats, dual_floats = sk._smem_floats(data, 1 << log2_tile)
        layout = (log2_tile, aux_in_smem, smem, aux_floats, dual_floats)
    zu, y, residual, gap = stream_op(*sk.pack_args(pack), x0, y0, iterations,
                                     restart, *layout)
    return zu[:, 0].contiguous(), zu, y, residual, gap
