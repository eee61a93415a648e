"""The stage-wise kernels' packing, shared-memory guard and plain version on
the CPU: the packed algebra against ``tpu_gpad.stagewise_kernel.
pack_stagewise_constants``, and the wrappers (which run the plain version
on CPU tensors) against the TPU kernels in interpret mode,
``solve_stagewise_pallas`` and ``solve_stagewise_stream`` (after
tests/test_stagewise_kernel.py and tests/test_stagewise_stream.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gpad import problems as jp
from tpu_gpad import stagewise as js
from tpu_gpad.stagewise_kernel import pack_stagewise_constants as jax_pack
from tpu_gpad.stagewise_kernel import solve_stagewise_pallas
from tpu_gpad.stagewise_stream import solve_stagewise_stream as jax_stream

from tpu_gpad_torch import problems as tp
from tpu_gpad_torch import stagewise as ts
from tpu_gpad_torch import stagewise_kernel as sk
from tpu_gpad_torch import stagewise_stream as ss

torch.set_num_threads(2)

ITERS = 40
TOL = 1e-5  # plain version vs interpret-mode kernel, fixed budget
RESTART_TOL = 5e-5  # u and z under restart: tpu_gpad's pallas-vs-xla bound
OUT = ("u0", "zu", "y", "residual", "gap")


def _pair(n, N, iterations=ITERS, **kw):
    d_j = js.build_stagewise(jp.battery(n, N), iterations=iterations, **kw)
    d_t = ts.build_stagewise(tp.battery(n, N), iterations=iterations,
                             device="cpu", **kw)
    return d_j, d_t


def _x0(B, n, seed=0):
    return np.random.default_rng(seed).uniform(-0.3, 0.3, (B, n)).astype(np.float32)


@pytest.mark.parametrize("n,N", [(3, 6), (8, 12)])
def test_packing_encodes_the_tpu_algebra(n, N):
    """R = [E'|-K'], HB = [HiB'|Hi], M = [[E,-B],[-K,-I]], G = diag(Gx, Gu),
    h and [dtl; qoff; c], read out of the TPU layout's padding."""
    prob_j = dataclasses.replace(jp.battery(n, N), c=np.linspace(-0.02, 0.02, n))
    prob_t = dataclasses.replace(tp.battery(n, N), c=np.linspace(-0.02, 0.02, n))
    d_j = js.build_stagewise(prob_j, iterations=ITERS)
    d_t = ts.build_stagewise(prob_t, iterations=ITERS, device="cpu")
    CP, _, G, dd = (np.asarray(a) if not isinstance(a, dict) else a
                    for a in jax_pack(d_j))
    pk = sk.pack_stagewise_constants(d_t)
    n_p, p_p, np_pp = dd["n_p"], dd["p_p"], dd["np_pp"]
    p, m_x, mx_p = dd["p"], dd["m_x"], dd["mx_p"]
    cols = np.r_[0:n, n_p:n_p + p]  # the real columns of an [n | p] block
    R = CP[:, :n, 0:np_pp][:, :, cols]
    HB = CP[:, :p, np_pp:2 * np_pp][:, :, cols]
    M = CP[:, :, 2 * np_pp:3 * np_pp][:, cols][:, :, cols]
    off = 3 * np_pp + dd["n_hcols"]
    V = CP[:, :n, off:off + 3].transpose(0, 2, 1)
    h = CP[:, :, 3 * np_pp:off].transpose(0, 2, 1).reshape(N, -1)
    h = h[:, np.r_[0:m_x, mx_p:mx_p + dd["m_u"]]]
    tr = lambda a: a.numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(tr(pk.RT), R)
    np.testing.assert_allclose(tr(pk.HBT), HB, atol=1e-7, rtol=1e-6)
    np.testing.assert_array_equal(tr(pk.MT), M)
    np.testing.assert_array_equal(pk.V.numpy(), V)
    np.testing.assert_array_equal(pk.h.numpy(), h)
    Gd = G[np.r_[0:m_x, mx_p:mx_p + dd["m_u"]]][:, cols]
    np.testing.assert_array_equal(Gd[:m_x, :n], pk.Gx.numpy())
    np.testing.assert_array_equal(Gd[m_x:, n:], pk.Gu.numpy())
    assert not Gd[:m_x, n:].any() and not Gd[m_x:, :n].any()


def _warm(d_j, X0):
    return np.asarray(js.solve_stagewise(d_j, jnp.asarray(X0 * 0.8),
                                         iterations=ITERS, engine="xla",
                                         scan="sequential").y)


@pytest.mark.parametrize("kernel", ["resident", "stream"])
@pytest.mark.parametrize("n,N", [(3, 6), (8, 12)])
@pytest.mark.parametrize("variant", ["cold", "warm", "restart"])
def test_plain_matches_interpret_kernel(kernel, n, N, variant):
    d_j, d_t = _pair(n, N)
    X0 = _x0(4, n, seed=n)
    y0 = _warm(d_j, X0) if variant == "warm" else None
    restart = variant == "restart"
    jax_fn = solve_stagewise_pallas if kernel == "resident" else jax_stream
    out_j = jax_fn(d_j, jnp.asarray(X0), iterations=ITERS, restart=restart,
                   interpret=True, y0=None if y0 is None else jnp.asarray(y0))
    wrapper = (sk.solve_stagewise_cuda if kernel == "resident"
               else ss.solve_stagewise_stream)
    before = (sk.STAGEWISE_LAUNCHES, ss.STAGEWISE_STREAM_LAUNCHES)
    out_t = wrapper(d_t, torch.as_tensor(X0), ITERS, restart=restart,
                    y0=None if y0 is None else torch.as_tensor(y0))
    # CPU tensors run the plain version: no launch is counted
    assert (sk.STAGEWISE_LAUNCHES, ss.STAGEWISE_STREAM_LAUNCHES) == before
    names = OUT[:2] if restart else OUT
    for name, a, b in zip(OUT, out_j, out_t):
        assert tuple(a.shape) == tuple(b.shape), name
        if name in names:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=RESTART_TOL if restart else TOL,
                                       err_msg=name)


def test_plain_matches_interpret_kernel_with_offsets_and_reference():
    """The packed [dtl | qoff | c] columns: affine dynamics and a fixed
    tracking reference."""
    prob = dataclasses.replace(jp.battery(3, 7), c=np.array([0.02, -0.01, 0.015]))
    d_j = js.build_stagewise(prob, iterations=ITERS, x_ref=np.full(3, 0.05))
    d_t = ts.build_stagewise(
        dataclasses.replace(tp.battery(3, 7), c=np.array([0.02, -0.01, 0.015])),
        iterations=ITERS, x_ref=np.full(3, 0.05), device="cpu")
    X0 = _x0(4, 3, seed=13)
    out_j = solve_stagewise_pallas(d_j, jnp.asarray(X0), iterations=ITERS,
                                   interpret=True)
    out_t = sk.solve_stagewise_cuda(d_t, torch.as_tensor(X0), ITERS)
    for name, a, b in zip(OUT, out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=0,
                                   err_msg=name)


def test_shared_memory_guard():
    d8 = ts.build_stagewise(tp.battery(8, 60), iterations=5, L=1.0, device="cpu")
    d30 = ts.build_stagewise(tp.battery(30, 200), iterations=5, L=1.0,
                             device="cpu")
    # the streamed kernel's carve-up of csrc/gpad_stagewise.cu by hand, in
    # floats, for n8 N60 at a tile of 8: G blocks with odd row strides
    # (16 x 9, 18 x 9 -> 164), x0 (8 x 8), a scratch block of 34 rows x 8
    # per warp, two per-warp partials and 3 momentum words per scenario;
    # then the st, zu, ru, kff slabs (60 x 8 x 8 each) and y (60 x 34 x 8)
    shared = 144 + 164 + 64 + 8 * 34 * 8 + 2 * 8 * 8 + 3 * 8
    assert sk._smem_floats(d8, 8) == (shared, 4 * 60 * 8 * 8, 60 * 34 * 8)
    # n30 N200, T = 2, the streamed kernel: its chains' ring adds 16
    # mbarrier words (4 x 8), 8 slots of 32 x 32 and 8 addend rows of 32
    # per chain warp
    assert sk._smem_bytes(d30, 2, True) == 215344 + 4 * (
        32 + 8 * 32 * 32 + 8 * 32 * 2)
    # the resident kernel (test_torch_stagewise_resident.py has its
    # carve-up): 8 scenarios per block fit, 16 do not; one block of 16
    # warps per SM at n8 N60
    assert sk.stagewise_fits_smem(d8, 8) and not sk.stagewise_fits_smem(d8, 16)
    lay = sk.resident_layout(d8, 4096, 132)
    assert (lay.log2_tile, lay.warps, lay.chains_in_smem) == (3, 16, True)
    assert sk.blocks_per_sm(lay.smem, lay.warps) == 1
    assert sk.resident_layout(d8, 3, 132).log2_tile == 0
    assert sk.resident_layout(d8, 1, 132).log2_tile == 0
    assert not sk.stagewise_fits_smem(d30, 1)
    assert sk.stagewise_kernel_compatible(d8) == (True, "")
    assert not sk.stagewise_kernel_compatible(d30)[0]
    assert ss.stagewise_stream_compatible(d30) == (True, "")
    # n30 N200 B1024 on 132 SMs: 4 scenarios per block (8 would leave SMs
    # idle), the slope/plan slabs in device memory, two blocks per SM
    log2, aux_smem, smem = ss.stream_layout(d30, 1024, 132)
    assert (log2, aux_smem) == (2, False) and sk.blocks_per_sm(smem) == 2
    # 64 plants: one scenario per block, whose slabs and ring (146 KB) take
    # one block per SM, the grid still one wave; two scenarios' would not
    # fit a block
    assert ss.stream_layout(d30, 64, 132)[:2] == (0, True)
    assert sk.blocks_per_sm(sk._smem_bytes(d30, 1, True)) == 1
    assert ss.stream_layout(d30, 256, 132)[:2] == (0, False)  # two waves
    assert sk._smem_bytes(d30, 2, True) > 227 * 1024
    # n8 N60 B4096: the streamed kernel takes 8 scenarios per block, slabs
    # in shared memory, two blocks per SM; the resident kernel is
    # preferred at every batch (measured at B256, B1024, B4096)
    log2, aux_smem, smem = ss.stream_layout(d8, 4096, 132)
    assert (log2, aux_smem, sk.blocks_per_sm(smem)) == (3, True, 2)
    for B in (64, 1024, 4096):
        assert sk.resident_preferred(d8, B, 132)
    assert ss.stream_layout(d30, 1024, 132, 3)[1] is False  # forced tile


def test_wrapper_checks_its_inputs():
    _, d_t = _pair(3, 6)
    X0 = torch.as_tensor(_x0(2, 3))
    for fn in (sk.solve_stagewise_cuda, ss.solve_stagewise_stream):
        with pytest.raises(ValueError, match="x0 must be"):
            fn(d_t, X0[:, :2], ITERS)
        with pytest.raises(ValueError, match="schedule"):
            fn(d_t, X0, ITERS + 1)
        with pytest.raises(ValueError, match="does not broadcast"):
            fn(d_t, X0, ITERS, y0=torch.zeros((3, 6, 1)))
        with pytest.raises(ValueError, match="float32"):
            fn(d_t, X0.double(), ITERS)
    no_u = dataclasses.replace(d_t, Gu=d_t.Gu[:0], hu=d_t.hu[:, :0])
    assert not sk.stagewise_kernel_compatible(no_u)[0]
    assert not ss.stagewise_stream_compatible(no_u)[0]
