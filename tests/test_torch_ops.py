"""The eleven kernel launchers as registered ops (``tpu_gpad_torch::*``), on
the CPU, where each op's implementation is its kernel's plain version:
``torch.library.opcheck`` of each op with the arguments its public wrapper
passes, an export round trip of each wrapper whose graph holds the op, and
the wrappers' diagnostics-off contract (w and zhat None)."""

import io

import numpy as np
import pytest
import torch

import tpu_gpad_torch as tg
from tpu_gpad_torch import stagewise_kernel as sk
from tpu_gpad_torch import stagewise_stream as ss
from tpu_gpad_torch.solver import core, dual_kernels, kernels

torch.set_num_threads(2)

ITERS = 6


@pytest.fixture(scope="module")
def inputs():
    """Small condensed data (paired with D, and dense), stage-wise data and
    seeded states, all on the CPU."""
    qp = tg.condense(tg.problems.battery(n_cells=3, horizon=4))
    paired = tg.dualize(qp, ITERS, paired="auto", device="cpu")
    dense = tg.dualize(qp, ITERS, paired=False, device="cpu")
    sw = tg.build_stagewise(tg.problems.battery(n_cells=3, horizon=5),
                            iterations=ITERS, device="cpu")
    rng = np.random.default_rng(3)
    X0 = torch.as_tensor(rng.uniform(-0.4, 0.4, (5, 3)).astype(np.float32))
    g_P, p_D = core.affine_params(paired, X0)
    gd, pd = core.affine_params(dense, X0)
    y0 = torch.as_tensor(rng.uniform(0, 0.3, (5, 2, paired.m_half)),
                         dtype=torch.float32)
    c = dual_kernels.relu_offsets(paired, g_P, p_D)
    state = (y0, (0.5 * y0).contiguous(),
             torch.as_tensor(rng.uniform(-0.1, 0.1, (5, paired.m_half)),
                             dtype=torch.float32),
             torch.as_tensor(rng.uniform(0.5, 1.0, (5, 2)),
                             dtype=torch.float32))
    return dict(paired=paired, dense=dense, sw=sw, X0=X0, g_P=g_P, p_D=p_D,
                gd=gd, pd=pd, y0=y0, c=c, state=state)


# op name -> (module, the op's attribute, a call of its public wrapper)
CASES = {
    "paired_flat": (kernels, "paired_flat_op", lambda i: kernels.
                    gpad_fixed_paired_flat(i["paired"], i["g_P"], i["p_D"],
                                           i["y0"], iterations=ITERS)),
    "paired": (kernels, "paired_op", lambda i: kernels.gpad_fixed_paired(
        i["paired"], i["g_P"], i["p_D"], iterations=ITERS)),
    "flat_tiled": (kernels, "flat_tiled_op", lambda i: kernels.
                   gpad_fixed_flat_tiled(i["paired"], i["g_P"], i["p_D"],
                                         i["y0"][:1], iterations=ITERS)),
    "dense": (kernels, "dense_op", lambda i: kernels.gpad_fixed_dense(
        i["dense"], i["gd"], i["pd"], iterations=ITERS)),
    "dense_tiled": (kernels, "dense_tiled_op", lambda i: kernels.
                    gpad_fixed_dense_tiled(i["dense"], i["gd"], i["pd"],
                                           0.5 * i["pd"][:1].abs(),
                                           iterations=ITERS)),
    "dual": (dual_kernels, "dual_op", lambda i: dual_kernels.gpad_fixed_dual(
        i["paired"], i["g_P"], i["p_D"], i["y0"], iterations=ITERS,
        restart=True)),
    "dual_tiled": (dual_kernels, "dual_tiled_op", lambda i: dual_kernels.
                   gpad_fixed_dual_tiled(i["paired"], i["g_P"], i["p_D"],
                                         iterations=ITERS)),
    "dual_chunk": (dual_kernels, "dual_chunk_op", lambda i: dual_kernels.
                   gpad_dual_chunk(i["paired"], i["c"], *i["state"], k0=2,
                                   chunk=3)),
    "dual_tiled_chunk": (dual_kernels, "dual_tiled_chunk_op", lambda i:
                         dual_kernels.gpad_dual_tiled_chunk(
                             i["paired"], i["c"], *i["state"], k0=1, chunk=4,
                             restart=True)),
    "stagewise_resident": (sk, "resident_op", lambda i: sk.
                           solve_stagewise_cuda(i["sw"], i["X0"], ITERS)),
    "stagewise_stream": (ss, "stream_op", lambda i: ss.solve_stagewise_stream(
        i["sw"], i["X0"], ITERS, restart=True)),
}


def _recorded(monkeypatch, name, i):
    """The wrapper's result and the arguments it passed its op."""
    module, attr, call = CASES[name]
    op, seen = getattr(module, attr), []

    def record(*args):
        seen.append(args)
        return op(*args)

    monkeypatch.setattr(module, attr, record)
    out = call(i)
    monkeypatch.undo()
    assert len(seen) == 1, name
    return op, seen[0], out


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck(monkeypatch, inputs, name):
    """Schema, fake implementation, and the op under AOT dispatch with
    static and dynamic shapes, on the arguments its wrapper passes."""
    op, args, _ = _recorded(monkeypatch, name, inputs)
    assert op._qualname == f"tpu_gpad_torch::{name}"
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_exports_through_its_op(inputs, name):
    """torch.export of the public wrapper on CPU tensors: the graph calls
    ``torch.ops.tpu_gpad_torch.<name>``, and the saved and loaded program
    gives the eager wrapper's outputs exactly."""
    _, _, call = CASES[name]

    class Wrapper(torch.nn.Module):
        def forward(self, x0):
            i = dict(inputs, X0=x0)
            i["g_P"], i["p_D"] = core.affine_params(inputs["paired"], x0)
            i["gd"], i["pd"] = core.affine_params(inputs["dense"], x0)
            return tuple(t for t in call(i) if t is not None)

    x0 = inputs["X0"]
    program = torch.export.export(Wrapper(), (x0,))
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert f"tpu_gpad_torch.{name}.default" in targets, targets
    buf = io.BytesIO()
    torch.export.save(program, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue())).module()
    eager = Wrapper()(x0)
    for a, b in zip(loaded(x0), eager, strict=True):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("name", ["paired_flat", "paired", "flat_tiled",
                                  "paired_tiled", "dense", "dense_tiled",
                                  "dual", "dual_tiled"])
def test_diagnostics_off_returns_none(inputs, name):
    """Without diagnostics an op returns empty placeholders for w and zhat;
    the wrapper hands back None for both, and z and y as with them."""
    i = inputs
    dense = name.startswith("dense")
    data = i["dense"] if dense else i["paired"]
    g_P, p_D = (i["gd"], i["pd"]) if dense else (i["g_P"], i["p_D"])
    fn = {"paired_flat": kernels.gpad_fixed_paired_flat,
          "paired": kernels.gpad_fixed_paired,
          "flat_tiled": kernels.gpad_fixed_flat_tiled,
          "paired_tiled": kernels.gpad_fixed_paired_tiled,
          "dense": kernels.gpad_fixed_dense,
          "dense_tiled": kernels.gpad_fixed_dense_tiled,
          "dual": dual_kernels.gpad_fixed_dual,
          "dual_tiled": dual_kernels.gpad_fixed_dual_tiled}[name]
    z, y, w, zhat = fn(data, g_P, p_D, iterations=ITERS, diagnostics=False)
    assert w is None and zhat is None
    z_d, y_d, w_d, zhat_d = fn(data, g_P, p_D, iterations=ITERS)
    assert w_d.shape == y.shape and zhat_d.shape == z.shape
    assert torch.equal(z, z_d) and torch.equal(y, y_d)


def test_ops_never_run_the_plain_version_on_another_device(inputs):
    """The ops have a CPU implementation (the plain version) and a CUDA one
    (the kernel) and nothing else: a tensor on any other device raises in
    the wrapper, before any op runs."""
    meta = inputs["g_P"].to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.on_card(meta)
