"""Port parity: ``tpu_gpad_torch`` condense + dualize against ``tpu_gpad``.

The host algebra is the same float64 NumPy, so the emitted float32
operands must agree bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp

import tpu_gpad_torch
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch.convert import gpad_data_from_numpy, solve_result_to_numpy
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)


def _rate(pkg):
    base = pkg.problems.battery(n_cells=3, horizon=6)
    return dataclasses.replace(
        base, du_min=np.full(3, -0.1), du_max=np.full(3, 0.1)
    )


# (name, problem builder taking the package, condense kwargs)
CASES = [
    ("battery_n3_N10", lambda pkg: pkg.problems.battery(3, 10), {}),
    ("battery_n5_N20", lambda pkg: pkg.problems.battery(5, 20), {}),
    ("double_integrator", lambda pkg: pkg.problems.double_integrator(horizon=8), {}),
    ("mass_spring", lambda pkg: pkg.problems.mass_spring(n_masses=3, horizon=6), {}),
    ("random_lti", lambda pkg: pkg.problems.random_lti(seed=3, coupled=True), {}),
    ("tracking", lambda pkg: pkg.problems.battery(3, 6), {"tracking": True}),
    ("soft_state", lambda pkg: pkg.problems.mass_spring(n_masses=2, horizon=5),
     {"soft_state": 50.0}),
    ("rate_limited", _rate, {}),
]


def _fields(data):
    return {
        name: None if getattr(data, name) is None else np.asarray(getattr(data, name))
        for name in GPAD_TENSOR_FIELDS
    }


@pytest.mark.parametrize("name,build,kw", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("paired", ["auto", False])
def test_condense_dualize_bit_exact(name, build, kw, paired):
    qp_j = tpu_gpad.condense(build(tpu_gpad), **kw)
    qp_t = tpu_gpad_torch.condense(build(tpu_gpad_torch), **kw)
    for f in ("H", "F", "g", "G", "b0", "E"):
        np.testing.assert_array_equal(getattr(qp_t, f), getattr(qp_j, f))
    assert (qp_t.n_u, qp_t.n_x, qp_t.horizon, qp_t.name) == (
        qp_j.n_u, qp_j.n_x, qp_j.horizon, qp_j.name)

    d_j = tpu_gpad.dualize(qp_j, iterations=50, paired=paired)
    d_t = tpu_gpad_torch.dualize(qp_t, iterations=50, paired=paired)
    for meta in GPAD_META_FIELDS:
        assert getattr(d_t, meta) == getattr(d_j, meta), meta
    for field, ref in _fields(d_j).items():
        got = getattr(d_t, field)
        if ref is None:
            assert got is None, field
            continue
        assert got.dtype == torch.float32 and got.is_contiguous(), field
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=field)
    assert d_t.m == d_j.m and d_t.n_z == d_j.n_z and d_t.max_iters == 50
    if d_t.paired:
        assert d_t.m_half == d_j.m_half


def test_headline_layout():
    """The headline problem condenses to the kernel's flat paired layout."""
    d = tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(tp.battery(3, 10)), iterations=100, paired="auto"
    )
    assert d.paired and (d.n_z, d.m_half, d.n_struct) == (30, 70, 40)
    assert d.device.type == "cpu"


def test_gpad_data_from_numpy_round_trip():
    """JAX GPADData leaves -> the port's GPADData, bit for bit, and back."""
    d_j = tpu_gpad.dualize(
        tpu_gpad.condense(jp.battery(3, 10)), iterations=40, paired="auto"
    )
    meta = {k: getattr(d_j, k) for k in GPAD_META_FIELDS}
    d_t = gpad_data_from_numpy(_fields(d_j), meta, device="cpu")
    for field, ref in _fields(d_j).items():
        if ref is None:
            assert getattr(d_t, field) is None
        else:
            np.testing.assert_array_equal(getattr(d_t, field).numpy(), ref)
    assert d_t.n_struct == d_j.n_struct and d_t.paired
    moved = d_t.to("cpu")
    assert moved.MG_T.device.type == "cpu" and moved.n_struct == d_t.n_struct
    with pytest.raises(ValueError, match="missing"):
        gpad_data_from_numpy({"MG_T": ref}, meta)

    res = tpu_gpad_torch.solve_batch(d_t, np.zeros((2, 3), np.float32))
    out = solve_result_to_numpy(res)
    assert out["u"].shape == (2, 3) and out["iterations"].dtype == np.int32
    assert out["converged"].dtype == np.bool_ and out["converged"].all()
