"""Runs of the cells on the CPU with the timed path broken underneath:
each fault the cells can have has to turn ``correct`` false, and the
control (the reference in the program's place, its products in TF32) too.

The faults: a solve that returns its state unchanged (no iteration run);
half of the batch left out (its rows copied from the solved half); an
answer altered where it is produced (one scenario's move, every call).
No cell spans chips, so no exchange between chips can be left out.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_gpad_torch as tg
from gpad_bench import control, harness


def _with_z(res, z, y=None):
    return dataclasses.replace(res, z=z, u=z[..., :res.u.shape[-1]],
                               y=res.y if y is None else y)


def unchanged(solve):
    def broken(data, x0, config=tg.SolverConfig(), y0=None):
        res = solve(data, x0, config, y0)
        y = torch.zeros_like(res.y) if y0 is None else y0.expand_as(res.y).clone()
        return _with_z(res, torch.zeros_like(res.z), y)
    return broken


def half(solve):
    def broken(data, x0, config=tg.SolverConfig(), y0=None):
        res = solve(data, x0, config, y0)
        z = res.z.clone()
        B = z.shape[0]
        z[B // 2:] = z[:B - B // 2]
        return _with_z(res, z)
    return broken


def altered(solve):
    rng = np.random.default_rng(0)

    def broken(data, x0, config=tg.SolverConfig(), y0=None):
        res = solve(data, x0, config, y0)
        z = res.z.clone()
        z[int(rng.integers(z.shape[0])), 0] += 1e-2
        return _with_z(res, z)
    return broken


CELLS = ["battery_n3_N10.fleet", "battery_n30_N30.serve"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(run_cpu, cell):
    r = run_cpu(cell)
    assert r.correct, r.checks
    assert r.attempted > 0 and r.failed == 0


@pytest.mark.parametrize("fault", [unchanged, half, altered],
                         ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(run_cpu, cell, fault):
    with control.solve_replaced(fault):
        r = run_cpu(cell)
    assert not r.correct, r.checks


# The control: the reference put in the program's place, one precision
# down (its loop in float32 with TF32 products, warm-started from its own
# duals). In the serve cell it fails ``u_gap_median``; restart decisions
# that flip under float32 rounding keep the widest gap of sound runs too
# close to it for ``u_gap`` to separate the two.
@pytest.mark.parametrize("cell", ["battery_n3_N10.fleet",
                                  "battery_n30_N30.fleet_b256",
                                  "battery_n30_N30.serve"])
def test_control_is_not_correct(run_cpu, cell):
    cfg = harness.load_cell(cell).config
    with control.solve_replaced(
            control.reference_in_place(cfg, torch.device("cpu"))):
        r = run_cpu(cell)
    assert not r.correct, r.checks
