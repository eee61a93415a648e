"""The work of a GPAD solve, counted from shapes alone, and the H100's peaks.

A frozen yardstick for ``solve_roofline_pct.*``. The flops of one
scenario's iteration are the least over the iteration forms the program
has (the dual form against the scaled dual Hessian, the mvp form, and the
mvp form with the input box's identity block cut out of step 4; the same
per-iteration terms as the program's ``utils/flops.py`` at this commit),
so the count is the same whichever form or kernel a route takes. The bytes
are each operand of the cheapest form read once a call, and each
scenario's inputs and outputs once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: fp32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
FLOAT_BYTES = 4


def iteration_flops(shape: dict) -> dict:
    """Flops of one scenario's iteration in each form: products as 2 flops
    a multiply-add, plus the O(m) vector steps."""
    m_h, n_z, n_s = shape["m_half"], shape["n_z"], shape["n_struct"]
    return {
        "dual": 2 * m_h * m_h + 10 * m_h,
        "mvp": 2 * m_h * n_z + 2 * n_z * m_h + 3 * m_h + 3 * n_z,
        "mvp_flat": 2 * m_h * n_z + 2 * n_z * n_s + 3 * m_h + 3 * n_z + n_z,
    }


def least_iteration_flops(shape: dict) -> int:
    return min(iteration_flops(shape).values())


def call_work(shape: dict, batch: int, iterations: int,
              warm_start: bool = False) -> tuple[float, float]:
    """(flops, bytes) of one call on ``batch`` scenarios: the least flops,
    and the cheapest form's operands (all m_h rows of H^-1 P' and the
    n_struct structured columns of P' / L, the parameter maps and
    constants, the schedule) read once, each scenario's x0 (and with
    ``warm_start`` its dual) in, its z and dual out."""
    m_h, n_z, n_s, n_x = (shape["m_half"], shape["n_z"], shape["n_struct"],
                          shape["n_x"])
    flops = float(least_iteration_flops(shape)) * iterations * batch
    operands = m_h * n_z + n_z * n_s + n_x * n_z + n_z + 2 * n_x * m_h \
        + 2 * m_h + 2 * iterations
    per_scenario = n_x + n_z + 2 * m_h + (2 * m_h if warm_start else 0)
    return flops, float(FLOAT_BYTES * (operands + batch * per_scenario))


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
