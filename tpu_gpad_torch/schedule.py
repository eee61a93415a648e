"""Momentum (theta/beta) schedules for GPAD.

The scalar recursions (reference ``acceldualgrad.m:55-56``; paper eq. (8e)):

    theta_{k+1} = theta_k (sqrt(theta_k^2 + 4) - theta_k) / 2,  theta_0 = 1
    beta_k      = theta_k (1/theta_{k-1} - 1),                   beta_0 = 0

The reference MATLAB computes ``beta`` *before* shifting its theta registers
(``acceldualgrad.m:56,63-64``), which makes its effective beta sequence lag
the paper's by one iteration (beta_ref[k] = beta_paper[k-1]).  Both converge;
``variant="reference"`` reproduces the MATLAB trajectory bit-for-bit for u*
parity tests, ``variant="paper"`` is the canonical schedule.

The schedule is precomputed offline and shipped with the problem, matching
the reference runtime's design (``main.cu:61-64`` reads theta/beta arrays
from the input file).
"""

from __future__ import annotations

import numpy as np


def momentum_schedule(num_iterations: int, variant: str = "paper") -> tuple[np.ndarray, np.ndarray]:
    """Return float32 arrays (theta, beta), each of length ``num_iterations``.

    ``theta[k]`` / ``beta[k]`` are the scalars consumed by iteration k
    (0-indexed) of the GPAD loop.
    """
    if num_iterations < 1:
        raise ValueError("num_iterations must be >= 1")
    # theta in float64 then cast: the recursion loses precision quickly in fp32.
    theta = np.empty(num_iterations + 1, dtype=np.float64)
    theta[0] = 1.0
    for k in range(num_iterations):
        t = theta[k]
        theta[k + 1] = t * (np.sqrt(t * t + 4.0) - t) / 2.0

    beta_paper = np.zeros(num_iterations, dtype=np.float64)
    for k in range(1, num_iterations):
        beta_paper[k] = theta[k] * (1.0 / theta[k - 1] - 1.0)

    if variant == "paper":
        beta = beta_paper
    elif variant == "reference":
        # MATLAB's lagged schedule: beta used at iteration k equals the
        # paper's beta at k-1 (with beta[0] = 0).
        beta = np.concatenate([[0.0], beta_paper[:-1]])
    else:
        raise ValueError(f"unknown schedule variant: {variant!r}")

    return theta[:num_iterations].astype(np.float32), beta.astype(np.float32)
