"""2D point mass with quadratic drag, the trajectory-tracking NMPC testbed
(as ``tpu_gpad.problems.point_mass``).

State ``x = [px, py, vx, vy]``, input ``u = [ax, ay]`` (commanded
acceleration); drag decelerates the mass by ``k |v| v``, the nonlinearity
that makes the linearization change along every trajectory.
"""

from __future__ import annotations

import numpy as np
import torch


def point_mass_drag(k: float = 0.3):
    """Continuous dynamics ``f(x, u) -> xdot``, a torch callable that
    ``torch.func`` transforms accept. ``k`` is the quadratic drag
    coefficient (0 reduces to a double integrator). The 1e-9 under the root
    keeps the Jacobian finite at v = 0."""

    def f(x, u):
        v = x[2:]
        speed = torch.sqrt(torch.sum(v * v) + 1e-9)
        return torch.cat([v, u - k * speed * v])

    return f


def figure_eight(n: int, dt: float, scale: float = 1.0, period: float = 8.0):
    """A (n, 4) figure-eight reference trajectory (positions and consistent
    velocities) for the point mass: a Lissajous 1:2 curve."""
    t = np.arange(n) * dt
    w = 2.0 * np.pi / period
    px = scale * np.sin(w * t)
    py = scale * np.sin(2.0 * w * t) / 2.0
    vx = scale * w * np.cos(w * t)
    vy = scale * w * np.cos(2.0 * w * t)
    return np.stack([px, py, vx, vy], axis=1)
