"""Torque-limited inverted pendulum, the classic nonlinear MPC testbed (as
``tpu_gpad.problems.pendulum``). State ``x = [theta, omega]`` with theta =
0 hanging down, theta = pi upright; the input is the motor torque.
"""

from __future__ import annotations

import numpy as np
import torch


def pendulum_dynamics(
    m: float = 1.0,
    l: float = 1.0,
    b: float = 0.1,
    g: float = 9.81,
):
    """Continuous dynamics ``f(x, u) -> xdot`` of a damped pendulum:
    ``ml^2 theta'' = -mgl sin(theta) - b theta' + u``. A torch callable on
    (n_x,) and (n_u,) tensors that ``torch.func`` transforms accept (no
    in-place ops); discretize with ``tpu_gpad_torch.nonlinear.rk4``."""

    def f(x, u):
        theta, omega = x[0], x[1]
        domega = (-m * g * l * torch.sin(theta) - b * omega + u[0]) / (m * l * l)
        return torch.stack([omega, domega])

    return f


UPRIGHT = np.array([np.pi, 0.0])
