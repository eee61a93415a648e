"""Bundled plant models, as in ``tpu_gpad.problems``: the linear plants
(NumPy ``LinearMPCProblem``s) and the nonlinear dynamics of the pendulum
and the point mass with drag (torch callables for ``nonlinear.NMPC``)."""

from tpu_gpad_torch.problems.battery import battery, default_x0 as battery_default_x0
from tpu_gpad_torch.problems.double_integrator import double_integrator
from tpu_gpad_torch.problems.mass_spring import mass_spring
from tpu_gpad_torch.problems.pendulum import pendulum_dynamics
from tpu_gpad_torch.problems.point_mass import figure_eight, point_mass_drag
from tpu_gpad_torch.problems.random_lti import random_lti, random_ltv

__all__ = [
    "battery",
    "battery_default_x0",
    "double_integrator",
    "mass_spring",
    "pendulum_dynamics",
    "point_mass_drag",
    "figure_eight",
    "random_lti",
    "random_ltv",
]
