"""Bundled linear plant models (NumPy, as in ``tpu_gpad.problems``).

``pendulum`` and ``point_mass`` have nonlinear dynamics and come with the
NMPC port."""

from tpu_gpad_torch.problems.battery import battery, default_x0 as battery_default_x0
from tpu_gpad_torch.problems.double_integrator import double_integrator
from tpu_gpad_torch.problems.mass_spring import mass_spring
from tpu_gpad_torch.problems.random_lti import random_lti, random_ltv

__all__ = [
    "battery",
    "battery_default_x0",
    "double_integrator",
    "mass_spring",
    "random_lti",
    "random_ltv",
]
