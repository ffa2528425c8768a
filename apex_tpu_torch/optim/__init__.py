"""Optimizers of the port: Levenberg-Marquardt in python loop mode.
Gauss-Newton and DogLeg are ROADMAP A.5."""

from .common import ConvergenceConfig, SolverResult, Status
from .lm import LevenbergMarquardt, LevenbergMarquardtConfig

__all__ = ["LevenbergMarquardt", "LevenbergMarquardtConfig", "SolverResult",
           "Status", "ConvergenceConfig"]
