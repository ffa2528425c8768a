"""Optimizers of the port, each in python loop mode and in ``mode="jit"``:
Levenberg-Marquardt, Gauss-Newton and DogLeg."""

from .common import ConvergenceConfig, IterationStats, SolverResult, Status
from .dogleg import DogLeg, DogLegConfig
from .gauss_newton import GaussNewton, GaussNewtonConfig
from .lm import LevenbergMarquardt, LevenbergMarquardtConfig

__all__ = ["Status", "SolverResult", "IterationStats", "ConvergenceConfig",
           "LevenbergMarquardt", "LevenbergMarquardtConfig",
           "GaussNewton", "GaussNewtonConfig", "DogLeg", "DogLegConfig"]
