"""Factors of the port: the projection factor of bundle adjustment and the
between factor of pose graphs. Prior and autodiff factors are ROADMAP A.4
and A.7."""

from .base import Factor
from .between import BetweenFactor
from .projection import OPTIMIZE_MODES, ProjectionFactor

__all__ = ["Factor", "BetweenFactor", "ProjectionFactor", "OPTIMIZE_MODES"]
