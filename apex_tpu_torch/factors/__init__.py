"""Factors of the port: the projection factor of bundle adjustment, the
between factor of pose graphs and the two prior factors. Autodiff factors
are ROADMAP A.7."""

from .base import Factor
from .between import BetweenFactor
from .prior import ManifoldPriorFactor, PriorFactor
from .projection import OPTIMIZE_MODES, ProjectionFactor

__all__ = ["Factor", "BetweenFactor", "ManifoldPriorFactor", "PriorFactor",
           "ProjectionFactor", "OPTIMIZE_MODES"]
