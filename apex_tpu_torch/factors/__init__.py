"""Factors of the port: the projection factor of bundle adjustment, the
between factor of pose graphs, the two prior factors and the base of
custom factors with autodiff Jacobians."""

from .base import AutoDiffFactor, Factor
from .between import BetweenFactor
from .prior import ManifoldPriorFactor, PriorFactor
from .projection import OPTIMIZE_MODES, ProjectionFactor

__all__ = ["Factor", "AutoDiffFactor", "BetweenFactor", "ManifoldPriorFactor", "PriorFactor",
           "ProjectionFactor", "OPTIMIZE_MODES"]
