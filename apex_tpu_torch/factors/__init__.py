"""Factors of the port: the projection factor of bundle adjustment. Between,
prior and autodiff factors are ROADMAP A.1, A.4 and A.7."""

from .base import Factor
from .projection import OPTIMIZE_MODES, ProjectionFactor

__all__ = ["Factor", "ProjectionFactor", "OPTIMIZE_MODES"]
