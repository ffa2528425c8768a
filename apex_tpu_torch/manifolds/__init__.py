"""Lie-group manifolds of the port: SO2, SE2, SO3, SE3 and R^n, with their
tangent Jacobians. The extended groups (SE23, SGal3, Sim3) are ROADMAP
A.7."""

from .base import LieGroup
from .rn import Rn
from .se2 import SE2
from .se3 import SE3
from .so2 import SO2
from .so3 import SO3

_REGISTRY = {"SO2": SO2, "SO3": SO3, "SE2": SE2, "SE3": SE3}


def get(name: str) -> LieGroup:
    """Look up a manifold by name; R^n via 'R3', 'R10', ..."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith("R") and name[1:].isdigit():
        return Rn(int(name[1:]))
    raise NotImplementedError(
        f"manifold {name!r} is not ported yet (ROADMAP A.7: SE23, SGal3, Sim3)")


__all__ = ["LieGroup", "SO2", "SO3", "SE2", "SE3", "Rn", "get"]
