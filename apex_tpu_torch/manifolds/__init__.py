"""Lie-group manifolds of the port: SO3, SE3 and R^n (the groups the
bundle-adjustment and SE3 pose-graph paths bind), with their tangent
Jacobians. SO2, SE2 and the extended groups are ROADMAP A.2 and A.7."""

from .base import LieGroup
from .rn import Rn
from .se3 import SE3
from .so3 import SO3

_REGISTRY = {"SO3": SO3, "SE3": SE3}


def get(name: str) -> LieGroup:
    """Look up a manifold by name; R^n via 'R3', 'R10', ..."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith("R") and name[1:].isdigit():
        return Rn(int(name[1:]))
    raise NotImplementedError(
        f"manifold {name!r} is not ported yet (ROADMAP A.2: SO2/SE2, A.7: the others)")


__all__ = ["LieGroup", "SO3", "SE3", "Rn", "get"]
