"""Lie-group manifolds of the port (counterpart of
``apex_tpu/manifolds/__init__.py``): SO2, SE2, SO3, SE3 and R^n, and the
extended groups SE23, Sim3 and SGal3, imported lazily (they register
themselves)."""

from .base import LieGroup, with_autodiff_jacobians
from .rn import Rn
from .se2 import SE2
from .se3 import SE3
from .so2 import SO2
from .so3 import SO3

_REGISTRY = {"SO2": SO2, "SO3": SO3, "SE2": SE2, "SE3": SE3}


def register(group: LieGroup):
    _REGISTRY[group.name] = group
    return group


def get(name: str) -> LieGroup:
    """Look up a manifold by name; R^n via 'R3', 'R10', ..."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith("R") and name[1:].isdigit():
        return Rn(int(name[1:]))
    _register_extended()
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown manifold: {name!r}")


def _register_extended():
    """Import the extended groups lazily (they register themselves)."""
    from . import se23 as _se23  # noqa: F401
    from . import sgal3 as _sgal3  # noqa: F401
    from . import sim3 as _sim3  # noqa: F401


__all__ = ["LieGroup", "with_autodiff_jacobians", "SO2", "SO3", "SE2", "SE3", "Rn", "get",
           "register"]
