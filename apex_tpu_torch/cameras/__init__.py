"""Camera models of the port. Only the BAL pinhole is ported; the pinhole
and the seven extended models are ROADMAP A.7."""

from .bal_pinhole import BALPinholeCamera
from .base import MIN_DEPTH, CameraModel

_REGISTRY = {BALPinholeCamera.name: BALPinholeCamera()}


def get(name: str) -> CameraModel:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"camera model {name!r} is not ported yet (ROADMAP A.7)")
    return _REGISTRY[name]


__all__ = ["CameraModel", "BALPinholeCamera", "MIN_DEPTH", "get"]
