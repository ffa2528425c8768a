"""Camera models of the port (counterpart of ``apex_tpu/cameras``): the
BAL pinhole, the pinhole and, imported on first lookup, the seven extended
models. Models are stateless, so instances are shared."""

from .bal_pinhole import BALPinholeCamera
from .base import MIN_DEPTH, CameraModel
from .pinhole import PinholeCamera

_REGISTRY = {}


def register(model: CameraModel):
    _REGISTRY[model.name] = model
    return model


register(BALPinholeCamera())
register(PinholeCamera())


def get(name: str) -> CameraModel:
    if name not in _REGISTRY:
        # the extended models register themselves on import
        from . import extended  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown camera model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


__all__ = ["CameraModel", "BALPinholeCamera", "PinholeCamera", "get", "register", "MIN_DEPTH"]
