"""Error hierarchy of the port (counterpart of ``apex_tpu/errors.py``, the
same classes and names).

Layer C module errors (core / linalg / manifold / factor / linearizer /
camera / io) and Layer B subsystem errors (optimizer / observer) all derive
from Layer A, ``ApexError``: catching it catches everything the framework
raises. ``log()`` records the error through the package logger
``"apex_tpu_torch"`` before it is raised:

    raise CoreError("bad variable").log()
"""

from __future__ import annotations

import logging

_logger = logging.getLogger("apex_tpu_torch")


class ApexError(Exception):
    """Layer A: top-level framework error."""

    def log(self, source: Exception | None = None) -> "ApexError":
        if source is not None:
            _logger.error("%s: %s (caused by %r)", type(self).__name__, self, source)
            self.__cause__ = source
        else:
            _logger.error("%s: %s", type(self).__name__, self)
        return self


# --- Layer B: subsystem errors ---------------------------------------------


class OptimizerError(ApexError):
    pass


class ObserverError(ApexError):
    pass


# --- Layer C: module errors --------------------------------------------------


class CoreError(ApexError):
    """Problem construction / residual block errors."""


class ManifoldError(ApexError):
    """Invalid manifold elements, dimension mismatches."""


class FactorError(ApexError):
    """Factor linearization errors."""


class LinearizerError(ApexError):
    """Assembly errors."""


class LinAlgError(ApexError):
    """Linear solver failures: raised directly by solvers, and wrapped by
    OptimizerError when surfaced through an optimizer."""


class CameraModelError(ApexError):
    """Invalid camera parameters / projection domain errors."""


class IoError(ApexError):
    """Dataset / file format errors."""
