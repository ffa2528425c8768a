"""Numerical configuration of the port (counterpart of
``apex_tpu/config.py``).

- ``default_dtype()``: the dtype ``Problem.compile`` uses when none is
  given, f64 as in the JAX package, or f32 when ``APEX_TPU_NO_X64=1`` is set
  when the package is imported (the JAX package's switch of the same name).
- ``accum_dtype()``: the dtype of the H / g and PCG accumulations, the same.
- ``SMALL_ANGLE_THRESHOLD`` / ``small_angle_threshold``: the switch between
  the exact formulas and the Taylor expansions of the Lie groups
  (``manifolds/utils.py`` holds them).

The JAX package's x64 and matmul-precision switches have no counterpart:
torch takes the dtype per tensor, and TF32 is off at import
(``device.disable_tf32``).
"""

from __future__ import annotations

import os

import torch

from .manifolds.utils import SMALL_ANGLE_THRESHOLD, small_angle_threshold

_X64_DISABLED = os.environ.get("APEX_TPU_NO_X64", "0") == "1"


def default_dtype() -> torch.dtype:
    """Storage/compute dtype for manifold values, residuals and Jacobians."""
    return torch.float32 if _X64_DISABLED else torch.float64


def accum_dtype() -> torch.dtype:
    """Accumulation dtype for H/g assembly and PCG inner products."""
    return torch.float32 if _X64_DISABLED else torch.float64


__all__ = ["default_dtype", "accum_dtype", "SMALL_ANGLE_THRESHOLD", "small_angle_threshold"]
