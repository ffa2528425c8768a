"""Lie-group container (counterpart of ``apex_tpu/manifolds/base.py``).

Each group is a record of plain functions on tensors that broadcast over
leading batch dimensions. Conventions follow the JAX package: right
perturbation, ``plus(x, t) = x ∘ Exp(t)``, w-first Hamilton quaternions.
Only what the bundle-adjustment path runs is ported; the tangent Jacobians
are ROADMAP A.1 and the autodiff fallbacks A.7.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class LieGroup:
    name: str
    dof: int
    storage_dim: int

    identity: Callable  # (dtype, device) -> (S,)
    inverse: Callable  # (..., S) -> (..., S)
    compose: Callable  # (..., S), (..., S) -> (..., S)
    exp: Callable  # (..., D) -> (..., S)
    log: Callable  # (..., S) -> (..., D)
    normalize: Callable  # (..., S) -> (..., S)
    act: Optional[Callable] = None  # (..., S), (..., 3) -> (..., 3)

    def plus(self, x, t):
        """Right plus: x ∘ Exp(t)."""
        return self.compose(x, self.exp(t))
