"""Lie-group container (counterpart of ``apex_tpu/manifolds/base.py``).

Each group is a record of plain functions on tensors that broadcast over
leading batch dimensions. Conventions follow the JAX package: right
perturbation, ``plus(x, t) = x ∘ Exp(t)``, w-first Hamilton quaternions,
Jacobians with respect to right perturbations on the tangent space. The
derived operations are written once from the group primitives:

    J_{g⁻¹}_g = -Ad(g)
    J_{g1∘g2}_{g1} = Ad(g2⁻¹),   J_{g1∘g2}_{g2} = I
    J_{Log(g)}_g = Jr⁻¹(Log(g)),  J_{Exp(t)}_t = Jr(t)
    between(a, b) = a⁻¹∘b;  J_a = -Ad((a⁻¹b)⁻¹),  J_b = I

SO2, SE2, SO3 and SE3 have their adjoint and tangent Jacobians in closed
form, R^n identities; the autodiff fallbacks for the other groups are
ROADMAP A.7.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


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
    # (..., S), (..., V) -> (..., V): V = 3 for SO3/SE3, 2 for SO2/SE2, n for R^n
    act: Optional[Callable] = None
    adjoint: Optional[Callable] = None  # (..., S) -> (..., D, D)
    # tangent Jacobians, (..., D) -> (..., D, D)
    rjac: Optional[Callable] = None
    ljac: Optional[Callable] = None
    rjac_inv: Optional[Callable] = None
    ljac_inv: Optional[Callable] = None

    def plus(self, x, t):
        """Right plus: x ∘ Exp(t)."""
        return self.compose(x, self.exp(t))

    def inverse_j(self, x):
        """g⁻¹ with J = -Ad(g)."""
        return self.inverse(x), -self.adjoint(x)

    def compose_j(self, a, b):
        """a∘b with J_a = Ad(b⁻¹), J_b = I."""
        return self.compose(a, b), self.adjoint(self.inverse(b)), _batched_eye(self.dof, a)

    def log_j(self, x):
        """Log(x) with J = Jr⁻¹(Log(x))."""
        t = self.log(x)
        return t, self.rjac_inv(t)

    def exp_j(self, t):
        """Exp(t) with J = Jr(t)."""
        return self.exp(t), self.rjac(t)

    def between(self, a, b):
        return self.compose(self.inverse(a), b)

    def between_j(self, a, b):
        """a⁻¹∘b with J_a = -Ad((a⁻¹b)⁻¹), J_b = I."""
        r = self.between(a, b)
        return r, -self.adjoint(self.inverse(r)), _batched_eye(self.dof, a)

    def minus(self, x, y):
        """Right minus: Log(y⁻¹ ∘ x)."""
        return self.log(self.compose(self.inverse(y), x))

    def minus_j(self, x, y):
        """J_x = Jr⁻¹(d), J_y = -Jl⁻¹(d) with d = x ⊟ y."""
        d = self.minus(x, y)
        return d, self.rjac_inv(d), -self.ljac_inv(d)


def _batched_eye(d, like):
    eye = torch.eye(d, dtype=like.dtype, device=like.device)
    return eye.expand(like.shape[:-1] + (d, d))
