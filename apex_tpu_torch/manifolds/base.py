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

SO2, SE2, SO3, SE3 and SE23 have their adjoint and tangent Jacobians in
closed form, R^n identities. Sim3 and SGal3 take theirs from
``with_autodiff_jacobians``: exact forward-mode autodiff of the group's own
exp / log / compose (``torch.func.jacfwd`` under ``torch.func.vmap``), not
finite differences.
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

    hat: Optional[Callable] = None  # (..., D) -> matrix Lie algebra element
    # (generator, batch=(), dtype, device) -> (*batch, S), drawn on the
    # generator's device
    random: Optional[Callable] = None
    is_valid: Optional[Callable] = None  # (..., S), tol -> bool (...,)
    interpolate: Optional[Callable] = None  # (x, y, alpha) -> (..., S)

    def plus(self, x, t):
        """Right plus: x ∘ Exp(t)."""
        return self.compose(x, self.exp(t))

    def plus_j(self, x, t):
        """J_x = Ad(Exp(t)⁻¹), J_t = Jr(t)."""
        e = self.exp(t)
        return self.compose(x, e), self.adjoint(self.inverse(e)), self.rjac(t)

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

    def random_batch(self, generator, n, dtype=torch.float64, device=None):
        """``n`` random elements (n, S) from ``generator`` (the JAX
        package draws them from split keys: same laws, other values)."""
        return self.random(generator, (n,), dtype=dtype, device=device)

    def identity_like(self, batch_shape=(), dtype=torch.float64, device=None):
        e = self.identity(dtype=dtype, device=device)
        return e.expand(tuple(batch_shape) + e.shape)


def _batched_eye(d, like):
    eye = torch.eye(d, dtype=like.dtype, device=like.device)
    return eye.expand(like.shape[:-1] + (d, d))


def with_autodiff_jacobians(g: LieGroup) -> LieGroup:
    """Fill in missing tangent Jacobians by exact forward-mode autodiff:

        Jr(t) = d/dd Log(Exp(t)⁻¹ ∘ Exp(t + d)) at d = 0
        Jl(t) = d/dd Log(Exp(t + d) ∘ Exp(t)⁻¹) at d = 0

    and Jr⁻¹ / Jl⁻¹ as the inverses of those."""
    updates = {}
    if g.rjac is None:
        updates["rjac"] = _jac_over_batch(g, mode="r")
    if g.ljac is None:
        updates["ljac"] = _jac_over_batch(g, mode="l")
    if g.rjac_inv is None:
        updates["rjac_inv"] = _inv_of(updates.get("rjac", g.rjac))
    if g.ljac_inv is None:
        updates["ljac_inv"] = _inv_of(updates.get("ljac", g.ljac))
    return dataclasses.replace(g, **updates) if updates else g


def vmap_rows(single, *xs, out_shape):
    """``single`` mapped over the rows of ``xs`` flattened to (-1, last):
    (..., *out_shape), with the leading dimensions of ``xs[0]``."""
    lead = xs[0].shape[:-1]
    flat = [x.reshape(-1, x.shape[-1]) for x in xs]
    if flat[0].shape[0] == 0:
        out = torch.zeros((0,) + tuple(out_shape), dtype=xs[0].dtype, device=xs[0].device)
    else:
        out = torch.func.vmap(single)(*flat)
    return out.reshape(lead + tuple(out_shape))


def _jac_over_batch(g: LieGroup, mode: str):
    # each row keeps a batch dimension of 1 (``t[None]``): under forward-mode
    # autodiff a python number times a 0-dim tensor (a tangent's scalar
    # part) gets a float64 tangent, which an f32 solve cannot take
    def single(t):
        t = t[None]
        if mode == "r":
            def f(d):
                return g.log(g.compose(g.inverse(g.exp(t)), g.exp(t + d)))[0]
        else:
            def f(d):
                return g.log(g.compose(g.exp(t + d), g.inverse(g.exp(t))))[0]
        return torch.func.jacfwd(f)(torch.zeros_like(t))[:, 0]

    def batched(t):
        return vmap_rows(single, t, out_shape=(t.shape[-1], t.shape[-1]))

    return batched


def _inv_of(jac_fn):
    """The inverse of ``jac_fn``'s matrices. ``inv_ex`` reads no status
    back to the host, so a CUDA graph can capture it."""
    def inv(t):
        return torch.linalg.inv_ex(jac_fn(t))[0]

    return inv
