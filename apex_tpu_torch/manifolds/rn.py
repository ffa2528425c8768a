"""R^n as a trivial Lie group (counterpart of ``apex_tpu/manifolds/rn.py``):
compose is addition, the adjoint and every tangent Jacobian are the
identity."""

from __future__ import annotations

import functools

import torch

from .base import LieGroup
from .utils import randn


def _ident(x):
    return x


@functools.lru_cache(maxsize=None)
def Rn(n: int) -> LieGroup:
    def eye(x):
        return torch.eye(n, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (n, n))

    def random(generator, batch=(), dtype=torch.float64, device=None):
        return randn(generator, tuple(batch) + (n,), dtype, device)

    def is_valid(x, tol=1e-6):
        return torch.all(torch.isfinite(x), dim=-1)

    def interpolate(a, b, alpha):
        return a + alpha * (b - a)

    return LieGroup(
        name=f"R{n}",
        dof=n,
        storage_dim=n,
        identity=lambda dtype=torch.float64, device=None: torch.zeros(
            n, dtype=dtype, device=device),
        inverse=torch.neg,
        compose=torch.add,
        exp=_ident,
        log=_ident,
        normalize=_ident,
        act=torch.add,
        adjoint=eye,
        rjac=eye,
        ljac=eye,
        rjac_inv=eye,
        ljac_inv=eye,
        hat=_ident,
        random=random,
        is_valid=is_valid,
        interpolate=interpolate,
    )
