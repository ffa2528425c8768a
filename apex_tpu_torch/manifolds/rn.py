"""R^n as a trivial Lie group (counterpart of ``apex_tpu/manifolds/rn.py``)."""

from __future__ import annotations

import functools

import torch

from .base import LieGroup


def _ident(x):
    return x


@functools.lru_cache(maxsize=None)
def Rn(n: int) -> LieGroup:
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
    )
