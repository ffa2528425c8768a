"""Prior factors (counterpart of ``apex_tpu/factors/prior.py``).

``PriorFactor`` is the Euclidean anchor r = x - x_prior on the raw
parameter vector with an identity Jacobian; it is well-posed only where
storage_dim == dof (R^n, SE2, SO2), and raises elsewhere.

``ManifoldPriorFactor`` is the manifold-aware one: r = x ⊟ prior with
J = Jr^{-1}(r).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..manifolds import get as get_manifold
from .base import Factor


class PriorFactor(Factor):
    kind = "prior"

    def __init__(self, prior, manifold=None):
        self.prior = np.asarray(prior, dtype=np.float64)
        if manifold is None:
            manifold = f"R{self.prior.shape[0]}"
        if isinstance(manifold, str):
            manifold = get_manifold(manifold)
        if manifold.storage_dim != manifold.dof:
            raise ValueError(
                f"Euclidean PriorFactor requires storage_dim == dof; "
                f"{manifold.name} has {manifold.storage_dim} != {manifold.dof}. "
                f"Use ManifoldPriorFactor instead.")
        self.manifold = manifold

    def signature(self):
        return ("prior", self.manifold.name)

    def var_manifolds(self) -> List[str]:
        return [self.manifold.name]

    def residual_dim(self) -> int:
        return self.manifold.dof

    def data(self) -> Dict[str, np.ndarray]:
        return {"prior": self.prior}

    @classmethod
    def linearize(cls, manifolds, data, params, compute_jacobian):
        r = params[0] - data["prior"]
        if not compute_jacobian:
            return r, None
        d = r.shape[-1]
        return r, [torch.eye(d, dtype=r.dtype, device=r.device).expand(r.shape[:-1] + (d, d))]


class ManifoldPriorFactor(Factor):
    kind = "manifold_prior"

    def __init__(self, manifold, prior):
        if isinstance(manifold, str):
            manifold = get_manifold(manifold)
        self.manifold = manifold
        self.prior = np.asarray(prior, dtype=np.float64)
        if self.prior.shape != (manifold.storage_dim,):
            raise ValueError(
                f"ManifoldPriorFactor<{manifold.name}> prior must have shape "
                f"({manifold.storage_dim},), got {self.prior.shape}")

    def signature(self):
        return ("manifold_prior", self.manifold.name)

    def var_manifolds(self) -> List[str]:
        return [self.manifold.name]

    def residual_dim(self) -> int:
        return self.manifold.dof

    def data(self) -> Dict[str, np.ndarray]:
        return {"prior": self.prior}

    @classmethod
    def linearize(cls, manifolds, data, params, compute_jacobian):
        G = manifolds[0]
        if not compute_jacobian:
            return G.minus(params[0], data["prior"]), None
        r, jx, _ = G.minus_j(params[0], data["prior"])
        return r, [jx]
