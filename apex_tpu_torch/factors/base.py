"""Factor protocol (counterpart of ``apex_tpu/factors/base.py``).

A factor instance is a host-side descriptor. All factors sharing a
``signature()`` compile into one factor group, linearized by one batched
kernel over stacked tensors:
``kernel(manifolds, data, params, compute_jacobian) -> (r [K, d], [J [K, d, dof_s]])``.
A custom factor either writes that kernel (``linearize``) or subclasses
:class:`AutoDiffFactor` and writes only its residual.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


class Factor:
    kind: str = "factor"

    def signature(self):
        raise NotImplementedError

    def var_manifolds(self) -> List[str]:
        raise NotImplementedError

    def residual_dim(self) -> int:
        raise NotImplementedError

    def data(self) -> Dict[str, np.ndarray]:
        return {}

    @classmethod
    def linearize(cls, manifolds, data, params, compute_jacobian):
        raise NotImplementedError

    def group_kernel(self):
        """The batched linearization kernel shared by this factor's group:
        the class's ``linearize`` unless the factor binds state."""
        return type(self).linearize


class AutoDiffFactor(Factor):
    """Base for custom factors: implement only the batched residual
    ``residual(manifolds, data, params) -> [K, d]``. The Jacobian of each
    slot, with respect to a right perturbation ``G.plus(p, delta)``, is
    exact forward-mode autodiff (``torch.func.jacfwd`` of one block's
    residual at delta = 0, under ``torch.func.vmap`` over the blocks)."""

    @classmethod
    def residual(cls, manifolds, data, params):
        raise NotImplementedError

    @classmethod
    def linearize(cls, manifolds, data, params, compute_jacobian):
        r = cls.residual(manifolds, data, params)
        if not compute_jacobian:
            return r, None
        keys = sorted(data.keys())
        data_leaves = [data[k] for k in keys]
        n = len(params)
        jacs = []
        for slot, G in enumerate(manifolds):
            def block_residual(delta, *per_block, slot=slot, G=G):
                # one block, given a batch dimension of 1 for ``residual``
                ps = [p[None] for p in per_block[:n]]
                ps[slot] = G.plus(ps[slot], delta[None])
                d1 = {k: v[None] for k, v in zip(keys, per_block[n:])}
                return cls.residual(manifolds, d1, ps)[0]

            def block_jac(delta, *per_block, block_residual=block_residual):
                return torch.func.jacfwd(block_residual)(delta, *per_block)

            zero = torch.zeros(params[0].shape[:-1] + (G.dof,), dtype=params[0].dtype,
                               device=params[0].device)
            jacs.append(torch.func.vmap(block_jac)(zero, *params, *data_leaves))
        return r, jacs
