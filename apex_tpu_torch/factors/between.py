"""BetweenFactor: relative-pose constraint for any Lie group (counterpart
of ``apex_tpu/factors/between.py``). With params ``[pose_i, pose_j]``:

    d = pose_j.between(pose_i) = T_j^{-1} ∘ T_i        (step 1)
    e = d ∘ T_meas                                      (step 2)
    r = Log(e)                                          (step 3)

and the chain-rule Jacobians dr/dpose_i, dr/dpose_j, each [K, dof, dof],
one batched pass per group.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..manifolds import get as get_manifold
from .base import Factor


class BetweenFactor(Factor):
    kind = "between"

    def __init__(self, manifold, measurement):
        if isinstance(manifold, str):
            manifold = get_manifold(manifold)
        self.manifold = manifold
        self.measurement = np.asarray(measurement, dtype=np.float64)
        if self.measurement.shape != (manifold.storage_dim,):
            raise ValueError(
                f"BetweenFactor<{manifold.name}> measurement must have shape "
                f"({manifold.storage_dim},), got {self.measurement.shape}")

    def signature(self):
        return ("between", self.manifold.name)

    def var_manifolds(self) -> List[str]:
        return [self.manifold.name, self.manifold.name]

    def residual_dim(self) -> int:
        return self.manifold.dof

    def data(self) -> Dict[str, np.ndarray]:
        return {"meas": self.measurement}

    @classmethod
    def linearize(cls, manifolds, data, params, compute_jacobian):
        G = manifolds[0]
        xi, xj = params
        meas = data["meas"]
        if not compute_jacobian:
            return G.log(G.compose(G.between(xj, xi), meas)), None
        d, jd_xj, jd_xi = G.between_j(xj, xi)
        e, je_d, _ = G.compose_j(d, meas)
        r, jr_e = G.log_j(e)
        chain = jr_e @ je_d
        return r, [chain @ jd_xi, chain @ jd_xj]
