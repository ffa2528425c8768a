"""Factor protocol (counterpart of ``apex_tpu/factors/base.py``).

A factor instance is a host-side descriptor. All factors sharing a
``signature()`` compile into one factor group, linearized by one batched
kernel over stacked tensors:
``kernel(manifolds, data, params, compute_jacobian) -> (r [K, d], [J [K, d, dof_s]])``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


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
