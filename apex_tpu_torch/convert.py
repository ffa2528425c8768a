"""Carry optimizer state between the JAX package and the port.

``values_from_jax`` takes the JAX package's pool values, as numpy arrays in
pool order, together with that package's ``CompiledProblem.pools`` (read
for their ``names`` and ``manifold.name`` only; nothing of JAX is imported)
and returns the port's values tuple on ``cp``'s device and dtype. It checks
that both problems have the same pools: names, manifolds and shapes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .core.problem import CompiledProblem


def values_from_jax(cp: CompiledProblem, arrays: Sequence[np.ndarray],
                    pools) -> Tuple[torch.Tensor, ...]:
    if len(arrays) != len(cp.pools) or len(pools) != len(cp.pools):
        raise ValueError(
            f"expected {len(cp.pools)} pools, got {len(arrays)} arrays and "
            f"{len(pools)} reference pools")
    out = []
    for i, (pool, ref, arr) in enumerate(zip(cp.pools, pools, arrays)):
        arr = np.asarray(arr)
        if ref.manifold.name != pool.manifold.name:
            raise ValueError(
                f"pool {i}: manifold {ref.manifold.name} != {pool.manifold.name}")
        if list(ref.names) != list(pool.names):
            raise ValueError(f"pool {i} ({pool.manifold.name}): variable names differ")
        if arr.shape != tuple(pool.values0.shape):
            raise ValueError(
                f"pool {i} ({pool.manifold.name}): shape {arr.shape} != "
                f"{tuple(pool.values0.shape)}")
        out.append(torch.tensor(arr, dtype=cp.dtype, device=cp.device))
    return tuple(out)


def values_to_numpy(values) -> list:
    """The port's values tuple as a list of numpy arrays in pool order."""
    return [v.detach().cpu().numpy() for v in values]
