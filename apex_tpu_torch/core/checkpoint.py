"""Optimization-state checkpointing (counterpart of
``apex_tpu/core/checkpoint.py``): save and restore (values, damping, nu,
cost, iteration) to one ``.npz`` so a long solve survives an interruption.

The file layout is the JAX package's (``_meta`` = [damping, nu, cost,
iteration], ``_n_pools``, ``pool_i`` per variable pool), so a checkpoint
written by one package loads in the other. ``LevenbergMarquardt.optimize(cp,
checkpoint=...)`` resumes from one (GaussNewton and DogLeg too).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .problem import CompiledProblem


@dataclasses.dataclass
class OptimizerCheckpoint:
    values: Tuple[np.ndarray, ...]
    damping: float
    nu: float
    cost: float
    iteration: int

    def save(self, path):
        arrays = {f"pool_{i}": np.asarray(v) for i, v in enumerate(self.values)}
        np.savez(
            path,
            _meta=np.array([self.damping, self.nu, self.cost, float(self.iteration)]),
            _n_pools=np.array([len(self.values)]),
            **arrays,
        )

    @classmethod
    def load(cls, path) -> "OptimizerCheckpoint":
        with np.load(path) as z:
            n = int(z["_n_pools"][0])
            meta = z["_meta"]
            return cls(
                values=tuple(z[f"pool_{i}"] for i in range(n)),
                damping=float(meta[0]),
                nu=float(meta[1]),
                cost=float(meta[2]),
                iteration=int(meta[3]),
            )

    def validate_against(self, cp: CompiledProblem):
        if len(self.values) != len(cp.pools):
            raise ValueError(
                f"checkpoint has {len(self.values)} pools, problem has {len(cp.pools)}"
            )
        for i, (v, p) in enumerate(zip(self.values, cp.pools)):
            expected = (len(p.names), p.manifold.storage_dim)
            if v.shape != expected:
                raise ValueError(f"pool {i}: checkpoint shape {v.shape} != {expected}")


class CheckpointObserver:
    """Observer that snapshots optimizer state every N iterations (when
    ``iteration % every == 0``, iteration 0 included), overwriting ``path``.
    As in the JAX package it stores nu = 2.0, not the solver's nu.

    Observers receive named variables; this observer re-packs them into
    pool arrays using the compiled problem's layout."""

    def __init__(self, cp: CompiledProblem, path, every: int = 5):
        self.cp = cp
        self.path = path
        self.every = every
        self._last: Optional[OptimizerCheckpoint] = None

    def on_step(self, variables, iteration, cost, gradient_norm, damping,
                step_norm, step_quality):
        if iteration % self.every != 0:
            return
        values = []
        for pool in self.cp.pools:
            values.append(np.stack([np.asarray(variables[n]) for n in pool.names]))
        ck = OptimizerCheckpoint(
            values=tuple(values), damping=damping, nu=2.0, cost=cost,
            iteration=iteration,
        )
        ck.save(self.path)
        self._last = ck

    def notify_complete(self, variables, iterations):
        pass
