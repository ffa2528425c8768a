"""Observer pattern for optimization progress (counterpart of
``apex_tpu/observers/base.py``).

An ``OptObserver`` receives per-iteration state (``on_step`` with the
variables as host numpy arrays and the iteration's metrics) and a
completion notification; ``OptObserverVec`` multiplexes several observers.
Observers run on the host between iterations: a solver with observers runs
python mode, also under ``mode="jit"``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np


class OptObserver:
    """Base observer. Subclass and override what you need."""

    def on_step(
        self,
        variables: Dict[str, np.ndarray],
        iteration: int,
        cost: float,
        gradient_norm: float,
        damping: float,
        step_norm: float,
        step_quality: float,
    ) -> None:
        """Called once per optimizer iteration with the current state."""

    def notify_complete(self, variables: Dict[str, np.ndarray], iterations: int) -> None:
        """Called once when optimization terminates."""

    def set_matrix_data(self, hessian: np.ndarray, gradient: np.ndarray) -> None:
        """Optional: receives the dense (H, g) at the new point each
        iteration, before ``on_step``, when the optimizer config enables
        ``expose_matrix_data`` (for Hessian heat maps). Default: ignored."""


class OptObserverVec(OptObserver):
    """Multiplexes a list of observers."""

    def __init__(self, observers: Optional[List[OptObserver]] = None):
        self.observers: List[OptObserver] = list(observers or [])

    def add(self, obs: OptObserver):
        self.observers.append(obs)

    def __len__(self):
        return len(self.observers)

    def on_step(self, *args, **kw):
        for o in self.observers:
            o.on_step(*args, **kw)

    def notify_complete(self, *args, **kw):
        for o in self.observers:
            o.notify_complete(*args, **kw)


class CallbackObserver(OptObserver):
    """Adapts a plain function f(variables, iteration, metrics_dict)."""

    def __init__(self, fn: Callable, on_complete: Optional[Callable] = None):
        self.fn = fn
        self.on_complete = on_complete

    def on_step(self, variables, iteration, cost, gradient_norm, damping,
                step_norm, step_quality):
        self.fn(
            variables,
            iteration,
            dict(
                cost=cost,
                gradient_norm=gradient_norm,
                damping=damping,
                step_norm=step_norm,
                step_quality=step_quality,
            ),
        )

    def notify_complete(self, variables, iterations):
        if self.on_complete is not None:
            self.on_complete(variables, iterations)


@dataclasses.dataclass
class IterationRecord:
    iteration: int
    cost: float
    gradient_norm: float
    damping: float
    step_norm: float
    step_quality: float


class HistoryObserver(OptObserver):
    """Records the metric time series (costs, |g|, lambda, |step|, rho)."""

    def __init__(self, record_variables: bool = False):
        self.history: List[IterationRecord] = []
        self.variable_history: List[Dict[str, np.ndarray]] = []
        self.record_variables = record_variables
        self.final_variables: Optional[Dict[str, np.ndarray]] = None
        self.total_iterations: Optional[int] = None

    def on_step(self, variables, iteration, cost, gradient_norm, damping,
                step_norm, step_quality):
        self.history.append(
            IterationRecord(iteration, cost, gradient_norm, damping, step_norm, step_quality)
        )
        if self.record_variables:
            self.variable_history.append({k: np.array(v) for k, v in variables.items()})

    def notify_complete(self, variables, iterations):
        self.final_variables = {k: np.array(v) for k, v in variables.items()}
        self.total_iterations = iterations

    @property
    def costs(self) -> np.ndarray:
        return np.asarray([r.cost for r in self.history])
