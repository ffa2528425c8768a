"""Shared optimizer machinery (counterpart of ``apex_tpu/optim/common.py``):
status codes, convergence configuration and check, step quality, results.

The convergence check and the step quality are nested ``torch.where`` on
0-d tensors in the problem's dtype, as the JAX package computes them under
jit: both loop modes run the one step that calls them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Mapping, Optional

import numpy as np
import torch


class Status(enum.IntEnum):
    RUNNING = 0
    CONVERGED = 1
    MAX_ITERATIONS_REACHED = 2
    COST_TOLERANCE_REACHED = 3
    PARAMETER_TOLERANCE_REACHED = 4
    GRADIENT_TOLERANCE_REACHED = 5
    NUMERICAL_FAILURE = 6
    USER_TERMINATED = 7
    TIMEOUT = 8
    TRUST_REGION_RADIUS_TOO_SMALL = 9
    MIN_COST_THRESHOLD_REACHED = 10
    ILL_CONDITIONED_JACOBIAN = 11
    INVALID_NUMERICAL_VALUES = 12
    FAILED = 13

    @property
    def converged(self) -> bool:
        return self in (
            Status.CONVERGED,
            Status.COST_TOLERANCE_REACHED,
            Status.PARAMETER_TOLERANCE_REACHED,
            Status.GRADIENT_TOLERANCE_REACHED,
            Status.MIN_COST_THRESHOLD_REACHED,
        )


@dataclasses.dataclass
class ConvergenceConfig:
    max_iterations: int = 50
    cost_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-10
    timeout: Optional[float] = None  # seconds; checked by the host loop
    min_cost_threshold: Optional[float] = None
    min_trust_region_radius: float = 1e-32


def check_convergence(
    *,
    iteration,
    current_cost,
    new_cost,
    parameter_norm,
    parameter_update_norm,
    gradient_norm,
    step_accepted,
    cfg: ConvergenceConfig,
    trust_region_radius: Optional[float] = None,
):
    """The reference's check order on 0-d device tensors (``iteration``, an
    integer tensor, the 0-based index of the step that just ran, so
    max_iterations=N means exactly N steps): the status as a 0-d int32
    tensor. Timeout is handled by the host loop."""
    inval = ~(torch.isfinite(new_cost) & torch.isfinite(parameter_update_norm)
              & torch.isfinite(gradient_norm))
    max_iter = iteration + 1 >= cfg.max_iterations
    grad_ok = gradient_norm < cfg.gradient_tolerance
    rel_step_tol = cfg.parameter_tolerance * (parameter_norm + cfg.parameter_tolerance)
    param_ok = (iteration > 0) & (parameter_update_norm <= rel_step_tol)
    rel_change = torch.abs(current_cost - new_cost) / torch.clamp_min(current_cost, 1e-10)
    cost_ok = (iteration > 0) & (rel_change < cfg.cost_tolerance)
    # in the reference's order: the first test that holds decides
    checks = [(inval, Status.INVALID_NUMERICAL_VALUES),
              (max_iter, Status.MAX_ITERATIONS_REACHED),
              (~step_accepted, Status.RUNNING),
              (grad_ok, Status.GRADIENT_TOLERANCE_REACHED),
              (param_ok, Status.PARAMETER_TOLERANCE_REACHED),
              (cost_ok, Status.COST_TOLERANCE_REACHED)]
    if cfg.min_cost_threshold is not None:
        checks.append((new_cost < cfg.min_cost_threshold, Status.MIN_COST_THRESHOLD_REACHED))
    if trust_region_radius is not None:
        # a device term: DogLeg's radius is a 0-d tensor, LM's a config float
        if not isinstance(trust_region_radius, torch.Tensor):
            trust_region_radius = torch.full_like(new_cost, trust_region_radius)
        checks.append((trust_region_radius < cfg.min_trust_region_radius,
                       Status.TRUST_REGION_RADIUS_TOO_SMALL))
    status = torch.full_like(iteration, int(Status.RUNNING), dtype=torch.int32)
    for hit, code in reversed(checks):
        status = torch.where(hit, torch.full_like(status, int(code)), status)
    return status


def compute_step_quality(current_cost, new_cost, predicted_reduction):
    """rho = actual / predicted on 0-d device tensors, with the reference's
    near-zero handling."""
    actual = current_cost - new_cost
    tiny = torch.abs(predicted_reduction) < 1e-15
    fallback = (actual > 0.0).to(actual.dtype)
    safe = torch.where(tiny, torch.ones_like(predicted_reduction), predicted_reduction)
    return torch.where(tiny, fallback, actual / safe)


@dataclasses.dataclass
class IterationStats:
    iteration: int
    cost: float
    cost_change: float
    gradient_norm: float
    step_norm: float
    tr_ratio: float
    tr_radius: float
    iter_time_ms: float
    total_time_ms: float
    accepted: bool

    HEADER = (
        f"{'iter':>4} {'cost':>14} {'cost_change':>12} {'|gradient|':>12} "
        f"{'|step|':>12} {'tr_ratio':>10} {'tr_radius':>10} "
        f"{'iter_time':>9} {'total':>9}  ok"
    )

    def line(self) -> str:
        return (
            f"{self.iteration:>4} {self.cost:>14.6e} {self.cost_change:>12.3e} "
            f"{self.gradient_norm:>12.3e} {self.step_norm:>12.3e} "
            f"{self.tr_ratio:>10.3e} {self.tr_radius:>10.3e} "
            f"{self.iter_time_ms:>8.2f}m {self.total_time_ms:>8.2f}m  "
            f"{'✓' if self.accepted else '✗'}"
        )


@dataclasses.dataclass
class SolverResult:
    status: Status
    iterations: int
    initial_cost: float
    final_cost: float
    elapsed_seconds: float
    variables: Mapping[str, np.ndarray]
    final_gradient_norm: float = float("nan")
    final_step_norm: float = float("nan")
    cost_evaluations: int = 0
    jacobian_evaluations: int = 0
    successful_steps: int = 0
    unsuccessful_steps: int = 0
    iteration_stats: Optional[list] = None
    covariances: Optional[Dict[str, np.ndarray]] = None

    @property
    def converged(self) -> bool:
        return self.status.converged

    def summary(self) -> str:
        frac = ((self.initial_cost - self.final_cost) / self.initial_cost * 100.0
                if self.initial_cost > 0 else 0.0)
        return (
            f"status={self.status.name} iters={self.iterations} "
            f"cost {self.initial_cost:.6e} -> {self.final_cost:.6e} "
            f"({frac:.2f}% reduction) in {self.elapsed_seconds*1e3:.1f} ms"
        )

    def detailed_summary(self, name: str = "Optimizer") -> str:
        """The multi-section report of the JAX package's ``SolverResult``:
        the status, counts, costs, final norms, wall time, and the
        per-iteration table where stats were collected."""
        frac = ((self.initial_cost - self.final_cost) / self.initial_cost * 100.0
                if self.initial_cost > 0 else 0.0)
        lines = [
            f"==== {name} Summary " + "=" * max(0, 48 - len(name)),
            f"  status:               {self.status.name}",
            f"  converged:            {self.converged}",
            f"  iterations:           {self.iterations}"
            f" ({self.successful_steps} accepted, {self.unsuccessful_steps} rejected)",
            f"  initial cost:         {self.initial_cost:.6e}",
            f"  final cost:           {self.final_cost:.6e}",
            f"  cost reduction:       {frac:.4f}%",
            f"  final |gradient|:     {self.final_gradient_norm:.3e}",
            f"  final |step|:         {self.final_step_norm:.3e}",
            f"  cost evaluations:     {self.cost_evaluations}",
            f"  jacobian evaluations: {self.jacobian_evaluations}",
            f"  wall time:            {self.elapsed_seconds*1e3:.2f} ms",
        ]
        if self.iteration_stats:
            lines.append("  per-iteration stats:")
            lines.append("  " + IterationStats.HEADER)
            for st in self.iteration_stats:
                lines.append("  " + st.line())
        return "\n".join(lines)
