"""Gauss-Newton (counterpart of ``apex_tpu/optim/gauss_newton.py``): the
undamped normal equations every iteration, every step applied, LM's
convergence test and linear solvers.

A gauge-free graph makes the undamped H singular: the Cholesky fails, and
the solvers' retry ladders carry the step on an escalating diagonal shift.
Both modes run LM's loops with the step below (``_make_device_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.problem import CompiledProblem
from ..utils.profiling import span
from . import graphs
from .common import ConvergenceConfig, check_convergence
from .lm import LevenbergMarquardt, LevenbergMarquardtConfig


@dataclasses.dataclass
class GaussNewtonConfig:
    linear_solver_type: str = "dense_cholesky"
    max_iterations: int = 50
    cost_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-10
    timeout: Optional[float] = None
    min_cost_threshold: Optional[float] = None
    use_jacobi_scaling: bool = False
    compute_covariances: bool = False
    mode: str = "python"
    collect_stats: bool = False
    verbose: bool = False
    schur_preconditioner: str = "schur_jacobi"
    pcg_max_iterations: int = 200
    pcg_tolerance: float = 1e-6

    def convergence(self) -> ConvergenceConfig:
        return ConvergenceConfig(
            max_iterations=self.max_iterations,
            cost_tolerance=self.cost_tolerance,
            parameter_tolerance=self.parameter_tolerance,
            gradient_tolerance=self.gradient_tolerance,
            timeout=self.timeout,
            min_cost_threshold=self.min_cost_threshold,
        )


class GaussNewton(LevenbergMarquardt):
    """The degenerate trust-region method: zero damping, every step
    accepted."""

    def __init__(self, config: Optional[GaussNewtonConfig] = None):
        gcfg = config or GaussNewtonConfig()
        self.gn_config = gcfg
        super().__init__(LevenbergMarquardtConfig(
            linear_solver_type=gcfg.linear_solver_type,
            max_iterations=gcfg.max_iterations,
            cost_tolerance=gcfg.cost_tolerance,
            parameter_tolerance=gcfg.parameter_tolerance,
            gradient_tolerance=gcfg.gradient_tolerance,
            timeout=gcfg.timeout,
            min_cost_threshold=gcfg.min_cost_threshold,
            use_jacobi_scaling=gcfg.use_jacobi_scaling,
            compute_covariances=gcfg.compute_covariances,
            mode=gcfg.mode,
            collect_stats=gcfg.collect_stats,
            verbose=gcfg.verbose,
            schur_preconditioner=gcfg.schur_preconditioner,
            pcg_max_iterations=gcfg.pcg_max_iterations,
            pcg_tolerance=gcfg.pcg_tolerance,
        ))

    def _make_device_step(self, cp: CompiledProblem):
        """The reference's GN ``step`` on jit state: every step applied, the
        status a device tensor."""
        ccfg = self.config.convergence()
        solve_fn = self._make_solve_fn(cp)
        n_pools = len(cp.pools)

        def step(*state):
            values = state[:n_pools]
            damping, nu, _, iteration, _, jacobi_scale, _, _, rho, n_succ, n_fail, cost0 = \
                state[n_pools:]
            dx, g, current_cost, scale, _ = solve_fn(values, 0.0, iteration, jacobi_scale)
            with span("lm.trial_cost"):
                new_values = cp.apply_step(values, dx)
                new_cost = cp.cost(new_values)
            gradient_norm = torch.linalg.vector_norm(g)
            step_norm = torch.linalg.vector_norm(dx)
            status = check_convergence(
                iteration=iteration,
                current_cost=current_cost,
                new_cost=new_cost,
                parameter_norm=cp.parameter_norm(new_values),
                parameter_update_norm=step_norm,
                gradient_norm=gradient_norm,
                step_accepted=torch.ones_like(iteration, dtype=torch.bool),
                cfg=ccfg,
            )
            return graphs.assign(state, (
                *new_values, damping, nu, new_cost, iteration + 1, status, scale,
                gradient_norm, step_norm, torch.ones_like(rho), n_succ + 1, n_fail, cost0))

        step.solve_fn = solve_fn
        step.host_loop = getattr(solve_fn, "host_loop", None)
        return step
