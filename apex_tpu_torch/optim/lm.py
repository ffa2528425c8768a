"""Levenberg-Marquardt with Nielsen damping (counterpart of
``apex_tpu/optim/lm.py``), python loop mode.

- accepted step: lambda *= max(1/3, 1 - (2 rho - 1)^3), nu = 2;
  rejected: lambda *= nu, nu *= 2; clamped to [damping_min, damping_max]
- accept iff rho > 0, exact rollback on rejection
- convergence checked after each iteration in the reference's order

Each iteration runs eagerly on the problem's device and reads its scalars
(costs, norms, predicted reduction) back once. The linear solver ported is
``schur_implicit``; ``mode="jit"``, a whole solve captured without host
syncs, is ROADMAP A.8.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Optional

import torch

from ..core.problem import CompiledProblem
from .common import (
    ConvergenceConfig,
    IterationStats,
    SolverResult,
    Status,
    check_convergence,
    compute_step_quality,
)

_NOT_PORTED_SOLVERS = {
    "dense_cholesky": "A.3 (dense Cholesky)",
    "dense_qr": "A.3 (dense QR)",
    "sparse_cholesky": "A.1 (banded sparse Cholesky)",
    "banded_cholesky": "A.1 (banded sparse Cholesky)",
    "sparse_qr": "A.6 (banded QR)",
    "banded_qr": "A.6 (banded QR)",
    "sparse_general": "A.6 (general-sparsity tier)",
    "pcg": "A.6 (iterative normal-equation solver)",
    "schur_explicit": "A.3 (explicit Schur)",
    "sparse_schur_complement": "A.3 (explicit Schur)",
    "sparse_schur": "A.3 (explicit Schur)",
    "schur": "A.3 (explicit Schur)",
    "schur_auto": "A.3 (explicit Schur)",
}


@dataclasses.dataclass
class LevenbergMarquardtConfig:
    """The JAX package's fields and defaults (Ceres-compatible)."""

    linear_solver_type: str = "dense_cholesky"
    max_iterations: int = 50
    cost_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-10
    timeout: Optional[float] = None
    # a float, or "auto": lambda_0 = damping_tau * max diag(J^T J)
    damping: float | str = 1e-3
    damping_tau: float = 1e-11
    damping_min: float = 1e-12
    damping_max: float = 1e12
    trust_region_radius: float = 1e4
    min_trust_region_radius: float = 1e-32
    min_cost_threshold: Optional[float] = None
    use_jacobi_scaling: bool = False
    compute_covariances: bool = False
    mode: str = "python"  # "python"; "jit" is ROADMAP A.8
    collect_stats: bool = False
    verbose: bool = False
    # Schur options
    schur_preconditioner: str = "schur_jacobi"  # none | block_diagonal | schur_jacobi
    pcg_max_iterations: int = 200
    pcg_tolerance: float = 1e-6
    # loose PCG solves on early LM iterations, tightening to pcg_tolerance
    pcg_forcing: bool = True
    # warm-start each PCG from the previous LM step (guarded); the previous
    # step rides in the jacobi_scale state slot, unused on Schur paths
    pcg_warm_start: bool = True
    # Nash-Sofer Q-stagnation termination of PCG; None disables (default)
    pcg_q_tolerance: Optional[float] = None
    # landmark-block shift floor (None: 1e-4 in f32, 0 in f64)
    schur_pp_shift_floor: Optional[float] = None
    # banded solver panel (the banded solver is ROADMAP A.1)
    banded_panel: int | None = None
    # Hessian hook for observers (observers are ROADMAP A.10)
    expose_matrix_data: bool = False

    @classmethod
    def for_bundle_adjustment(cls) -> "LevenbergMarquardtConfig":
        """Implicit Schur + Schur-Jacobi, 20 iterations."""
        return cls(linear_solver_type="schur_implicit",
                   schur_preconditioner="schur_jacobi", max_iterations=20)

    def convergence(self) -> ConvergenceConfig:
        return ConvergenceConfig(
            max_iterations=self.max_iterations,
            cost_tolerance=self.cost_tolerance,
            parameter_tolerance=self.parameter_tolerance,
            gradient_tolerance=self.gradient_tolerance,
            timeout=self.timeout,
            min_cost_threshold=self.min_cost_threshold,
            min_trust_region_radius=self.min_trust_region_radius,
        )


class LevenbergMarquardt:
    def __init__(self, config: Optional[LevenbergMarquardtConfig] = None):
        self.config = config or LevenbergMarquardtConfig()
        # step functions per compiled problem: the Schur structure analysis
        # runs once per problem object, and dies with it
        self._step_cache = weakref.WeakKeyDictionary()

    # ------------------------------------------------------------------
    def _make_solve_fn(self, cp: CompiledProblem):
        """linearize_and_solve(values, damping, iteration, jacobi_scale)
        -> (dx, g, cost, scale, predicted)."""
        cfg = self.config
        aliases = {"iterative_schur": "schur_implicit"}
        solver_type = aliases.get(cfg.linear_solver_type, cfg.linear_solver_type)
        if solver_type != "schur_implicit":
            if solver_type in _NOT_PORTED_SOLVERS:
                raise NotImplementedError(
                    f"linear solver {cfg.linear_solver_type!r} is not ported yet "
                    f"(ROADMAP {_NOT_PORTED_SOLVERS[solver_type]}); the port has "
                    "'schur_implicit'")
            raise ValueError(f"unknown linear solver {cfg.linear_solver_type!r}")
        from ..linalg.schur import SchurContext

        ctx = SchurContext(
            cp,
            variant="iterative",
            preconditioner=cfg.schur_preconditioner,
            pcg_max_iterations=cfg.pcg_max_iterations,
            pcg_tolerance=cfg.pcg_tolerance,
            pcg_forcing=cfg.pcg_forcing,
            pp_shift_floor=cfg.schur_pp_shift_floor,
            # pcg_forcing=False means exact solves, so it disables both
            # inexact-inner-solve policies
            pcg_q_tolerance=cfg.pcg_q_tolerance if cfg.pcg_forcing else None,
        )
        warm = cfg.pcg_warm_start and not cfg.use_jacobi_scaling

        def solve_schur(values, damping, iteration, jacobi_scale):
            if warm:
                # the state slot holds the previous global step; the loop
                # initializes it to ones, so iteration 0 zeroes it
                prev = torch.zeros_like(jacobi_scale) if iteration == 0 else jacobi_scale
                dx, g, cost, predicted = ctx.solve(values, damping, iteration=iteration,
                                                   dx_prev=prev)
                return dx, g, cost, dx, predicted
            dx, g, cost, predicted = ctx.solve(values, damping, iteration=iteration)
            return dx, g, cost, jacobi_scale, predicted

        return solve_schur

    def _make_step_fn(self, cp: CompiledProblem):
        cfg = self.config
        ccfg = cfg.convergence()
        solve_fn = self._make_solve_fn(cp)

        def step(values, damping, nu, iteration, jacobi_scale):
            dx, g, current_cost, scale, predicted = solve_fn(
                values, damping, iteration, jacobi_scale)
            new_values = cp.apply_step(values, dx)
            new_cost = cp.cost(new_values)
            # one read-back of this step's scalars
            current_cost, new_cost, predicted, gradient_norm, step_norm = torch.stack([
                current_cost, new_cost, predicted,
                torch.linalg.vector_norm(g), torch.linalg.vector_norm(dx),
            ]).tolist()

            rho = compute_step_quality(current_cost, new_cost, predicted)
            accepted = rho > 0.0
            if accepted:
                coff = 2.0 * rho - 1.0
                damping = min(max(damping * max(1.0 / 3.0, 1.0 - coff * coff * coff),
                                  cfg.damping_min), cfg.damping_max)
                nu = 2.0
                values, cost = new_values, new_cost
            else:
                damping = min(damping * nu, cfg.damping_max)
                nu = nu * 2.0
                cost = current_cost

            status = check_convergence(
                iteration=iteration,
                current_cost=current_cost,
                new_cost=cost,
                parameter_norm=float(cp.parameter_norm(values)),
                parameter_update_norm=step_norm,
                gradient_norm=gradient_norm,
                step_accepted=accepted,
                cfg=ccfg,
                trust_region_radius=cfg.trust_region_radius,
            )
            metrics = dict(rho=rho, accepted=accepted, gradient_norm=gradient_norm,
                           step_norm=step_norm, new_cost=new_cost)
            return values, damping, nu, cost, status, scale, metrics

        return step

    # ------------------------------------------------------------------
    def optimize(self, problem, initial_values=None) -> SolverResult:
        """Run the optimization. A ``Problem`` is compiled with
        ``Problem.compile``'s defaults (f64 on the CPU); compile it yourself
        to pick the dtype and the device."""
        cfg = self.config
        if cfg.mode != "python":
            raise NotImplementedError(
                f"mode {cfg.mode!r} is not ported yet (ROADMAP A.8: a solve "
                "captured as a CUDA graph); the port has mode='python'")
        if cfg.compute_covariances:
            raise NotImplementedError("covariances are not ported yet (ROADMAP A.5)")
        cp = problem if isinstance(problem, CompiledProblem) else problem.compile(initial_values)
        if not cp.groups or cp.total_dof == 0:
            values = cp.initial_values()
            cost = float(cp.cost(values)) if cp.groups else 0.0
            return SolverResult(status=Status.CONVERGED, iterations=0,
                                initial_cost=cost, final_cost=cost,
                                elapsed_seconds=0.0, variables=cp.values_dict(values))
        return self._optimize_python(cp)

    def _init_damping(self, cp: CompiledProblem, values) -> float:
        cfg = self.config
        if cfg.damping == "auto":
            lam0 = cfg.damping_tau * float(cp.normal_diag_max(values))
            return min(max(lam0, cfg.damping_min), cfg.damping_max)
        return float(cfg.damping if not isinstance(cfg.damping, str) else 1e-3)

    def _optimize_python(self, cp: CompiledProblem) -> SolverResult:
        cfg = self.config
        start = time.perf_counter()
        values = cp.initial_values()
        initial_cost = float(cp.cost(values))
        if cp not in self._step_cache:
            self._step_cache[cp] = self._make_step_fn(cp)
        step_fn = self._step_cache[cp]
        damping = self._init_damping(cp, values)
        nu = 2.0
        jacobi_scale = torch.ones(cp.total_dof, dtype=cp.dtype, device=cp.device)

        stats = [] if (cfg.collect_stats or cfg.verbose) else None
        if cfg.verbose:
            print(IterationStats.HEADER)

        iteration = 0
        n_succ = n_fail = 0
        grad_norm = step_norm = float("nan")
        cost_evals, jac_evals = 1, 0
        cost = prev_cost = initial_cost
        while True:
            it_start = time.perf_counter()
            values, damping, nu, cost, status, jacobi_scale, metrics = step_fn(
                values, damping, nu, iteration, jacobi_scale)
            jac_evals += 1
            cost_evals += 1
            accepted = metrics["accepted"]
            grad_norm = metrics["gradient_norm"]
            step_norm = metrics["step_norm"]
            n_succ += accepted
            n_fail += not accepted

            if stats is not None:
                st = IterationStats(
                    iteration=iteration, cost=cost, cost_change=prev_cost - cost,
                    gradient_norm=grad_norm, step_norm=step_norm,
                    tr_ratio=metrics["rho"], tr_radius=damping,
                    iter_time_ms=(time.perf_counter() - it_start) * 1e3,
                    total_time_ms=(time.perf_counter() - start) * 1e3,
                    accepted=accepted)
                stats.append(st)
                if cfg.verbose:
                    print(st.line())
            prev_cost = cost

            if (status == Status.RUNNING and cfg.timeout is not None
                    and time.perf_counter() - start >= cfg.timeout):
                status = Status.TIMEOUT
            iteration += 1
            if status != Status.RUNNING:
                break

        return SolverResult(
            status=status,
            iterations=iteration,
            initial_cost=initial_cost,
            final_cost=cost,
            elapsed_seconds=time.perf_counter() - start,
            variables=cp.values_dict(values),
            final_gradient_norm=grad_norm,
            final_step_norm=step_norm,
            cost_evaluations=cost_evals,
            jacobian_evaluations=jac_evals,
            successful_steps=n_succ,
            unsuccessful_steps=n_fail,
            iteration_stats=stats,
        )
