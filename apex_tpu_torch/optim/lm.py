"""Levenberg-Marquardt with Nielsen damping (counterpart of
``apex_tpu/optim/lm.py``).

- accepted step: lambda *= max(1/3, 1 - (2 rho - 1)^3), nu = 2;
  rejected: lambda *= nu, nu *= 2; clamped to [damping_min, damping_max]
- accept iff rho > 0, exact rollback on rejection
- convergence checked after each iteration in the reference's order

Two modes, as in the JAX package. ``mode="python"`` (the default) runs each
iteration eagerly on the problem's device and reads its scalars (costs,
norms, predicted reduction) back once. ``mode="jit"`` keeps the whole solve
on the device: accept/reject, the damping, rho and the status are device
tensors, and the host reads back only the status before each iteration
and one flag per branch the step takes (the solvers' ladders, refinement
gate, PCG chunks; ``_optimize_jit``). On a CUDA problem each iteration is a
program of CUDA graphs captured once and replayed (``graphs.py``); on the
CPU the same step runs eagerly.

The linear solvers: ``dense_cholesky`` (the default: dense H by
scatter-add, Cholesky with the retry ladder), ``dense_qr`` (QR of the
damped stacked Jacobian); ``banded_cholesky``, alias ``sparse_cholesky``
(pose graphs: band assembly and block cyclic reduction; above a block
bandwidth of 1536 the general tier, when its plan is healthy), and
``banded_qr``, alias ``sparse_qr`` (the same band, a QR sweep; ``dense_qr``
above a block bandwidth of 1536); ``sparse_general`` (independent-set
block elimination, any sparsity); ``schur_implicit``, alias
``iterative_schur``, and ``schur_explicit``, aliases ``sparse_schur`` and
``sparse_schur_complement`` (bundle adjustment), with ``schur`` /
``schur_auto`` choosing the explicit variant up to 4096 reduced camera
DOF; ``pcg`` (matrix-free CG on the normal equations). Every one runs in
both modes.

In python mode damping, nu and the step quality are numpy scalars of the
problem's dtype, updated in that dtype as the JAX package updates them in
its compile dtype; in jit mode they are 0-d tensors of that dtype.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..core.problem import CompiledProblem
from ..linalg import dense
from . import graphs
from .common import (
    ConvergenceConfig,
    IterationStats,
    SolverResult,
    Status,
    check_convergence,
    check_convergence_t,
    compute_step_quality,
    compute_step_quality_t,
)

# schur / schur_auto: the dense reduced camera matrix up to this many
# camera DOF, matrix-free PCG beyond
SCHUR_AUTO_MAX_DENSE = 4096


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
    mode: str = "python"  # "python" | "jit"
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
    # banded_cholesky block size (None: default_panel of the bandwidth)
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


def _np_float(cp: CompiledProblem):
    """The numpy scalar type of the problem's dtype."""
    return np.float64 if cp.dtype == torch.float64 else np.float32


def damping_update(damping, nu, rho, accepted: bool, cfg: LevenbergMarquardtConfig):
    """Nielsen's update of (damping, nu) in the dtype of the numpy scalar
    ``damping``, with the JAX package's operations in its order: accepted,
    damping *= max(1/3, 1 - (2 rho - 1)^3) clamped to [damping_min,
    damping_max] and nu = 2; rejected, damping = min(damping nu,
    damping_max) and nu *= 2."""
    t = type(damping)
    if accepted:
        coff = t(2.0) * t(rho) - t(1.0)
        damping = damping * np.maximum(t(1.0 / 3.0), t(1.0) - coff * coff * coff)
        return np.clip(damping, t(cfg.damping_min), t(cfg.damping_max)), t(2.0)
    return np.minimum(damping * t(nu), t(cfg.damping_max)), t(nu) * t(2.0)


def damping_update_t(damping, nu, rho, accepted, cfg: LevenbergMarquardtConfig):
    """``damping_update`` on 0-d tensors of the problem's dtype, both
    branches selected by the bool tensor ``accepted``: bit-equal to the
    numpy form and to the JAX package's jitted step."""
    coff = 2.0 * rho - 1.0
    grown = torch.clamp(damping * torch.clamp_min(1.0 - coff * coff * coff, 1.0 / 3.0),
                        cfg.damping_min, cfg.damping_max)
    new_damping = torch.where(accepted, grown, torch.clamp_max(damping * nu, cfg.damping_max))
    new_nu = torch.where(accepted, torch.full_like(nu, 2.0), nu * 2.0)
    return new_damping, new_nu


def _first_iteration(iteration, first, later):
    """``first()`` on iteration 0, else ``later``: a host branch on a Python
    iteration (python mode), a ``torch.where`` on a device counter (jit)."""
    if isinstance(iteration, torch.Tensor):
        return torch.where(iteration == 0, first(), later)
    return first() if iteration == 0 else later


class LevenbergMarquardt:
    # the names of jit mode's state after the pool tensors, in order (each
    # a 0-d tensor but jacobi_scale [D]): the reference's loop state, with
    # the initial cost. A subclass names its own (DogLeg).
    JIT_STATE = ("damping", "nu", "cost", "iteration", "status", "jacobi_scale",
                 "gradient_norm", "step_norm", "rho", "n_success", "n_fail", "initial_cost")
    # jit state read with the result and added to the solver's attribute of
    # the same name
    JIT_COUNTERS = ()

    def __init__(self, config: Optional[LevenbergMarquardtConfig] = None):
        self.config = config or LevenbergMarquardtConfig()
        # step functions per compiled problem: the Schur structure analysis
        # runs once per problem object, and dies with it
        self._step_cache = weakref.WeakKeyDictionary()
        # jit mode: the captured graphs and their static state per problem
        self._jit_cache = weakref.WeakKeyDictionary()

    # ------------------------------------------------------------------
    def _make_solve_fn(self, cp: CompiledProblem, sync_free: bool = False):
        """linearize_and_solve(values, damping, iteration, jacobi_scale)
        -> (dx, g, cost, scale, predicted). ``sync_free`` (jit mode):
        damping and iteration are device tensors, and PCG reads its flag
        per chunk."""
        cfg = self.config
        aliases = {
            "sparse_cholesky": "banded_cholesky",
            "sparse_qr": "banded_qr",
            "sparse_schur_complement": "schur_explicit",
            "iterative_schur": "schur_implicit",
        }
        solver_type = aliases.get(cfg.linear_solver_type, cfg.linear_solver_type)
        if solver_type == "banded_qr":
            from ..linalg import banded

            # a panel-hostile bandwidth falls back to the dense damped
            # stacked-J QR, which is at least as rank-robust
            if banded.block_bandwidth(cp) > banded.MAX_BANDWIDTH:
                solver_type = "dense_qr"
        if solver_type == "sparse_general" or (
                solver_type == "banded_cholesky" and cfg.banded_panel is None):
            from ..linalg import banded
            from ..linalg.sparse_general import GeneralSparseCholesky

            # the general tier takes any pattern; sparse_cholesky switches
            # to it when the band is panel-hostile (grid-like graphs), and
            # falls through to the wide panel if its plan is not healthy
            if solver_type == "sparse_general" or (
                    banded.block_bandwidth(cp) > banded.MAX_BANDWIDTH
                    and GeneralSparseCholesky.suitable(cp)):
                gs = GeneralSparseCholesky(cp)
                if gs.healthy() or solver_type == "sparse_general":
                    return self._make_general_solve_fn(gs)
        if solver_type in ("banded_cholesky", "banded_qr"):
            return self._make_banded_solve_fn(cp, qr=solver_type == "banded_qr")
        if solver_type == "dense_cholesky":
            return self._make_dense_cholesky_solve_fn(cp)
        if solver_type == "dense_qr":
            return self._make_dense_qr_solve_fn(cp)
        if solver_type == "pcg":
            return self._make_pcg_solve_fn(cp, sync_free)
        if solver_type not in ("schur_explicit", "schur_implicit", "sparse_schur",
                               "schur", "schur_auto"):
            raise ValueError(f"unknown linear solver {cfg.linear_solver_type!r}")
        from ..linalg.schur import SchurContext

        def context(variant):
            return SchurContext(
                cp,
                variant=variant,
                preconditioner=cfg.schur_preconditioner,
                pcg_max_iterations=cfg.pcg_max_iterations,
                pcg_tolerance=cfg.pcg_tolerance,
                pcg_forcing=cfg.pcg_forcing,
                pp_shift_floor=cfg.schur_pp_shift_floor,
                # pcg_forcing=False means exact solves, so it disables both
                # inexact-inner-solve policies
                pcg_q_tolerance=cfg.pcg_q_tolerance if cfg.pcg_forcing else None,
                sync_free=sync_free,
            )

        if solver_type in ("schur", "schur_auto"):
            # the variant by the size of the reduced system, read from the
            # iterative context (which enumerates no pairs)
            ctx = context("iterative")
            if ctx.Dc <= SCHUR_AUTO_MAX_DENSE:
                ctx = ctx.with_variant("sparse")
        else:
            ctx = context("iterative" if solver_type == "schur_implicit" else "sparse")
        warm = (cfg.pcg_warm_start and ctx.variant == "iterative"
                and not cfg.use_jacobi_scaling)

        def solve_schur(values, damping, iteration, jacobi_scale):
            if warm:
                # the state slot holds the previous global step; the loop
                # initializes it to ones, so iteration 0 zeroes it
                prev = _first_iteration(iteration, lambda: torch.zeros_like(jacobi_scale),
                                        jacobi_scale)
                dx, g, cost, predicted = ctx.solve(values, damping, iteration=iteration,
                                                   dx_prev=prev)
                return dx, g, cost, dx, predicted
            dx, g, cost, predicted = ctx.solve(values, damping, iteration=iteration)
            return dx, g, cost, jacobi_scale, predicted

        solve_schur.schur_context = ctx
        return solve_schur

    def _make_pcg_solve_fn(self, cp: CompiledProblem, sync_free: bool = False):
        """Matrix-free block-preconditioned CG on the normal equations."""
        from ..linalg.iterative import IterativeNormalSolver

        cfg = self.config
        it_solver = IterativeNormalSolver(
            cp, max_iterations=cfg.pcg_max_iterations * 3,
            tolerance=min(cfg.pcg_tolerance, 1e-8), sync_free=sync_free)

        def solve_pcg(values, damping, iteration, jacobi_scale):
            dx, g, cost = it_solver.solve(values, damping)
            return dx, g, cost, jacobi_scale, None

        return solve_pcg

    @staticmethod
    def _make_general_solve_fn(gs):
        """The general-sparsity tier's exact solve; like the JAX package's,
        it ignores ``use_jacobi_scaling``."""

        def solve_general(values, damping, iteration, jacobi_scale):
            dx, g, cost = gs.solve(values, damping)
            return dx, g, cost, jacobi_scale, None

        solve_general.general_sparse = gs
        return solve_general

    def _make_banded_solve_fn(self, cp: CompiledProblem, qr: bool = False):
        """Band assembly, then block cyclic reduction or (``qr``) the banded
        QR sweep; the predicted reduction is left to the step (exact
        solve)."""
        from ..linalg import banded

        cfg = self.config
        asm = banded.BandedNormalAssembler(cp, block=cfg.banded_panel)
        if qr:
            from ..linalg.banded_qr import make_blocktri_qr_core

            core = make_blocktri_qr_core(cp.total_dof, asm.m, cp.dtype)
        else:
            core = banded.make_blocktri_cr_core(cp.total_dof, asm.m, cp.dtype)
        D, m, n, Dp = asm.D, asm.m, asm.n, asm.Dp

        def solve_banded(values, damping, iteration, jacobi_scale):
            Dg, Cg, gv, cost = asm.assemble(values)
            Dg = asm.pad_diag_ones(Dg)
            if cfg.use_jacobi_scaling:
                scale = _first_iteration(
                    iteration,
                    lambda: 1.0 / (1.0 + torch.sqrt(
                        torch.diagonal(Dg, dim1=1, dim2=2).reshape(-1)[:D])),
                    jacobi_scale)
                sb = torch.nn.functional.pad(scale, (0, Dp - D), value=1.0).reshape(n, m)
                sb_prev = torch.cat([sb[:1] * 0.0, sb[:-1]])
                Dg = Dg * sb[:, :, None] * sb[:, None, :]
                Cg = Cg * sb[:, :, None] * sb_prev[:, None, :]
                gv = gv * scale
            else:
                scale = jacobi_scale
            bp = torch.nn.functional.pad(-gv, (0, Dp - D)).reshape(n, m)
            dx = core(Dg, Cg, bp, damping)[:D]
            if cfg.use_jacobi_scaling:
                dx = dx * scale
            return dx, gv, cost, scale, None

        return solve_banded

    def _make_dense_cholesky_solve_fn(self, cp: CompiledProblem):
        """Dense H = J^T J by scatter-add and a Cholesky solve with the
        retry ladder."""
        cfg = self.config

        def solve_chol(values, damping, iteration, jacobi_scale):
            with record_function("dense.assemble"):
                H, g, cost = cp.assemble_normal(values)
            if cfg.use_jacobi_scaling:
                scale = _first_iteration(
                    iteration, lambda: 1.0 / (1.0 + torch.sqrt(torch.diagonal(H))), jacobi_scale)
                H = H * scale[None, :] * scale[:, None]
                g = g * scale
            else:
                scale = jacobi_scale
            with record_function("dense.solve"):
                dx = dense.solve_cholesky_with_retry(H, g, damping)
            if cfg.use_jacobi_scaling:
                dx = dx * scale
            return dx, g, cost, scale, None

        return solve_chol

    def _make_dense_qr_solve_fn(self, cp: CompiledProblem):
        """The dense stacked Jacobian and the QR of [J; sqrt(damping) I]."""
        cfg = self.config

        def solve_qr(values, damping, iteration, jacobi_scale):
            with record_function("dense.assemble"):
                r, J = cp.assemble_dense_jacobian(values)
            cost = 0.5 * torch.dot(r, r)
            if cfg.use_jacobi_scaling:
                scale = _first_iteration(
                    iteration, lambda: 1.0 / (1.0 + torch.linalg.vector_norm(J, dim=0)),
                    jacobi_scale)
                J = J * scale[None, :]
            else:
                scale = jacobi_scale
            g = J.mT @ r
            with record_function("dense.solve"):
                dx = dense.solve_qr(r, J, damping)
            if cfg.use_jacobi_scaling:
                dx = dx * scale
            return dx, g, cost, scale, None

        return solve_qr

    def _make_step_fn(self, cp: CompiledProblem):
        cfg = self.config
        ccfg = cfg.convergence()
        solve_fn = self._make_solve_fn(cp)

        t = _np_float(cp)

        def step(values, damping, nu, iteration, jacobi_scale):
            dx, g, current_cost, scale, predicted = solve_fn(
                values, float(damping), iteration, jacobi_scale)
            if predicted is None:
                # exact solve: 0.5 step^T (lambda step - g)
                predicted = 0.5 * torch.sum(dx * (float(damping) * dx - g))
            with record_function("lm.trial_cost"):
                new_values = cp.apply_step(values, dx)
                new_cost = cp.cost(new_values)
            # one read-back of this step's scalars
            current_cost, new_cost, predicted, gradient_norm, step_norm = torch.stack([
                current_cost, new_cost, predicted,
                torch.linalg.vector_norm(g), torch.linalg.vector_norm(dx),
            ]).tolist()

            rho = compute_step_quality(t(current_cost), t(new_cost), t(predicted))
            accepted = bool(rho > 0.0)
            damping, nu = damping_update(damping, nu, rho, accepted, cfg)
            if accepted:
                values, cost = new_values, new_cost
            else:
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

        step.solve_fn = solve_fn
        return step

    # ------------------------------------------------------------------
    def optimize(self, problem, initial_values=None) -> SolverResult:
        """Run the optimization. A ``Problem`` is compiled with
        ``Problem.compile``'s defaults (f64 on the card, which raises where
        there is none); compile it yourself to pick the dtype and the
        device."""
        cfg = self.config
        if cfg.mode not in ("python", "jit"):
            raise ValueError(f"unknown mode {cfg.mode!r}; 'python' or 'jit'")
        cp = problem if isinstance(problem, CompiledProblem) else problem.compile(initial_values)
        if not cp.groups or cp.total_dof == 0:
            values = cp.initial_values()
            cost = float(cp.cost(values)) if cp.groups else 0.0
            return SolverResult(status=Status.CONVERGED, iterations=0,
                                initial_cost=cost, final_cost=cost,
                                elapsed_seconds=0.0, variables=cp.values_dict(values))
        if cfg.mode == "jit":
            return self._optimize_jit(cp)
        return self._optimize_python(cp)

    def _init_damping_state(self, cp: CompiledProblem, values):
        """The state threaded through ``step`` where LM's damping rides: a
        numpy scalar of the problem's dtype here; DogLeg packs its trust
        region and step cache."""
        cfg = self.config
        t = _np_float(cp)
        if cfg.damping == "auto":
            lam0 = t(cfg.damping_tau) * t(float(cp.normal_diag_max(values)))
            return np.clip(lam0, t(cfg.damping_min), t(cfg.damping_max))
        return t(cfg.damping if not isinstance(cfg.damping, str) else 1e-3)

    def _optimize_python(self, cp: CompiledProblem) -> SolverResult:
        cfg = self.config
        start = time.perf_counter()
        values = cp.initial_values()
        initial_cost = float(cp.cost(values))
        if cp not in self._step_cache:
            self._step_cache[cp] = self._make_step_fn(cp)
        step_fn = self._step_cache[cp]
        damping = self._init_damping_state(cp, values)
        nu = _np_float(cp)(2.0)
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
                    tr_ratio=metrics["rho"],
                    tr_radius=damping["delta"] if isinstance(damping, dict) else damping,
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

        covariances = None
        if cfg.compute_covariances:
            from ..core.covariance import compute_covariances

            covariances = compute_covariances(cp, values)

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
            covariances=covariances,
        )

    # ------------------------------------------------------------------
    def _make_device_init(self, cp: CompiledProblem):
        """The reference's ``init_state_fn``: the initial values, their
        cost, the initial damping and the empty statistics as jit state."""
        cfg = self.config
        dt, dev = cp.dtype, cp.device

        def full(value, dtype=dt):
            return torch.full((), value, dtype=dtype, device=dev)

        def init(*state):
            # every slot a tensor of its own: the captured programs write
            # them in place
            values = tuple(v.clone() for v in cp.initial_values())
            cost0 = cp.cost(values)
            if cfg.damping == "auto":
                damping = torch.clamp(cp.normal_diag_max(values) * cfg.damping_tau,
                                      cfg.damping_min, cfg.damping_max)
            else:
                damping = full(cfg.damping if not isinstance(cfg.damping, str) else 1e-3)
            nan = float("nan")
            return graphs.assign(state, (
                *values, damping, full(2.0), cost0.clone(), full(0, torch.int64),
                full(int(Status.RUNNING), torch.int32),
                torch.ones(cp.total_dof, dtype=dt, device=dev), full(nan), full(nan), full(nan),
                full(0, torch.int64), full(0, torch.int64), cost0))

        return init

    def _make_device_step(self, cp: CompiledProblem):
        """The reference's ``step`` on jit state (``JIT_STATE`` after the
        pool tensors): no value is read back; accept/reject, the damping
        update and the status are ``torch.where`` on 0-d tensors."""
        cfg = self.config
        ccfg = cfg.convergence()
        solve_fn = self._make_solve_fn(cp, sync_free=True)
        n_pools = len(cp.pools)

        def step(*state):
            values = state[:n_pools]
            damping, nu, _, iteration, _, jacobi_scale, _, _, _, n_succ, n_fail, cost0 = \
                state[n_pools:]
            dx, g, current_cost, scale, predicted = solve_fn(values, damping, iteration,
                                                             jacobi_scale)
            if predicted is None:
                # exact solve: 0.5 step^T (lambda step - g)
                predicted = 0.5 * torch.sum(dx * (damping * dx - g))
            with record_function("lm.trial_cost"):
                new_values = cp.apply_step(values, dx)
                new_cost = cp.cost(new_values)
            gradient_norm = torch.linalg.vector_norm(g)
            step_norm = torch.linalg.vector_norm(dx)
            rho = compute_step_quality_t(current_cost, new_cost, predicted)
            accepted = rho > 0.0
            damping, nu = damping_update_t(damping, nu, rho, accepted, cfg)
            values = tuple(torch.where(accepted, new, old) for new, old in zip(new_values, values))
            cost = torch.where(accepted, new_cost, current_cost)
            status = check_convergence_t(
                iteration=iteration,
                current_cost=current_cost,
                new_cost=cost,
                parameter_norm=cp.parameter_norm(values),
                parameter_update_norm=step_norm,
                gradient_norm=gradient_norm,
                step_accepted=accepted,
                cfg=ccfg,
                trust_region_radius=cfg.trust_region_radius,
            )
            return graphs.assign(state, (
                *values, damping, nu, cost, iteration + 1, status, scale, gradient_norm,
                step_norm, rho, n_succ + accepted, n_fail + ~accepted, cost0))

        step.solve_fn = solve_fn
        return step

    def _optimize_jit(self, cp: CompiledProblem) -> SolverResult:
        """The whole solve on the device (the reference's ``_optimize_jit``):
        the initial state and each iteration are replayed programs (CUDA
        graphs on a card, the same step eagerly on the CPU), captured once
        per problem. The host reads the status before each iteration and
        checks ``timeout`` every ``ceil(max_iterations / 8)`` iterations, so
        that TIMEOUT comes after the reference's iteration count."""
        cfg = self.config
        start = time.perf_counter()
        run = self._jit_cache.get(cp)
        if run is None:
            run = self._jit_cache[cp] = _JitRun(
                cp, self.JIT_STATE, self._make_device_init(cp),
                self._make_device_step(cp))
        run.init()
        chunk = max(1, -(-cfg.max_iterations // 8))
        done = 0
        while True:
            status = Status(run.status())
            if status != Status.RUNNING:
                break
            if (cfg.timeout is not None and done and done % chunk == 0
                    and time.perf_counter() - start >= cfg.timeout):
                status = Status.TIMEOUT
                break
            run.step()
            done += 1
        return self._finish_jit(cp, start, run, status)

    def _finish_jit(self, cp: CompiledProblem, start, run, status) -> SolverResult:
        """``SolverResult`` as the reference's ``_finish_jit`` builds it: one
        read of the scalars (``JIT_COUNTERS`` among them), no per-iteration
        statistics."""
        values = run.state[:len(cp.pools)]
        st = dict(zip(self.JIT_STATE, run.state[len(cp.pools):]))
        graphs.host_reads += 1
        cost0, cost, iteration, gnorm, snorm, n_succ, n_fail, *counts = torch.stack([
            st[k].to(torch.float64) for k in ("initial_cost", "cost", "iteration",
                                              "gradient_norm", "step_norm", "n_success",
                                              "n_fail", *self.JIT_COUNTERS)]).tolist()
        for name, count in zip(self.JIT_COUNTERS, counts):
            setattr(self, name, getattr(self, name) + int(count))
        covariances = None
        if self.config.compute_covariances:
            from ..core.covariance import compute_covariances

            covariances = compute_covariances(cp, values)
        iteration = int(iteration)
        return SolverResult(
            status=status,
            iterations=iteration,
            initial_cost=cost0,
            final_cost=cost,
            elapsed_seconds=time.perf_counter() - start,
            variables=cp.values_dict(values),
            final_gradient_norm=gnorm,
            final_step_norm=snorm,
            cost_evaluations=iteration + 1,
            jacobian_evaluations=iteration,
            successful_steps=int(n_succ),
            unsuccessful_steps=int(n_fail),
            covariances=covariances,
        )


class _JitRun:
    """jit mode's programs and static state for one problem: on a card the
    initial state and the step captured (``graphs.Captured``, one memory
    pool), on the CPU the same functions called eagerly."""

    def __init__(self, cp: CompiledProblem, names, init, step):
        t0 = time.perf_counter()
        self._init, self._step = init, step
        self._status = len(cp.pools) + names.index("status")
        self.state = init()
        self._graphs = None
        if cp.device.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
            self._graphs = (graphs.Captured(init, self.state, pool),
                            graphs.Captured(step, self.state, pool))
            torch.cuda.synchronize(cp.device)
        # host seconds to build the state, warm up and capture
        self.capture_seconds = time.perf_counter() - t0

    def init(self):
        if self._graphs:
            self._graphs[0].replay()
        else:
            self.state = self._init(*self.state)

    def step(self):
        if self._graphs:
            self._graphs[1].replay()
        else:
            self.state = self._step(*self.state)

    def status(self) -> int:
        return graphs.read_status(self.state[self._status])
