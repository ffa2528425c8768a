"""Levenberg-Marquardt with Nielsen damping (counterpart of
``apex_tpu/optim/lm.py``).

- accepted step: lambda *= max(1/3, 1 - (2 rho - 1)^3), nu = 2;
  rejected: lambda *= nu, nu *= 2; clamped to [damping_min, damping_max]
- accept iff rho > 0, exact rollback on rejection
- convergence checked after each iteration in the reference's order

One step, two modes, as in the JAX package. The step
(``_make_device_init`` / ``_make_device_step``) works on 0-d tensors of the
problem's dtype: accept/reject, the damping, nu, rho and the status are
``torch.where`` on the device, bit-equal to the JAX package's jitted step.
``mode="python"`` (the default) runs it eagerly on the problem's device,
each branch reading its flag, and reads the iteration's scalars back once
(``_optimize_python``: statistics, observers, timeout, checkpoints).
``mode="jit"`` keeps the whole solve on the device: on a CUDA problem the
initial state and the LM loop are one CUDA graph captured once per
problem, whose IF and WHILE nodes take the step's branches (the solvers'
ladders, refinement gate, PCG) and the loop itself (``graphs.py``), and the
host reads the result once (``_optimize_jit``; with the QR solvers the loop
stays on the host, ``QR_HOST_LOOP``). On the CPU the same step runs
eagerly, reading the status before each iteration and one flag per branch
it takes.

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
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Optional

import torch

from ..core.problem import CompiledProblem
from ..linalg import dense
from ..utils.profiling import span
from . import graphs
from .common import (
    ConvergenceConfig,
    IterationStats,
    SolverResult,
    Status,
    check_convergence,
    compute_step_quality,
)

# schur / schur_auto: the dense reduced camera matrix up to this many
# camera DOF, matrix-free PCG beyond
SCHUR_AUTO_MAX_DENSE = 4096

# Why jit mode's LM loop stays on the host for the QR solvers (dense_qr,
# sparse_qr) on a card: cuSOLVER's geqrf / orgqr call cuBLAS through a
# handle of their own, which allocates memory inside a CUDA graph capture,
# and a conditional node's body can hold no allocation. The step is still
# captured; the host reads the loop's flag once per iteration.
QR_HOST_LOOP = "cuSOLVER's QR allocates memory inside a CUDA graph capture"


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
    # observers' Hessian hook: each iteration, the dense (H, g) at the new
    # point, assembled anew and copied to the host, goes to every
    # observer's set_matrix_data (python mode; H is D^2)
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


def damping_update(damping, nu, rho, accepted, cfg: LevenbergMarquardtConfig):
    """Nielsen's update of (damping, nu) on 0-d tensors of the problem's
    dtype, both branches selected by the bool tensor ``accepted``, with the
    JAX package's operations in its order, bit-equal to its jitted step:
    accepted, damping *= max(1/3, 1 - (2 rho - 1)^3) clamped to
    [damping_min, damping_max] and nu = 2; rejected, damping =
    min(damping nu, damping_max) and nu *= 2. ``cfg`` gives damping_min
    and damping_max."""
    coff = 2.0 * rho - 1.0
    grown = torch.clamp(damping * torch.clamp_min(1.0 - coff * coff * coff, 1.0 / 3.0),
                        cfg.damping_min, cfg.damping_max)
    new_damping = torch.where(accepted, grown, torch.clamp_max(damping * nu, cfg.damping_max))
    new_nu = torch.where(accepted, torch.full_like(nu, 2.0), nu * 2.0)
    return new_damping, new_nu


def _first_iteration(iteration, first, later):
    """``first()`` on iteration 0 (a device counter), else ``later``."""
    return torch.where(iteration == 0, first(), later)


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
        # called on the host after each iteration and at the end; a solver
        # with observers runs python mode
        self.observers = []
        # python mode's step per compiled problem (``_python_step``): the
        # Schur structure analysis runs once per problem object, and dies
        # with it
        self._step_cache = weakref.WeakKeyDictionary()
        # jit mode: the captured graphs and their static state per problem
        self._jit_cache = weakref.WeakKeyDictionary()

    def add_observer(self, observer):
        self.observers.append(observer)

    # ------------------------------------------------------------------
    def _make_solve_fn(self, cp: CompiledProblem):
        """linearize_and_solve(values, damping, iteration, jacobi_scale)
        -> (dx, g, cost, scale, predicted), damping and iteration 0-d
        device tensors."""
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
            return self._make_pcg_solve_fn(cp)
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

    def _make_pcg_solve_fn(self, cp: CompiledProblem):
        """Matrix-free block-preconditioned CG on the normal equations."""
        from ..linalg.iterative import IterativeNormalSolver

        cfg = self.config
        it_solver = IterativeNormalSolver(
            cp, max_iterations=cfg.pcg_max_iterations * 3,
            tolerance=min(cfg.pcg_tolerance, 1e-8))

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

        solve_banded.host_loop = QR_HOST_LOOP if qr else None
        return solve_banded

    def _make_dense_cholesky_solve_fn(self, cp: CompiledProblem):
        """Dense H = J^T J by scatter-add and a Cholesky solve with the
        retry ladder."""
        cfg = self.config

        def solve_chol(values, damping, iteration, jacobi_scale):
            with span("dense.assemble"):
                H, g, cost = cp.assemble_normal(values)
            if cfg.use_jacobi_scaling:
                scale = _first_iteration(
                    iteration, lambda: 1.0 / (1.0 + torch.sqrt(torch.diagonal(H))), jacobi_scale)
                H = H * scale[None, :] * scale[:, None]
                g = g * scale
            else:
                scale = jacobi_scale
            with span("dense.solve"):
                dx = dense.solve_cholesky_with_retry(H, g, damping)
            if cfg.use_jacobi_scaling:
                dx = dx * scale
            return dx, g, cost, scale, None

        return solve_chol

    def _make_dense_qr_solve_fn(self, cp: CompiledProblem):
        """The dense stacked Jacobian and the QR of [J; sqrt(damping) I]."""
        cfg = self.config

        def solve_qr(values, damping, iteration, jacobi_scale):
            with span("dense.assemble"):
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
            with span("dense.solve"):
                dx = dense.solve_qr(r, J, damping)
            if cfg.use_jacobi_scaling:
                dx = dx * scale
            return dx, g, cost, scale, None

        solve_qr.host_loop = QR_HOST_LOOP
        return solve_qr

    # ------------------------------------------------------------------
    def optimize(self, problem, initial_values=None, checkpoint=None) -> SolverResult:
        """Run the optimization. A ``Problem`` is compiled with
        ``Problem.compile``'s defaults (f64 on the card, which raises where
        there is none); compile it yourself to pick the dtype and the
        device.

        ``checkpoint`` (a ``core.checkpoint.OptimizerCheckpoint``) resumes a
        solve, as in the JAX package: it is validated against the problem,
        its values are cast to the problem's dtype and device, its damping
        and nu are restored (not DogLeg's trust region), the iteration
        counter starts again at 0, and the solve runs python mode whatever
        ``mode`` says. With observers, ``mode="jit"`` runs python mode too."""
        with span("lm.solve"):
            return self._optimize(problem, initial_values, checkpoint)

    def _optimize(self, problem, initial_values, checkpoint) -> SolverResult:
        cfg = self.config
        if cfg.mode not in ("python", "jit"):
            raise ValueError(f"unknown mode {cfg.mode!r}; 'python' or 'jit'")
        cp = problem if isinstance(problem, CompiledProblem) else problem.compile(initial_values)
        if checkpoint is not None:
            checkpoint.validate_against(cp)
            return self._optimize_python(cp, checkpoint=checkpoint)
        if not cp.groups or cp.total_dof == 0:
            values = cp.initial_values()
            cost = float(cp.cost(values)) if cp.groups else 0.0
            return SolverResult(status=Status.CONVERGED, iterations=0,
                                initial_cost=cost, final_cost=cost,
                                elapsed_seconds=0.0, variables=cp.values_dict(values))
        if cfg.mode == "jit" and not self.observers:
            return self._optimize_jit(cp)
        return self._optimize_python(cp)

    def _notify_step(self, cp: CompiledProblem, values, iteration, cost, gradient_norm,
                     radius, step_norm, rho):
        """The observers' per-iteration hooks: with ``expose_matrix_data``
        first (H, g) at the new point, then ``on_step`` with a fresh dict of
        the variables per observer, all over one host copy of each pool."""
        if self.config.expose_matrix_data:
            H, g, _ = cp.assemble_normal(values)
            H, g = H.cpu().numpy(), g.cpu().numpy()
            for obs in self.observers:
                if hasattr(obs, "set_matrix_data"):
                    obs.set_matrix_data(H, g)
        named = cp.values_dict(values)
        for obs in self.observers:
            obs.on_step(dict(named), iteration, cost, gradient_norm, radius, step_norm, rho)

    def _python_step(self, cp: CompiledProblem):
        """python mode's step for ``cp``, built once per problem: jit mode's
        step (``_make_device_step``), with its initial state as ``init``."""
        step = self._step_cache.get(cp)
        if step is None:
            step = self._step_cache[cp] = self._make_device_step(cp)
            step.init = self._make_device_init(cp)
        return step

    def _optimize_python(self, cp: CompiledProblem, checkpoint=None) -> SolverResult:
        """The reference's python loop: jit mode's step run eagerly, and one
        host read of the iteration's scalars after each step."""
        cfg = self.config
        start = time.perf_counter()
        step = self._python_step(cp)
        n_pools = len(cp.pools)
        state = list(step.init())
        slot = {name: n_pools + k for k, name in enumerate(self.JIT_STATE)}
        if checkpoint is not None:
            values = tuple(torch.tensor(v, dtype=cp.dtype, device=cp.device)
                           for v in checkpoint.values)
            state[:n_pools] = values
            state[slot["cost"]] = state[slot["initial_cost"]] = cp.cost(values)
            if "damping" in slot:
                # DogLeg keeps its own trust region
                state[slot["damping"]] = torch.full_like(state[slot["damping"]],
                                                         checkpoint.damping)
                state[slot["nu"]] = torch.full_like(state[slot["nu"]], checkpoint.nu)
        # LM's damping or DogLeg's trust region, the first name
        radius_name = self.JIT_STATE[0]
        read = [slot[k] for k in ("initial_cost", "cost", "status", "gradient_norm",
                                  "step_norm", "rho", "n_success", radius_name,
                                  *self.JIT_COUNTERS)]

        stats = [] if (cfg.collect_stats or cfg.verbose) else None
        if cfg.verbose:
            print(IterationStats.HEADER)

        iteration = n_success = 0
        prev_cost = None  # the cost before the iteration, from the second on
        while True:
            it_start = time.perf_counter()
            state = step(*state)
            initial_cost, cost, status, gradient_norm, step_norm, rho, n_now, radius, *counts = \
                torch.stack([state[k].to(torch.float64) for k in read]).tolist()
            status = Status(int(status))
            accepted = n_now > n_success
            n_success = int(n_now)
            values = state[:n_pools]

            if stats is not None:
                st = IterationStats(
                    iteration=iteration, cost=cost,
                    cost_change=(prev_cost if iteration else initial_cost) - cost,
                    gradient_norm=gradient_norm, step_norm=step_norm, tr_ratio=rho,
                    tr_radius=radius, iter_time_ms=(time.perf_counter() - it_start) * 1e3,
                    total_time_ms=(time.perf_counter() - start) * 1e3, accepted=accepted)
                stats.append(st)
                if cfg.verbose:
                    print(st.line())
            prev_cost = cost

            if self.observers:
                self._notify_step(cp, values, iteration, cost, gradient_norm, radius,
                                  step_norm, rho)
            if (status == Status.RUNNING and cfg.timeout is not None
                    and time.perf_counter() - start >= cfg.timeout):
                status = Status.TIMEOUT
            iteration += 1
            if status != Status.RUNNING:
                break

        for name, count in zip(self.JIT_COUNTERS, counts):
            setattr(self, name, getattr(self, name) + int(count))
        covariances = None
        if cfg.compute_covariances:
            from ..core.covariance import compute_covariances

            covariances = compute_covariances(cp, values)

        final_vars = cp.values_dict(values)
        for obs in self.observers:
            if hasattr(obs, "notify_complete"):
                obs.notify_complete(final_vars, iteration)

        return SolverResult(
            status=status,
            iterations=iteration,
            initial_cost=initial_cost,
            final_cost=cost,
            elapsed_seconds=time.perf_counter() - start,
            variables=final_vars,
            final_gradient_norm=gradient_norm,
            final_step_norm=step_norm,
            cost_evaluations=iteration + 1,
            jacobian_evaluations=iteration,
            successful_steps=n_success,
            unsuccessful_steps=iteration - n_success,
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
        solve_fn = self._make_solve_fn(cp)
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
            with span("lm.trial_cost"):
                new_values = cp.apply_step(values, dx)
                new_cost = cp.cost(new_values)
            gradient_norm = torch.linalg.vector_norm(g)
            step_norm = torch.linalg.vector_norm(dx)
            rho = compute_step_quality(current_cost, new_cost, predicted)
            accepted = rho > 0.0
            damping, nu = damping_update(damping, nu, rho, accepted, cfg)
            values = tuple(torch.where(accepted, new, old) for new, old in zip(new_values, values))
            cost = torch.where(accepted, new_cost, current_cost)
            status = check_convergence(
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
        step.host_loop = getattr(solve_fn, "host_loop", None)
        return step

    def _optimize_jit(self, cp: CompiledProblem) -> SolverResult:
        """The whole solve on the device (the reference's ``_optimize_jit``):
        on a card the initial state and the LM loop are one CUDA graph
        (``_JitRun``), captured once per problem, whose WHILE node runs
        iterations while the status is RUNNING and the iteration below a cap
        on the device. Without ``timeout`` a solve is one launch, and the
        host reads the result once. With one, each launch runs
        ``ceil(max_iterations / 8)`` iterations at most, and the host reads
        the status and checks the clock between launches, so that TIMEOUT
        comes after the reference's iteration count. On the CPU the same
        step runs eagerly, the status read before each iteration."""
        cfg = self.config
        start = time.perf_counter()
        chunk = max(1, -(-cfg.max_iterations // 8))
        # the step sets MAX_ITERATIONS_REACHED at this cap itself
        cap = max(1, cfg.max_iterations)
        with span("lm.launch"):
            run = self._jit_cache.get(cp)
            if run is None:
                with span("lm.capture"):
                    run = self._jit_cache[cp] = _JitRun(
                        cp, self.JIT_STATE, self._make_device_init(cp),
                        self._make_device_step(cp), cfg.max_iterations)
            if run.captured is None:
                graphs.zero_device_counts(run.state[0].device)
            elif cfg.timeout is None:
                run.launch(first=True, cap=cap)
        if run.captured is None:
            run.init()
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
        if cfg.timeout is None:
            return self._finish_jit(cp, start, run, None)
        done = 0
        while True:
            done = min(done + chunk, cap)
            with span("lm.launch"):
                run.launch(first=done <= chunk, cap=done)
            with span("lm.read"):
                status = Status(run.status())
            if status != Status.RUNNING:
                break
            if time.perf_counter() - start >= cfg.timeout:
                status = Status.TIMEOUT
                break
        return self._finish_jit(cp, start, run, status)

    def _finish_jit(self, cp: CompiledProblem, start, run, status) -> SolverResult:
        """``SolverResult`` as the reference's ``_finish_jit`` builds it: one
        read of the scalars (``JIT_COUNTERS`` among them, the status where
        ``status`` is None, and on a card the conditional nodes' counts), no
        per-iteration statistics."""
        values = run.state[:len(cp.pools)]
        st = dict(zip(self.JIT_STATE, run.state[len(cp.pools):]))
        # a state tensor's device carries its index, where cp.device may not
        accumulators = graphs.device_counts(values[0].device)
        with span("lm.read"):
            graphs.host_reads += 1
            scalars = [torch.stack([
                st[k].to(torch.float64) for k in ("initial_cost", "cost", "iteration",
                                                  "gradient_norm", "step_norm", "n_success",
                                                  "n_fail", "status", *self.JIT_COUNTERS)])]
            scalars += [acc.to(torch.float64).reshape(1) for _, _, acc in accumulators]
            if run.captured is not None:
                scalars.append(run.captured.counts().to(torch.float64))
            cost0, cost, iteration, gnorm, snorm, n_succ, n_fail, device_status, *rest = \
                (torch.cat(scalars) if len(scalars) > 1 else scalars[0]).tolist()
        with span("lm.result"):
            k = len(self.JIT_COUNTERS)
            counts, device, nodes = rest[:k], rest[k:k + len(accumulators)], \
                rest[k + len(accumulators):]
            if run.captured is not None:
                run.captured.tally([int(c) for c in nodes])
            graphs.add_device_counts(accumulators, device)
            if status is None:
                status = Status(int(device_status))
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
    """jit mode's program and static state for one problem. On a card the
    initial state and the LM loop are captured as one program
    (``graphs.Captured``): an IF node on ``first`` that runs the initial
    state, then the reference's ``run_until_fn``, a WHILE node that runs
    the step while the status is RUNNING and the iteration below ``cap``.
    The host writes ``first`` and ``cap`` (device scalars) before each
    launch. On the CPU the same functions are called eagerly."""

    def __init__(self, cp: CompiledProblem, names, init, step, max_iterations):
        self._init, self._step = init, step
        n_pools = len(cp.pools)
        self._status = n_pools + names.index("status")
        self.state = init()
        self.captured = None
        if cp.device.type == "cuda":
            self.first = torch.ones((), dtype=torch.bool, device=cp.device)
            self.cap = torch.zeros((), dtype=torch.int64, device=cp.device)
            program = device_program(init, step, self.first, self.cap, self._status,
                                     n_pools + names.index("iteration"),
                                     max(1, max_iterations), getattr(step, "host_loop", None))
            self.captured = graphs.Captured(program, self.state,
                                            torch.cuda.graph_pool_handle())
            torch.cuda.synchronize(cp.device)

    def init(self):
        self.state = self._init(*self.state)

    def step(self):
        self.state = self._step(*self.state)

    def launch(self, first, cap):
        """One launch of the captured program: the initial state first
        where ``first``, then iterations up to ``cap``."""
        if first:
            self.captured.zero_counts()
        self.first.fill_(first)
        self.cap.fill_(cap)
        self.captured.launch()

    def status(self) -> int:
        return graphs.read_status(self.state[self._status])


def device_program(init, step, first, cap, status, iteration, max_trips, host=None):
    """The jit solve as one program on jit state: ``init`` where the 0-d
    bool ``first`` holds, then ``step`` while ``state[status]`` is RUNNING
    and ``state[iteration]`` below the 0-d ``cap`` (``max_trips`` at most;
    the warm-up runs one trip). ``host``, a reason, keeps the loop on the
    host (``graphs.while_update``)."""
    def more(*state):
        return (state[status] == int(Status.RUNNING)) & (state[iteration] < cap)

    def program(*state):
        state = graphs.cond_update(first, init, *state)
        return graphs.while_update(more, step, max_trips, *state, warmup_trips=1, host=host)

    return program
