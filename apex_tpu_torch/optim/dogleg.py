"""Powell's Dog Leg with the Ceres enhancements (counterpart of
``apex_tpu/optim/dogleg.py``).

- Cauchy point alpha = ||g||^2 / (g^T H g)
- the three-case step: Gauss-Newton inside the trust region, steepest
  descent scaled to the boundary, or the interpolation with the
  cancellation-robust beta
- predicted reduction -step^T g - 0.5 step^T H step, from the undamped H
- acceptance at rho > 1e-4; a good step (rho > 0.75) sets the radius to
  max(radius, 3 ||step||) and lowers mu, a poor one (rho < 0.25) halves it
- mu regularizes the Gauss-Newton solve only (initial 1e-4)
- a rejected poor step leaves its linearization in a cache, reused at most
  5 times (the parameters have not moved, so it is still exact)

In python mode the trust region, mu and the cache ride where LM's damping
rides, as a dict; the decision to reuse is taken on the host, and each step
reads its scalars back once. In ``mode="jit"`` (the reference's
``state_pack``) delta and mu are 0-d tensors and the cache is fixed device
buffers in the loop state (``DogLeg.JIT_STATE``, then the Hessian's
representation: the dense H, or the band's Dg and Cg); the fresh/reuse
``lax.cond`` is a ``graphs.cond_update`` on the device flag, whose body
(assembly, the solve with mu, the Cauchy point) writes the cache in place,
and the trust-region update and acceptance are ``torch.where``.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch
from torch.profiler import record_function

from ..core.problem import CompiledProblem
from ..linalg import dense
from . import graphs
from .common import (
    ConvergenceConfig,
    Status,
    check_convergence,
    check_convergence_t,
    compute_step_quality,
    compute_step_quality_t,
)
from .lm import LevenbergMarquardt, LevenbergMarquardtConfig

MAX_STEP_REUSE = 5
_SCHUR_NAMES = ("schur_explicit", "schur_implicit", "schur", "schur_auto",
                "sparse_schur_complement", "iterative_schur")


@dataclasses.dataclass
class DogLegConfig:
    linear_solver_type: str = "dense_cholesky"
    max_iterations: int = 50
    cost_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-10
    timeout: Optional[float] = None
    min_cost_threshold: Optional[float] = None
    trust_region_radius: float = 1e4
    trust_region_min: float = 1e-12
    trust_region_max: float = 1e12
    trust_region_decrease_factor: float = 0.5
    good_step_quality: float = 0.75
    poor_step_quality: float = 0.25
    initial_mu: float = 1e-4
    min_mu: float = 1e-12
    max_mu: float = 1e8
    mu_increase_factor: float = 10.0
    enable_step_reuse: bool = True
    compute_covariances: bool = False
    mode: str = "python"
    collect_stats: bool = False
    verbose: bool = False

    def convergence(self) -> ConvergenceConfig:
        return ConvergenceConfig(
            max_iterations=self.max_iterations,
            cost_tolerance=self.cost_tolerance,
            parameter_tolerance=self.parameter_tolerance,
            gradient_tolerance=self.gradient_tolerance,
            timeout=self.timeout,
            min_cost_threshold=self.min_cost_threshold,
            min_trust_region_radius=self.trust_region_min,
        )


def _dogleg_step(g, dx_gn, cauchy, delta):
    """The three-case dog-leg step from its pieces. Every branch is
    evaluated and selected with ``where`` on scalar conditions; each
    untaken side is computed from safe inputs, so it is finite."""
    one = torch.ones((), dtype=g.dtype, device=g.device)
    gn_norm = torch.linalg.vector_norm(dx_gn)
    c_norm = torch.linalg.vector_norm(cauchy)
    g_norm = torch.linalg.vector_norm(g)

    # case 2: steepest descent scaled to the boundary
    safe_g = torch.where(g_norm == 0, one, g_norm)
    sd_step = -(delta / safe_g) * g

    # case 3: the interpolation, with Ceres' cancellation-robust beta
    v = dx_gn - cauchy
    a = torch.sum(v * v)
    b = torch.sum(cauchy * v)
    c = c_norm * c_norm - delta * delta
    d2 = b * b - a * c
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    safe_a = torch.where(torch.abs(a) < 1e-15, one, a)
    safe_bd = torch.where(b + d == 0, one, b + d)
    beta = torch.where(
        (d2 < 0.0) | (torch.abs(a) < 1e-15),
        one,
        torch.where(b <= 0.0, (-b + d) / safe_a, -c / safe_bd),
    )
    beta = torch.clamp(beta, 0.0, 1.0)
    dl_step = cauchy + beta * v

    return torch.where(gn_norm <= delta, dx_gn,
                       torch.where(c_norm >= delta, sd_step, dl_step))


def _cauchy_point(g, rep, hmatvec):
    """-alpha g with alpha = ||g||^2 / (g^T H g), 1 where g^T H g is tiny."""
    gTg = torch.sum(g * g)
    gHg = torch.sum(g * hmatvec(rep, g))
    return -torch.where(torch.abs(gHg) > 1e-15, gTg / gHg, torch.ones_like(gHg)) * g


class DogLeg(LevenbergMarquardt):
    # jit mode's state after the pool tensors: the trust region and mu
    # where LM's damping rides, the loop's scalars, the steps taken from
    # the cache, and the cache; the Hessian's representation in the cache
    # (H, or Dg and Cg) follows these names
    JIT_STATE = ("delta", "mu", "cost", "iteration", "status", "gradient_norm", "step_norm",
                 "rho", "n_success", "n_fail", "initial_cost", "reused_steps",
                 "cache_valid", "cache_count", "cache_g", "cache_dx_gn", "cache_cauchy")
    JIT_COUNTERS = ("reused_steps",)

    def __init__(self, config: Optional[DogLegConfig] = None):
        self.dl_config = config or DogLegConfig()
        cfg = self.dl_config
        super().__init__(LevenbergMarquardtConfig(
            linear_solver_type=cfg.linear_solver_type,
            max_iterations=cfg.max_iterations,
            cost_tolerance=cfg.cost_tolerance,
            parameter_tolerance=cfg.parameter_tolerance,
            gradient_tolerance=cfg.gradient_tolerance,
            timeout=cfg.timeout,
            min_cost_threshold=cfg.min_cost_threshold,
            compute_covariances=cfg.compute_covariances,
            mode=cfg.mode,
            collect_stats=cfg.collect_stats,
            verbose=cfg.verbose,
        ))
        # steps taken from the cache, over this object's solves
        self.reused_steps = 0
        # the Hessian functions per compiled problem (the band plan is host
        # work), shared by both modes' steps and jit mode's initial state
        self._hessians = weakref.WeakKeyDictionary()

    def _hessian_functions(self, cp: CompiledProblem):
        """(assemble, hsolve, hmatvec, empty_rep) for the configured solver,
        built once per problem. The Hessian's representation ``rep`` is a
        tuple: the dense [D, D] matrix, or the block-tridiagonal (Dg, Cg) of
        the banded assembler, ``Cg[i] = H[i, i-1]``; ``empty_rep()`` is its
        zeros, jit mode's empty cache."""
        if cp not in self._hessians:
            self._hessians[cp] = self._build_hessian_functions(cp)
        return self._hessians[cp]

    def _build_hessian_functions(self, cp: CompiledProblem):
        dl = self.dl_config
        solver_type = {"sparse_cholesky": "banded_cholesky",
                       "sparse_qr": "banded_qr"}.get(dl.linear_solver_type,
                                                     dl.linear_solver_type)
        if solver_type in _SCHUR_NAMES:
            # every Schur name goes to the Cholesky tier instead of raising:
            # banded where the pattern allows, dense for bundle adjustment,
            # whose landmark-camera coupling makes the band the whole matrix
            from ..linalg import banded

            solver_type = ("banded_cholesky"
                           if banded.block_bandwidth(cp) <= banded.MAX_BANDWIDTH
                           else "dense_cholesky")
        if solver_type not in ("dense_cholesky", "dense_qr", "banded_cholesky", "banded_qr"):
            raise NotImplementedError(
                "DogLeg supports dense_cholesky / dense_qr / sparse_cholesky (banded) / "
                "sparse_qr (banded); Schur types fall back to Cholesky")

        if solver_type in ("banded_cholesky", "banded_qr"):
            from ..linalg import banded

            asm = banded.BandedNormalAssembler(cp)
            if solver_type == "banded_qr":
                from ..linalg.banded_qr import make_blocktri_qr_core

                core = make_blocktri_qr_core(cp.total_dof, asm.m, cp.dtype)
            else:
                core = banded.make_blocktri_cr_core(cp.total_dof, asm.m, cp.dtype)
            D, m, n, Dp = asm.D, asm.m, asm.n, asm.Dp

            def blocks(v):
                return torch.nn.functional.pad(v, (0, Dp - D)).reshape(n, m)

            def assemble(values):
                Dg, Cg, g, cost = asm.assemble(values)
                return (asm.pad_diag_ones(Dg), Cg), g, cost

            def hsolve(rep, g, mu):
                return core(rep[0], rep[1], blocks(-g), mu)[:D]

            def hmatvec(rep, v):
                Dg, Cg = rep
                xb = blocks(v)[..., None]
                hx = (Dg @ xb)[..., 0]
                hx[1:] += (Cg[1:] @ xb[:-1])[..., 0]
                hx[:-1] += (Cg[1:].mT @ xb[1:])[..., 0]
                return hx.reshape(-1)[:D]

            def empty_rep():
                return tuple(torch.zeros(n, m, m, dtype=cp.dtype, device=cp.device)
                             for _ in range(2))
        else:

            def assemble(values):
                H, g, cost = cp.assemble_normal(values)
                return (H,), g, cost

            def hsolve(rep, g, mu):
                return dense.solve_cholesky_with_retry(rep[0], g, mu)

            def hmatvec(rep, v):
                return rep[0] @ v

            def empty_rep():
                D = cp.total_dof
                return (torch.zeros(D, D, dtype=cp.dtype, device=cp.device),)

        return assemble, hsolve, hmatvec, empty_rep

    def _make_step_fn(self, cp: CompiledProblem):
        dl = self.dl_config
        ccfg = dl.convergence()
        assemble, hsolve, hmatvec, _ = self._hessian_functions(cp)

        def step(values, pack, nu, iteration, jacobi_scale):
            delta, mu, cache = pack["delta"], pack["mu"], pack["cache"]
            if cache is not None and cache["count"] < MAX_STEP_REUSE and iteration > 0:
                rep, g, dx_gn, cauchy, current_cost = cache["pieces"]
                reuse_count = cache["count"] + 1
                self.reused_steps += 1
            else:
                with record_function("dogleg.assemble"):
                    rep, g, current_cost = assemble(values)
                with record_function("dogleg.solve"):
                    # mu enters the solve only: rep stays the undamped H
                    dx_gn = hsolve(rep, g, mu)
                cauchy = _cauchy_point(g, rep, hmatvec)
                reuse_count = 0

            dx = _dogleg_step(g, dx_gn, cauchy, delta)
            predicted = -torch.sum(dx * g) - 0.5 * torch.sum(dx * hmatvec(rep, dx))
            with record_function("lm.trial_cost"):
                new_values = cp.apply_step(values, dx)
                new_cost_t = cp.cost(new_values)
            # one read-back of this step's scalars
            cost_f, new_cost, predicted, gradient_norm, step_norm = torch.stack([
                current_cost, new_cost_t, predicted,
                torch.linalg.vector_norm(g), torch.linalg.vector_norm(dx),
            ]).tolist()

            rho = compute_step_quality(cost_f, new_cost, predicted)
            accepted = rho > 1e-4
            good = rho > dl.good_step_quality
            poor = rho < dl.poor_step_quality
            if good:
                new_delta = min(max(delta, 3.0 * step_norm), dl.trust_region_max)
                new_mu = max(mu / (0.5 * dl.mu_increase_factor), dl.min_mu)
            else:
                new_delta = (max(delta * dl.trust_region_decrease_factor, dl.trust_region_min)
                             if poor else delta)
                new_mu = mu

            if accepted:
                values, cost = new_values, new_cost
            else:
                cost = cost_f
            # reuse only what a rejected step left: the parameters have not moved
            new_cache = None
            if not accepted and poor and dl.enable_step_reuse:
                new_cache = dict(pieces=(rep, g, dx_gn, cauchy, current_cost),
                                 count=reuse_count)

            status = check_convergence(
                iteration=iteration,
                current_cost=cost_f,
                new_cost=cost,
                parameter_norm=float(cp.parameter_norm(values)),
                parameter_update_norm=step_norm,
                gradient_norm=gradient_norm,
                step_accepted=accepted,
                cfg=ccfg,
                trust_region_radius=new_delta,
            )
            metrics = dict(rho=rho, accepted=accepted, gradient_norm=gradient_norm,
                           step_norm=step_norm, new_cost=new_cost)
            new_pack = dict(delta=new_delta, mu=new_mu, cache=new_cache)
            return values, new_pack, nu, cost, status, jacobi_scale, metrics

        return step

    def _init_damping_state(self, cp: CompiledProblem, values):
        dl = self.dl_config
        return dict(delta=float(dl.trust_region_radius), mu=float(dl.initial_mu), cache=None)

    # ------------------------------------------------------------------
    def _make_device_init(self, cp: CompiledProblem):
        """The reference's initial state for DogLeg: the initial values and
        cost, delta and mu, the empty statistics and an invalid cache."""
        dl = self.dl_config
        dt, dev, D = cp.dtype, cp.device, cp.total_dof
        empty_rep = self._hessian_functions(cp)[3]

        def full(value, dtype=dt):
            return torch.full((), value, dtype=dtype, device=dev)

        def init(*state):
            values = tuple(v.clone() for v in cp.initial_values())
            cost0 = cp.cost(values)
            nan = float("nan")
            return graphs.assign(state, (
                *values, full(dl.trust_region_radius), full(dl.initial_mu), cost0.clone(),
                full(0, torch.int64), full(int(Status.RUNNING), torch.int32), full(nan),
                full(nan), full(nan), full(0, torch.int64), full(0, torch.int64), cost0,
                full(0, torch.int64), full(False, torch.bool), full(0, torch.int64),
                *(torch.zeros(D, dtype=dt, device=dev) for _ in range(3)), *empty_rep()))

        return init

    def _make_device_step(self, cp: CompiledProblem):
        """The reference's DogLeg ``step`` on jit state: fresh or reuse by
        ``graphs.cond_update`` on ``~can_reuse`` (the fresh body writes the
        cache buffers and the cost in place; the solvers' ladders nest in
        it), then the dog-leg step, rho, acceptance at rho > 1e-4, delta, mu
        and the cache's validity as ``torch.where``."""
        dl = self.dl_config
        ccfg = dl.convergence()
        assemble, hsolve, hmatvec, _ = self._hessian_functions(cp)
        n_pools, n_named = len(cp.pools), len(self.JIT_STATE)

        def step(*state):
            values = state[:n_pools]
            (delta, mu, cost, iteration, _, _, _, _, n_succ, n_fail, cost0, reused,
             valid, count, g, dx_gn, cauchy) = state[n_pools:n_pools + n_named]
            rep = state[n_pools + n_named:]
            can_reuse = valid & (count < MAX_STEP_REUSE) & (iteration > 0)

            def fresh(*_):
                with record_function("dogleg.assemble"):
                    rep, g, current_cost = assemble(values)
                with record_function("dogleg.solve"):
                    dx_gn = hsolve(rep, g, mu)
                return (*rep, g, dx_gn, _cauchy_point(g, rep, hmatvec), current_cost,
                        torch.zeros_like(count))

            # reuse keeps the cache and the loop's cost: the rejected step
            # left the parameters where the cache was linearized
            *rep, g, dx_gn, cauchy, current_cost, count = graphs.cond_update(
                ~can_reuse, fresh, *rep, g, dx_gn, cauchy, cost, count)
            count = torch.where(can_reuse, count + 1, count)

            dx = _dogleg_step(g, dx_gn, cauchy, delta)
            predicted = -torch.sum(dx * g) - 0.5 * torch.sum(dx * hmatvec(rep, dx))
            with record_function("lm.trial_cost"):
                new_values = cp.apply_step(values, dx)
                new_cost = cp.cost(new_values)
            gradient_norm = torch.linalg.vector_norm(g)
            step_norm = torch.linalg.vector_norm(dx)
            rho = compute_step_quality_t(current_cost, new_cost, predicted)
            accepted = rho > 1e-4
            good = rho > dl.good_step_quality
            poor = rho < dl.poor_step_quality
            new_delta = torch.where(
                good, torch.clamp_max(torch.maximum(delta, 3.0 * step_norm), dl.trust_region_max),
                torch.where(poor, torch.clamp_min(delta * dl.trust_region_decrease_factor,
                                                  dl.trust_region_min), delta))
            new_mu = torch.where(
                good, torch.clamp_min(mu / (0.5 * dl.mu_increase_factor), dl.min_mu), mu)
            values = tuple(torch.where(accepted, new, old) for new, old in zip(new_values, values))
            cost = torch.where(accepted, new_cost, current_cost)
            # reuse only what a rejected step left: the parameters have not moved
            valid = ~accepted & poor & dl.enable_step_reuse
            status = check_convergence_t(
                iteration=iteration,
                current_cost=current_cost,
                new_cost=cost,
                parameter_norm=cp.parameter_norm(values),
                parameter_update_norm=step_norm,
                gradient_norm=gradient_norm,
                step_accepted=accepted,
                cfg=ccfg,
                trust_region_radius=new_delta,
            )
            return graphs.assign(state, (
                *values, new_delta, new_mu, cost, iteration + 1, status, gradient_norm,
                step_norm, rho, n_succ + accepted, n_fail + ~accepted, cost0,
                reused + can_reuse, valid, count, g, dx_gn, cauchy, *rep))

        return step
