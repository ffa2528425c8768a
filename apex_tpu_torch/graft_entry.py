"""Top-level entry points of the port (counterpart of ``__graft_entry__.py``).

- ``entry(device="cuda")`` -> (fn, example_args): one full
  Levenberg-Marquardt iteration (linearize, banded assembly, damped block
  cyclic reduction solve, manifold step, Nielsen damping) on a synthetic
  SE3 pose graph, ``LevenbergMarquardt``'s one step, run eagerly;
- ``dryrun_multichip(n_ranks, device="cuda", backend=None)``: spawns a world
  of ``n_ranks`` processes and takes one step of each multi-device solve:
  the factor-sharded pose-graph LM with dense and with banded normal
  equations, the landmark-partitioned BA Schur step and the
  observation-sharded block fallback of a flat BA layout.
"""

from __future__ import annotations

import math

import torch


def _small_problem(n_poses=32, rings=4, seed=0, device="cuda"):
    from .io import synthetic

    g = synthetic.synthetic_pose_graph_3d(n_poses=n_poses, rings=rings, seed=seed)
    return g.to_problem().compile(device=device)


def entry(device="cuda"):
    """(step, state): ``step(*state)`` is one LM iteration on the 32-pose
    sphere, and returns the next state. The problem has one pool, so the
    state is (values, damping, nu, cost, iteration, ...): the pool tensor,
    then ``LevenbergMarquardt.JIT_STATE``, 0-d tensors after ``values``."""
    from .optim.lm import LevenbergMarquardt, LevenbergMarquardtConfig

    cp = _small_problem(device=device)
    lm = LevenbergMarquardt(LevenbergMarquardtConfig(linear_solver_type="sparse_cholesky"))
    return lm._make_device_step(cp), lm._make_device_init(cp)()


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _one_step(step, cp, values=None):
    """(cost before, cost after) of one step from ``values`` (default: the
    initial values), damping 1e-3."""
    values = cp.initial_values() if values is None else values
    damping = torch.tensor(1e-3, dtype=cp.dtype, device=cp.device)
    nu = torch.tensor(2.0, dtype=cp.dtype, device=cp.device)
    cost0 = cp.cost(values)
    return float(cost0), float(step(values, damping, nu, cost0)[3])


def _dryrun_rank(mesh):
    """The four checks on one rank; the lines rank 0 prints."""
    from .ba import build_ba_problem
    from .io import synthetic
    from .parallel import (make_sharded_banded_lm_step, make_sharded_lm_step,
                           make_sharded_schur_step)

    n = mesh.size
    lines = []
    # 1. pose graph, factor-sharded dense normal equations
    cp = _small_problem(n_poses=24, rings=3, device=mesh.device)
    cost0, cost = _one_step(make_sharded_lm_step(cp, mesh), cp)
    _check(math.isfinite(cost) and cost < cost0, f"dense sharded LM step {cost0} -> {cost}")
    lines.append(f"dryrun_multichip({n}): pose-graph LM step cost {cost0:.6e} -> {cost:.6e} OK")

    # 1b. the same graph, banded normal equations (per-rank band plans)
    b0, b1 = _one_step(make_sharded_banded_lm_step(cp, mesh), cp)
    _check(math.isfinite(b1) and b1 < b0, f"banded sharded LM step {b0} -> {b1}")
    _check(abs(b1 - cost) / cost < 1e-6, f"banded {b1} against dense {cost}")
    lines.append(f"dryrun_multichip({n}): banded sharded LM step cost {b0:.6e} -> {b1:.6e} OK")

    # 2. bundle adjustment, default (bucketed) layout: landmarks partitioned
    ds = synthetic.synthetic_ba(n_cameras=5, n_points=60, seed=0)
    cp_ba = build_ba_problem(ds).compile(device=mesh.device)
    ba_step, _ = make_sharded_schur_step(cp_ba, mesh)
    _check(hasattr(ba_step, "solve"), "the bucketed BA layout must take the partitioned path")
    c0, c1 = _one_step(ba_step, cp_ba)
    _check(math.isfinite(c1) and c1 < c0, f"partitioned Schur BA step {c0} -> {c1}")
    lines.append(f"dryrun_multichip({n}): sharded Schur BA step (landmarks partitioned) "
                 f"cost {c0:.6e} -> {c1:.6e} OK")

    # 2b. a flat layout (unequal observation runs) takes the block path
    ds_f = synthetic.synthetic_ba_large(n_cameras=5, n_points=80, obs_per_camera=40, seed=1)
    cp_f = build_ba_problem(ds_f, layout="flat").compile(device=mesh.device)
    fb_step, _ = make_sharded_schur_step(cp_f, mesh)
    _check(not hasattr(fb_step, "solve"), "the flat BA layout must take the block path")
    f0, f1 = _one_step(fb_step, cp_f)
    _check(math.isfinite(f1) and f1 < f0, f"block Schur BA step {f0} -> {f1}")
    lines.append(f"dryrun_multichip({n}): sharded Schur BA step (block fallback) "
                 f"cost {f0:.6e} -> {f1:.6e} OK")
    return dict(lines=lines, costs=dict(dense=(cost0, cost), banded=(b0, b1),
                                        partitioned=(c0, c1), block=(f0, f1)))


def dryrun_multichip(n_ranks: int, device="cuda", backend=None) -> dict:
    """One step of each multi-device solve on a spawned world of
    ``n_ranks`` (``parallel.launch``); prints rank 0's lines and returns
    its costs {solve: (before, after)}. ``backend`` defaults to ``nccl``
    on ``cuda`` (one card per rank) and ``gloo`` on the CPU; ``gloo`` lets
    ranks share a card."""
    from .parallel import launch

    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    results = launch(_dryrun_rank, n_ranks, backend, device)
    for line in results[0]["lines"]:
        print(line)
    return results[0]["costs"]
