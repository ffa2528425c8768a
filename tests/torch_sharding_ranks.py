"""The rank side of ``test_torch_sharding.py``: every case of the port's
multi-device functions, run on each rank of a spawned gloo world on the
CPU. It imports no JAX, so that a spawned rank starts in a few seconds.

``cases(mesh)`` returns {case: numpy arrays and numbers}; the test process
holds each rank's results to the JAX package and to the port's
single-device functions."""

import torch

import apex_tpu_torch as apx
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.factors import ManifoldPriorFactor
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.parallel import (make_sharded_banded_lm_step, make_sharded_lm_step,
                                     make_sharded_normal_fn, make_sharded_schur_step)

F64 = torch.float64
DEVICE = "cpu"
# The flat-layout block path is held to the JAX package's at rtol 1e-8 with
# its PCG solved to 1e-12 (as tests/test_sharding.py's Schur case does) and
# from damping 1e2. From 1e-3 the scale gauge leaves the reduced camera
# system's condition near 1e9: PCG stops at its cap of Dc = 54 iterations
# near 1e-10, and the costs after a step differ by up to 1e-7 between two
# rank counts of one package as between the packages. From 1e2 they agree
# to 1e-14.
FLAT_PCG = dict(pcg_tolerance=1e-12, pcg_max_iterations=500)
FLAT_DAMPING = 1e2


def ring_problem():
    g = synthetic.synthetic_pose_graph_2d(n_poses=50, trajectory="ring", seed=2)
    return g.to_problem().compile(dtype=F64, device=DEVICE)


def huber_problem():
    g = synthetic.synthetic_pose_graph_2d(n_poses=33, seed=4)  # odd count: padding
    return g.to_problem(loss=apx.HuberLoss(1.0), fix_first=True).compile(dtype=F64, device=DEVICE)


def se3_problem(seed):
    g = synthetic.synthetic_pose_graph_3d(n_poses=48, rings=4, seed=seed)
    return g.to_problem().compile(dtype=F64, device=DEVICE)


def ba_problem():
    ds = synthetic.synthetic_ba(n_cameras=7, n_points=110, seed=4)
    return build_ba_problem(ds, mode="self_calibration").compile(dtype=F64, device=DEVICE)


def prior_problem():
    ds = synthetic.synthetic_ba(n_cameras=5, n_points=60, seed=2)
    problem = build_ba_problem(ds, mode="self_calibration")
    problem.add_residual_block(["pose_0001"], ManifoldPriorFactor("SE3", ds.camera_se3()[1]))
    return problem.compile(dtype=F64, device=DEVICE)


def flat_problem():
    ds = synthetic.synthetic_ba_large(n_cameras=6, n_points=300, obs_per_camera=100, seed=3)
    return build_ba_problem(ds, layout="flat").compile(dtype=F64, device=DEVICE)


def _state(cp, damping=1e-3):
    values = cp.initial_values()
    return (values, torch.tensor(damping, dtype=cp.dtype), torch.tensor(2.0, dtype=cp.dtype),
            cp.cost(values))


def _costs(step, cp, n, damping=1e-3, **kw):
    """[initial cost, cost after each of n steps from ``damping``], and the
    final values."""
    state = _state(cp, damping)
    costs = [float(state[3])]
    for _ in range(n):
        state = step(*state, **kw)
        costs.append(float(state[3]))
    return costs, [v.numpy() for v in state[0]]


def _normal(cp, mesh):
    fn, shard_args = make_sharded_normal_fn(cp, mesh)
    H, g, cost = fn(cp.initial_values(), *shard_args)
    return dict(H=H.numpy(), g=g.numpy(), cost=float(cost),
                rows=[group.count for group, _ in shard_args])


def _solve(step, cp):
    dx, g, cost, pred = step.solve(cp.initial_values(), torch.tensor(1e-3, dtype=cp.dtype))
    return dict(dx=dx.numpy(), g=g.numpy(), cost=float(cost), predicted=float(pred))


def cases(mesh):
    torch.set_num_threads(1)
    out = {"ring": _normal(ring_problem(), mesh), "huber": _normal(huber_problem(), mesh)}

    cp = se3_problem(9)
    out["dense"] = dict(zip(("costs", "values"), _costs(make_sharded_lm_step(cp, mesh), cp, 8)))

    cp = se3_problem(0)
    banded, _ = _costs(make_sharded_banded_lm_step(cp, mesh), cp, 3)
    dense, _ = _costs(make_sharded_lm_step(cp, mesh), cp, 1)
    out["banded"] = dict(banded=banded, dense=dense)

    cp = ba_problem()
    step, _ = make_sharded_schur_step(cp, mesh)
    out["partitioned"] = _solve(step, cp)
    out["partitioned"].update(
        metas=[(m.cap, m.n, m.n_loc, m.k_loc) for m in step.metas],
        local_landmarks=step.context.num_landmarks,
        local_rows=[step.context._group(m.gi).count for m in step.metas])
    out["partitioned"]["costs"], _ = _costs(step, cp, 6)
    # the forcing sequence and the warm start, as a solve loop drives them
    state, warm = _state(cp), []
    for i in range(6):
        state = step(*state, iteration=i, dx_prev=step.last_dx)
        warm.append(float(state[3]))
    out["partitioned"]["warm_costs"] = warm

    cp = prior_problem()
    step, _ = make_sharded_schur_step(cp, mesh)
    out["prior"] = dict(partitioned=hasattr(step, "solve"), **_solve(step, cp))

    cp = flat_problem()
    step, _ = make_sharded_schur_step(cp, mesh, **FLAT_PCG)
    costs, values = _costs(step, cp, 3)
    damped, _ = _costs(step, cp, 3, damping=FLAT_DAMPING)
    out["flat"] = dict(partitioned=hasattr(step, "solve"), costs=costs, damped=damped,
                       values=values)
    out["all_reduces"] = mesh.all_reduces
    return out
