"""End-to-end SE2 pose graphs, the robust-loss sweep with a manifold prior,
and LM's dense solvers of the PyTorch port, f64 on the CPU: the certified
medium SE2 fixture through the three solvers, and the JAX package's own
end-to-end cases held to apex_tpu (the same iterations and status, the
final cost within rtol 1e-8)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu.core import losses as jlosses
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.convert import values_from_jax
from apex_tpu_torch.core import losses
from apex_tpu_torch.io import synthetic
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
# tests/test_medium_fixture.py: the certified f64 optimum and iterations
MEDIUM_SE2 = ("medium_se2_300.g2o", 5.668402411723587e-02, 9)
CERTIFIED = dict(max_iterations=100, cost_tolerance=1e-10, parameter_tolerance=1e-14,
                 gradient_tolerance=1e-14)


@pytest.mark.parametrize("solver", ["sparse_cholesky", "dense_cholesky", "dense_qr"])
def test_medium_se2_reaches_certified_cost(solver):
    fname, cost, iters = MEDIUM_SE2
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type=solver, **CERTIFIED)
    r = apx.LevenbergMarquardt(cfg).optimize(
        apx.load_g2o(FIXTURES / fname).to_problem().compile(device="cpu"))
    assert r.converged and r.iterations == iters
    np.testing.assert_allclose(r.final_cost, cost, rtol=1e-8)


def _solve_both(make_problem, cfg=None, check_variables=False):
    """make_problem(pkg) solved by both packages; the port held to
    apex_tpu. Returns the port's result."""
    cfg = cfg or {}
    rj = jax_apx.LevenbergMarquardt(jax_apx.LevenbergMarquardtConfig(**cfg)).optimize(
        make_problem(jax_apx).compile(dtype=np.float64))
    rt = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(**cfg)).optimize(
        make_problem(apx).compile(device="cpu"))
    assert (rt.iterations, rt.status) == (rj.iterations, apx.Status(int(rj.status)))
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    if check_variables:
        for name, v in rj.variables.items():
            np.testing.assert_allclose(rt.variables[name], v, rtol=0, atol=1e-8)
    return rt


def _graph(pkg, **kw):
    return (jax_synthetic if pkg is jax_apx else synthetic).synthetic_pose_graph_2d(**kw)


def _outliers(pkg, loss=None):
    """tests/test_pose_graph_e2e.py::test_robust_loss_on_outlier_edges: an
    80-pose ring with three loop edges corrupted hard."""
    g = _graph(pkg, n_poses=80, trajectory="ring", seed=11)
    for e in g.edges_se2[-3:]:
        e.measurement = e.measurement + np.array([2.0, -1.5, 0.7])
    return g.to_problem(loss=loss)


def test_ring_se2_default_solver():
    """test_ring_se2_lm_converges with LM's default configuration
    (``dense_cholesky``)."""
    assert apx.LevenbergMarquardtConfig().linear_solver_type == "dense_cholesky"
    r = _solve_both(lambda pkg: _graph(pkg, n_poses=100, trajectory="ring", seed=1).to_problem(),
                    check_variables=True)
    assert r.converged and r.final_cost < 0.15 * r.initial_cost
    g = synthetic.synthetic_pose_graph_2d(n_poses=100, trajectory="ring", seed=1)
    assert g.chi2(r.variables) < g.chi2()


def test_manhattan_se2_with_loops():
    r = _solve_both(lambda pkg: _graph(pkg, n_poses=150, trajectory="manhattan",
                                       loop_stride=10, seed=3).to_problem())
    assert r.converged and r.final_cost < 0.15 * r.initial_cost


def test_robust_loss_on_outlier_edges():
    """Huber keeps the trajectory closer to the clean solution than L2."""
    res_l2 = _solve_both(_outliers)
    res_huber = _solve_both(lambda pkg: _outliers(pkg, pkg.HuberLoss(1.0)))
    assert res_huber.converged
    g_clean = synthetic.synthetic_pose_graph_2d(n_poses=80, trajectory="ring", seed=11)
    res_clean = apx.LevenbergMarquardt().optimize(g_clean.to_problem().compile(device="cpu"))

    def traj_err(a, b):
        return np.mean([np.linalg.norm(a[k][:2] - b[k][:2]) for k in a])

    assert traj_err(res_huber.variables, res_clean.variables) < traj_err(
        res_l2.variables, res_clean.variables)


# tests/test_pose_graph_e2e.py::test_robust_loss_sweep_with_priors_parking_garage
SWEEP = [("l2", ()), ("huber", (1.0,)), ("cauchy", (1.0,)), ("fair", (1.3998,)),
         ("geman_mcclure", (1.0,)), ("welsch", (2.9846,)), ("tukey_biweight", (4.6851,)),
         ("trimmed_mean", (2.0,)), ("barron_general", (-2.0, 1.0)), ("t_distribution", (5.0,))]


@pytest.mark.parametrize("name,args", SWEEP, ids=[name for name, _ in SWEEP])
def test_robust_sweep_with_prior_matches_apex_tpu(name, args):
    """48 SE3 poses on 4 rings, the loss on every edge and a
    ManifoldPriorFactor on the first pose, LM's defaults and 40 iterations:
    converged with the cost below 0.6x the initial, as the JAX test asks."""
    kw = dict(n_poses=48, rings=4, seed=21)

    def make(pkg):
        mod = jax_synthetic if pkg is jax_apx else synthetic
        lib = jlosses if pkg is jax_apx else losses
        g = mod.synthetic_pose_graph_3d(**kw)
        first = sorted(g.vertices_se3)[0]
        problem = g.to_problem(loss=lib.LOSS_BY_NAME[name](*args))
        problem.add_residual_block(
            [f"x{first}"], pkg.ManifoldPriorFactor("SE3", np.asarray(g.vertices_se3[first])))
        return problem

    r = _solve_both(make, dict(max_iterations=40))
    assert r.converged and r.final_cost < 0.6 * r.initial_cost


def test_values_from_jax_se2_and_so2_pools():
    """values_from_jax carries SE2 and SO2 pools across (a heading
    variable with a manifold prior beside the SE2 poses)."""

    def make(pkg):
        p = _graph(pkg, n_poses=12, trajectory="ring", seed=4).to_problem()
        p.add_variable("h0", "SO2", np.array([0.3]))
        p.add_residual_block(["h0"], pkg.ManifoldPriorFactor("SO2", np.array([2.9])))
        return p

    jcp = make(jax_apx).compile(dtype=np.float64)
    cp = make(apx).compile(device="cpu")
    arrays = [np.asarray(v) for v in jcp.initial_values()]
    values = values_from_jax(cp, arrays, jcp.pools)
    assert [p.manifold.name for p in cp.pools] == ["SO2", "SE2"]
    for v, a in zip(values, arrays):
        assert v.dtype == torch.float64
        np.testing.assert_array_equal(v.numpy(), a)
    np.testing.assert_allclose(float(cp.cost(values)), float(jcp.cost(jcp.initial_values())),
                               rtol=1e-12)
