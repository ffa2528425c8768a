"""The port's matrix-free normal-equation solver (``pcg``) against the dense
H and against apex_tpu, on the CPU in f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu.linalg.iterative import IterativeNormalSolver as JaxIterative
from apex_tpu_torch.convert import values_from_jax
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.linalg.iterative import IterativeNormalSolver
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

DAMPING = 1e-3


@pytest.fixture(scope="module")
def setup():
    """A 40-pose SE3 sphere with a robust loss, the first pose fixed, at a
    mid-solve state shared by both packages."""
    kw = dict(n_poses=40, rings=4, seed=20)
    pj = jax_synthetic.synthetic_pose_graph_3d(**kw).to_problem(
        loss=jax_apx.HuberLoss(1.0), fix_first=True)
    pt = synthetic.synthetic_pose_graph_3d(**kw).to_problem(
        loss=apx.HuberLoss(1.0), fix_first=True)
    jcp = pj.compile(dtype=np.float64)
    tcp = pt.compile(dtype=torch.float64, device="cpu")
    dx = np.random.default_rng(1).normal(scale=1e-2, size=jcp.total_dof)
    jvals = jcp.apply_step(jcp.initial_values(), jnp.asarray(dx))
    tvals = values_from_jax(tcp, [np.asarray(v) for v in jvals], jcp.pools)
    return jcp, tcp, jvals, tvals


def test_matvec_gradient_and_cost_match_dense_h(setup):
    _, tcp, _, tvals = setup
    solver = IterativeNormalSolver(tcp)
    blocks, g, cost = solver._linearize_all(tvals)
    H, g_ref, cost_ref = tcp.assemble_normal(tvals)
    torch.testing.assert_close(g, g_ref, rtol=1e-12, atol=1e-12 * float(g_ref.abs().max()))
    torch.testing.assert_close(cost, cost_ref, rtol=1e-13, atol=0)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=tcp.total_dof))
    want = H @ x + DAMPING * x
    got = solver._hx(blocks, x, DAMPING)
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


def test_block_preconditioner_is_the_inverse_block_diagonal(setup):
    _, tcp, _, tvals = setup
    solver = IterativeNormalSolver(tcp)
    blocks, _, _ = solver._linearize_all(tvals)
    (inv,) = solver._block_diag_inv(blocks, DAMPING)
    H, _, _ = tcp.assemble_normal(tvals)
    cols = solver._pool_cols[0]
    diag_blocks = H[cols[:, :, None], cols[:, None, :]] + DAMPING * torch.eye(6, dtype=H.dtype)
    # the fixed pose's block is damping I alone: clamped, not inverted to 1e3
    free = tcp.pools[0].free_mask[:, 0] == 1
    assert int((~free).sum()) == 1
    eye = torch.eye(6, dtype=H.dtype).expand(int(free.sum()), 6, 6)
    torch.testing.assert_close(inv[free] @ diag_blocks[free], eye, rtol=0, atol=1e-9)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=tcp.total_dof))
    y = solver._apply_prec([inv], x)
    torch.testing.assert_close(y[cols], (inv @ x[cols][..., None])[..., 0], rtol=0, atol=0)


def test_solve_matches_dense_and_apex_tpu(setup):
    """One damped solve: the step of the dense Cholesky (rtol 1e-7 of its
    largest entry at a CG tolerance of 1e-10), and apex_tpu's dx, g and cost
    (dx to 1e-7 too: both stop on the same test, not on the same iterate)."""
    jcp, tcp, jvals, tvals = setup
    solver = IterativeNormalSolver(tcp, max_iterations=500, tolerance=1e-10)
    dx, g, cost = solver.solve(tvals, DAMPING)
    H, g_ref, _ = tcp.assemble_normal(tvals)
    ref = torch.linalg.solve(H + DAMPING * torch.eye(tcp.total_dof, dtype=H.dtype), -g_ref)
    assert (dx - ref).abs().max() <= 1e-7 * ref.abs().max()
    jsolver = JaxIterative(jcp, max_iterations=500, tolerance=1e-10)
    jdx, jg, jcost = jax.jit(lambda v: jsolver.solve(v, DAMPING))(jvals)
    assert np.abs(dx.numpy() - np.asarray(jdx)).max() <= 1e-7 * np.abs(np.asarray(jdx)).max()
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-12)


def test_iteration_cap_and_dtype(setup):
    _, tcp, _, tvals = setup
    capped = IterativeNormalSolver(tcp, max_iterations=2, tolerance=1e-14)
    full = IterativeNormalSolver(tcp, max_iterations=500, tolerance=1e-14)
    dx2, _, _ = capped.solve(tvals, DAMPING)
    dx, _, _ = full.solve(tvals, DAMPING)
    assert torch.isfinite(dx2).all() and (dx2 - dx).abs().max() > 1e-6 * dx.abs().max()
    cp32 = synthetic.synthetic_pose_graph_2d(n_poses=30, seed=2).to_problem().compile(
        dtype=torch.float32, device="cpu")
    dx32, g32, cost32 = IterativeNormalSolver(cp32).solve(cp32.initial_values(), 1e-3)
    assert dx32.dtype == g32.dtype == cost32.dtype == torch.float32
    assert torch.isfinite(dx32).all()


def _lm(pkg, solver, **kw):
    return pkg.LevenbergMarquardt(pkg.LevenbergMarquardtConfig(linear_solver_type=solver, **kw))


def test_lm_pcg_matches_dense_and_apex_tpu():
    """tests/test_optimizers.py's SE2 ring with Huber(1.0): the same
    iterations and status as apex_tpu, final cost to rtol 1e-8; and the
    dense solver's optimum to rtol 1e-6."""
    kw = dict(n_poses=80, trajectory="ring", seed=21)
    pj = jax_synthetic.synthetic_pose_graph_2d(**kw).to_problem(loss=jax_apx.HuberLoss(1.0))
    tcp = synthetic.synthetic_pose_graph_2d(**kw).to_problem(loss=apx.HuberLoss(1.0)).compile(
        dtype=torch.float64, device="cpu")
    rj = _lm(jax_apx, "pcg").optimize(pj.compile(dtype=np.float64))
    rt = _lm(apx, "pcg").optimize(tcp)
    assert rt.converged and rt.final_cost < 0.15 * rt.initial_cost
    assert rt.iterations == rj.iterations and rt.status == apx.Status(int(rj.status))
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    np.testing.assert_allclose(rt.final_cost, _lm(apx, "dense_cholesky").optimize(tcp).final_cost,
                               rtol=1e-6)


def test_lm_pcg_se3_matches_dense():
    """tests/test_optimizers.py's SE3 case (slow there: the JAX compile)."""
    tcp = synthetic.synthetic_pose_graph_3d(n_poses=60, rings=4, seed=20).to_problem().compile(
        dtype=torch.float64, device="cpu")
    r_dense = _lm(apx, "dense_cholesky").optimize(tcp)
    r_pcg = _lm(apx, "pcg", pcg_max_iterations=300, pcg_tolerance=1e-12).optimize(tcp)
    assert r_pcg.converged, r_pcg.status
    np.testing.assert_allclose(r_pcg.final_cost, r_dense.final_cost, rtol=1e-6)


def test_lm_pcg_options(monkeypatch):
    """LM hands the solver 3x its PCG iteration cap and a tolerance of at
    most 1e-8."""
    import apex_tpu_torch.linalg.iterative as iterative

    seen = {}

    class Spy(IterativeNormalSolver):
        def __init__(self, cp, max_iterations, tolerance, **kw):
            seen.update(max_iterations=max_iterations, tolerance=tolerance)
            super().__init__(cp, max_iterations, tolerance, **kw)

    monkeypatch.setattr(iterative, "IterativeNormalSolver", Spy)
    cp = synthetic.synthetic_pose_graph_2d(n_poses=20, seed=1).to_problem().compile(
        dtype=torch.float64, device="cpu")
    assert _lm(apx, "pcg", pcg_max_iterations=50, pcg_tolerance=1e-3).optimize(cp).converged
    assert seen == dict(max_iterations=150, tolerance=1e-8)
    _lm(apx, "pcg", pcg_tolerance=1e-11)._make_solve_fn(cp)
    assert seen["tolerance"] == 1e-11
