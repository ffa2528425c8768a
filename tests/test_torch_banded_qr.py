"""The port's banded QR tier against a dense solve and against apex_tpu, on
the CPU in f64. Solutions are compared, never Q or R: ``torch.linalg.qr``
and XLA's pick different column signs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu.linalg.banded_qr import make_blocktri_qr_core as jax_qr_core
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.linalg.banded import make_blocktri_cr_core
from apex_tpu_torch.linalg.banded_qr import make_blocktri_qr_core
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)


def _random_blocktri(n, m, seed, spd_shift=None):
    """Random symmetric block-tridiagonal (Dg, Cg, dense H), as
    tests/test_banded_qr.py builds it."""
    rng = np.random.default_rng(seed)
    H = np.zeros((n * m, n * m))
    Dg, Cg = np.zeros((n, m, m)), np.zeros((n, m, m))
    for i in range(n):
        A = rng.normal(size=(m, m))
        A = A + A.T
        if spd_shift is not None:
            A += spd_shift * np.eye(m)
        Dg[i] = A
        H[i * m:(i + 1) * m, i * m:(i + 1) * m] = A
        if i > 0:
            Cg[i] = rng.normal(size=(m, m))
            H[i * m:(i + 1) * m, (i - 1) * m:i * m] = Cg[i]
            H[(i - 1) * m:i * m, i * m:(i + 1) * m] = Cg[i].T
    return Dg, Cg, H


def _solve(core, Dg, Cg, b, damping=None):
    return core(torch.from_numpy(Dg), torch.from_numpy(Cg), torch.from_numpy(b), damping).numpy()


@pytest.mark.parametrize("n,m", [(1, 5), (2, 4), (3, 4), (7, 6), (16, 8)])
def test_qr_core_matches_dense(n, m):
    Dg, Cg, H = _random_blocktri(n, m, seed=n * 31 + m, spd_shift=4.0 * m)
    b = np.random.default_rng(99).normal(size=(n, m))
    core = make_blocktri_qr_core(n * m, m, torch.float64)
    assert (core.block, core.n_blocks) == (m, n)
    x = _solve(core, Dg, Cg, b)
    np.testing.assert_allclose(x, np.linalg.solve(H, b.reshape(-1)), rtol=1e-10, atol=1e-10)


def test_qr_core_indefinite_matches_dense_and_apex_tpu():
    """QR needs no positive definiteness: a symmetric indefinite system
    (no diagonal shift) solves to the dense answer in both packages."""
    n, m = 7, 6
    Dg, Cg, H = _random_blocktri(n, m, seed=5)
    assert np.linalg.eigvalsh(H)[0] < 0
    b = np.random.default_rng(1).normal(size=(n, m))
    x = _solve(make_blocktri_qr_core(n * m, m, torch.float64), Dg, Cg, b, 0.37)
    ref = np.linalg.solve(H + 0.37 * np.eye(n * m), b.reshape(-1))
    np.testing.assert_allclose(x, ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())
    xj = np.asarray(jax_qr_core(n * m, m, jnp.float64)(
        jnp.asarray(Dg), jnp.asarray(Cg), jnp.asarray(b), damping=0.37))
    np.testing.assert_allclose(x, xj, rtol=1e-9, atol=1e-9 * np.abs(ref).max())


def test_qr_core_damping():
    n, m = 5, 4
    Dg, Cg, H = _random_blocktri(n, m, seed=3, spd_shift=3.0 * m)
    b = np.random.default_rng(4).normal(size=(n, m))
    x = _solve(make_blocktri_qr_core(n * m, m, torch.float64), Dg, Cg, b, 0.37)
    ref = np.linalg.solve(H + 0.37 * np.eye(n * m), b.reshape(-1))
    np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-10)


def _singular_band(n, m, seed):
    rng = np.random.default_rng(seed)
    D = n * m
    G = rng.normal(size=(D - 2, D))
    H = G.T @ G
    Dg = np.stack([H[i * m:(i + 1) * m, i * m:(i + 1) * m] for i in range(n)])
    Cg = np.zeros((n, m, m))
    Hb = np.zeros_like(H)
    for i in range(n):
        Hb[i * m:(i + 1) * m, i * m:(i + 1) * m] = Dg[i]
        if i > 0:
            Cg[i] = H[i * m:(i + 1) * m, (i - 1) * m:i * m]
            Hb[i * m:(i + 1) * m, (i - 1) * m:i * m] = Cg[i]
            Hb[(i - 1) * m:i * m, i * m:(i + 1) * m] = Cg[i].T
    return Dg, Cg, Hb, rng.normal(size=(n, m))


def test_qr_core_singular_with_damping():
    """With damping > 0 the QR tolerates a singular H (the gauge-free pose
    graph): finite and equal to the damped dense solve."""
    n, m = 4, 3
    Dg, Cg, Hb, b = _singular_band(n, m, seed=7)
    x = _solve(make_blocktri_qr_core(n * m, m, torch.float64), Dg, Cg, b, 1e-4)
    assert np.all(np.isfinite(x))
    ref = np.linalg.solve(Hb + 1e-4 * np.eye(n * m), b.reshape(-1))
    np.testing.assert_allclose(x, ref, rtol=1e-8, atol=1e-8)


def test_qr_core_retry_ladder_on_exact_singularity():
    """A zero diagonal block row makes R singular at zero damping: the step
    is not finite, and the ladder's first shift (1e-10 of the mean
    diagonal) gives the shifted system's answer."""
    n, m = 3, 2
    Dg = np.stack([np.eye(m), np.zeros((m, m)), np.eye(m)])
    Cg = np.zeros((n, m, m))
    b = np.ones((n, m))
    x = _solve(make_blocktri_qr_core(n * m, m, torch.float64), Dg, Cg, b)
    assert np.all(np.isfinite(x))
    reg = 1e-10 * (4.0 / 6.0)
    np.testing.assert_allclose(x, b.reshape(-1) / (np.repeat([1.0, 0.0, 1.0], m) + reg),
                               rtol=1e-12)


def test_qr_core_matches_cr_core_on_a_pose_graph_band():
    """The two tiers on one assembled band, with a padded last block."""
    from apex_tpu_torch.linalg.banded import BandedNormalAssembler

    cp = synthetic.synthetic_pose_graph_3d(n_poses=50, rings=5, seed=1).to_problem(
        fix_first=True).compile(dtype=torch.float64, device="cpu")
    asm = BandedNormalAssembler(cp)
    assert asm.Dp > asm.D and asm.n > 2
    Dg, Cg, g, _ = asm.assemble(cp.initial_values())
    Dg = asm.pad_diag_ones(Dg)
    bp = torch.nn.functional.pad(-g, (0, asm.Dp - asm.D)).reshape(asm.n, asm.m)
    x_qr = make_blocktri_qr_core(asm.D, asm.m, torch.float64)(Dg, Cg, bp, 1e-3)
    x_cr = make_blocktri_cr_core(asm.D, asm.m, torch.float64)(Dg, Cg, bp, 1e-3)
    assert (x_qr - x_cr).abs().max() <= 1e-9 * x_cr.abs().max()


@pytest.fixture(scope="module")
def ring60():
    kw = dict(n_poses=60, loop_stride=3, seed=11)
    return (jax_synthetic.synthetic_pose_graph_2d(**kw).to_problem(fix_first=True),
            synthetic.synthetic_pose_graph_2d(**kw).to_problem(fix_first=True))


@pytest.mark.parametrize("solver", ["sparse_qr", "banded_qr"])
def test_lm_sparse_qr_matches_cholesky_and_apex_tpu(ring60, solver):
    pj, pt = ring60
    tcp = pt.compile(dtype=torch.float64, device="cpu")

    def lm(pkg, name):
        return pkg.LevenbergMarquardt(pkg.LevenbergMarquardtConfig(
            linear_solver_type=name, max_iterations=40))

    rq = lm(apx, solver).optimize(tcp)
    assert rq.converged, rq.summary()
    for other in ("sparse_cholesky", "dense_cholesky"):
        rc = lm(apx, other).optimize(tcp)
        assert rq.iterations == rc.iterations
        np.testing.assert_allclose(rq.final_cost, rc.final_cost, rtol=1e-8, atol=1e-12)
    if solver == "sparse_qr":
        rj = lm(jax_apx, solver).optimize(pj.compile(dtype=np.float64))
        assert rq.iterations == rj.iterations and rq.status == apx.Status(int(rj.status))
        np.testing.assert_allclose(rq.final_cost, rj.final_cost, rtol=1e-8)


def test_lm_sparse_qr_free_gauge_and_jacobi_scaling():
    """A gauge-free SE3 graph: H is singular, the damping carries the QR."""
    pt = synthetic.synthetic_pose_graph_3d(n_poses=24, rings=3, seed=5).to_problem()
    tcp = pt.compile(dtype=torch.float64, device="cpu")
    ref = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", max_iterations=30)).optimize(tcp)
    for kw in ({}, {"use_jacobi_scaling": True}, {"banded_panel": 160}):
        r = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_qr", max_iterations=30, **kw)).optimize(tcp)
        assert r.converged and r.final_cost < 0.05 * r.initial_cost
        np.testing.assert_allclose(r.final_cost, ref.final_cost, rtol=1e-6)


def test_sparse_qr_wide_band_falls_to_dense_qr():
    """Above a block bandwidth of 1536, banded_qr runs dense_qr (the solve
    functions are told apart by name; a dense QR of this size is not run
    here)."""
    p = apx.Problem()
    ident = np.array([0, 0, 0, 1.0, 0, 0, 0])
    for i in range(300):
        p.add_variable(f"x{i}", "SE3", ident)
    for i in range(299):
        p.add_residual_block([f"x{i}", f"x{i + 1}"], apx.BetweenFactor("SE3", ident))
    p.add_residual_block(["x0", "x299"], apx.BetweenFactor("SE3", ident))
    wide = p.compile(dtype=torch.float64, device="cpu", ordering="name")
    narrow = synthetic.synthetic_pose_graph_2d(n_poses=20, seed=0).to_problem().compile(
        dtype=torch.float64, device="cpu")

    def solve_fn(cp, solver):
        return apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type=solver))._make_solve_fn(cp).__name__

    for name in ("sparse_qr", "banded_qr"):
        assert solve_fn(wide, name) == solve_fn(wide, "dense_qr") == "solve_qr"
        assert solve_fn(narrow, name) == solve_fn(narrow, "sparse_cholesky") == "solve_banded"
