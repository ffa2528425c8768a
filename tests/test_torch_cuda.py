"""Tests of the port that need a CUDA card (marker ``cuda``; they skip
without one). This file imports nothing of JAX, so it also runs where only
PyTorch is installed: ``pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import apex_tpu_torch as apx
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.kernels import landmark_blocks as lb
from assembly_problems import (assembly_scene, behind_a_camera, camera_major_problem,
                               pinhole_problem)
from chip_smoke import (SELFCAL_MODELS, extended_chain, rosenbrock_problem, selfcal_problem,
                        selfcal_scene)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _blocks(n, seed):
    """Random SPD blocks plus a near-singular, a zero and a 1e12-scaled
    block (at 5, 17 and 100, or modulo n when there are fewer)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 3, 3))
    H = A @ np.transpose(A, (0, 2, 1)) + 0.1 * np.eye(3)
    H[5 % n] = np.diag([1e-15, 1.0, 1.0])  # near-singular
    H[17 % n] = np.zeros((3, 3))  # fully degenerate
    H[100 % n] *= 1e12  # huge scale
    return H


def _assert_bitwise_plain(H, k):
    p = lb.invert_landmark_blocks_plain(H)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    assert torch.equal(k, p), f"max abs diff {(k - p).abs().max().item()}"


T = lb.TILE


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [1, 2, 3, T - 1, T, T + 1, 2 * T + 3, 65_132, 156_502, 226_730])
def test_kernel_matches_plain(card, dtype, P):
    """Every tile count and ragged edge: bitwise the plain version, one
    launch per call."""
    H = torch.as_tensor(_blocks(P, seed=11), dtype=dtype, device=card)
    before = lb.launches
    k = lb.invert_landmark_blocks(H)
    assert lb.launches == before + 1
    _assert_bitwise_plain(H, k)


def test_kernel_needs_16_byte_alignment(card):
    H = torch.as_tensor(_blocks(300, seed=4), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="aligned"):
        lb.invert_landmark_blocks(H[1:])  # 72 B past the allocation


@pytest.mark.parametrize("dtype,skip", [(torch.float64, 2), (torch.float32, 4)])
def test_kernel_takes_aligned_views(card, dtype, skip):
    H = torch.as_tensor(_blocks(2 * T + 7, seed=5), dtype=dtype, device=card)
    view = H[skip:]  # 144 B past the allocation
    assert view.data_ptr() % 16 == 0
    _assert_bitwise_plain(view, lb.invert_landmark_blocks(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_config(card, dtype):
    c = lb.launch_config(dtype)
    assert c["tile_blocks"] == lb.TILE
    assert c["ctas_per_sm"] >= 1 and c["sms"] >= 1


def test_compile_defaults_to_the_card(card):
    ds = synthetic.synthetic_ba(n_cameras=4, n_points=40, seed=1)
    cp = build_ba_problem(ds).compile()
    assert cp.device.type == "cuda"
    # optimize(Problem) compiles with those defaults: the kernel launches
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type="schur_implicit", max_iterations=2)
    before = lb.launches
    apx.LevenbergMarquardt(cfg).optimize(build_ba_problem(ds))
    assert lb.launches > before


def test_kernel_rejects_what_it_does_not_take(card):
    H = torch.as_tensor(_blocks(300, seed=2), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        lb.invert_landmark_blocks(H.transpose(1, 2))
    with pytest.raises(TypeError):
        lb.invert_landmark_blocks(H.half())
    with pytest.raises(ValueError, match="3, 3"):
        lb.invert_landmark_blocks(H.reshape(-1, 9))


def test_small_solve_card_matches_cpu(card):
    """Exact inner solves in f64: the card and the CPU take the same LM
    path. CUDA index_add_ sums in atomic order, so costs agree to rounding
    (rtol 1e-8), not bitwise."""
    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    problem = build_ba_problem(ds)
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type="schur_implicit", max_iterations=30,
                                       pcg_forcing=False, pcg_tolerance=1e-10,
                                       pcg_max_iterations=500)
    before = lb.launches
    rc = apx.LevenbergMarquardt(cfg).optimize(problem.compile(device=card))
    assert lb.launches - before >= rc.iterations
    rh = apx.LevenbergMarquardt(cfg).optimize(problem.compile(device="cpu"))
    assert (rc.iterations, rc.status) == (rh.iterations, rh.status)
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)


# -- the banded SE3 pose-graph path --------------------------------------------


def _banded_spd(D, half_band, seed):
    rng = np.random.default_rng(seed)
    A = np.zeros((D, D))
    for i in range(D):
        j0 = max(0, i - half_band + 1)
        A[i, j0:i + 1] = rng.normal(size=i + 1 - j0)
    A = A @ A.T + D * np.eye(D)
    W = 2 * half_band - 1
    mask = np.abs(np.subtract.outer(np.arange(D), np.arange(D))) < W
    return np.where(mask, A, 0.0), W, rng.normal(size=D)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
@pytest.mark.parametrize("base_blocks", [2, None])
def test_cr_solve_card_matches_cpu(card, dtype, rtol, base_blocks):
    from apex_tpu_torch.linalg import banded

    A, W, g = _banded_spd(1500, 160, seed=7)
    solve = banded.make_blocktri_cr_solver(1500, W, dtype, base_blocks=base_blocks)
    A_t, g_t = torch.from_numpy(A).to(dtype), torch.from_numpy(g).to(dtype)
    x_card = solve(A_t.to(card), g_t.to(card), 0.1).cpu()
    x_cpu = solve(A_t, g_t, 0.1)
    scale = x_cpu.abs().max()
    assert (x_card - x_cpu).abs().max() <= rtol * scale


def test_band_assembly_card_matches_cpu(card):
    from apex_tpu_torch.linalg import banded

    problem = synthetic.synthetic_pose_graph_3d(n_poses=300, rings=10, seed=0).to_problem()
    out = {}
    for device in (card, "cpu"):
        cp = problem.compile(dtype=torch.float64, device=device)
        out[str(device)] = banded.BandedNormalAssembler(cp).assemble(cp.initial_values())
    for a, b in zip(out[str(card)], out["cpu"]):
        a = a.cpu()
        assert (a - b).abs().max() <= 1e-12 * max(float(b.abs().max()), 1e-300)


def test_medium_fixture_on_the_card(card):
    """tests/test_medium_fixture.py's certified optimum, reached on the
    card in the same 6 LM iterations."""
    from pathlib import Path

    path = Path(__file__).resolve().parent / "fixtures" / "medium_se3_250.g2o"
    cfg = apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", max_iterations=100, cost_tolerance=1e-10,
        parameter_tolerance=1e-14, gradient_tolerance=1e-14)
    r = apx.LevenbergMarquardt(cfg).optimize(apx.load_g2o(path).to_problem().compile(device=card))
    assert r.converged and r.iterations == 6
    np.testing.assert_allclose(r.final_cost, 5.132992631561506e-01, rtol=1e-8)


def test_retry_ladder_card_matches_cpu(card):
    """An indefinite block-tridiagonal system: the failed factorizations
    give NaN on the card too, and the ladder's fifth shift gives the CPU's
    answer."""
    from apex_tpu_torch.linalg import banded

    A, _, b = _banded_spd(6 * 32, 16, seed=5)
    lam = np.linalg.eigvalsh(A)[0]
    A = A - (lam + 1e-3 * (np.trace(A) / A.shape[0] - lam)) * np.eye(A.shape[0])
    A4 = A.reshape(6, 32, 6, 32)
    Dg = torch.from_numpy(np.stack([A4[i, :, i] for i in range(6)]))
    Cg = torch.from_numpy(np.stack([np.zeros((32, 32))] + [A4[i, :, i - 1] for i in range(1, 6)]))
    bp = torch.from_numpy(b.reshape(6, 32))
    core = banded.make_blocktri_cr_core(A.shape[0], 32, torch.float64, base_blocks=2)
    x_card = core(Dg.to(card), Cg.to(card), bp.to(card)).cpu()
    x_cpu = core(Dg, Cg, bp)
    assert torch.isfinite(x_card).all()
    assert (x_card - x_cpu).abs().max() <= 1e-9 * x_cpu.abs().max()


def test_failed_cholesky_is_nan_on_the_card(card):
    from apex_tpu_torch.linalg import banded

    eye = torch.eye(8, dtype=torch.float64, device=card)
    L = banded._cholesky(torch.stack([2.0 * eye, -eye, 2.0 * eye]))
    assert torch.isnan(L[1]).all()
    torch.testing.assert_close(L[0], eye * 2.0 ** 0.5)
    torch.testing.assert_close(L[2], L[0])


# -- SE2, the loss menu and the dense tier -------------------------------------


@pytest.mark.parametrize("solver", ["sparse_cholesky", "dense_cholesky", "dense_qr"])
def test_medium_se2_on_the_card(card, solver):
    """tests/test_medium_fixture.py's certified SE2 optimum in 9 LM
    iterations on the card, as on the CPU."""
    from pathlib import Path

    path = Path(__file__).resolve().parent / "fixtures" / "medium_se2_300.g2o"
    cfg = apx.LevenbergMarquardtConfig(
        linear_solver_type=solver, max_iterations=100, cost_tolerance=1e-10,
        parameter_tolerance=1e-14, gradient_tolerance=1e-14)
    problem = apx.load_g2o(path).to_problem()
    rc = apx.LevenbergMarquardt(cfg).optimize(problem.compile(device=card))
    rh = apx.LevenbergMarquardt(cfg).optimize(problem.compile(device="cpu"))
    assert rc.converged and rc.iterations == rh.iterations == 9 and rc.status == rh.status
    np.testing.assert_allclose(rc.final_cost, 5.668402411723587e-02, rtol=1e-8)
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)


def test_losses_card_match_cpu(card):
    """Every loss kernel on the card against the CPU in f64 (rtol 1e-13),
    over a grid of s from 0 to 1e6."""
    from apex_tpu_torch.core import losses

    s = torch.cat([torch.tensor([0.0, 1e-300], dtype=torch.float64),
                   10.0 ** torch.linspace(-12, 6, 61, dtype=torch.float64)])
    for name, make in losses.LOSS_BY_NAME.items():
        loss = make()
        for part, c, h in zip(("rho", "rho'", "rho''"), loss.evaluate(s.to(card)),
                              loss.evaluate(s)):
            assert c.device.type == "cuda"
            torch.testing.assert_close(c.cpu(), h, rtol=1e-13, atol=1e-13 * float(h.abs().max()),
                                       msg=f"{name} {part}")


def _dense_spd(D, seed, shift_to_indefinite=False):
    A = np.random.default_rng(seed).normal(size=(D, D))
    A = A @ A.T + D * np.eye(D)
    if shift_to_indefinite:  # the retry ladder's fifth shift rescues it
        lam = np.linalg.eigvalsh(A)[0]
        A = A - (lam + 1e-3 * (np.trace(A) / D - lam)) * np.eye(D)
    return torch.from_numpy(A)


@pytest.mark.parametrize("kind", ["spd", "indefinite"])
def test_dense_solvers_card_match_cpu(card, kind):
    from apex_tpu_torch.linalg import dense

    H = _dense_spd(300, 3, kind == "indefinite")
    g = torch.from_numpy(np.random.default_rng(4).normal(size=300))
    x_card = dense.solve_cholesky_with_retry(H.to(card), g.to(card), 0.5).cpu()
    x_cpu = dense.solve_cholesky_with_retry(H, g, 0.5)
    assert torch.isfinite(x_card).all()
    assert (x_card - x_cpu).abs().max() <= 1e-9 * x_cpu.abs().max()
    J = torch.from_numpy(np.random.default_rng(6).normal(size=(900, 300)))
    q_card = dense.solve_qr(g.new_ones(900).to(card), J.to(card), 1e-3).cpu()
    q_cpu = dense.solve_qr(g.new_ones(900), J, 1e-3)
    assert (q_card - q_cpu).abs().max() <= 1e-12 * q_cpu.abs().max()


# -- explicit Schur, Gauss-Newton, DogLeg, sparse_qr, pcg, covariances ---------

FIXTURES = __import__("pathlib").Path(__file__).resolve().parent / "fixtures"


@pytest.mark.parametrize("solver", ["schur_explicit", "schur"])
def test_explicit_schur_card_matches_cpu(card, solver):
    """The explicit solve in f64: the same LM path on the card and the CPU,
    and the landmark kernel launched once per LM iteration."""
    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    problem = build_ba_problem(ds)
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type=solver, max_iterations=30)
    lm = apx.LevenbergMarquardt(cfg)
    cp = problem.compile(device=card)
    before = lb.launches
    rc = lm.optimize(cp)
    assert lb.launches - before == rc.iterations
    assert lm._step_cache[cp].solve_fn.schur_context.variant == "sparse"
    rh = apx.LevenbergMarquardt(cfg).optimize(problem.compile(device="cpu"))
    assert (rc.iterations, rc.status) == (rh.iterations, rh.status)
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)


def test_explicit_schur_matrix_card_matches_cpu(card):
    """S and b of one assembly, pairs in chunks of 37 on the card."""
    from apex_tpu_torch.linalg.schur import SchurContext, landmark_inverse

    ds = synthetic.synthetic_ba(n_cameras=6, n_points=80, seed=2)
    problem = build_ba_problem(ds)
    out = {}
    for device in (card, "cpu"):
        cp = problem.compile(device=device)
        ctx = SchurContext(cp, variant="sparse")
        ctx.PAIR_CHUNK = 37 if device is card else SchurContext.PAIR_CHUNK
        Hcc, _, Hpp, _, Ws, _ = ctx.assemble(cp.initial_values(), 0.1)
        out[str(device)] = ctx._schur_dense(Hcc, landmark_inverse(Hpp), Ws).cpu()
    S_card, S_cpu = out[str(card)], out["cpu"]
    assert (S_card - S_cpu).abs().max() <= 1e-12 * S_cpu.abs().max()


@pytest.mark.parametrize("optimizer", ["gn", "dl"])
@pytest.mark.parametrize("solver", ["sparse_cholesky", "dense_cholesky", "sparse_qr"])
def test_optimizers_card_match_cpu(card, optimizer, solver):
    problem = synthetic.synthetic_pose_graph_3d(n_poses=120, rings=6, seed=3).to_problem(
        fix_first=solver == "sparse_qr")

    def make():
        if optimizer == "gn":
            return apx.GaussNewton(apx.GaussNewtonConfig(linear_solver_type=solver))
        return apx.DogLeg(apx.DogLegConfig(linear_solver_type=solver))

    rc = make().optimize(problem.compile(device=card))
    rh = make().optimize(problem.compile(device="cpu"))
    assert rc.converged and (rc.iterations, rc.status) == (rh.iterations, rh.status)
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)


@pytest.mark.parametrize("solver", ["sparse_qr", "pcg"])
@pytest.mark.parametrize("fname,certified", [("medium_se3_250.g2o", 5.132992631561506e-01),
                                             ("medium_se2_300.g2o", 5.668402411723587e-02)])
def test_small_solvers_on_the_card(card, solver, fname, certified):
    cfg = apx.LevenbergMarquardtConfig(
        linear_solver_type=solver, max_iterations=100, cost_tolerance=1e-10,
        parameter_tolerance=1e-14, gradient_tolerance=1e-14)
    r = apx.LevenbergMarquardt(cfg).optimize(
        apx.load_g2o(FIXTURES / fname).to_problem().compile(device=card))
    assert r.converged
    np.testing.assert_allclose(r.final_cost, certified, rtol=1e-8)


def test_qr_core_card_matches_cpu(card):
    from apex_tpu_torch.linalg.banded_qr import make_blocktri_qr_core

    A, _, b = _banded_spd(6 * 32, 16, seed=5)
    A4 = A.reshape(6, 32, 6, 32)
    Dg = torch.from_numpy(np.stack([A4[i, :, i] for i in range(6)]))
    Cg = torch.from_numpy(np.stack([np.zeros((32, 32))] + [A4[i, :, i - 1] for i in range(1, 6)]))
    bp = torch.from_numpy(b.reshape(6, 32))
    core = make_blocktri_qr_core(A.shape[0], 32, torch.float64)
    x_card = core(Dg.to(card), Cg.to(card), bp.to(card), 0.3).cpu()
    x_cpu = core(Dg, Cg, bp, 0.3)
    assert (x_card - x_cpu).abs().max() <= 1e-12 * x_cpu.abs().max()
    np.testing.assert_allclose(x_cpu.numpy(), np.linalg.solve(A + 0.3 * np.eye(192), b),
                               rtol=1e-10, atol=1e-12)


def test_covariances_card_match_cpu(card):
    """LM's covariance blocks (dense route), the selected blocks, and the
    banded route called directly, card against CPU."""
    from apex_tpu_torch.core import covariance

    problem = apx.load_g2o(FIXTURES / "medium_se3_250.g2o").to_problem(fix_first=True)
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type="sparse_cholesky",
                                       compute_covariances=True)
    out = {}
    for device in (card, "cpu"):
        cp = problem.compile(device=device)
        res = apx.LevenbergMarquardt(cfg).optimize(cp)
        v0 = cp.initial_values()
        out[str(device)] = (res.covariances,
                            covariance.compute_covariances_for(cp, v0, ["x0", "x7", "x249"]),
                            covariance._banded_covariances_for(cp, v0, ["x0", "x7", "x249"]))
    for got, want in zip(out[str(card)], out["cpu"]):
        assert set(got) == set(want)
        for n in want:
            assert got[n].shape == (6, 6)
            assert np.abs(got[n] - want[n]).max() <= 1e-8 * max(np.abs(want[n]).max(), 1e-300)
    assert np.abs(out[str(card)][0]["x0"]).max() == 0.0  # the fixed pose


def _capped_general(base_cap):
    from apex_tpu_torch.linalg import sparse_general as sg

    class Capped(sg.GeneralSparseCholesky):
        def __init__(self, cp, deg_cap=24, min_picked=32, **_):
            super().__init__(cp, deg_cap=deg_cap, base_cap=base_cap, min_picked=min_picked)

    return Capped


def test_general_plan_tensors_on_the_card(card):
    """Every plan tensor of the general tier is moved to the card once, at
    construction."""
    from apex_tpu_torch.linalg.sparse_general import GeneralSparseCholesky

    cp = synthetic.synthetic_pose_graph_grid3d(4, 3, 3).to_problem().compile(device=card)
    gs = GeneralSparseCholesky(cp, base_cap=8)
    assert gs.sym.n_levels >= 1
    tensors = [gs._h_dest, gs._g_dest, gs._diag_pin, gs._diag_slots_all, gs._real,
               gs._core_i, gs._core_j, gs._core_slots, gs._base_ids]
    tensors += [t for lv in gs._levels_dev for t in lv.values()]
    assert all(t.device.type == "cuda" for t in tensors)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 5e-4)])
def test_general_solve_card_matches_cpu(card, dtype, rtol):
    """Assembly and one solve with elimination levels, card against CPU,
    the gauge fixed by the first pose. f32: the CPU's f32 step is 1.8e-5
    (of its largest entry) from the f64 one, so rounding alone moves it by
    that much."""
    from apex_tpu_torch.linalg.sparse_general import GeneralSparseCholesky

    problem = synthetic.synthetic_pose_graph_grid3d(5, 4, 3, seed=0).to_problem(fix_first=True)
    out = {}
    for device in (card, "cpu"):
        cp = problem.compile(dtype=dtype, device=device)
        gs = GeneralSparseCholesky(cp, base_cap=8)
        out[str(device)] = [t.cpu() for t in gs.solve(cp.initial_values(), 1e-3)]
    for a, b in zip(out[str(card)], out["cpu"]):
        assert (a - b).abs().max() <= rtol * max(float(b.abs().max()), 1e-300)


@pytest.mark.parametrize("levels", [True, False], ids=["levels", "no_levels"])
def test_general_lm_card_matches_cpu(card, levels, monkeypatch):
    """LM sparse_general on the 6x6x4 grid: the same iterations and status
    on the card and the CPU, final cost within rtol 1e-8."""
    from apex_tpu_torch.linalg import sparse_general as sg

    if levels:
        monkeypatch.setattr(sg, "GeneralSparseCholesky", _capped_general(8))
    problem = synthetic.synthetic_pose_graph_grid3d(6, 6, 4, seed=1).to_problem()
    res = {}
    for device in (card, "cpu"):
        lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_general", max_iterations=30, cost_tolerance=1e-6))
        cp = problem.compile(dtype=torch.float64, device=device)
        assert (lm._make_solve_fn(cp).general_sparse.sym.n_levels > 0) == levels
        res[str(device)] = lm.optimize(cp)
    rc, rh = res[str(card)], res["cpu"]
    assert (rc.iterations, rc.status) == (rh.iterations, rh.status) and rc.converged
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)


def test_sparse_cholesky_switches_on_the_card(card):
    """Above a 1536-column bandwidth sparse_cholesky takes the general tier
    on the card as on the CPU."""
    p = apx.Problem()
    ident = np.array([0, 0, 0, 1.0, 0, 0, 0])
    for i in range(300):
        p.add_variable(f"x{i}", "SE3", ident)
    for i in range(299):
        p.add_residual_block([f"x{i}", f"x{i + 1}"], apx.BetweenFactor("SE3", ident))
    p.add_residual_block(["x0", "x299"], apx.BetweenFactor("SE3", ident))
    cp = p.compile(device=card, ordering="name")
    lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", max_iterations=2))
    assert lm._make_solve_fn(cp).general_sparse.healthy()
    assert lm.optimize(cp).final_cost == 0.0


# -- mode="jit": captured CUDA graphs --------------------------------------------

JIT_CASES = {
    "se3_sparse_cholesky": ("medium_se3_250.g2o", "lm", dict(linear_solver_type="sparse_cholesky")),
    "se2_dense_cholesky": ("medium_se2_300.g2o", "lm", dict(linear_solver_type="dense_cholesky")),
    "se2_dense_qr": ("medium_se2_300.g2o", "lm", dict(linear_solver_type="dense_qr")),
    "se2_jacobi_scaling": ("medium_se2_300.g2o", "lm", dict(linear_solver_type="sparse_cholesky",
                                                            use_jacobi_scaling=True)),
    "ba_schur_explicit": ("ba", "lm", dict(linear_solver_type="schur_explicit",
                                           max_iterations=30)),
    "ba_schur_implicit": ("ba", "lm", dict(linear_solver_type="schur_implicit",
                                           max_iterations=30)),
    # the first pose fixed: undamped GN on a gauge-free graph leans on the
    # ladder's 1e-10 shift, which magnifies index_add_'s atomic rounding
    "se3_gauss_newton": ("medium_se3_250.g2o", "gn", dict(linear_solver_type="sparse_cholesky")),
}


def _jit_problem(name, fix_first=False):
    if name == "ba":
        return build_ba_problem(synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0))
    return apx.load_g2o(FIXTURES / name).to_problem(fix_first=fix_first)


def _jit_solver(kind, **kw):
    if kind == "dl":
        return apx.DogLeg(apx.DogLegConfig(**kw))
    if kind == "gn":
        return apx.GaussNewton(apx.GaussNewtonConfig(**kw))
    return apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(**kw))


def _eager_jit(solver, cp):
    """jit mode's step run eagerly on the card, without capture: (status,
    iterations, final cost)."""
    from apex_tpu_torch.optim import graphs

    init, step = solver._make_device_init(cp), solver._make_device_step(cp)
    state = init()
    k = len(cp.pools)
    names = solver.JIT_STATE
    while graphs.read_status(state[k + names.index("status")]) == apx.Status.RUNNING:
        state = step(*state)
    st = dict(zip(names, state[k:]))
    return apx.Status(int(st["status"])), int(st["iteration"]), float(st["cost"])


@pytest.mark.parametrize("case", list(JIT_CASES))
def test_jit_captured_matches_eager_and_python(card, case):
    """The captured solve against the same step run eagerly on the card and
    against python mode on the card: the same iterations and status, rtol
    1e-10 (the same arithmetic, summed by index_add_ in atomic order)."""
    from apex_tpu_torch.optim import graphs

    name, kind, kw = JIT_CASES[case]
    cp = _jit_problem(name, fix_first=kind == "gn").compile(dtype=torch.float64, device=card)
    graphs.reset_counters()
    rj = _jit_solver(kind, mode="jit", **kw).optimize(cp)
    assert graphs.captures == 1 and graphs.replays >= rj.iterations
    status, iterations, cost = _eager_jit(_jit_solver(kind, mode="jit", **kw), cp)
    assert (rj.status, rj.iterations) == (status, iterations)
    np.testing.assert_allclose(rj.final_cost, cost, rtol=1e-10)
    rp = _jit_solver(kind, mode="python", **kw).optimize(cp)
    assert rj.converged and (rj.iterations, rj.status) == (rp.iterations, rp.status)
    np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=1e-10)


@pytest.mark.parametrize("solver", ["schur_explicit", "schur_implicit"])
def test_jit_replays_the_landmark_kernel(card, solver):
    """The landmark kernel is captured into the BA graphs: each replay of
    the step launches it (counted per replay), and no LM iteration calls
    the wrapper; a second solve replays without a new capture and gives
    the first one's result (rtol 1e-10: index_add_ sums in atomic order)."""
    from apex_tpu_torch.optim import graphs

    cp = _jit_problem("ba").compile(dtype=torch.float64, device=card)
    lm = _jit_solver("lm", mode="jit", linear_solver_type=solver, max_iterations=30)
    graphs.reset_counters()
    lb.launches = lb.captured = 0
    replayed = graphs.replayed["landmark_blocks"]
    r1 = lm.optimize(cp)
    assert lb.captured == 1  # recorded once, in the step's first graph
    assert lb.launches == 1  # the warm-up's eager launch
    assert graphs.replayed["landmark_blocks"] - replayed == r1.iterations
    r2 = lm.optimize(cp)
    assert graphs.captures == 1 and lb.captured == 1 and lb.launches == 1
    assert graphs.replayed["landmark_blocks"] - replayed == r1.iterations + r2.iterations
    assert (r1.iterations, r1.status) == (r2.iterations, r2.status)
    np.testing.assert_allclose(r2.final_cost, r1.final_cost, rtol=1e-10)


def test_jit_timeout_on_the_card(card):
    """TIMEOUT after the first launch's ceil(16 / 8) = 2 iterations: one
    read of the status after it, and the result's read."""
    from apex_tpu_torch.optim import graphs

    cfg = apx.LevenbergMarquardtConfig(
        mode="jit", max_iterations=16, cost_tolerance=0.0, parameter_tolerance=0.0,
        gradient_tolerance=0.0, timeout=0.0)
    cp = synthetic.synthetic_pose_graph_3d(n_poses=60, rings=4, seed=0).to_problem().compile(
        dtype=torch.float64, device=card)
    graphs.reset_counters()
    r = apx.LevenbergMarquardt(cfg).optimize(cp)
    assert r.status == apx.Status.TIMEOUT and r.iterations == 2
    assert (graphs.launches, graphs.status_reads, graphs.host_reads) == (1, 1, 2)


@pytest.mark.parametrize("case", list(JIT_CASES))
def test_jit_solve_reads_the_result_once(card, case):
    """A jit solve without a timeout is one launch of one parent graph and
    one host read of its result; with the QR solvers the LM loop stays on
    the host (``QR_HOST_LOOP``): one flag read per iteration and one more,
    plus the QR sweep's retry ladder's test per iteration."""
    from apex_tpu_torch.optim import graphs
    from apex_tpu_torch.optim.lm import QR_HOST_LOOP

    name, kind, kw = JIT_CASES[case]
    cp = _jit_problem(name, fix_first=kind == "gn").compile(dtype=torch.float64, device=card)
    solver = _jit_solver(kind, mode="jit", **kw)
    solver.optimize(cp)
    graphs.reset_counters()
    r = solver.optimize(cp)
    run = solver._jit_cache[cp]
    qr = kw["linear_solver_type"] in ("dense_qr", "sparse_qr")
    assert run._step.host_loop == (QR_HOST_LOOP if qr else None)
    if not qr:
        assert graphs.host_reads == 1 and graphs.launches == 1
        assert [type(p).__name__ for p in run.captured.parts] == ["_Parent"]
    else:
        ladder = kw["linear_solver_type"] == "sparse_qr"
        assert graphs.host_reads == (r.iterations + 1) * (1 + ladder) + 1 - ladder
        assert graphs.replays >= r.iterations


def test_parent_graph_branches_and_loops(card):
    """``graphs.Captured`` on a program with an IF around cuSOLVER and cuBLAS
    calls and a WHILE holding an IF: one parent graph, whose launch gives
    the eager program's values, the taken count and the trips counted on
    the device, and no host read."""
    from apex_tpu_torch.optim import graphs

    def program(*state):
        x, y, c = state

        def heavy(x, y, c):
            M = x.reshape(8, 4, 4)
            L, _ = torch.linalg.cholesky_ex(M @ M.mT + torch.eye(4, dtype=x.dtype, device=x.device))
            z = torch.linalg.solve_triangular(L, y.reshape(8, 4, 1), upper=False).reshape(-1)
            w = torch.zeros_like(y).index_add_(0, torch.arange(32, device=x.device) % 7, z)
            return x * 0.5, w, c + 1

        x, y, c = graphs.cond_update(c < 100, heavy, x, y, c)

        def body(x, y, c):
            x, y, c = graphs.cond_update(c % 2 == 0, lambda x, y, c: (x + 1, y, c), x, y, c)
            return x * 0.9, y, c + 1

        x, y, c = graphs.while_update(lambda x, y, c: c < 10, body, 50, x, y, c)
        return graphs.assign(state, (x, y, c))

    gen = torch.Generator().manual_seed(0)
    start = (torch.randn(128, generator=gen, dtype=torch.float64).to(card),
             torch.randn(32, generator=gen, dtype=torch.float64).to(card),
             torch.zeros((), dtype=torch.int64, device=card))
    want = program(*(t.clone() for t in start))
    state = tuple(t.clone() for t in start)
    cap = graphs.Captured(program, state, torch.cuda.graph_pool_handle())
    for t, t0 in zip(state, start):
        t.copy_(t0)
    graphs.reset_counters()
    cap.zero_counts()
    cap.launch()
    counts = cap.counts().tolist()
    assert [type(p).__name__ for p in cap.parts] == ["_Parent"]
    assert graphs.host_reads == 0 and graphs.launches == 1
    # the IF taken once, the WHILE's 9 trips, its IF taken on 4 of them
    assert counts[0::2] == [1, 9, 4]
    # index_add_ sums in atomic order
    for got, ref in zip(state, want):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n", [(1, 1), (64, 1), (300, 3), (16_384, 3), (250, 6), (257, 9),
                                 (1778, 9), (50, 10), (257, 15), (10, 32), (3, 33), (2, 44),
                                 (4, 64), (1, 101)])
def test_spd_kernel_matches_plain(card, dtype, B, n):
    """The SPD-clamped inverse kernel against its plain version (eigh) on
    SPD, near-singular and indefinite blocks (an SPD one first in every
    batch): each kind within chip_smoke's gates at its own scale
    (``spd_errors``), one launch per call."""
    from apex_tpu_torch.kernels import spd_inverse as spd
    from chip_smoke import SPD_KEPT_RTOL, SPD_RTOL, spd_blocks, spd_errors

    H = torch.as_tensor(spd_blocks(B, n), dtype=dtype, device=card)
    before = spd.launches
    k = spd.spd_clamped_inv(H)
    assert spd.launches == before + 1
    p = spd.spd_clamped_inv_plain(H)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    full, kept, clamped = spd_errors(H, k, p)
    name = str(dtype).replace("torch.", "")
    assert full <= SPD_RTOL[name] and clamped <= SPD_RTOL[name]
    assert kept <= SPD_KEPT_RTOL[name]


def test_spd_kernel_raises_outside_its_domain(card):
    from apex_tpu_torch.kernels import spd_inverse as spd

    with pytest.raises(ValueError, match="block size"):
        spd.spd_clamped_inv(torch.zeros(1, 1025, 1025, dtype=torch.float64, device=card))
    with pytest.raises(TypeError, match="float32 or float64"):
        spd.spd_clamped_inv(torch.zeros(4, 3, 3, dtype=torch.float16, device=card))
    with pytest.raises(ValueError, match=r"\[B, n, n\]"):
        spd.spd_clamped_inv(torch.zeros(4, 3, 2, dtype=torch.float64, device=card))


# the paths jit mode took last (ROADMAP A.8b): DogLeg, the QR sweep, plain
# PCG and the general tier (a lattice with a dense core of at most 8 blocks)
JIT_A8B_CASES = {
    "se3_sparse_qr": ("medium_se3_250.g2o", "lm", dict(linear_solver_type="sparse_qr")),
    "se2_pcg": ("medium_se2_300.g2o", "lm", dict(linear_solver_type="pcg")),
    "se3_gauss_newton_sparse_qr": ("medium_se3_250.g2o", "gn",
                                   dict(linear_solver_type="sparse_qr")),
    "se3_dogleg": ("medium_se3_250.g2o", "dl", dict(linear_solver_type="sparse_cholesky")),
    "se2_dogleg": ("medium_se2_300.g2o", "dl", dict(linear_solver_type="dense_cholesky")),
    "grid_sparse_general": ("grid", "lm", dict(linear_solver_type="sparse_general",
                                               max_iterations=30)),
}


@pytest.mark.parametrize("case", list(JIT_A8B_CASES))
def test_jit_a8b_paths_captured_match_cpu(card, case, monkeypatch):
    """Each path captures (one program: the initial state and the LM
    loop), a second solve launches it without a new capture and gives the
    first one's result, plain PCG launches the SPD inverse kernel inside
    the graph once per variable pool and LM iteration, and the captured
    solve gives the CPU's jit solve: the same iterations and status, final
    cost within rtol 1e-8 (index_add_ sums in atomic order)."""
    from apex_tpu_torch.linalg import sparse_general as sg
    from apex_tpu_torch.optim import graphs

    name, kind, kw = JIT_A8B_CASES[case]
    if name == "grid":
        monkeypatch.setattr(sg, "GeneralSparseCholesky", _capped_general(8))
        problem = synthetic.synthetic_pose_graph_grid3d(6, 6, 4, seed=1).to_problem()
    else:
        problem = _jit_problem(name, fix_first=kind == "gn")
    cp = problem.compile(dtype=torch.float64, device=card)
    solver = _jit_solver(kind, mode="jit", **kw)
    graphs.reset_counters()
    spd_before = graphs.replayed["spd_clamped_inv"]
    r1 = solver.optimize(cp)
    assert graphs.captures == 1 and graphs.replays >= r1.iterations
    if kw["linear_solver_type"] == "pcg":
        assert graphs.replayed["spd_clamped_inv"] - spd_before == r1.iterations * len(cp.pools)
    r2 = solver.optimize(cp)
    assert graphs.captures == 1 and len(solver._jit_cache) == 1
    assert (r2.iterations, r2.status) == (r1.iterations, r1.status)
    np.testing.assert_allclose(r2.final_cost, r1.final_cost, rtol=1e-8)
    rh = _jit_solver(kind, mode="jit", **kw).optimize(problem.compile(dtype=torch.float64,
                                                                      device="cpu"))
    assert r1.converged and (r1.iterations, r1.status) == (rh.iterations, rh.status)
    np.testing.assert_allclose(r1.final_cost, rh.final_cost, rtol=1e-8)


def test_jit_dogleg_reuse_on_the_card(card):
    """DogLeg's fresh/reuse branch replayed on the card: the BA problem's
    Schur fallback for 30 iterations, whose rejected steps retry from the
    cache, gives python mode's reused steps, iterations and status on the
    card, and its cost (rtol 1e-10)."""
    cp = _jit_problem("ba").compile(dtype=torch.float64, device=card)
    kw = dict(linear_solver_type="schur_explicit", max_iterations=30)
    python, jit = (_jit_solver("dl", mode=mode, **kw) for mode in ("python", "jit"))
    rp, rj = python.optimize(cp), jit.optimize(cp)
    assert python.reused_steps > 10 and jit.reused_steps == python.reused_steps
    assert (rj.iterations, rj.status) == (rp.iterations, rp.status)
    np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=1e-10)


# -- slice 9: the camera models, the extended groups, AutoDiffFactor -----------

# tests/test_cameras.py's intrinsics (this file imports no JAX test module)
CAMERAS = {
    "bal_pinhole": ([800.0, -0.05, 0.01], -1),
    "pinhole": ([500.0, 510.0, 320.0, 240.0], +1),
    "rad_tan": ([460.0, 455.0, 320.0, 240.0, -0.28, 0.07, 1e-4, -2e-4, 0.0], +1),
    "kannala_brandt": ([380.0, 379.0, 318.0, 242.0, 0.01, -0.002, 0.001, -2e-4], +1),
    "fov": ([300.0, 300.0, 320.0, 240.0, 0.9], +1),
    "ucm": ([460.0, 460.0, 320.0, 240.0, 0.6], +1),
    "eucm": ([460.0, 460.0, 320.0, 240.0, 0.6, 1.1], +1),
    "double_sphere": ([350.0, 350.0, 320.0, 240.0, -0.2, 0.59], +1),
    "ftheta": ([320.0, 240.0, 300.0, 5.0, -2.0, 0.3], +1),
}


@pytest.mark.parametrize("name", list(CAMERAS))
def test_cameras_card_match_cpu(card, name):
    """Projection, mask, Jacobians (autodiff for the extended models) and
    unprojection on the card against the CPU (rtol 1e-12)."""
    from apex_tpu_torch import cameras

    intr, sign = CAMERAS[name]
    rng = np.random.default_rng(0)
    p = rng.uniform(-1, 1, (500, 3))
    p[:, 2] = sign * rng.uniform(1.0, 5.0, 500)
    p[::7, 2] *= -1.0  # some behind the camera
    cam = cameras.get(name)
    out = {}
    for device in (card, torch.device("cpu")):
        i = torch.tensor(intr, dtype=torch.float64, device=device).expand(500, len(intr))
        x = torch.tensor(p, device=device)
        uv, valid = cam.project(i, x)
        out[device.type] = (uv, valid, *cam.jacobians(i, x), cam.unproject(i, uv),
                            cam.project_batch(i, x))
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("solver", ["schur_explicit", "schur_implicit"])
@pytest.mark.parametrize("model", ["kannala_brandt", "rad_tan"])
def test_selfcal_jit_captured_matches_cpu(card, model, solver):
    """tests/test_camera_selfcal.py's self-calibration problem
    (``chip_smoke.selfcal_problem``) with autodiff camera Jacobians captured
    into the step's CUDA graphs, the landmark kernel replayed once per LM
    iteration: the CPU's python-mode iterations and status, its final cost
    within rtol 1e-8 (1e-7 through ``schur_implicit``, whose PCG stops at a
    relative residual of 1e-10 and leaves the weakly observed distortion
    directions to the card's and the CPU's rounding), and the focal within
    1% of the truth."""
    from apex_tpu_torch.optim import graphs

    intr = SELFCAL_MODELS[model]
    problem, _ = selfcal_problem(model, intr, *selfcal_scene())
    kw = dict(linear_solver_type=solver, max_iterations=40, pcg_tolerance=1e-10,
              pcg_forcing=False, pcg_max_iterations=500)
    graphs.reset_counters()
    replayed = graphs.replayed["landmark_blocks"]
    rj = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode="jit", **kw)).optimize(
        problem.compile(dtype=torch.float64, device=card))
    assert graphs.captures == 1
    assert graphs.replayed["landmark_blocks"] - replayed >= rj.iterations
    rh = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(**kw)).optimize(
        problem.compile(dtype=torch.float64, device="cpu"))
    assert rj.converged and (rj.iterations, rj.status) == (rh.iterations, rh.status)
    np.testing.assert_allclose(rj.final_cost, rh.final_cost,
                               rtol=1e-7 if solver == "schur_implicit" else 1e-8)
    np.testing.assert_allclose(rj.variables["intr_shared"][0], intr[0], rtol=0.01)


@pytest.mark.parametrize("gname", ["SE23", "Sim3", "SGal3"])
def test_extended_groups_card_match_cpu(card, gname):
    """Exp, log, compose, the adjoint and the tangent Jacobians (closed
    form for SE23, ``torch.func`` autodiff and ``inv_ex`` for Sim3 and
    SGal3) on the card against the CPU (rtol 1e-12)."""
    from apex_tpu_torch.manifolds import get

    G = get(gname)
    t = torch.from_numpy(np.random.default_rng(1).normal(size=(64, G.dof)) * 0.5)
    out = {}
    for device in (card, torch.device("cpu")):
        x = t.to(device)
        e = G.exp(x)
        out[device.type] = (e, G.log(e), G.compose(e, G.inverse(e.flip(0))), G.adjoint(e),
                            G.rjac(x), G.ljac(x), G.rjac_inv(x), G.ljac_inv(x))
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("gname", ["SE23", "Sim3", "SGal3"])
def test_extended_chain_jit_captured_matches_cpu(card, gname):
    """The loop-closed chain of each extended group, jit mode captured on
    the card: the CPU's iterations and status, a final cost below 1e-12."""
    from apex_tpu_torch.optim import graphs

    problem = extended_chain(gname)
    graphs.reset_counters()
    rj = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        max_iterations=60, mode="jit")).optimize(problem.compile(device=card))
    assert graphs.captures == 1
    rh = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(max_iterations=60)).optimize(
        problem.compile(device="cpu"))
    assert rj.converged and (rj.iterations, rj.status) == (rh.iterations, rh.status)
    assert rj.final_cost < 1e-12


def test_autodiff_factor_jit_captured_on_the_card(card):
    """An ``AutoDiffFactor`` (Rosenbrock) in jit mode on the card: captured,
    the CPU's iterations and final cost (rtol 1e-8), the minimum (1, 1)."""
    from apex_tpu_torch.optim import graphs

    problem = rosenbrock_problem()
    graphs.reset_counters()
    rj = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        max_iterations=100, mode="jit")).optimize(problem.compile(device=card))
    assert graphs.captures == 1
    rh = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(max_iterations=100)).optimize(
        problem.compile(device="cpu"))
    assert (rj.iterations, rj.status) == (rh.iterations, rh.status) and rj.converged
    np.testing.assert_allclose(rj.final_cost, rh.final_cost, rtol=1e-8, atol=1e-25)
    np.testing.assert_allclose(rj.variables["xy"], [1.0, 1.0], atol=1e-6)


def _observed_ba_solve(device, tmp_path, mode="python"):
    """The small BA problem, exact implicit Schur, with a history, a
    checkpoint every 3 iterations and a headless visualization observer."""
    from apex_tpu_torch.core.checkpoint import CheckpointObserver
    from apex_tpu_torch.observers import HistoryObserver, RerunObserver, VisualizationConfig
    from apex_tpu_torch.observers.visualization import MemorySink

    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    cp = build_ba_problem(ds).compile(dtype=torch.float64, device=device)
    lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="schur_implicit", max_iterations=30, pcg_forcing=False,
        pcg_tolerance=1e-10, pcg_max_iterations=500, mode=mode))
    h, sink = HistoryObserver(), MemorySink()
    for obs in (h, CheckpointObserver(cp, tmp_path / f"{device}.npz", every=3),
                RerunObserver(VisualizationConfig.for_bundle_adjustment(), sink=sink)):
        lm.add_observer(obs)
    return cp, lm, lm.optimize(cp), h, sink


def test_observed_solve_card_matches_cpu(card, tmp_path):
    """An observed LM solve on the card: the CPU's iterations and status,
    history costs within rtol 1e-8, the same panels, one kernel launch per
    LM iteration."""
    before = lb.launches
    _, _, rc, hc, sc = _observed_ba_solve(card, tmp_path)
    assert lb.launches - before == rc.iterations
    _, _, rh, hh, sh = _observed_ba_solve(torch.device("cpu"), tmp_path)
    assert (rc.iterations, rc.status) == (rh.iterations, rh.status)
    np.testing.assert_allclose(hc.costs, hh.costs, rtol=1e-8)
    assert [(p, k) for p, k, _ in sc.records] == [(p, k) for p, k, _ in sh.records]


def test_checkpoint_resumes_on_the_card(card, tmp_path):
    """The checkpoint written on the card resumes on the card (under
    ``mode="jit"``, which runs python mode) as on the CPU: the stored cost
    recomputed (rtol 1e-10), the CPU's iterations and status, final costs
    within rtol 1e-8, one kernel launch per LM iteration. A resume is not
    the uninterrupted solve continued (the counter restarts at 0, nu at 2):
    it ends within the cost tolerance (1e-6) of that solve's cost."""
    from apex_tpu_torch.core.checkpoint import OptimizerCheckpoint

    _, _, res, _, _ = _observed_ba_solve(card, tmp_path)
    c = OptimizerCheckpoint.load(tmp_path / "cuda.npz")
    assert c.iteration == 3 * ((res.iterations - 1) // 3)
    cfg = dict(linear_solver_type="schur_implicit", max_iterations=30, pcg_forcing=False,
               pcg_tolerance=1e-10, pcg_max_iterations=500)
    problem = build_ba_problem(synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0))
    before = lb.launches
    rc = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode="jit", **cfg)).optimize(
        problem.compile(dtype=torch.float64, device=card), checkpoint=c)
    assert lb.launches - before == rc.iterations
    rh = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(**cfg)).optimize(
        problem.compile(dtype=torch.float64, device="cpu"), checkpoint=c)
    np.testing.assert_allclose(rc.initial_cost, c.cost, rtol=1e-10)
    assert (rc.iterations, rc.status) == (rh.iterations, rh.status) and rc.converged
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)
    np.testing.assert_allclose(rc.final_cost, res.final_cost, rtol=1e-6)


def test_jit_with_observers_captures_nothing(card, tmp_path):
    """``mode="jit"`` with observers runs python mode on the card: no graph
    captured or replayed, and python mode's result."""
    from apex_tpu_torch.optim import graphs

    graphs.reset_counters()
    _, lm, rj, hj, _ = _observed_ba_solve(card, tmp_path, mode="jit")
    assert (graphs.captures, graphs.replays, graphs.graphs) == (0, 0, 0)
    assert not lm._jit_cache
    _, _, rp, hp, _ = _observed_ba_solve(card, tmp_path)
    assert (rj.iterations, rj.status) == (rp.iterations, rp.status)
    np.testing.assert_allclose(hj.costs, hp.costs, rtol=1e-10)


def test_compare_solvers_example_on_the_card(card, monkeypatch):
    """``examples.compare_solvers`` on the card (its default platform): one
    landmark-kernel launch per LM iteration of the two Schur rows, none in
    the dense rows, and the rows of ``--platform cpu`` (iterations and
    status equal, costs and RMSE within rtol 1e-8)."""
    from apex_tpu_torch.examples import compare_solvers

    launches = []
    optimize = apx.LevenbergMarquardt.optimize

    def counted(self, *a, **kw):
        before = lb.launches
        res = optimize(self, *a, **kw)
        launches.append(lb.launches - before)
        return res

    monkeypatch.setattr(apx.LevenbergMarquardt, "optimize", counted)
    rows = compare_solvers.main([])
    cpu = compare_solvers.main(["--platform", "cpu"])
    assert launches[4:] == [0, 0, 0, 0]
    assert launches[:4] == [0 if r["solver"].startswith("dense") else r["iterations"] for r in rows]
    assert launches[2] > 0 and launches[3] > 0
    for r, c in zip(rows, cpu, strict=True):
        assert (r["solver"], r["status"], r["iterations"]) == (
            c["solver"], c["status"], c["iterations"])
        np.testing.assert_allclose([r["final_cost"], r["rmse"]], [c["final_cost"], c["rmse"]],
                                   rtol=1e-8)


def _partitioned_rank(mesh):
    """Five landmark-partitioned LM steps (forcing sequence, warm start) of
    ``synthetic_ba(7, 110, seed=4)`` with self-calibration, f64, on one
    rank: the costs and the landmark kernel's launches."""
    from apex_tpu_torch.parallel import make_sharded_schur_step

    ds = synthetic.synthetic_ba(n_cameras=7, n_points=110, seed=4)
    cp = build_ba_problem(ds, mode="self_calibration").compile(dtype=torch.float64,
                                                               device=mesh.device)
    step, _ = make_sharded_schur_step(cp, mesh)
    values = cp.initial_values()
    state = (values, torch.tensor(1e-3, dtype=cp.dtype, device=cp.device),
             torch.tensor(2.0, dtype=cp.dtype, device=cp.device), cp.cost(values))
    before, costs = lb.launches, [float(state[3])]
    for i in range(5):
        state = step(*state, iteration=i, dx_prev=step.last_dx)
        costs.append(float(state[3]))
    return dict(partitioned=hasattr(step, "solve"), costs=costs, launches=lb.launches - before)


def test_partitioned_step_nccl_matches_cpu(card):
    """One NCCL rank on the card against one gloo rank on the CPU: the
    partitioned path, one kernel launch per LM iteration on the card and
    none on the CPU, costs within rtol 1e-8."""
    from apex_tpu_torch.parallel import launch

    gpu = launch(_partitioned_rank, 1, "nccl", "cuda")[0]
    cpu = launch(_partitioned_rank, 1, "gloo", "cpu")[0]
    assert gpu["partitioned"] and cpu["partitioned"]
    assert (gpu["launches"], cpu["launches"]) == (5, 0)
    np.testing.assert_allclose(gpu["costs"], cpu["costs"], rtol=1e-8)


def test_venice_rung_reduced_on_the_card(card):
    """The ladder's venice rung (``solve_venice``: 8 LM iterations, 15 PCG
    iterations, stop at 0.46 px) on a reduced venice-shaped problem built
    by the ladder, f64: in python mode one kernel launch per LM iteration;
    jit mode gives python mode's iterations and status, its final cost
    within rtol 1e-10 (or 10x python mode's own spread), launches the
    kernel inside its graphs, and passes the gate."""
    from apex_tpu_torch.benches import ladder
    from apex_tpu_torch.optim import graphs

    built = ladder.build_ba(torch.float64, card, n_cameras=24, n_points=20_000,
                            obs_per_camera=3000, pixel_noise=0.3)
    before = lb.launches
    python = ladder.solve_venice(built, runs=1, mode="python")
    assert lb.launches - before == python.first_result.iterations + python.result.iterations
    replayed = graphs.replayed["landmark_blocks"]
    jit = ladder.solve_venice(built, runs=1, mode="jit")
    assert graphs.replayed["landmark_blocks"] - replayed >= jit.result.iterations
    ref, res = python.result, jit.result
    assert python.gate_passed and jit.gate_passed
    assert (res.iterations, res.status) == (ref.iterations, ref.status)
    spread = abs(ref.final_cost - python.first_result.final_cost) / ref.final_cost
    np.testing.assert_allclose(res.final_cost, ref.final_cost, rtol=max(1e-10, 10.0 * spread))


# ---------------------------------------------------------------------------
# the tracer (utils/profiling.py): phase stamps, launches on the host clock,
# and work counted where it runs
# ---------------------------------------------------------------------------


def _graph_nodes(program):
    """The node counts of a recorded program's captured graphs, in order,
    bodies included."""
    from apex_tpu_torch.optim import graphs

    out = []
    for item in program:
        out += [item.nodes] if isinstance(item, graphs._Graph) else _graph_nodes(item.body)
    return out


def test_phase_stamps_sum_over_while_trips(card):
    """A span around ``torch.cuda._sleep`` in the body of a WHILE node of 6
    trips, captured with tracing on: its phase row counts 6 occurrences
    and 6 sleeps within 5%, inside the launch's device interval (within
    the anchor's uncertainty)."""
    import time

    from apex_tpu_torch.optim import graphs
    from apex_tpu_torch.utils import profiling

    cycles = 2_000_000
    torch.cuda._sleep(cycles)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    sleep_ns = start.elapsed_time(end) * 1e6 / 10

    def program(*state):
        def trip(c):
            with profiling.span("test.sleep"):
                torch.cuda._sleep(cycles)
            return (c + 1,)

        return graphs.assign(state, graphs.while_update(lambda c: c < 6, trip, 8, *state))

    profiling.set_tracing(True)
    try:
        state = (torch.zeros((), dtype=torch.int64, device=card),)
        cap = graphs.Captured(program, state, torch.cuda.graph_pool_handle())
        time.sleep(0.01)
        profiling.reset_trace()
        cap.zero_counts()
        cap.launch()
        trace = profiling.collect_trace()
    finally:
        profiling.set_tracing(False)
    assert int(state[0]) == 6
    phase, = [p for p in trace["phases"] if p["path"] == "test.sleep"]
    assert phase["count"] == 6
    assert phase["total_ns"] == pytest.approx(6 * sleep_ns, rel=0.05)
    launch, = trace["launches"]
    slack = 2 * trace["anchors"][card.index or 0]["uncertainty_ns"] + 20_000
    assert launch["start_ns"] - slack <= phase["first_ns"] < phase["last_ns"]
    assert phase["last_ns"] <= launch["end_ns"] + slack


@pytest.mark.parametrize("name,solver", [("ba", "schur_implicit"),
                                         ("sphere_excerpt.g2o", "sparse_cholesky")])
def test_tracing_off_captures_the_same_nodes(card, name, solver, monkeypatch):
    """Captured with tracing off, the jit programs hold the nodes of the
    same programs with every span a no-op, and no device counter exists;
    captured with tracing on they hold more (the stamps)."""
    from apex_tpu_torch.optim import graphs
    from apex_tpu_torch.utils import profiling

    cp = _jit_problem(name).compile(dtype=torch.float64, device=card)

    def nodes():
        lm = _jit_solver("lm", mode="jit", linear_solver_type=solver, max_iterations=10)
        lm.optimize(cp)
        return _graph_nodes(lm._jit_cache[cp].captured.program)

    assert not profiling.tracing()
    accumulators = len(graphs.device_counts(card))
    off = nodes()
    assert len(graphs.device_counts(card)) == accumulators
    with monkeypatch.context() as m:
        m.setattr(profiling.span, "__enter__", lambda self: self)
        m.setattr(profiling.span, "__exit__", lambda self, *exc: False)
        bare = nodes()
    profiling.set_tracing(True)
    try:
        on = nodes()
    finally:
        profiling.set_tracing(False)
    assert off == bare
    assert sum(on) > sum(off)


def test_host_sleep_between_launches_is_idle_under_its_span(card):
    """A host sleep between two launches of a small parent graph shows as
    device-idle time under the span that wraps it."""
    import time

    from apex_tpu_torch.optim import graphs
    from apex_tpu_torch.utils import profiling

    def program(*state):
        return graphs.assign(state, (state[0] * 2.0,))

    profiling.set_tracing(True)
    try:
        state = (torch.ones(1024, dtype=torch.float64, device=card),)
        cap = graphs.Captured(program, state, torch.cuda.graph_pool_handle())
        profiling.reset_trace()
        with profiling.span("test.outer"):
            cap.launch()
            with profiling.span("test.host"):
                time.sleep(0.05)
            cap.launch()
        torch.cuda.synchronize()
        idle = profiling.idle_by_span()
    finally:
        profiling.set_tracing(False)
    assert 0.049 <= idle["test.host"] <= 0.06
    assert idle.get("test.outer", 0.0) < 0.005


@pytest.mark.parametrize("name,solver", [("ba", "schur_implicit"),
                                         ("sphere_excerpt.g2o", "sparse_cholesky")])
def test_jit_counts_python_modes_work_on_the_card(card, name, solver):
    """A jit solve captured with tracing on counts, from its device counts,
    the CR solves, refinements and retries and the PCG solves and live
    iterations that python mode counts; the first solve (which warms up
    and captures) counts one solve's work, as the second does."""
    from apex_tpu_torch.linalg import banded, schur
    from apex_tpu_torch.utils import profiling

    work = ("cr_solves", "cr_refines", "cr_retries", "pcg_calls", "pcg_iterations")

    def counted(lm):
        before = [getattr(banded if k.startswith("cr") else schur, k) for k in work]
        res = lm.optimize(cp)
        after = [getattr(banded if k.startswith("cr") else schur, k) for k in work]
        return res, [a - b for a, b in zip(after, before)]

    cp = _jit_problem(name).compile(dtype=torch.float64, device=card)
    kw = dict(linear_solver_type=solver, max_iterations=10, pcg_max_iterations=40)
    rp, python = counted(_jit_solver("lm", mode="python", **kw))
    profiling.set_tracing(True)
    try:
        jit = _jit_solver("lm", mode="jit", **kw)
        first, first_counts = counted(jit)
        again, again_counts = counted(jit)
    finally:
        profiling.set_tracing(False)
    assert (first.iterations, first.status) == (rp.iterations, rp.status)
    assert first_counts == again_counts == python
    assert python[0] + python[3] == rp.iterations


def test_jit_general_counts_python_modes_work_on_the_card(card):
    """The general tier's counters (``linalg.sparse_general.general_*``)
    from a jit solve's device counts, tracing off as users run it, equal
    python mode's on the 10^3 lattice (elimination levels and a dense
    core): one tier solve and one core factorization of R*dmax columns per
    LM iteration, the first solve (which warms up and captures) as the
    second."""
    from apex_tpu_torch.linalg import sparse_general as sg

    work = ("general_solves", "general_retries", "general_core_factors", "general_core_cols")

    def counted(lm):
        before = [getattr(sg, k) for k in work]
        res = lm.optimize(cp)
        return res, [getattr(sg, k) - b for k, b in zip(work, before)]

    cp = synthetic.synthetic_pose_graph_grid3d(10, 10, 10, seed=0).to_problem().compile(
        dtype=torch.float64, device=card)
    kw = dict(linear_solver_type="sparse_general", max_iterations=20, cost_tolerance=1e-4,
              damping="auto")
    python_lm = _jit_solver("lm", mode="python", **kw)
    rp, python = counted(python_lm)
    gs = python_lm._step_cache[cp].solve_fn.general_sparse
    jit = _jit_solver("lm", mode="jit", **kw)
    first, first_counts = counted(jit)
    again, again_counts = counted(jit)
    assert (first.iterations, first.status) == (rp.iterations, rp.status)
    assert first_counts == again_counts == python
    assert gs.sym.n_levels >= 1 and python[0] == rp.iterations
    assert python[2] == python[0] + python[1] and python[3] == python[2] * gs.R * gs.dmax


# ---------------------------------------------------------------------------
# the assembly kernels (kernels/schur_assemble.py, csrc/schur_assemble.cu)
# ---------------------------------------------------------------------------

# each output's largest error against the generic path's (group_linearize
# and index_add_), relative to its largest entry: the kernels contract
# multiply-adds and sum in another order (shuffles, tiles) than the generic
# path's atomics, and the entries of W from the rotation Jacobian,
# differences of products, lose the most (about 1e-13 in f64 and 5e-5 in
# f32 at venice's size)
ASSEMBLY_RTOL = {torch.float64: 1e-12, torch.float32: 1e-3}
# the small problems: mode, loss, layout, first camera fixed
_SMALL_CASES = [(mode, loss, layout, fixed)
                for mode in ("self_calibration", "bundle_adjustment")
                for loss in ("huber", "l2") for layout in ("bucketed", "flat", "camera_major")
                for fixed in (True, False)]


def _assembly_problems(size):
    """The problems of a size, one at a time: ``small``, the scene of
    ``assembly_problems`` in every case of ``_SMALL_CASES`` (four bucketed
    groups with weight-0 padding, one flat group, or one group whose rows
    come camera by camera, out of landmark order); ``venice``, the venice
    rung's size and caps (1,778 cameras, 993,923 landmarks, 5.0M
    observations)."""
    from apex_tpu_torch.benches import ladder

    if size == "venice":
        ds = synthetic.synthetic_ba_large(seed=0, **ladder.RUNGS["venice"].build.keywords)
        yield build_ba_problem(ds)
        return
    ds = assembly_scene()
    for mode, loss, layout, fixed in _SMALL_CASES:
        loss = apx.HuberLoss(1.0) if loss == "huber" else None
        if layout == "camera_major":
            yield camera_major_problem(ds, mode, loss, fixed)
        else:
            yield build_ba_problem(ds, mode=mode, loss=loss, layout=layout,
                                   fix_first_camera=fixed)


def _assembled(ctx, values):
    out = ctx.assemble(values, 0.1)
    return list(out[:4]) + [out[5]] + list(out[4])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("size", ["small", "venice"])
def test_assembly_kernels_match_plain(card, size, dtype):
    """Every group of the problems takes the kernels, one call each (the
    rows of the camera-major layout through their landmark-major order);
    two assembles give the same bits; and H_cc, g_c, H_pp, g_p, the cost
    and each W equal the generic path's (the port's plain version: the
    same context built with ``whole_groups=False``) on the same card
    tensors within ``ASSEMBLY_RTOL`` of their largest entry. At the small
    size the first row's landmark lies behind its camera, so that the ok
    mask engages: its W is zero."""
    from apex_tpu_torch.kernels import schur_assemble as sa
    from apex_tpu_torch.linalg.schur import SchurContext

    for problem in _assembly_problems(size):
        cp = problem.compile(dtype=dtype, device=card)
        ctx = SchurContext(cp)
        assert all(p.kernel is not None for p in ctx.plans)
        values = cp.initial_values()
        if size == "small":
            values = behind_a_camera(cp, values)
        before = sa.launches
        got = _assembled(ctx, values)
        assert sa.launches - before == len(cp.groups)
        again = _assembled(ctx, values)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        generic = SchurContext(cp, whole_groups=False)
        assert all(p.kernel is None for p in generic.plans)
        want = _assembled(generic, values)
        assert sa.launches - before == 2 * len(cp.groups)
        torch.cuda.synchronize()
        if size == "small":
            w0 = cp.groups[0].weights
            assert (w0 is None or float(w0[0]) == 1.0) and not got[5][0].any()
        for t, w in zip(got, want):
            assert torch.isfinite(t).all()
            err = float((t - w).abs().max() / w.abs().max())
            assert err <= ASSEMBLY_RTOL[dtype], (size, dtype, err)
        del ctx, generic, cp, got, again, want
        torch.cuda.empty_cache()


def test_jit_selfcal_ba_with_the_assembly_kernels(card):
    """A small self-calibrating BA in jit mode against python mode: the
    same iterations and status, final cost within rtol 1e-9. The assembly
    kernels give the same bits run to run; while PCG's sums ran by
    index_add_ in atomic order, python mode's own final costs on this
    problem spread by up to 1.1e-10 (six solves on an H100), and jit mode's
    fell inside that spread (the coupling kernels now take those sums too,
    ``test_jit_ba_replays_the_coupling_kernels``). The second camera's x is fixed too, so
    that the scale is held by more than the damping. Python mode calls the
    kernels once per group and LM iteration; jit mode records each group's
    call once, replays it once per LM iteration, and its warm-up calls
    each once; the kernels take every row (``assemble_kernel_rows`` =
    ``assemble_rows``)."""
    from apex_tpu_torch.kernels import schur_assemble as sa
    from apex_tpu_torch.linalg import schur
    from apex_tpu_torch.optim import graphs

    problem = build_ba_problem(assembly_scene())
    problem.fix_variable("pose_0001", indices=[0])
    cp = problem.compile(dtype=torch.float64, device=card)
    n, K = len(cp.groups), sum(g.count for g in cp.groups)
    kw = dict(linear_solver_type="schur_implicit", max_iterations=10, pcg_forcing=False,
              pcg_tolerance=1e-10, pcg_max_iterations=200)

    def counted(mode):
        rows, kernel_rows = schur.assemble_rows, schur.assemble_kernel_rows
        res = _jit_solver("lm", mode=mode, **kw).optimize(cp)
        return res, schur.assemble_rows - rows, schur.assemble_kernel_rows - kernel_rows

    before = sa.launches
    rp, rows, kernel_rows = counted("python")
    assert sa.launches - before == n * rp.iterations
    assert rows == kernel_rows == K * rp.iterations
    graphs.reset_counters()
    sa.launches = sa.captured = 0
    replayed = graphs.replayed["schur_assemble"]
    rj, rows, kernel_rows = counted("jit")
    assert sa.captured == n and sa.launches == n
    assert graphs.replayed["schur_assemble"] - replayed == n * rj.iterations
    assert rows == kernel_rows == K * rj.iterations
    assert (rj.iterations, rj.status) == (rp.iterations, rp.status)
    np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=1e-9)


def test_other_cameras_take_the_generic_assembly_on_the_card(card):
    """A pinhole group and an extended camera's group (per-camera
    intrinsics) assemble by the generic path on the card: no kernel call.
    They have their row orders, but their entities (De = 10, 14) are wider
    than the coupling kernels are built for: W u takes the plain path."""
    from apex_tpu_torch.kernels import schur_apply as ap
    from apex_tpu_torch.kernels import schur_assemble as sa
    from apex_tpu_torch.linalg.schur import SchurContext

    poses, pts = selfcal_scene()
    for model in ("pinhole", "kannala_brandt"):
        problem, _ = selfcal_problem(model, SELFCAL_MODELS[model], poses, pts, shared=False)
        ctx = SchurContext(problem.compile(dtype=torch.float64, device=card))
        assert ctx.couplings and all(p.kernel is None for p in ctx.plans)
        assert all(p.orders is not None and not ctx._kernel_takes(p) for p in ctx.couplings)
        before, before_ap = sa.launches, ap.launches
        Ws = ctx.assemble(ctx.cp.initial_values(), 0.1)[4]
        ctx._w_u(Ws, torch.ones((ctx.num_landmarks, 3), dtype=torch.float64, device=card))
        assert sa.launches == before and ap.launches == before_ap


# ---------------------------------------------------------------------------
# the coupling kernels (kernels/schur_apply.py, csrc/schur_apply.cu)
# ---------------------------------------------------------------------------

# Each result's largest error against the plain path's (gathers, batched
# products, index_add_), over the largest entry of the same sum taken over
# |W|, |x|, |u|, |Hpp^-1|: both orders of summation round within (n + 9)
# units of the dtype's rounding of that scale, n the rows of one sum (at
# most 150 in these scenes, 9 the terms of a row's product), so the two
# within 2 x 159 units: 3.5e-14 in f64, 1.9e-5 in f32.
COUPLING_RTOL = {torch.float64: 1e-13, torch.float32: 5e-5}


def _coupling_problems():
    """The small scenes of the coupling kernels: BAL rows bucketed (four
    groups, De = 9), flat with the pose alone (De = 6), camera by camera
    (rows out of landmark order); pinhole rows with constant intrinsics
    (De = 6, a group the assembly kernels do not take)."""
    ds = assembly_scene()
    yield "bal_bucketed", build_ba_problem(ds)
    yield "bal_flat_pose", build_ba_problem(ds, mode="bundle_adjustment", layout="flat")
    yield "bal_camera_major", camera_major_problem(ds)
    yield "pinhole_pose", pinhole_problem()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_coupling_kernels_match_plain(card, dtype):
    """Every coupling group of each scene has its row orders and takes the
    kernels, one call per group and sum; two calls give the same bits; W^T
    x (alone, fused with Hpp^-1, and with Hpp^-1 after the sum where a
    landmark could lie in two groups), W u and the Schur-Jacobi sum equal
    the plain path's (the same context built with ``whole_groups=False``)
    on the same card tensors within ``COUPLING_RTOL``."""
    from apex_tpu_torch.kernels import schur_apply as ap
    from apex_tpu_torch.linalg.schur import SchurContext, landmark_inverse

    for name, problem in _coupling_problems():
        cp = problem.compile(dtype=dtype, device=card)
        ctx = SchurContext(cp)
        assert all(p.orders is not None for p in ctx.couplings), name
        assert all(map(ctx._kernel_takes, ctx.couplings)) and ctx._disjoint_landmarks, name
        plain = SchurContext(cp, whole_groups=False)
        assert not any(map(plain._kernel_takes, plain.couplings))
        Hcc, _, Hpp, _, Ws, _ = ctx.assemble(cp.initial_values(), 0.1)
        Hinv = landmark_inverse(Hpp)
        gen = torch.Generator(device=card).manual_seed(0)
        x = torch.randn(ctx.Dc, dtype=dtype, device=card, generator=gen)
        u = torch.randn((ctx.num_landmarks, 3), dtype=dtype, device=card, generator=gen)
        zero, absW = torch.zeros_like(Hcc), [W.abs() for W in Ws]
        # (the sum, its rounding scale)
        sums = {"wt_x": (lambda c: c._wt_x(Ws, x), plain._wt_x(absW, x.abs())),
                "hinv_wt_x": (lambda c: c._wt_x(Ws, x, Hinv),
                              plain._wt_x(absW, x.abs(), Hinv.abs())),
                "w_u": (lambda c: c._w_u(Ws, u), plain._w_u(absW, u.abs())),
                "schur_jacobi": (lambda c: -c._schur_diagonal(zero, Hinv, Ws),
                                 -plain._schur_diagonal(zero, Hinv.abs(), absW))}
        before = ap.launches
        for op, (fn, scale) in sums.items():
            got, again, want = fn(ctx), fn(ctx), fn(plain)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (name, op)
            err = float((got - want).abs().max() / scale.abs().max())
            assert err <= COUPLING_RTOL[dtype], (name, dtype, op, err)
        assert ap.launches - before == 2 * len(sums) * len(ctx.couplings)
        ctx._disjoint_landmarks = False
        fn, scale = sums["hinv_wt_x"]
        err = float((fn(ctx) - fn(plain)).abs().max() / scale.abs().max())
        assert err <= COUPLING_RTOL[dtype], (name, dtype, "hinv_wt_x, not fused", err)


def test_jit_ba_replays_the_coupling_kernels(card):
    """The small self-calibrating BA (De = 9, the assembly kernels) and the
    pinhole scene (De = 6, the generic assembly) in jit mode against python
    mode: the same iterations and status, final cost within rtol 1e-9 (the
    jit BA test's tolerance); jit mode replays the coupling kernels'
    calls; in both modes the kernels take every coupling row
    (``coupling_kernel_rows`` = ``coupling_rows``)."""
    from apex_tpu_torch.linalg import schur
    from apex_tpu_torch.optim import graphs

    bal = build_ba_problem(assembly_scene())
    bal.fix_variable("pose_0001", indices=[0])
    kw = dict(linear_solver_type="schur_implicit", max_iterations=10, pcg_forcing=False,
              pcg_tolerance=1e-10, pcg_max_iterations=200)
    for problem in (bal, pinhole_problem()):
        cp = problem.compile(dtype=torch.float64, device=card)

        def counted(mode):
            rows, kernel_rows = schur.coupling_rows, schur.coupling_kernel_rows
            res = _jit_solver("lm", mode=mode, **kw).optimize(cp)
            return res, schur.coupling_rows - rows, schur.coupling_kernel_rows - kernel_rows

        rp, rows, kernel_rows = counted("python")
        assert rows == kernel_rows > 0
        replayed = graphs.replayed["schur_apply"]
        rj, rows, kernel_rows = counted("jit")
        assert rows == kernel_rows > 0
        assert graphs.replayed["schur_apply"] > replayed
        assert (rj.iterations, rj.status) == (rp.iterations, rp.status)
        np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=1e-9)
