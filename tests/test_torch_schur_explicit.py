"""The port's explicit Schur solve (``variant="sparse"``: the dense reduced
camera matrix S from pair products, Cholesky with the retry ladder) against
apex_tpu's, on the CPU in f64.

Tolerances: the pair sets are equal as sets (the order within a landmark
differs); S, b and the cost of one assembly agree to rtol 1e-10 of each
tensor's largest entry (the sums run in another order); one solve at
damping 0.1 to rtol 1e-8 (self-calibration leaves the scale free, so the
step's conditioning grows as 1/damping); end to end the same iterations and
status, final cost to rtol 1e-8, and to rtol 1e-6 of the dense solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.factors import BetweenFactor as JaxBetween
from apex_tpu.linalg.schur import SchurContext as JaxSchur
from apex_tpu.linalg.schur import landmark_inverse as jax_landmark_inverse
from apex_tpu.manifolds import SE3 as JaxSE3
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.convert import values_from_jax
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.linalg.schur import SchurContext, enumerate_pairs, landmark_inverse
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

DAMPING = 0.1
EXPLICIT_NAMES = ["schur_explicit", "sparse_schur_complement", "sparse_schur", "schur",
                  "schur_auto"]


def _reference_pairs(lm_of_coupling):
    """The reference's dict loops (apex_tpu/linalg/schur.py, _enumerate_pairs),
    transcribed: a list over ordered coupling pairs of sets of (ia, ib)."""
    by_rec = []
    for ids in lm_of_coupling:
        by_lm = {}
        for k in np.argsort(ids, kind="stable"):
            by_lm.setdefault(int(ids[k]), []).append(int(k))
        by_rec.append(by_lm)
    out = []
    for a in by_rec:
        for b in by_rec:
            out.append({(k1, k2) for lm in set(a) & set(b) for k1 in a[lm] for k2 in b[lm]})
    return out


@pytest.mark.parametrize("sizes,n_landmarks", [((40,), 12), ((30, 17), 9), ((25, 0, 8), 30)],
                         ids=["one", "two", "three_one_empty"])
def test_pair_enumeration_matches_reference_loops(sizes, n_landmarks):
    rng = np.random.default_rng(sum(sizes))
    lms = [rng.integers(0, n_landmarks, size=k).astype(np.int64) for k in sizes]
    got = enumerate_pairs(lms)
    want = _reference_pairs(lms)
    assert len(got) == len(want) == len(sizes) ** 2
    for (ia, ib), ref in zip(got, want):
        assert ia.dtype == ib.dtype == np.int64 and len(ia) == len(ref)
        assert set(zip(ia.tolist(), ib.tolist())) == ref


@pytest.fixture(scope="module")
def setup():
    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    jcp = jax_build(ds, mode="self_calibration").compile(dtype=np.float64)
    jctx = JaxSchur(jcp, variant="sparse")
    tcp = build_ba_problem(ds, mode="self_calibration").compile(
        dtype=torch.float64, device="cpu")
    tctx = SchurContext(tcp, variant="sparse")
    # a mid-solve state: the initial values moved by a seeded step
    dx = np.random.default_rng(3).normal(scale=1e-2, size=jcp.total_dof)
    jvals = jcp.apply_step(jcp.initial_values(), jnp.asarray(dx))
    tvals = values_from_jax(tcp, [np.asarray(v) for v in jvals], jcp.pools)
    return ds, jcp, jctx, jvals, tcp, tctx, tvals


def _close(t, j, rtol):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * np.abs(j).max())


def test_pair_set_matches_apex_tpu(setup):
    _, _, jctx, _, tcp, tctx, _ = setup
    assert len(tctx.pair_indices) == len(jctx.pair_indices) == len(tctx.couplings) ** 2
    for (ia, ib), (ja, jb) in zip(tctx.pair_indices, jctx.pair_indices):
        assert ia.dtype == torch.int64 and ia.device == tcp.device
        assert set(zip(ia.tolist(), ib.tolist())) == set(
            zip(np.asarray(ja).tolist(), np.asarray(jb).tolist()))
    assert sum(len(ia) for ia, _ in tctx.pair_indices) > 1000


def test_schur_matrix_and_rhs(setup):
    """S and b of one assembly, each side through its own methods."""
    _, _, jctx, jvals, _, tctx, tvals = setup

    @jax.jit
    def jax_side(values):
        Hcc, gc, Hpp, gp, Ws, cost = jctx.assemble(values, DAMPING)
        inv = jax_landmark_inverse(Hpp)
        mc = jctx.mcouplings[0]
        Y = jnp.einsum("kij,kjl->kil", Ws[0], inv[mc.lm_ids])
        ia, ib = jctx.pair_indices[0]
        S = jctx._scatter_pair_products(jctx._hcc_dense(Hcc), Y, Ws[0], mc.ent_ids,
                                        mc.ent_ids, ia, ib)
        return S, -gc + jctx._w_u(Ws, jnp.einsum("kij,kj->ki", inv, gp)), cost

    jS, jb, jcost = jax_side(jvals)

    Hcc, gc, Hpp, gp, Ws, cost = tctx.assemble(tvals, DAMPING)
    inv = landmark_inverse(Hpp)
    S = tctx._schur_dense(Hcc, inv, Ws)
    b = -gc + tctx._w_u(Ws, (inv @ gp[..., None])[..., 0])
    assert S.shape == (tctx.Dc, tctx.Dc) == (72, 72)
    _close(S, jS, 1e-10)
    _close(b, jb, 1e-10)
    _close(cost, jcost, 1e-12)
    # S is symmetric, and positive definite through the damping
    assert (S - S.T).abs().max() <= 1e-12 * S.abs().max()
    assert torch.linalg.eigvalsh((S + S.T) / 2)[0] > 0


def test_explicit_solve_matches_apex_tpu(setup):
    _, _, jctx, jvals, _, tctx, tvals = setup
    jdx, jg, jcost, jpred = jax.jit(lambda v: jctx.solve(v, DAMPING))(jvals)
    tdx, tg, tcost, tpred = tctx.solve(tvals, DAMPING)
    scale = np.abs(np.asarray(jdx)).max()
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-8, atol=1e-12 * scale)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8,
                               atol=1e-12 * np.abs(np.asarray(jg)).max())
    _close(tcost, jcost, 1e-12)
    np.testing.assert_allclose(float(tpred), float(jpred), rtol=1e-8)


def test_explicit_solve_matches_implicit(setup):
    """The two variants solve the same reduced system: one exact implicit
    solve of the port gives the explicit step (rtol 1e-7 of its largest
    entry, the PCG tolerance being 1e-10)."""
    tcp, tctx, tvals = setup[4:]
    exact = SchurContext(tcp, variant="iterative", pcg_forcing=False, pcg_tolerance=1e-10,
                         pcg_max_iterations=500)
    dx_e, _, _, pred_e = tctx.solve(tvals, DAMPING)
    dx_i, _, _, pred_i = exact.solve(tvals, DAMPING)
    assert (dx_e - dx_i).abs().max() <= 1e-7 * dx_e.abs().max()
    np.testing.assert_allclose(float(pred_e), float(pred_i), rtol=1e-8)


def _lm(pkg, solver, **kw):
    return pkg.LevenbergMarquardt(pkg.LevenbergMarquardtConfig(
        linear_solver_type=solver, max_iterations=30, **kw))


@pytest.fixture(scope="module")
def e2e(setup):
    """One JAX explicit solve and the port's dense solve, shared by the
    cases below."""
    _, jcp, _, _, tcp, _, _ = setup
    return _lm(jax_apx, "schur_explicit").optimize(jcp), _lm(apx, "dense_cholesky").optimize(tcp)


@pytest.mark.parametrize("solver", EXPLICIT_NAMES)
def test_explicit_e2e_matches_apex_tpu_and_dense(setup, e2e, solver):
    ds, tcp = setup[0], setup[4]
    rj, r_dense = e2e
    lm = _lm(apx, solver)
    rt = lm.optimize(tcp)
    assert lm._step_cache[tcp].solve_fn.schur_context.variant == "sparse"
    assert rt.converged and rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status))
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    np.testing.assert_allclose(rt.final_cost, r_dense.final_cost, rtol=1e-6)
    # tests/test_ba_e2e.py's convergence gate
    assert rt.final_cost < 0.15 * rt.initial_cost
    assert apx.ba.rmse(rt.final_cost, ds.num_observations) < 1.0


def test_explicit_with_jacobi_scaling_option_runs(setup, e2e):
    """``use_jacobi_scaling`` is ignored by the Schur paths of both packages
    (no warm start rides the slot either): the explicit result is the same."""
    rt = _lm(apx, "schur_explicit", use_jacobi_scaling=True).optimize(setup[4])
    assert rt.iterations == e2e[0].iterations
    np.testing.assert_allclose(rt.final_cost, e2e[0].final_cost, rtol=1e-8)


def test_pair_chunking_matches_one_chunk(monkeypatch):
    """PAIR_CHUNK = 37 (many chunks and a ragged tail) against one chunk:
    the same iterations, final cost to rtol 1e-10."""
    ds = synthetic.synthetic_ba(n_cameras=6, n_points=80, seed=2)
    cp = build_ba_problem(ds, mode="self_calibration").compile(
        dtype=torch.float64, device="cpu")
    results = []
    for chunk in (1 << 18, 37):
        monkeypatch.setattr(SchurContext, "PAIR_CHUNK", chunk)
        cfg = apx.LevenbergMarquardtConfig(linear_solver_type="schur_explicit",
                                           max_iterations=8)
        results.append(apx.LevenbergMarquardt(cfg).optimize(cp))
    r1, r2 = results
    assert r1.iterations == r2.iterations
    np.testing.assert_allclose(r2.final_cost, r1.final_cost, rtol=1e-10)


def _hybrid_problem(pkg, build, between, ds):
    """BA observations plus an odometry chain on the camera poses: the
    pose-pose factors merge all cameras into one 36-DOF entity."""
    problem = build(ds, mode="bundle_adjustment")
    poses = ds.camera_se3()
    for i in range(ds.num_cameras - 1):
        meas = np.asarray(JaxSE3.between(jnp.asarray(poses[i]), jnp.asarray(poses[i + 1])))
        problem.add_residual_block([f"pose_{i:04d}", f"pose_{i + 1:04d}"],
                                   between("SE3", meas))
    return problem


def test_hybrid_explicit_matches_dense_and_apex_tpu():
    """tests/test_schur_hybrid.py: H_cc is one dense 36 x 36 block, its
    padded diagonal carried into S."""
    ds = synthetic.synthetic_ba(n_cameras=6, n_points=80, seed=3)
    tcp = _hybrid_problem(apx, build_ba_problem, apx.BetweenFactor, ds).compile(
        dtype=torch.float64, device="cpu")
    ctx = SchurContext(tcp, variant="sparse")
    assert (ctx.num_entities, ctx.entity_dof) == (1, 36)
    r_exp = _lm(apx, "schur_explicit").optimize(tcp)
    r_dense = _lm(apx, "dense_cholesky").optimize(tcp)
    np.testing.assert_allclose(r_exp.final_cost, r_dense.final_cost, rtol=1e-6)
    jcp = _hybrid_problem(jax_apx, jax_build, JaxBetween, ds).compile(dtype=np.float64)
    rj = _lm(jax_apx, "schur_explicit").optimize(jcp)
    assert r_exp.iterations == rj.iterations and r_exp.status == apx.Status(int(rj.status))
    np.testing.assert_allclose(r_exp.final_cost, rj.final_cost, rtol=1e-8)


def test_padded_entity_diagonal_reaches_s():
    """Entities narrower than De carry 1.0 on their padded diagonal; without
    it S is singular."""
    ds = synthetic.synthetic_ba(n_cameras=5, n_points=60, seed=4)
    problem = build_ba_problem(ds, mode="self_calibration")
    # a between factor joins two cameras into one 18-DOF entity; the other
    # three stay 9 wide and are padded to 18
    poses = ds.camera_se3()
    meas = np.asarray(JaxSE3.between(jnp.asarray(poses[0]), jnp.asarray(poses[1])))
    problem.add_residual_block(["pose_0000", "pose_0001"], apx.BetweenFactor("SE3", meas))
    cp = problem.compile(dtype=torch.float64, device="cpu")
    ctx = SchurContext(cp, variant="sparse")
    assert ctx.entity_dof == 18 and ctx.num_entities == 4
    Hcc, _, Hpp, _, Ws, _ = ctx.assemble(cp.initial_values(), None)
    S = ctx._schur_dense(Hcc, landmark_inverse(Hpp), Ws)
    pad = ctx._pad_diag.reshape(-1).bool()
    assert int(pad.sum()) == 3 * 9
    torch.testing.assert_close(torch.diagonal(S)[pad], torch.ones(27, dtype=torch.float64))
    assert S[pad][:, ~pad].abs().max() == 0
    r_exp = _lm(apx, "schur_explicit").optimize(cp)
    r_dense = _lm(apx, "dense_cholesky").optimize(cp)
    assert r_exp.converged
    np.testing.assert_allclose(r_exp.final_cost, r_dense.final_cost, rtol=1e-6)


@pytest.mark.parametrize("cameras,variant", [(455, "sparse"), (456, "iterative")])
def test_schur_auto_choice(cameras, variant):
    """``schur`` / ``schur_auto`` take the explicit variant up to 4096
    reduced camera DOF: 455 self-calibrating cameras are 4095, 456 are 4104
    (apex_tpu/optim/lm.py reads the same Dc from a probe context)."""
    ds = synthetic.synthetic_ba_large(n_cameras=cameras, n_points=600, obs_per_camera=6, seed=0)
    cp = build_ba_problem(ds, mode="self_calibration").compile(
        dtype=torch.float64, device="cpu")
    for name in ("schur", "schur_auto"):
        ctx = _lm(apx, name)._make_solve_fn(cp).schur_context
        assert ctx.Dc == 9 * cameras and ctx.variant == variant
        assert (ctx.pair_indices is not None) == (variant == "sparse")


def test_schur_auto_reduced_size_matches_apex_tpu(setup):
    _, jcp, jctx, _, tcp, tctx, _ = setup
    assert tctx.Dc == jctx.Dc == 72
    it = SchurContext(tcp, variant="iterative")
    sp = it.with_variant("sparse")
    assert it.pair_indices is None and sp.variant == "sparse" and sp.plans is it.plans
    for (ia, ib), (ja, jb) in zip(sp.pair_indices, tctx.pair_indices):
        assert torch.equal(ia, ja) and torch.equal(ib, jb)


def test_variant_names():
    cp = build_ba_problem(synthetic.synthetic_ba(4, 40, seed=1)).compile(
        dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="unknown Schur variant"):
        SchurContext(cp, variant="explicit")
    ctx = SchurContext(cp, variant="sparse")
    assert ctx.pp_shift_floor == 1e-4  # the f32 landmark floor holds for both variants
    dx, g, cost, pred = ctx.solve(cp.initial_values(), 1e-6)
    assert dx.dtype == torch.float32 and torch.isfinite(dx).all() and float(pred) > 0


def test_cli_solver_explicit(capsys):
    from apex_tpu_torch.cli.bundle_adjustment import main

    rc = main(["--synthetic", "--cameras", "6", "--points", "80", "--max-iterations", "8",
               "--solver", "explicit", "--platform", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Optimization completed!" in out and "Final RMSE" in out
