"""The port's implicit Schur solver against apex_tpu's block path
(APEX_TPU_UNIFORM=0) on synthetic_ba(8, 150, seed=0), f64, both started
from the same mid-solve state through convert.values_from_jax.

Tolerances: assembly rtol 1e-10 and solve rtol 1e-8. The sums run in
another order (index_add_ against sorted segment sums) and the PCG
preconditioner comes from another eigh, so the results agree to rounding
and to the PCG tolerance (1e-10), not bitwise. The solve runs at damping
0.1: self-calibration leaves the global scale free, held only by the
damping, so the step's conditioning grows as 1/damping and at 1e-3 turns
1e-16 assembly rounding into ~5e-8 relative differences of dx."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.linalg.schur import SchurContext as JaxSchur
from apex_tpu_torch import LevenbergMarquardt, LevenbergMarquardtConfig
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.convert import values_from_jax, values_to_numpy
from apex_tpu_torch.core.losses import HuberLoss
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.kernels import schur_assemble
from apex_tpu_torch.linalg.schur import SchurContext
from assembly_problems import assembly_scene, camera_major_problem
from chip_smoke import SELFCAL_MODELS, selfcal_problem, selfcal_scene
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

EXACT = dict(variant="iterative", pcg_forcing=False, pcg_tolerance=1e-10,
             pcg_max_iterations=500)
DAMPING = 0.1


@pytest.fixture(scope="module")
def setup():
    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_UNIFORM", "0")
        jcp = jax_build(ds, mode="self_calibration").compile(dtype=np.float64)
        jctx = JaxSchur(jcp, **EXACT)
    assert jctx.uniform is None, "the JAX side must run its block path"
    tcp = build_ba_problem(ds, mode="self_calibration").compile(
        dtype=torch.float64, device="cpu")
    tctx = SchurContext(tcp, **EXACT)
    # a mid-solve state: the initial values moved by a seeded step
    dx = np.random.default_rng(3).normal(scale=1e-2, size=jcp.total_dof)
    jvals = jcp.apply_step(jcp.initial_values(), jnp.asarray(dx))
    tvals = values_from_jax(tcp, [np.asarray(v) for v in jvals], jcp.pools)
    return jcp, jctx, jvals, tcp, tctx, tvals


def _close(t, j, rtol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=0)


def test_structure(setup):
    _, jctx, _, _, tctx, _ = setup
    assert (tctx.num_landmarks, tctx.num_entities, tctx.entity_dof) == (
        jctx.num_landmarks, jctx.num_entities, jctx.entity_dof)
    np.testing.assert_array_equal(tctx.red_of_global, jctx.red_of_global)
    assert len(tctx.couplings) == len(jctx.mcouplings)


def test_assemble(setup):
    _, jctx, jvals, _, tctx, tvals = setup
    jout = jctx.assemble(jvals, DAMPING)
    tout = tctx.assemble(tvals, DAMPING)
    for name, t, j in zip(("Hcc", "gc", "Hpp", "gp"), tout[:4], jout[:4]):
        assert t.shape == j.shape, name
        _close(t, j, 1e-10)
    assert len(tout[4]) == len(jout[4])
    for tw, jw in zip(tout[4], jout[4]):
        _close(tw, jw, 1e-10)
    _close(tout[5], jout[5], 1e-10)


@pytest.mark.parametrize("start", ["cold", "warm", "bad_warm"])
def test_solve(setup, start):
    jcp, jctx, jvals, _, tctx, tvals = setup
    jx0 = None
    if start != "cold":
        ref, *_ = jctx.solve(jvals, DAMPING)
        rng = np.random.default_rng(5)
        # a good warm start is near the answer; a bad one is rejected by the
        # guard and PCG starts from zero
        x0 = (0.9 * np.asarray(ref) if start == "warm"
              else rng.normal(scale=1e3, size=jcp.total_dof))
        jx0 = jnp.asarray(x0)
    jdx, jg, jcost, jpred = jctx.solve(jvals, DAMPING, dx_prev=jx0)
    tdx, tg, tcost, tpred = tctx.solve(
        tvals, DAMPING, dx_prev=None if jx0 is None else torch.from_numpy(np.array(jx0)))
    scale = np.abs(np.asarray(jdx)).max()
    # fixed-DOF entries are rounding noise around 0 in both: atol at the
    # step's scale
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-8, atol=1e-12 * scale)
    _close(tg, jg, 1e-8)
    _close(tcost, jcost, 1e-12)
    _close(tpred, jpred, 1e-8)


def test_forcing_and_f32_knobs(setup):
    _, _, _, tcp, tctx, _ = setup
    assert tctx.pcg_rtol(None) == tctx.pcg_rtol_floor == 1e-10
    forced = SchurContext(tcp, variant="iterative", pcg_tolerance=1e-6)
    assert [forced.pcg_rtol(k) for k in (0, 1, 3, 30)] == [0.1, 0.05, 0.0125, 1e-6]
    f32 = SchurContext(build_ba_problem(synthetic.synthetic_ba(4, 40, seed=1)).compile(
        dtype=torch.float32, device="cpu"))
    assert f32.pp_shift_floor == 1e-4 and f32.pcg_rtol_floor == 3e-5
    assert tctx.pp_shift_floor == 0.0


def test_convert_checks(setup):
    jcp, _, jvals, tcp, _, tvals = setup
    arrays = values_to_numpy(tvals)
    for a, j in zip(arrays, jvals):
        np.testing.assert_array_equal(a, np.asarray(j))
    with pytest.raises(ValueError, match="shape"):
        values_from_jax(tcp, [a[:-1] for a in arrays], jcp.pools)
    with pytest.raises(ValueError, match="pools"):
        values_from_jax(tcp, arrays[:-1], jcp.pools)
    with pytest.raises(ValueError, match="manifold"):
        values_from_jax(tcp, arrays, jcp.pools[::-1])


def test_not_ported_variant(setup):
    """Both variants are ported (tests/test_torch_schur_explicit.py holds
    the explicit one to apex_tpu); any other name is a ValueError."""
    assert SchurContext(setup[3], variant="sparse").pair_indices is not None
    assert setup[4].pair_indices is None
    for make in (lambda: SchurContext(setup[3], variant="dense"),
                 lambda: setup[4].with_variant("explicit")):
        with pytest.raises(ValueError, match="unknown Schur variant"):
            make()


# -- the assembly kernels' plans (kernels/schur_assemble.py) ------------------


@pytest.fixture(scope="module")
def scene():
    return assembly_scene()


def _tiles_of(kp, ent):
    """The plan's camera-major order and tiles against numpy: the order is
    a stable argsort of the entity ids, each tile holds at most TILE_ROWS
    rows of one entity, and ``fin_ent`` / ``fin_off`` name each entity
    with rows and its run of tiles."""
    np.testing.assert_array_equal(kp.cam_perm.numpy(), np.argsort(ent, kind="stable"))
    tiles = kp.tile_off.numpy()
    assert tiles[0] == 0 and tiles[-1] == ent.size
    assert (np.diff(tiles) > 0).all() and (np.diff(tiles) <= schur_assemble.TILE_ROWS).all()
    ent_sorted = ent[kp.cam_perm.numpy()]
    assert (ent_sorted[tiles[:-1]] == ent_sorted[tiles[1:] - 1]).all()
    fin_ent, fin_off = kp.fin_ent.numpy(), kp.fin_off.numpy()
    np.testing.assert_array_equal(fin_ent, np.unique(ent))
    np.testing.assert_array_equal(ent_sorted[tiles[fin_off[:-1]]], fin_ent)
    np.testing.assert_array_equal(tiles[fin_off[1:]] - tiles[fin_off[:-1]],
                                  np.bincount(ent)[fin_ent])


@pytest.mark.parametrize("fix_first", [True, False], ids=["fixed", "free"])
@pytest.mark.parametrize("layout", ["bucketed", "flat", "camera_major"])
@pytest.mark.parametrize("loss", ["huber", "l2"])
@pytest.mark.parametrize("mode", ["self_calibration", "bundle_adjustment"])
def test_kernel_plans_follow_the_generic_layout(scene, mode, loss, layout, fix_first):
    """The assembly kernels' plan of every group, against the generic
    path's own layout of the same rows (the kernels' arithmetic is held to
    the generic path on the card, ``test_torch_cuda.py``): every row once
    in the landmark runs, under its own landmark, each landmark one run;
    every row once in the camera-major tiles (``_tiles_of``); each row's
    camera columns at its entity's offsets (``ent_cols``), where the
    generic path writes them (``cam_cols``); the lanes per run. The rows of
    the camera-major layout come out of landmark order and get a
    landmark-major permutation. A CPU problem builds no plan itself."""
    loss = HuberLoss(1.0) if loss == "huber" else None
    if layout == "camera_major":
        problem = camera_major_problem(scene, mode, loss, fix_first)
    else:
        problem = build_ba_problem(scene, mode=mode, loss=loss, layout=layout,
                                   fix_first_camera=fix_first)
    cp = problem.compile(dtype=torch.float64, device="cpu")
    ctx = SchurContext(cp)
    assert all(p.kernel is None for p in ctx.plans), "a CPU problem takes the generic path"
    assert ctx.couplings == ctx.plans
    if layout == "bucketed":
        assert len(cp.groups) == 4 and all(g.weights is not None for g in cp.groups)
        assert min(float(g.weights.min()) for g in cp.groups) == 0.0
    for plan, lm in zip(ctx.couplings, ctx._lm_host):
        kp = ctx._kernel_plan(plan, lm)
        K = cp.groups[plan.group_idx].count
        assert kp.nc == (9 if mode == "self_calibration" else 6)
        assert torch.equal(kp.ent, plan.ent)
        assert (kp.lm_perm is not None) == (layout == "camera_major")
        order = np.arange(K) if kp.lm_perm is None else kp.lm_perm.numpy()
        np.testing.assert_array_equal(np.sort(order), np.arange(K))
        seg_off, seg_lm = kp.seg_off.numpy(), kp.seg_lm.numpy()
        assert seg_off[0] == 0 and seg_off[-1] == K and (np.diff(seg_off) > 0).all()
        assert (np.diff(seg_lm) > 0).all()
        np.testing.assert_array_equal(np.repeat(seg_lm, np.diff(seg_off)), lm[order])
        assert kp.width == min(32, 1 << (int(np.diff(seg_off).max()) - 1).bit_length())
        _tiles_of(kp, plan.ent.numpy())
        first = kp.ent_cols.numpy()[plan.ent.numpy()]
        assert len(plan.cam_cols) == (2 if mode == "self_calibration" else 1)
        for j, cols in enumerate(plan.cam_cols):
            np.testing.assert_array_equal(cols.numpy(),
                                          first[:, j:j + 1] + np.arange(cols.shape[1]))


def _entities_and_landmarks(ctx, plan):
    cols = ctx.cp.host_group_cols[plan.group_idx]
    ent = ctx.red_of_global[cols[plan.cam_slots[0]]] // ctx.entity_dof
    return ent, ctx._lm_host[ctx.couplings.index(plan)]


def test_kernel_plans_and_dispatch(scene):
    """Rows out of landmark order get a landmark-major permutation; the
    kernels take no group of a pinhole or an extended camera, nor a pose
    graph's, nor a group whose camera columns differ within an entity
    (shared intrinsics); and a CPU solve launches nothing."""
    ctx = SchurContext(build_ba_problem(scene).compile(dtype=torch.float64, device="cpu"))
    for plan in ctx.couplings:
        ent, lm = _entities_and_landmarks(ctx, plan)
        shuffled = lm[np.random.default_rng(1).permutation(lm.size)]
        np.testing.assert_array_equal(ctx._kernel_plan(plan, shuffled).lm_perm.numpy(),
                                      np.argsort(shuffled, kind="stable"))
        # a camera slot whose column differs between rows of one entity
        g = ctx.cp.groups[plan.group_idx]
        locs = [np.full(ent.size, 3), np.zeros(ent.size, dtype=np.int64)]
        assert schur_assemble.plan_group(g, plan.cam_slots, plan.lm_slot, ent, locs, lm,
                                         ctx.num_entities, plan.ent) is not None
        locs[0][np.flatnonzero(ent == ent[0])[-1]] = 0
        assert schur_assemble.plan_group(g, plan.cam_slots, plan.lm_slot, ent, locs, lm,
                                         ctx.num_entities, plan.ent) is None

    poses, pts = selfcal_scene()
    for model in ("pinhole", "kannala_brandt"):
        problem, _ = selfcal_problem(model, SELFCAL_MODELS[model], poses, pts, shared=False)
        other = SchurContext(problem.compile(dtype=torch.float64, device="cpu"))
        assert other.couplings
        for plan in other.couplings:
            assert other._kernel_plan(plan, _entities_and_landmarks(other, plan)[1]) is None, model
    graph = synthetic.synthetic_pose_graph_3d(n_poses=50, rings=5, seed=0)
    cp = graph.to_problem(fix_first=True).compile(dtype=torch.float64, device="cpu")
    assert not any(schur_assemble.takes(g, range(len(g.manifolds)), None) for g in cp.groups)
    before = schur_assemble.launches
    res = LevenbergMarquardt(LevenbergMarquardtConfig(linear_solver_type="schur_implicit",
                                                      max_iterations=2)).optimize(
        build_ba_problem(scene).compile(dtype=torch.float64, device="cpu"))
    assert res.iterations == 2 and schur_assemble.launches == before
