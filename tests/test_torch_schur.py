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
from apex_tpu_torch.kernels import schur_apply, schur_assemble
from apex_tpu_torch.linalg import schur
from apex_tpu_torch.linalg.schur import SchurContext
from apex_tpu_torch.linalg.utils import bmv
from assembly_problems import assembly_scene, camera_major_problem, pinhole_problem
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


def _tiles_of(orders, ent):
    """The camera-major order and tiles against numpy: the order is a
    stable argsort of the entity ids, each tile holds at most TILE_ROWS
    rows of one entity, and ``fin_ent`` / ``fin_off`` name each entity
    with rows and its run of tiles."""
    np.testing.assert_array_equal(orders.cam_perm.numpy(), np.argsort(ent, kind="stable"))
    tiles = orders.tile_off.numpy()
    assert tiles[0] == 0 and tiles[-1] == ent.size
    assert (np.diff(tiles) > 0).all() and (np.diff(tiles) <= schur_apply.TILE_ROWS).all()
    ent_sorted = ent[orders.cam_perm.numpy()]
    assert (ent_sorted[tiles[:-1]] == ent_sorted[tiles[1:] - 1]).all()
    fin_ent, fin_off = orders.fin_ent.numpy(), orders.fin_off.numpy()
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
    landmark-major permutation (``_orders_of``). A CPU problem builds no
    plan and no row orders itself."""
    loss = HuberLoss(1.0) if loss == "huber" else None
    if layout == "camera_major":
        problem = camera_major_problem(scene, mode, loss, fix_first)
    else:
        problem = build_ba_problem(scene, mode=mode, loss=loss, layout=layout,
                                   fix_first_camera=fix_first)
    cp = problem.compile(dtype=torch.float64, device="cpu")
    ctx = SchurContext(cp)
    assert all(p.kernel is None for p in ctx.plans), "a CPU problem takes the generic path"
    assert all(p.orders is None for p in ctx.plans) and not ctx._disjoint_landmarks
    assert ctx.couplings == ctx.plans
    if layout == "bucketed":
        assert len(cp.groups) == 4 and all(g.weights is not None for g in cp.groups)
        assert min(float(g.weights.min()) for g in cp.groups) == 0.0
    for plan, lm in zip(ctx.couplings, ctx._lm_host):
        orders = ctx._row_orders(plan, lm)
        kp = ctx._kernel_plan(plan, orders)
        assert kp.orders is orders
        assert kp.nc == (9 if mode == "self_calibration" else 6)
        assert torch.equal(kp.ent, plan.ent)
        assert (orders.lm_perm is not None) == (layout == "camera_major")
        _orders_of(orders, plan.ent.numpy(), lm)
        first = kp.ent_cols.numpy()[plan.ent.numpy()]
        assert len(plan.cam_cols) == (2 if mode == "self_calibration" else 1)
        for j, cols in enumerate(plan.cam_cols):
            np.testing.assert_array_equal(cols.numpy(),
                                          first[:, j:j + 1] + np.arange(cols.shape[1]))


def _entities_and_landmarks(ctx, plan):
    return ctx._entities(plan)[0], ctx._lm_host[ctx.couplings.index(plan)]


def _orders_of(orders, ent, lm):
    """A group's row orders against numpy, with the properties the kernels
    assume: int32 and contiguous; every row once in the landmark runs,
    under its own landmark, each landmark one run, ``lm_ent`` each row's
    entity in that order; the lanes per run; the camera-major tiles
    (``_tiles_of``), ``cam_lm`` each row's landmark in that order."""
    K = ent.size
    for name in ("lm_perm", "lm_ent", "seg_lm", "seg_off", "cam_perm", "cam_lm", "tile_off",
                 "fin_ent", "fin_off"):
        t = getattr(orders, name)
        assert t is None or (t.dtype == torch.int32 and t.is_contiguous()), name
    assert orders.rows == K
    order = np.arange(K) if orders.lm_perm is None else orders.lm_perm.numpy()
    np.testing.assert_array_equal(order, np.argsort(lm, kind="stable"))
    seg_off, seg_lm = orders.seg_off.numpy(), orders.seg_lm.numpy()
    assert seg_off[0] == 0 and seg_off[-1] == K and (np.diff(seg_off) > 0).all()
    assert (np.diff(seg_lm) > 0).all()
    np.testing.assert_array_equal(np.repeat(seg_lm, np.diff(seg_off)), lm[order])
    np.testing.assert_array_equal(orders.lm_ent.numpy(), ent[order])
    assert orders.width == min(32, 1 << (int(np.diff(seg_off).max()) - 1).bit_length())
    _tiles_of(orders, ent)
    np.testing.assert_array_equal(orders.cam_lm.numpy(), lm[orders.cam_perm.numpy()])


def test_kernel_plans_and_dispatch(scene):
    """Rows out of landmark order get a landmark-major permutation; the
    kernels take no group of a pinhole or an extended camera, nor a pose
    graph's, nor a group whose camera columns differ within an entity
    (shared intrinsics); and a CPU solve launches nothing."""
    ctx = SchurContext(build_ba_problem(scene).compile(dtype=torch.float64, device="cpu"))
    for plan in ctx.couplings:
        ent, lm = _entities_and_landmarks(ctx, plan)
        shuffled = lm[np.random.default_rng(1).permutation(lm.size)]
        np.testing.assert_array_equal(ctx._row_orders(plan, shuffled).lm_perm.numpy(),
                                      np.argsort(shuffled, kind="stable"))
        # a camera slot whose column differs between rows of one entity
        g = ctx.cp.groups[plan.group_idx]
        orders = ctx._row_orders(plan, lm)
        locs = [np.full(ent.size, 3), np.zeros(ent.size, dtype=np.int64)]
        assert schur_assemble.plan_group(g, plan.cam_slots, plan.lm_slot, ent, locs, orders,
                                         ctx.num_entities, plan.ent) is not None
        locs[0][np.flatnonzero(ent == ent[0])[-1]] = 0
        assert schur_assemble.plan_group(g, plan.cam_slots, plan.lm_slot, ent, locs, orders,
                                         ctx.num_entities, plan.ent) is None
        # a group of no rows has no orders, and no plan
        assert schur_apply.plan_orders(ent[:0], lm[:0], ctx.num_entities, "cpu") is None
        assert schur_assemble.plan_group(g, plan.cam_slots, plan.lm_slot, ent, locs, None,
                                         ctx.num_entities, plan.ent) is None

    poses, pts = selfcal_scene()
    for model in ("pinhole", "kannala_brandt"):
        problem, _ = selfcal_problem(model, SELFCAL_MODELS[model], poses, pts, shared=False)
        other = SchurContext(problem.compile(dtype=torch.float64, device="cpu"))
        assert other.couplings
        for plan in other.couplings:
            orders = other._row_orders(plan, _entities_and_landmarks(other, plan)[1])
            assert orders is not None and other._kernel_plan(plan, orders) is None, model
    graph = synthetic.synthetic_pose_graph_3d(n_poses=50, rings=5, seed=0)
    cp = graph.to_problem(fix_first=True).compile(dtype=torch.float64, device="cpu")
    assert not any(schur_assemble.takes(g, range(len(g.manifolds)), None) for g in cp.groups)
    before = schur_assemble.launches
    res = LevenbergMarquardt(LevenbergMarquardtConfig(linear_solver_type="schur_implicit",
                                                      max_iterations=2)).optimize(
        build_ba_problem(scene).compile(dtype=torch.float64, device="cpu"))
    assert res.iterations == 2 and schur_assemble.launches == before


# -- the coupling kernels' row orders and sums (kernels/schur_apply.py) -------


def _orders_problem(case, scene):
    """The problems of the coupling kernels' CPU tests: BAL rows bucketed
    (De = 9, four groups), flat (De = 6), camera by camera (rows out of
    landmark order); pinhole rows (a camera the assembly kernels do not
    take) with constant intrinsics (De = 6) and free ones (De = 10, a width
    the coupling kernels are not built for)."""
    if case == "bal_bucketed":
        return build_ba_problem(scene)
    if case == "bal_flat_pose":
        return build_ba_problem(scene, mode="bundle_adjustment", layout="flat")
    if case == "bal_camera_major":
        return camera_major_problem(scene)
    return pinhole_problem(intrinsics_free=case == "pinhole_selfcal")


ORDER_CASES = ["bal_bucketed", "bal_flat_pose", "bal_camera_major", "pinhole_pose",
               "pinhole_selfcal"]


@pytest.mark.parametrize("case", ORDER_CASES)
def test_row_orders_of_every_coupling_group(scene, case):
    """Every coupling group gets its row orders, whatever its camera model
    and entity width (on the card ``SchurContext`` builds them for every
    coupling group; here ``_row_orders``), with the properties the kernels
    assume (``_orders_of``); the coupling kernels take the entity widths
    they are built for."""
    ctx = SchurContext(_orders_problem(case, scene).compile(dtype=torch.float64, device="cpu"))
    want_de = {"bal_bucketed": 9, "bal_flat_pose": 6, "bal_camera_major": 9, "pinhole_pose": 6,
               "pinhole_selfcal": 10}[case]
    assert ctx.entity_dof == want_de
    assert ctx.couplings and all(p.orders is None for p in ctx.couplings)
    for plan, lm in zip(ctx.couplings, ctx._lm_host):
        orders = ctx._row_orders(plan, lm)
        _orders_of(orders, plan.ent.numpy(), lm)
        assert (orders.lm_perm is not None) == (case in ("bal_camera_major", "pinhole_pose",
                                                          "pinhole_selfcal"))
        plan.orders = orders
        assert ctx._kernel_takes(plan) == (want_de in (6, 9))
        plan.orders = None


def _kernel_order_sums(ctx, Ws, x, u, Hpp_inv):
    """The coupling sums in the kernels' order from the row orders: per
    group, each landmark run's sum of its rows (W^T x), and each entity's
    tiles' sums added in tile order (W u, the Schur-Jacobi blocks'
    W Hpp^-1 W^T); the groups in turn. Each row's product is the plain
    path's own, so that the sums differ from its by their order alone.
    (t, y, Z)."""
    E, De, P = ctx.num_entities, ctx.entity_dof, ctx.num_landmarks
    xe = x.reshape(E, De)
    t, y, Z = np.zeros((P, 3)), np.zeros((E, De)), np.zeros((E, De, De))
    for plan, W, lm in zip(ctx.couplings, Ws, ctx._lm_host):
        o = ctx._row_orders(plan, lm)
        order = np.arange(W.shape[0]) if o.lm_perm is None else o.lm_perm.numpy()
        rows = bmv(W.transpose(1, 2), xe[plan.ent]).numpy()[order]
        t[o.seg_lm.numpy()] += np.add.reduceat(rows, o.seg_off.numpy()[:-1])
        cam, tiles, fin = o.cam_perm.numpy(), o.tile_off.numpy()[:-1], o.fin_off.numpy()[:-1]
        for out, rows in ((y, bmv(W, u[plan.lm])),
                          (Z, W @ Hpp_inv[plan.lm] @ W.transpose(1, 2))):
            out[o.fin_ent.numpy()] += np.add.reduceat(np.add.reduceat(rows.numpy()[cam], tiles),
                                                      fin)
    return t, y, Z


@pytest.mark.parametrize("case", ORDER_CASES[:4])
def test_kernel_summation_order_matches_index_add(scene, case):
    """The kernels' order of summation (``_kernel_order_sums``) gives the
    plain path's W^T x (alone and under Hpp^-1), W u and Schur-Jacobi
    blocks (gathers, batched products, ``index_add_``) within 1e-12 of each
    sum's largest entry in f64: the orders cover every row once, under
    its own entity and landmark, and the sums differ by rounding alone."""
    cp = _orders_problem(case, scene).compile(dtype=torch.float64, device="cpu")
    ctx = SchurContext(cp)
    Hcc, _, Hpp, _, Ws, _ = ctx.assemble(cp.initial_values(), DAMPING)
    Hpp_inv = schur.landmark_inverse(Hpp)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=ctx.Dc))
    u = torch.from_numpy(rng.normal(size=(ctx.num_landmarks, 3)))
    t, y, Z = _kernel_order_sums(ctx, Ws, x, u, Hpp_inv)
    got = {"wt_x": t, "hinv_wt_x": bmv(Hpp_inv, torch.from_numpy(t)).numpy(),
           "w_u": y.reshape(-1), "schur_jacobi_sum": Z}
    want = {"wt_x": ctx._wt_x(Ws, x), "hinv_wt_x": ctx._wt_x(Ws, x, Hpp_inv),
            "w_u": ctx._w_u(Ws, u),
            # the sum alone: 0 - sum is exact
            "schur_jacobi_sum": -ctx._schur_diagonal(torch.zeros_like(Hcc), Hpp_inv, Ws)}
    for name, w in want.items():
        w = w.numpy()
        assert np.abs(got[name] - w).max() <= 1e-12 * np.abs(w).max(), name


@pytest.mark.parametrize("mode", ["python", "jit"])
def test_coupling_rows_count_where_the_work_runs(mode):
    """``coupling_rows`` counts each pass over the couplings where it runs:
    per LM iteration b, the Schur-Jacobi blocks, PCG's warm start, two per
    PCG iteration executed (masked ones of jit mode's chunks included) and
    two in the back substitution, so 6 per PCG solve and 2 per iteration
    executed, each the problem's coupling rows. On the CPU the kernels take
    none (``coupling_kernel_rows`` stays)."""
    cp = build_ba_problem(synthetic.synthetic_ba_large(
        n_cameras=6, n_points=300, obs_per_camera=120, pixel_noise=0.3, seed=0)).compile(
        dtype=torch.float64, device="cpu")
    K = sum(g.count for g in cp.groups)
    names = ("coupling_rows", "coupling_kernel_rows", "pcg_calls", "pcg_executed")
    before = {n: getattr(schur, n) for n in names}
    res = LevenbergMarquardt(LevenbergMarquardtConfig(
        linear_solver_type="schur_implicit", max_iterations=4, pcg_max_iterations=15,
        mode=mode)).optimize(cp)
    d = {n: getattr(schur, n) - before[n] for n in names}
    assert d["pcg_calls"] == res.iterations >= 2
    assert d["coupling_rows"] == K * (6 * d["pcg_calls"] + 2 * d["pcg_executed"])
    assert d["coupling_kernel_rows"] == 0
