"""The general-sparsity tier of the port (linalg/sparse_general.py) against
apex_tpu on the CPU in f64: the 3D-lattice generator, the symbolic
elimination plans (array-equal), the block assembly, one solve against the
dense one, the retry ladder, LM end to end with and without elimination
levels, sparse_cholesky's switch above a 1536-column bandwidth, and the
tier's work counters (solves, ladder attempts, dense core factorizations
and their columns) counted where the work runs.

A graph of at most ``base_cap`` = 512 blocks has no elimination level: the
whole graph is the dense core. The tests that mean to run levels build with
``base_cap=8``, or substitute a subclass that does for
``GeneralSparseCholesky`` in both packages (both LM modules import it when
they build the solve)."""

import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu.linalg.sparse_general as jax_sg
import apex_tpu_torch as apx
import apex_tpu_torch.linalg.sparse_general as sg
from apex_tpu.ba import build_ba_problem as jax_build_ba
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.convert import values_from_jax
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.optim import graphs
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)
from test_torch_tracing import _CpuRecorder

FIXTURES = Path(__file__).resolve().parent / "fixtures"
# tests/test_medium_fixture.py: certified f64 optimum
MEDIUM_SE3 = ("medium_se3_250.g2o", 5.132992631561506e-01)
CERTIFIED = dict(max_iterations=100, cost_tolerance=1e-10, parameter_tolerance=1e-14,
                 gradient_tolerance=1e-14)
LM_SETTINGS = dict(max_iterations=30, cost_tolerance=1e-6)
# the tier's work counters (module globals of linalg/sparse_general.py)
WORK = ("general_solves", "general_retries", "general_core_factors", "general_core_cols")


def _work():
    return {name: getattr(sg, name) for name in WORK}


def _work_since(before):
    return {name: getattr(sg, name) - before[name] for name in WORK}


def _with_base_cap(cls, base_cap):
    class Capped(cls):
        def __init__(self, cp, deg_cap=24, min_picked=32, **_):
            super().__init__(cp, deg_cap=deg_cap, base_cap=base_cap, min_picked=min_picked)

    return Capped


@functools.lru_cache(maxsize=None)
def _grid_pair(shape, seed=0):
    """The lattice graph of ``shape`` from both packages (shared: the JAX
    package's generator compiles its group operations for each size)."""
    return (synthetic.synthetic_pose_graph_grid3d(*shape, seed=seed),
            jax_synthetic.synthetic_pose_graph_grid3d(*shape, seed=seed))


def _compiled_pair(problems, dtype=torch.float64):
    """(port cp, JAX cp, port values equal to the JAX initial values)."""
    pt, pj = problems
    cp = pt.compile(dtype=dtype, device="cpu")
    jcp = pj.compile(dtype=np.float64)
    values = values_from_jax(cp, [np.asarray(v) for v in jcp.initial_values()], jcp.pools)
    return cp, jcp, values


@pytest.mark.parametrize("shape", [(5, 4, 3), (4, 3, 3)], ids=["5x4x3", "4x3x3"])
def test_grid_generator_matches_apex_tpu(shape):
    t, j = _grid_pair(shape)
    n = int(np.prod(shape))
    assert t.num_vertices == j.num_vertices == n and t.num_edges == j.num_edges
    vt = np.stack([t.vertices_se3[i] for i in range(n)])
    vj = np.stack([j.vertices_se3[i] for i in range(n)])
    np.testing.assert_allclose(vt, vj, rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(vt[0], vj[0])
    for te, je in zip(t.edges_se3, j.edges_se3, strict=True):
        assert (te.frm, te.to) == (je.frm, je.to)
        np.testing.assert_allclose(te.measurement, je.measurement, rtol=1e-12, atol=1e-15)
        np.testing.assert_array_equal(te.information, je.information)


@pytest.mark.parametrize("shape,base_cap", [((10, 10, 10), 512), ((5, 4, 3), 8)],
                         ids=["10x10x10-default", "5x4x3-base8"])
def test_symbolic_plan_matches_apex_tpu(shape, base_cap):
    """The same levels, slot table and core: the independent sets follow
    Python's set iteration order, so only a statement-by-statement copy
    gives the same plan."""
    cp, jcp, _ = _compiled_pair(tuple(g.to_problem() for g in _grid_pair(shape)))
    gs = sg.GeneralSparseCholesky(cp, base_cap=base_cap)
    jgs = jax_sg.GeneralSparseCholesky(jcp, base_cap=base_cap)
    assert gs.sym.n_levels == jgs.sym.n_levels >= 1
    for lv, jlv in zip(gs.sym.levels, jgs.sym.levels, strict=True):
        for field in ("picked", "nbrs", "perm", "idx", "u_slots", "diag_slots", "upd_slots"):
            np.testing.assert_array_equal(getattr(lv, field), getattr(jlv, field), err_msg=field)
    assert gs.sym.slot_of == jgs.sym.slot_of and gs.sym.remaining == jgs.sym.remaining
    assert (gs.R, gs.dmax, gs.nv) == (jgs.R, jgs.dmax, jgs.nv)
    np.testing.assert_array_equal(gs.col_arr, jgs.col_arr)
    assert gs.sym.fill_ratio() == jgs.sym.fill_ratio() and gs.healthy() == jgs.healthy()


def _grid_problems():
    return tuple(g.to_problem() for g in _grid_pair((5, 4, 3)))


def _mixed_dof_problems():
    kw = dict(n_cameras=4, n_points=25, seed=3)
    return (build_ba_problem(synthetic.synthetic_ba(**kw), mode="self_calibration",
                             layout="flat"),
            jax_build_ba(jax_synthetic.synthetic_ba(**kw), mode="self_calibration",
                         layout="flat"))


# (problems, GeneralSparseCholesky options, damping, solve rtol)
SOLVE_CASES = {
    "grid": (_grid_problems, dict(base_cap=8), 1e-3, 1e-9),
    "mixed_dof_ba": (_mixed_dof_problems, dict(deg_cap=64, base_cap=4), 1e-2, 1e-8),
}


@pytest.fixture(scope="module", params=list(SOLVE_CASES))
def one_solve(request):
    """Assembly and one solve of the same values in both packages."""
    make, opts, damping, rtol = SOLVE_CASES[request.param]
    cp, jcp, values = _compiled_pair(make())
    gs, jgs = sg.GeneralSparseCholesky(cp, **opts), jax_sg.GeneralSparseCholesky(jcp, **opts)
    jvals = jcp.initial_values()
    return dict(cp=cp, gs=gs, values=values, damping=damping, rtol=rtol,
                assembled=gs.assemble(values), jassembled=jax.jit(jgs.assemble)(jvals),
                solved=gs.solve(values, damping),
                jsolved=jax.jit(lambda v: jgs.solve(v, damping))(jvals))


def test_assemble_matches_apex_tpu(one_solve):
    """B (without the trash block B[n_slots], which only the reference
    fills), the gradient blocks and the cost, rtol 1e-12."""
    (B, gv, cost), (jB, jgv, jcost) = one_solve["assembled"], one_solve["jassembled"]
    gs = one_solve["gs"]
    assert gs.sym.n_levels >= 1 and B.shape == jB.shape
    jB = np.asarray(jB)[:gs.sym.n_slots]
    np.testing.assert_allclose(B.numpy()[:gs.sym.n_slots], jB, rtol=1e-12,
                               atol=1e-12 * np.abs(jB).max())
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jgv)).max())
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-12)


def test_solve_matches_dense_and_apex_tpu(one_solve):
    cp, damping, rtol = one_solve["cp"], one_solve["damping"], one_solve["rtol"]
    dx, g, cost = one_solve["solved"]
    jdx, jg, _ = one_solve["jsolved"]
    H, gd, cd = cp.assemble_normal(one_solve["values"])
    ref = torch.linalg.solve(H + damping * torch.eye(cp.total_dof, dtype=H.dtype), -gd)
    assert float(torch.linalg.vector_norm(dx - ref) / torch.linalg.vector_norm(ref)) < rtol
    jdx = np.asarray(jdx)
    assert np.linalg.norm(dx.numpy() - jdx) / np.linalg.norm(jdx) < rtol
    np.testing.assert_allclose(g.numpy(), gd.numpy(), rtol=1e-10,
                               atol=1e-12 * gd.abs().max().item())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12 * gd.abs().max().item())
    np.testing.assert_allclose(float(cost), float(cd), rtol=1e-12)
    assert one_solve["gs"].retry_stages == 0


def test_retry_ladder_recovers_singular_block():
    """A fixed variable zeroes its Jacobian columns; with damping=None its
    diagonal block is singular, the first factorization fails, and the
    ladder's first stage gives a finite step, close to the reference's."""
    cp, jcp, values = _compiled_pair(tuple(
        g.to_problem(fix_first=True) for g in _grid_pair((4, 3, 3), seed=2)))
    gs = sg.GeneralSparseCholesky(cp, base_cap=8)
    jgs = jax_sg.GeneralSparseCholesky(jcp, base_cap=8)
    before = _work()
    dx, _, _ = gs.solve(values, None)
    work = _work_since(before)
    jdx = np.asarray(jax.jit(lambda v: jgs.solve(v, None)[0])(jcp.initial_values()))
    assert bool(torch.isfinite(dx).all()) and gs.sym.n_levels >= 1
    assert gs.retry_stages >= 1
    # one solve; a ladder attempt and a core factorization per stage run
    assert work["general_solves"] == 1 and work["general_retries"] == gs.retry_stages
    assert work["general_core_factors"] == 1 + gs.retry_stages
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=1e-8, atol=1e-8 * np.abs(jdx).max())


@pytest.fixture(scope="module")
def grid_lm():
    """The 6x6x4 grid (seed 1) through LM sparse_general in both packages,
    without elimination levels (144 blocks, all in the dense core) and with
    ``base_cap=8``; and through the port's dense_cholesky."""
    gt, gj = _grid_pair((6, 6, 4), seed=1)
    out = {}
    for variant, cap in (("no_levels", None), ("levels", 8)):
        with pytest.MonkeyPatch.context() as mp:
            if cap is not None:
                mp.setattr(sg, "GeneralSparseCholesky",
                           _with_base_cap(sg.GeneralSparseCholesky, cap))
                mp.setattr(jax_sg, "GeneralSparseCholesky",
                           _with_base_cap(jax_sg.GeneralSparseCholesky, cap))
            lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
                linear_solver_type="sparse_general", **LM_SETTINGS))
            cp = gt.to_problem().compile(dtype=torch.float64, device="cpu")
            levels = lm._make_solve_fn(cp).general_sparse.sym.n_levels
            rt = lm.optimize(cp)
            rj = jax_apx.LevenbergMarquardt(jax_apx.LevenbergMarquardtConfig(
                linear_solver_type="sparse_general", **LM_SETTINGS)).optimize(
                gj.to_problem().compile(dtype=np.float64))
        out[variant] = (rt, rj, levels)
    out["dense"] = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="dense_cholesky", **LM_SETTINGS)).optimize(
        gt.to_problem().compile(dtype=torch.float64, device="cpu"))
    return out


@pytest.mark.parametrize("variant", ["levels", "no_levels"])
def test_lm_matches_apex_tpu_and_dense(grid_lm, variant):
    rt, rj, levels = grid_lm[variant]
    assert (levels > 0) == (variant == "levels")
    assert rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status)) and rt.converged
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    np.testing.assert_allclose(rt.final_cost, grid_lm["dense"].final_cost, rtol=1e-8)


def test_medium_fixture_reaches_certified_cost():
    """tests/test_medium_fixture.py's case through the general tier: 250
    blocks, so one dense core."""
    fname, cost = MEDIUM_SE3
    r = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_general", **CERTIFIED)).optimize(
        apx.load_g2o(FIXTURES / fname).to_problem().compile(dtype=torch.float64, device="cpu"))
    assert r.converged
    np.testing.assert_allclose(r.final_cost, cost, rtol=1e-8)


def test_f32_tracks_f64():
    """tests/test_precision.py's bar on a smaller grid, with elimination
    levels: f32 within one iteration and 1% of f64."""
    problem = synthetic.synthetic_pose_graph_grid3d(5, 4, 3, seed=0).to_problem()

    def run(dtype):
        lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_general", max_iterations=100, cost_tolerance=1e-4,
            damping="auto"))
        return lm.optimize(problem.compile(dtype=dtype, device="cpu"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sg, "GeneralSparseCholesky", _with_base_cap(sg.GeneralSparseCholesky, 8))
        r64, r32 = run(torch.float64), run(torch.float32)
    assert r64.converged and r32.converged
    assert abs(r32.iterations - r64.iterations) <= 1
    np.testing.assert_allclose(r32.final_cost, r64.final_cost, rtol=1e-2)


def _wide_chain(pkg, n=300, seed=0):
    """The chain of test_torch_pose_graph_e2e's wide-band test, noisy: a
    closure from the first pose to the last gives a block bandwidth of
    6 * n columns under the name ordering."""
    rng = np.random.default_rng(seed)
    p = pkg.Problem()
    for i in range(n):
        q = rng.normal(size=4) * 0.02 + np.array([0, 0, 0, 1.0])
        p.add_variable(f"x{i}", "SE3", np.concatenate([rng.normal(size=3) * 0.1 + [i, 0, 0],
                                                       q / np.linalg.norm(q)]))
    step = np.array([1.0, 0, 0, 0, 0, 0, 1.0])
    for i in range(n - 1):
        p.add_residual_block([f"x{i}", f"x{i + 1}"], pkg.BetweenFactor("SE3", step))
    p.add_residual_block(["x0", f"x{n - 1}"], pkg.BetweenFactor(
        "SE3", np.array([n - 1.0, 0, 0, 0, 0, 0, 1.0])))
    return p


@pytest.mark.parametrize("route", ["general", "wide_panel"])
def test_sparse_cholesky_switch_matches_apex_tpu(route):
    """sparse_cholesky above a 1536-column bandwidth takes the general tier;
    with a plan that is not healthy (MAX_FILL_RATIO = 0) it falls through to
    the banded tier's default wide panel. Both packages take the same route
    to the same result."""
    from apex_tpu_torch.linalg import banded

    settings = dict(linear_solver_type="sparse_cholesky", max_iterations=4)
    with pytest.MonkeyPatch.context() as mp:
        if route == "wide_panel":
            mp.setattr(sg.GeneralSparseCholesky, "MAX_FILL_RATIO", 0.0)
            mp.setattr(jax_sg.GeneralSparseCholesky, "MAX_FILL_RATIO", 0.0)
        cp = _wide_chain(apx).compile(dtype=torch.float64, device="cpu", ordering="name")
        assert banded.block_bandwidth(cp) > banded.MAX_BANDWIDTH
        lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(**settings))
        solve_fn = lm._make_solve_fn(cp)
        rt = lm.optimize(cp)
        rj = jax_apx.LevenbergMarquardt(jax_apx.LevenbergMarquardtConfig(**settings)).optimize(
            _wide_chain(jax_apx).compile(dtype=np.float64, ordering="name"))
    assert hasattr(solve_fn, "general_sparse") == (route == "general")
    assert rt.iterations == rj.iterations and rt.status == apx.Status(int(rj.status))
    assert rt.final_cost < 0.01 * rt.initial_cost
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)


def test_plan_tensors_on_the_problem_device():
    cp = synthetic.synthetic_pose_graph_grid3d(4, 3, 3).to_problem().compile(
        dtype=torch.float32, device="cpu")
    gs = sg.GeneralSparseCholesky(cp, base_cap=8)
    tensors = [gs._h_dest, gs._g_dest, gs._diag_pin, gs._diag_slots_all, gs._real,
               gs._core_i, gs._core_j, gs._core_slots, gs._base_ids]
    tensors += [t for lv in gs._levels_dev for t in lv.values()]
    assert all(t.device == cp.device for t in tensors)
    assert gs._diag_pin.dtype == torch.float32
    dx, _, _ = gs.solve(cp.initial_values(), 1e-3)
    assert dx.dtype == torch.float32 and dx.shape == (cp.total_dof,)
    assert bool(torch.isfinite(dx).all())


def _lattice_lm(mode, fix_first=False):
    """The 5x4x3 lattice through LM forced to ``sparse_general`` with
    elimination levels (``base_cap=8``) in ``mode``: (result, the
    solver's tier, the counters' change)."""
    cp = _grid_pair((5, 4, 3))[0].to_problem(fix_first=fix_first).compile(
        dtype=torch.float64, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sg, "GeneralSparseCholesky", _with_base_cap(sg.GeneralSparseCholesky, 8))
        lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            mode=mode, linear_solver_type="sparse_general", **LM_SETTINGS))
        before = _work()
        result = lm.optimize(cp)
        work = _work_since(before)
    cache = lm._step_cache if mode == "python" else lm._jit_cache
    gs, = {id(v): v for v in _general_tiers(cache)}.values()
    return result, gs, work


def _general_tiers(cache):
    """The general tiers a solver's cache holds (python mode's step cache
    or jit mode's run cache)."""
    for entry in cache.values():
        step = getattr(entry, "_step", entry)
        yield step.solve_fn.general_sparse


@pytest.mark.parametrize("mode", ["python", "jit"])
def test_counters_count_where_the_work_runs(mode):
    """One tier solve per LM iteration, each with one dense core
    factorization of R*dmax columns and no ladder stage; jit mode on the
    CPU (its step eager) counts what python mode counts."""
    result, gs, work = _lattice_lm(mode)
    assert result.converged and gs.sym.n_levels >= 1 and gs.R > 0
    assert work["general_solves"] == result.iterations
    assert work["general_retries"] == gs.retry_stages == 0
    assert work["general_core_factors"] == result.iterations
    assert work["general_core_cols"] == result.iterations * gs.R * gs.dmax
    if mode == "jit":
        assert work == _lattice_lm("python")[2]


@pytest.mark.parametrize("case", ["grid-base8", "grid-no_levels", "mixed_dof_ba"])
def test_core_width_from_the_counters_is_the_plans(case):
    """``general_core_cols / general_core_factors`` is the plan's dense core
    width R*dmax: lattice blocks of 6 with and without elimination levels,
    and a bundle adjustment's blocks of 9 and 3 padded to 9."""
    if case == "mixed_dof_ba":
        cp = build_ba_problem(synthetic.synthetic_ba(n_cameras=4, n_points=25, seed=3),
                              mode="self_calibration", layout="flat").compile(
            dtype=torch.float64, device="cpu")
        gs = sg.GeneralSparseCholesky(cp, deg_cap=64, base_cap=4)
    else:
        cp = synthetic.synthetic_pose_graph_grid3d(5, 4, 3).to_problem().compile(
            dtype=torch.float64, device="cpu")
        gs = sg.GeneralSparseCholesky(cp, base_cap=8 if case == "grid-base8" else 512)
    values = cp.initial_values()
    assert (gs.sym.n_levels > 0) == (case != "grid-no_levels") and gs.R > 0
    before = _work()
    for damping in (1e-3, 1e-2):
        gs.solve(values, damping)
    work = _work_since(before)
    assert work["general_solves"] == work["general_core_factors"] == 2
    assert work["general_core_cols"] / work["general_core_factors"] == gs.R * gs.dmax


def test_recorded_counts_follow_the_device_counts():
    """A recorded tier solve adds nothing at capture: the solve and its
    first core factorization sit in the step's graph, each ladder attempt
    and its core factorization in the ladder's WHILE trip, and the tally
    adds them per launch and per trip. The warm-up form counts nothing."""
    cp, _, values = _compiled_pair(tuple(
        g.to_problem(fix_first=True) for g in _grid_pair((4, 3, 3), seed=2)))
    gs = sg.GeneralSparseCholesky(cp, base_cap=8)
    B, gv, _ = gs.assemble(values)

    def program(x):
        return graphs.assign((x,), (gs.solve_blocks(B, gv, None),))

    state = (torch.zeros(cp.total_dof, dtype=torch.float64),)
    before = _work()
    with graphs.warmup_mode():
        program(*state)
    tree = graphs.record(program, state, _CpuRecorder())
    assert _work_since(before) == dict.fromkeys(WORK, 0)
    loop, = [item for item in tree if isinstance(item, graphs._Loop)]
    loop.slot = 0
    # three launches, the ladder's trips 1, 1 and 2
    graphs._tally(tree, 3, [[4, 0]])
    cols = gs.R * gs.dmax
    assert _work_since(before) == {"general_solves": 3, "general_retries": 4,
                                   "general_core_factors": 3 + 4,
                                   "general_core_cols": (3 + 4) * cols}
