"""``mode="jit"`` of the port (LM, Gauss-Newton and DogLeg, the whole solve
on the device) against the JAX package's ``mode="jit"`` and against the
port's python mode, on the CPU in f64: the medium SE3 and SE2 fixtures
through every solver (``sparse_qr``, ``pcg`` and the general tier too), the
small BA problem through both Schur variants, ``schur`` and DogLeg's Schur
fallback, a lattice through the general tier with elimination levels, a
ring through ``sparse_cholesky``'s switch to it, Gauss-Newton, DogLeg,
``damping="auto"``, Jacobi scaling, the timeout, the result's jit fields,
the host reads, f32, and the masked form of the step that runs before a
CUDA graph is captured (no host read at all).

Each JAX reference solve runs once per module (``jax_jit``): its
``while_loop`` compiles for a few seconds."""

from pathlib import Path

import numpy as np
import pytest
import threadpoolctl
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import apex_tpu as jax_apx
import apex_tpu.linalg.sparse_general as jax_sg
import apex_tpu_torch as apx
import apex_tpu_torch.linalg.sparse_general as sg
from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.io import load_g2o as jax_load_g2o
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.optim import graphs

FIXTURES = Path(__file__).resolve().parent / "fixtures"
EXACT = dict(pcg_forcing=False, pcg_tolerance=1e-10, pcg_max_iterations=500)

# name: (problem, optimizer, config); each runs in both packages' jit mode
CASES = {
    "se3_sparse_cholesky": ("se3", "lm", dict(linear_solver_type="sparse_cholesky")),
    "se2_dense_cholesky": ("se2", "lm", dict(linear_solver_type="dense_cholesky")),
    "se2_dense_qr": ("se2", "lm", dict(linear_solver_type="dense_qr")),
    "se2_sparse_cholesky": ("se2", "lm", dict(linear_solver_type="sparse_cholesky")),
    "ba_schur_explicit": ("ba", "lm", dict(linear_solver_type="schur_explicit",
                                           max_iterations=30)),
    "ba_schur_implicit": ("ba", "lm", dict(linear_solver_type="schur_implicit",
                                           max_iterations=30, **EXACT)),
    "ba_schur": ("ba", "lm", dict(linear_solver_type="schur", max_iterations=30)),
    "se3_gauss_newton": ("se3", "gn", dict(linear_solver_type="sparse_cholesky")),
    "se3_damping_auto": ("se3", "lm", dict(linear_solver_type="sparse_cholesky",
                                           damping="auto", cost_tolerance=1e-4)),
    "se2_jacobi_scaling": ("se2", "lm", dict(linear_solver_type="dense_cholesky",
                                             use_jacobi_scaling=True)),
    "se2_min_cost_threshold": ("se2", "lm", dict(linear_solver_type="sparse_cholesky",
                                                 min_cost_threshold=0.1)),
    "se3_sparse_qr": ("se3", "lm", dict(linear_solver_type="sparse_qr")),
    "se2_sparse_qr": ("se2", "lm", dict(linear_solver_type="sparse_qr")),
    "se2_pcg": ("se2", "lm", dict(linear_solver_type="pcg")),
    "se3_gauss_newton_sparse_qr": ("se3", "gn", dict(linear_solver_type="sparse_qr")),
    "se3_dogleg": ("se3", "dl", dict(linear_solver_type="sparse_cholesky")),
    "se2_dogleg": ("se2", "dl", dict(linear_solver_type="dense_cholesky")),
    # the Schur name falls back to a Cholesky tier; the packages agree for
    # 8 iterations here (ROADMAP queue C)
    "ba_dogleg": ("ba", "dl", dict(linear_solver_type="schur_explicit", max_iterations=8)),
    # elimination levels: GeneralSparseCholesky with base_cap=8 (LEVELS)
    "grid_sparse_general": ("grid", "lm", dict(linear_solver_type="sparse_general")),
    # a 300-pose ring in name order: a bandwidth above 1536 columns, so
    # sparse_cholesky switches to the general tier
    "ring_sparse_cholesky_switch": ("ring", "lm", dict(linear_solver_type="sparse_cholesky")),
}
# the cases that run the general tier with a dense core of at most 8 blocks
# (the ring's whole graph would otherwise be one 1,800-column dense core)
LEVELS = {"grid_sparse_general", "ring_sparse_cholesky_switch"}
# the ring keeps its name order (x0, x1, x10, x100, ...): a wide band
ORDERING = {"ring": "name"}


def _ring(pkg, n=300, seed=0):
    """An SE3 ring of ``n`` poses: noisy near-identity measurements (so the
    optimum is not zero) and initial poses perturbed from a seed."""
    rng = np.random.default_rng(seed)

    def pose(t_scale, q_scale):
        q = np.append(rng.normal(scale=q_scale, size=3), 1.0)
        return np.concatenate([rng.normal(scale=t_scale, size=3), q / np.linalg.norm(q)])

    p = pkg.Problem()
    for i in range(n):
        p.add_variable(f"x{i}", "SE3", pose(0.02, 0.005))
    for i in range(n):
        p.add_residual_block([f"x{i}", f"x{(i + 1) % n}"],
                             pkg.BetweenFactor("SE3", pose(0.01, 0.005)))
    return p


def _with_base_cap(cls, base_cap):
    class Capped(cls):
        def __init__(self, cp, deg_cap=24, min_picked=32, **_):
            super().__init__(cp, deg_cap=deg_cap, base_cap=base_cap, min_picked=min_picked)

    return Capped


def _levels(mp, case):
    """For a case of ``LEVELS``, both packages' general tier with a dense
    core of at most 8 blocks, so that a small graph runs elimination
    levels (both LM modules import the class when they build the solve)."""
    if case in LEVELS:
        for mod in (sg, jax_sg):
            mp.setattr(mod, "GeneralSparseCholesky",
                       _with_base_cap(mod.GeneralSparseCholesky, 8))


def _problem(pkg, name):
    if name == "ring":
        return _ring(pkg)
    if name == "grid":
        return (synthetic if pkg is apx else jax_synthetic).synthetic_pose_graph_grid3d(
            4, 3, 3, seed=0).to_problem()
    if name == "ba":
        ds = (synthetic if pkg is apx else jax_synthetic).synthetic_ba(
            n_cameras=8, n_points=150, seed=0)
        return (build_ba_problem if pkg is apx else jax_build)(ds)
    fname = {"se3": "medium_se3_250.g2o", "se2": "medium_se2_300.g2o"}[name]
    return (apx.load_g2o if pkg is apx else jax_load_g2o)(FIXTURES / fname).to_problem()


def _compile(pkg, problem, dtype=np.float64, ordering="auto"):
    if pkg is apx:
        return problem.compile(dtype=torch.float64 if dtype == np.float64 else torch.float32,
                               device="cpu", ordering=ordering)
    return problem.compile(dtype=dtype, ordering=ordering)


def _solver(pkg, kind, **kw):
    if kind == "dl":
        return pkg.DogLeg(pkg.DogLegConfig(**kw))
    if kind == "gn":
        return pkg.GaussNewton(pkg.GaussNewtonConfig(**kw))
    return pkg.LevenbergMarquardt(pkg.LevenbergMarquardtConfig(**kw))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS / LAPACK / OpenMP thread for this module's small solves:
    beside other test workers, multithreaded QR and Cholesky calls of this
    size spend their time spinning against each other. scipy's LAPACK,
    which the JAX package's CPU linear algebra calls, is loaded first, so
    that the limit covers it too."""
    import scipy.linalg  # noqa: F401

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problems():
    return {name: _problem(apx, name) for name in ("se3", "se2", "ba", "grid", "ring")}


@pytest.fixture(scope="module")
def jax_jit():
    """The JAX package's jit solve of each case, once per module (BA on its
    block path, APEX_TPU_UNIFORM=0, as tests/test_torch_ba_e2e.py)."""
    done = {}

    def get(case):
        if case not in done:
            name, kind, kw = CASES[case]
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("APEX_TPU_UNIFORM", "0")
                _levels(mp, case)
                done[case] = _solver(jax_apx, kind, mode="jit", **kw).optimize(
                    _compile(jax_apx, _problem(jax_apx, name),
                             ordering=ORDERING.get(name, "auto")))
        return done[case]

    return get


@pytest.fixture(scope="module")
def port():
    """The port's (python, jit) solves of each case, with the jit solve's
    host reads, once per module; ``get.solvers[case]`` holds the (python,
    jit) solver objects."""
    done = {}

    def get(case, problems):
        if case not in done:
            name, kind, kw = CASES[case]
            with pytest.MonkeyPatch.context() as mp:
                _levels(mp, case)
                cp = _compile(apx, problems[name], ordering=ORDERING.get(name, "auto"))
                python, jit = (_solver(apx, kind, mode=mode, **kw) for mode in ("python", "jit"))
                rp = python.optimize(cp)
                graphs.reset_counters()
                rj = jit.optimize(cp)
            done[case] = rp, rj, graphs.host_reads, graphs.status_reads
            get.solvers[case] = python, jit
        return done[case]

    get.solvers = {}
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_jit_matches_jax_jit(case, jax_jit, port, problems):
    """The same iterations, status and step counts as the JAX package's
    jit solve; initial cost to rtol 1e-12, final cost to 1e-8."""
    rj = jax_jit(case)
    _, rt, _, _ = port(case, problems)
    assert rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status))
    assert (rt.successful_steps, rt.unsuccessful_steps) == (
        rj.successful_steps, rj.unsuccessful_steps)
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    # DogLeg on the BA problem is held to the reference for its first 8
    # iterations only
    assert rt.converged or (case, rt.status) == ("ba_dogleg", apx.Status.MAX_ITERATIONS_REACHED)


def test_min_cost_threshold_stops_jit(jax_jit, port, problems):
    _, rt, _, _ = port("se2_min_cost_threshold", problems)
    assert rt.status == apx.Status.MIN_COST_THRESHOLD_REACHED and rt.final_cost < 0.1


def test_jit_covariances_match_python_mode(problems):
    """``compute_covariances`` runs after the device loop, on its values:
    python mode's blocks (rtol 1e-8)."""
    kw = dict(linear_solver_type="sparse_cholesky", compute_covariances=True)
    cp = problems["se2"].compile(dtype=torch.float64, device="cpu")
    rp = _solver(apx, "lm", mode="python", **kw).optimize(cp)
    rj = _solver(apx, "lm", mode="jit", **kw).optimize(cp)
    assert set(rj.covariances) == set(rp.covariances)
    for name, block in rp.covariances.items():
        np.testing.assert_allclose(rj.covariances[name], block, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_jit_matches_python_mode(case, port, problems):
    """jit and python mode of the port run the same arithmetic: the same
    iterations and status, final cost to rtol 1e-12, the same variables."""
    rp, rj, _, _ = port(case, problems)
    assert (rj.iterations, rj.status) == (rp.iterations, rp.status)
    np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=1e-12)
    for name, v in rp.variables.items():
        np.testing.assert_allclose(rj.variables[name], v, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("solver", ["dense_cholesky", "sparse_cholesky"])
def test_f32_dogleg_jit_matches_python_mode(solver, problems):
    """DogLeg in f32 on the SE2 fixture: both modes run the one step, delta
    and mu in the problem's dtype as in the JAX package, so python mode
    takes jit mode's iterations to its status and its cost, to f32's
    rounding."""
    cp = _compile(apx, problems["se2"], np.float32)
    rp, rj = (_solver(apx, "dl", mode=mode, linear_solver_type=solver).optimize(cp)
              for mode in ("python", "jit"))
    assert (rj.iterations, rj.status) == (rp.iterations, rp.status)
    np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=np.finfo(np.float32).eps)


@pytest.mark.parametrize("options", [{}, {"pcg_q_tolerance": 0.1}],
                         ids=["forcing_warm_start", "q_tolerance"])
def test_inexact_implicit_jit_matches_python_mode(problems, options):
    """The forcing sequence (its tolerance from the device iteration), the
    guarded warm start and Nash-Sofer, as the chunked device PCG runs them:
    python mode's iterations, status and cost (rtol 1e-12)."""
    kw = dict(linear_solver_type="schur_implicit", max_iterations=30, **options)
    cp = _compile(apx, problems["ba"])
    rp = _solver(apx, "lm", mode="python", **kw).optimize(cp)
    rj = _solver(apx, "lm", mode="jit", **kw).optimize(cp)
    assert (rj.iterations, rj.status) == (rp.iterations, rp.status)
    np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=1e-12)


@pytest.mark.parametrize("case", ["se3_sparse_cholesky", "ba_schur_implicit"])
def test_jit_result_fields(case, jax_jit, port, problems):
    """``SolverResult`` as ``_finish_jit`` builds it in both packages."""
    rj = jax_jit(case)
    _, rt, _, _ = port(case, problems)
    assert rt.cost_evaluations == rt.iterations + 1 == rj.cost_evaluations
    assert rt.jacobian_evaluations == rt.iterations == rj.jacobian_evaluations
    assert rt.iteration_stats is None and rj.iteration_stats is None
    assert rt.successful_steps + rt.unsuccessful_steps == rt.iterations
    np.testing.assert_allclose(rt.final_gradient_norm, rj.final_gradient_norm, rtol=1e-5)
    assert np.isfinite(rt.final_step_norm) and rt.elapsed_seconds > 0


@pytest.mark.parametrize("case,branch_reads_per_iteration", [
    ("se2_dense_qr", 0),  # no branch on the QR path
    ("se2_dense_cholesky", 1),  # the ladder's first test
    ("se3_sparse_cholesky", 2),  # refinement gate, then the ladder's test
])
def test_host_reads(case, branch_reads_per_iteration, port, problems):
    """The jit loop reads the status once per chunk (one iteration without
    a timeout), each good first attempt's gates once, and the result once;
    nothing else."""
    _, rj, reads, status_reads = port(case, problems)
    assert status_reads == rj.iterations + 1
    assert reads == status_reads + branch_reads_per_iteration * rj.iterations + 1


def test_pcg_reads_per_chunk(port, problems):
    """The implicit Schur solve reads PCG's flag once per PCG_CHUNK
    iterations: far fewer reads than PCG iterations."""
    _, rj, reads, status_reads = port("ba_schur_implicit", problems)
    assert reads - status_reads - 1 <= rj.iterations * (-(-200 // graphs.PCG_CHUNK))
    assert reads > status_reads + 1


def test_jit_timeout_matches_jax():
    """tests/test_optimizers.py::test_jit_mode_timeout's shape at 16
    iterations: both packages stop with TIMEOUT after their first chunk of
    ceil(16 / 8) = 2 iterations."""
    kw = dict(mode="jit", max_iterations=16, cost_tolerance=0.0, parameter_tolerance=0.0,
              gradient_tolerance=0.0, timeout=0.0)
    gargs = dict(n_poses=60, rings=4, seed=0)
    rj = jax_apx.LevenbergMarquardt(jax_apx.LevenbergMarquardtConfig(**kw)).optimize(
        jax_synthetic.synthetic_pose_graph_3d(**gargs).to_problem().compile(dtype=np.float64))
    graphs.reset_counters()
    rt = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(**kw)).optimize(
        synthetic.synthetic_pose_graph_3d(**gargs).to_problem().compile(
            dtype=torch.float64, device="cpu"))
    assert rj.status == jax_apx.optim.common.Status.TIMEOUT
    assert rt.status == apx.Status.TIMEOUT
    assert rt.iterations == rj.iterations == 2
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    assert graphs.status_reads == rt.iterations + 1


def test_f32_jit_near_f64(problems):
    """f32 jit on the SE3 fixture through sparse_cholesky at bench.py's
    settings: within one LM iteration and 1% of the f64 jit solve. (At the
    default tolerances f32 reaches its noise floor first, where its
    iterations depend on the summation order.)"""
    kw = dict(linear_solver_type="sparse_cholesky", mode="jit", damping="auto",
              cost_tolerance=1e-4)
    r64 = _solver(apx, "lm", **kw).optimize(_compile(apx, problems["se3"]))
    r32 = _solver(apx, "lm", **kw).optimize(_compile(apx, problems["se3"], np.float32))
    assert r32.converged and abs(r32.iterations - r64.iterations) <= 1
    np.testing.assert_allclose(r32.final_cost, r64.final_cost, rtol=1e-2)


def test_second_solve_reuses_the_programs(problems):
    """A second jit solve of the same problem starts again from the initial
    values through the cached step: the same result."""
    lm = _solver(apx, "lm", mode="jit", linear_solver_type="sparse_cholesky")
    cp = _compile(apx, problems["se3"])
    r1, r2 = lm.optimize(cp), lm.optimize(cp)
    assert len(lm._jit_cache) == 1
    assert (r1.iterations, r1.status) == (r2.iterations, r2.status)
    assert r1.final_cost == r2.final_cost and r1.initial_cost == r2.initial_cost


class _NoHostRead(TorchDispatchMode):
    """Fails on any op that reads a tensor's value back to the host or
    builds a tensor from host data: what a CUDA graph cannot capture."""

    BANNED = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
              torch.ops.aten.lift_fresh.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED:
            raise AssertionError(f"host read or host data in the step: {func}")
        return func(*args, **(kwargs or {}))


MASKED = ["se3_sparse_cholesky", "se2_dense_cholesky", "se2_dense_qr", "ba_schur_explicit",
          "ba_schur_implicit", "se3_gauss_newton", "se3_damping_auto", "se2_jacobi_scaling",
          "se3_sparse_qr", "se2_sparse_qr", "se2_pcg", "se3_gauss_newton_sparse_qr",
          "se3_dogleg", "se2_dogleg", "ba_dogleg", "grid_sparse_general",
          "ring_sparse_cholesky_switch"]


def _masked_solve(solver, cp, iterations):
    """``iterations`` steps from the initial state in the warm-up form,
    under ``_NoHostRead``: the named jit state after them."""
    init, step = solver._make_device_init(cp), solver._make_device_step(cp)
    with graphs.warmup_mode(), _NoHostRead():
        state = init()
        for _ in range(iterations):
            state = step(*state)
    return dict(zip(solver.JIT_STATE, state[len(cp.pools):]))


@pytest.mark.parametrize("case", MASKED)
def test_masked_step_reads_nothing(case, port, problems):
    """The form the card warms up before capture: every branch runs and
    ``torch.where`` selects, with no host read and no tensor from host data
    in the initial state or any step (DogLeg's fresh/reuse branch, the
    general tier's elimination and ladder, the QR sweep's ladder and the
    PCG chunks among them). Its iterations reproduce the jit solve: the
    same status and cost (rtol 1e-12)."""
    name, kind, kw = CASES[case]
    _, rj, _, _ = port(case, problems)
    with pytest.MonkeyPatch.context() as mp:
        _levels(mp, case)
        st = _masked_solve(_solver(apx, kind, mode="jit", **kw),
                           _compile(apx, problems[name], ordering=ORDERING.get(name, "auto")),
                           rj.iterations)
    assert int(st["iteration"]) == rj.iterations
    assert apx.Status(int(st["status"])) == rj.status
    np.testing.assert_allclose(float(st["cost"]), rj.final_cost, rtol=1e-12)


def test_sparse_cholesky_switches_to_the_general_tier_in_jit(port, problems):
    """Above a 1536-column bandwidth jit mode's sparse_cholesky takes the
    general tier, as python mode does (the ring in name order; its solves
    are held to the JAX package's by the CASES tests)."""
    port("ring_sparse_cholesky_switch", problems)
    _, jit = port.solvers["ring_sparse_cholesky_switch"]
    (run,) = jit._jit_cache.values()
    assert run._step.solve_fn.general_sparse.healthy()


def test_dogleg_reused_steps_match_python_mode(problems):
    """DogLeg's steps taken from its cache, counted on the device in jit
    mode and added to the solver's counter after the loop: on the BA
    problem's Schur fallback, 30 iterations (past the 8 held to the
    reference), whose rejected steps retry from the cache, python mode's
    count, iterations, status and cost (rtol 1e-12); the warm-up form,
    which reads nothing, counts the same."""
    cp = _compile(apx, problems["ba"])
    kw = dict(linear_solver_type="schur_explicit", max_iterations=30)
    python, jit = (_solver(apx, "dl", mode=mode, **kw) for mode in ("python", "jit"))
    rp, rj = python.optimize(cp), jit.optimize(cp)
    assert python.reused_steps > 10 and jit.reused_steps == python.reused_steps
    assert (rj.iterations, rj.status, rj.unsuccessful_steps) == (
        rp.iterations, rp.status, rp.unsuccessful_steps)
    np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=1e-12)
    st = _masked_solve(_solver(apx, "dl", mode="jit", **kw), cp, rp.iterations)
    assert int(st["reused_steps"]) == python.reused_steps
    np.testing.assert_allclose(float(st["cost"]), rp.final_cost, rtol=1e-12)


def test_plain_pcg_reads_per_chunk(port, problems, monkeypatch):
    """jit mode's plain PCG reads its continue flag once per PCG_CHUNK
    iterations: ceil(k / PCG_CHUNK) + 1 reads for a solve of k CG
    iterations (python mode's k, counted per LM iteration; at its cap of
    600 iterations, 150), plus the status before each LM iteration and the
    result."""
    from apex_tpu_torch.linalg.iterative import IterativeNormalSolver

    _, rj, reads, status_reads = port("se2_pcg", problems)
    counts, hx = [], IterativeNormalSolver._hx
    solve = IterativeNormalSolver.solve

    def counted_hx(self, *args):
        counts[-1] += 1
        return hx(self, *args)

    def counted_solve(self, *args):
        counts.append(0)
        return solve(self, *args)

    monkeypatch.setattr(IterativeNormalSolver, "_hx", counted_hx)
    monkeypatch.setattr(IterativeNormalSolver, "solve", counted_solve)
    rp = _solver(apx, "lm", mode="python", **CASES["se2_pcg"][2]).optimize(
        _compile(apx, problems["se2"]))
    assert len(counts) == rp.iterations == rj.iterations and max(counts) > graphs.PCG_CHUNK
    trips = -(-3 * apx.LevenbergMarquardtConfig().pcg_max_iterations // graphs.PCG_CHUNK)
    # a PCG at its iteration cap reads no flag after its last chunk
    chunks = sum(min(-(-k // graphs.PCG_CHUNK) + 1, trips) for k in counts)
    assert reads == status_reads + chunks + 1 and status_reads == rj.iterations + 1


def test_general_ladder_recovers_singular_block_in_jit():
    """Gauss-Newton through the general tier with levels on a lattice whose
    first pose is fixed: undamped, the fixed pose's block is singular, and
    every solve climbs the ladder (tests/test_torch_sparse_general.py's
    singular block). jit mode runs the ladder as a device loop: python
    mode's iterations, status, cost (rtol 1e-12) and retry stages, also in
    the warm-up form, which reads nothing."""
    problem = synthetic.synthetic_pose_graph_grid3d(4, 3, 3, seed=2).to_problem(fix_first=True)
    cp = _compile(apx, problem)
    kw = dict(linear_solver_type="sparse_general")
    with pytest.MonkeyPatch.context() as mp:
        _levels(mp, "grid_sparse_general")
        python, jit = (_solver(apx, "gn", mode=mode, **kw) for mode in ("python", "jit"))
        rp, rj = python.optimize(cp), jit.optimize(cp)
        st = _masked_solve(_solver(apx, "gn", mode="jit", **kw), cp, rp.iterations)
    gs_python = python._step_cache[cp].solve_fn.general_sparse
    gs_jit = jit._jit_cache[cp]._step.solve_fn.general_sparse
    assert gs_python.sym.n_levels >= 1 and gs_python.retry_stages >= rp.iterations
    assert gs_jit.retry_stages == gs_python.retry_stages
    assert (rj.iterations, rj.status) == (rp.iterations, rp.status) and rp.converged
    np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=1e-12)
    np.testing.assert_allclose(float(st["cost"]), rp.final_cost, rtol=1e-12)


def test_unknown_mode_raises(problems):
    with pytest.raises(ValueError, match="unknown mode"):
        _solver(apx, "lm", mode="graph").optimize(_compile(apx, problems["se2"]))


def test_mode_restored_when_a_step_raises():
    """A step that raises in its warm-up form leaves the branches in eager
    mode: the next branch reads its flag again, as python mode needs."""
    with pytest.raises(ZeroDivisionError):
        with graphs.warmup_mode():
            1 / 0
    before = graphs.host_reads
    (x,) = graphs.cond_update(torch.tensor(True), lambda x: (x + 1,), torch.zeros(()))
    assert graphs.host_reads == before + 1 and float(x) == 1.0
