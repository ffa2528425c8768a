"""``mode="jit"`` of the port (LM and Gauss-Newton, the whole solve on the
device) against the JAX package's ``mode="jit"`` and against the port's
python mode, on the CPU in f64: the medium SE3 and SE2 fixtures through
every jit solver, the small BA problem through both Schur variants and
``schur``, Gauss-Newton, ``damping="auto"``, Jacobi scaling, the timeout,
the result's jit fields, the host reads, f32, and the masked form of the
step that runs before a CUDA graph is captured (no host read at all).

Each JAX reference solve runs once per module (``jax_jit``): its
``while_loop`` compiles for a few seconds."""

from pathlib import Path

import numpy as np
import pytest
import threadpoolctl
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import apex_tpu as jax_apx
import apex_tpu_torch as apx
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
}


def _problem(pkg, name):
    if name == "ba":
        ds = (synthetic if pkg is apx else jax_synthetic).synthetic_ba(
            n_cameras=8, n_points=150, seed=0)
        return (build_ba_problem if pkg is apx else jax_build)(ds)
    fname = {"se3": "medium_se3_250.g2o", "se2": "medium_se2_300.g2o"}[name]
    return (apx.load_g2o if pkg is apx else jax_load_g2o)(FIXTURES / fname).to_problem()


def _compile(pkg, problem, dtype=np.float64):
    if pkg is apx:
        return problem.compile(dtype=torch.float64 if dtype == np.float64 else torch.float32,
                               device="cpu")
    return problem.compile(dtype=dtype)


def _solver(pkg, kind, **kw):
    if kind == "gn":
        return pkg.GaussNewton(pkg.GaussNewtonConfig(**kw))
    return pkg.LevenbergMarquardt(pkg.LevenbergMarquardtConfig(**kw))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS / LAPACK / OpenMP thread for this module's small solves:
    beside other test workers, multithreaded QR and Cholesky calls of this
    size spend their time spinning against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problems():
    return {name: _problem(apx, name) for name in ("se3", "se2", "ba")}


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
                done[case] = _solver(jax_apx, kind, mode="jit", **kw).optimize(
                    _compile(jax_apx, _problem(jax_apx, name)))
        return done[case]

    return get


@pytest.fixture(scope="module")
def port():
    """The port's (python, jit) solves of each case, with the jit solve's
    host reads, once per module."""
    done = {}

    def get(case, problems):
        if case not in done:
            name, kind, kw = CASES[case]
            cp = _compile(apx, problems[name])
            rp = _solver(apx, kind, mode="python", **kw).optimize(cp)
            graphs.reset_counters()
            rj = _solver(apx, kind, mode="jit", **kw).optimize(cp)
            done[case] = rp, rj, graphs.host_reads, graphs.status_reads
        return done[case]

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
    assert rt.converged


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


@pytest.mark.parametrize("case", ["se3_sparse_cholesky", "se2_dense_cholesky", "se2_dense_qr",
                                  "ba_schur_explicit", "ba_schur_implicit", "se3_gauss_newton",
                                  "se3_damping_auto", "se2_jacobi_scaling"])
def test_masked_step_reads_nothing(case, port, problems):
    """The form the card warms up before capture: every branch runs and
    ``torch.where`` selects, with no host read and no tensor from host data
    in the initial state or any step. Its iterations reproduce the jit
    solve: the same status and cost (rtol 1e-12)."""
    name, kind, kw = CASES[case]
    _, rj, _, _ = port(case, problems)
    solver = _solver(apx, kind, mode="jit", **kw)
    cp = _compile(apx, problems[name])
    init, step = solver._make_device_init(cp), solver._make_device_step(cp)
    with graphs.warmup_mode(), _NoHostRead():
        state = init()
        for _ in range(rj.iterations):
            state = step(*state)
    st = dict(zip(apx.optim.lm.JIT_STATE, state[len(cp.pools):]))
    assert int(st["iteration"]) == rj.iterations
    assert apx.Status(int(st["status"])) == rj.status
    np.testing.assert_allclose(float(st["cost"]), rj.final_cost, rtol=1e-12)


@pytest.mark.parametrize("kind,solver,match", [
    ("dl", "sparse_cholesky", "ROADMAP A.8b"),
    ("lm", "sparse_qr", "ROADMAP A.8b"),
    ("lm", "pcg", "ROADMAP A.8b"),
    ("lm", "sparse_general", "ROADMAP A.8b"),
    ("gn", "sparse_qr", "ROADMAP A.8b"),
])
def test_not_ported_jit_paths_raise(problems, kind, solver, match):
    cp = _compile(apx, problems["se3"])
    make = {"dl": lambda **kw: apx.DogLeg(apx.DogLegConfig(**kw))}.get(
        kind, lambda **kw: _solver(apx, kind, **kw))
    with pytest.raises(NotImplementedError, match=match):
        make(mode="jit", linear_solver_type=solver).optimize(cp)


def test_sparse_cholesky_general_switch_raises_in_jit():
    """Above a 1536-column bandwidth sparse_cholesky takes the general tier
    (tests/test_torch_pose_graph_e2e.py's ring in name order), which jit
    mode does not run yet."""
    p = apx.Problem()
    ident = np.array([0, 0, 0, 1.0, 0, 0, 0])
    for i in range(300):
        p.add_variable(f"x{i}", "SE3", ident)
    for i in range(299):
        p.add_residual_block([f"x{i}", f"x{i + 1}"], apx.BetweenFactor("SE3", ident))
    p.add_residual_block(["x0", "x299"], apx.BetweenFactor("SE3", ident))
    cp = p.compile(device="cpu", ordering="name")
    with pytest.raises(NotImplementedError, match="ROADMAP A.8b"):
        _solver(apx, "lm", mode="jit", linear_solver_type="sparse_cholesky").optimize(cp)


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
