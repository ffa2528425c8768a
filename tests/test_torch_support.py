"""The port's support surface against the JAX package's, f64 on the CPU:
the error hierarchy, the logger, the profiling helpers, the linalg
utilities, ``SolverResult.detailed_summary``, ``CompiledProblem.dump_debug``,
checkpoints (round trip, files read across the two packages, validation),
resuming LM and DogLeg from a checkpoint, and ``APEX_TPU_NO_X64``.

Each JAX solve runs once per module (``jax_runs``)."""

import inspect
import json
import logging
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu.core.checkpoint as jax_ck
import apex_tpu.errors as jax_errors
import apex_tpu.linalg.utils as jax_lu
import apex_tpu.optim.common as jax_common
import apex_tpu.utils.logger as jax_logger
import apex_tpu.utils.profiling as jax_profiling
import apex_tpu_torch as apx
import apex_tpu_torch.core.checkpoint as ck
import apex_tpu_torch.linalg.utils as lu
import apex_tpu_torch.optim.common as common
import apex_tpu_torch.utils.logger as logger_mod
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch import errors
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.utils import init_logger, profiling
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

REPO = Path(__file__).resolve().parent.parent


def _compile(pkg, problem):
    if pkg is apx:
        return problem.compile(dtype=torch.float64, device="cpu")
    return problem.compile(dtype=np.float64)


def _graph(pkg):
    """The SE2 graph every solve here runs on (first pose fixed)."""
    syn = synthetic if pkg is apx else jax_synthetic
    return _compile(pkg, syn.synthetic_pose_graph_2d(30, seed=3).to_problem(fix_first=True))


def _solver(pkg, kind, **kw):
    if kind == "dl":
        return pkg.DogLeg(pkg.DogLegConfig(**kw))
    return pkg.LevenbergMarquardt(pkg.LevenbergMarquardtConfig(**kw))


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def run(fn, *args):
        if (fn, args) not in cache:
            cache[(fn, args)] = fn(jax_apx, *args)
        return cache[(fn, args)]

    return run


# ---------------------------------------------------------------------------
# errors, logger, profiling
# ---------------------------------------------------------------------------


def _classes(module):
    return {n: c for n, c in inspect.getmembers(module, inspect.isclass)
            if issubclass(c, Exception) and c.__module__ == module.__name__}


def test_error_hierarchy_matches_apex_tpu():
    ours, theirs = _classes(errors), _classes(jax_errors)
    assert ours.keys() == theirs.keys()
    assert len(ours) == 10
    for name, cls in ours.items():
        assert [c.__name__ for c in cls.__mro__] == [c.__name__ for c in theirs[name].__mro__]
    assert errors.LinAlgError.__mro__[1] is errors.ApexError


def test_error_log(caplog, monkeypatch):
    # caplog listens on the root logger: an earlier ``init_logger`` in this
    # process (a CLI test on the same worker) turned propagation off
    monkeypatch.setattr(logging.getLogger("apex_tpu_torch"), "propagate", True)
    cause = ValueError("bad block")
    with caplog.at_level(logging.ERROR, logger="apex_tpu_torch"):
        err = errors.LinAlgError("singular").log(cause)
        plain = errors.CoreError("no variable").log()
    assert err.__cause__ is cause and isinstance(plain, errors.ApexError)
    assert [r.name for r in caplog.records] == ["apex_tpu_torch"] * 2
    assert caplog.records[0].getMessage() == "LinAlgError: singular (caused by ValueError('bad block'))"
    assert caplog.records[1].getMessage() == "CoreError: no variable"
    with pytest.raises(errors.ApexError):
        raise errors.CameraModelError("f < 0").log()


def test_logger(monkeypatch, capsys):
    log = logging.getLogger("apex_tpu_torch")
    level = log.level
    try:
        monkeypatch.setenv("APEX_LOG", "debug")
        assert init_logger() is log and log.level == logging.DEBUG
        assert init_logger("warning").level == logging.WARNING
        monkeypatch.delenv("APEX_LOG")
        assert init_logger().level == logging.INFO
        assert len(log.handlers) == 1
        assert not log.propagate
        log.info("loaded %s", "x")
        err = capsys.readouterr().err.strip()
        assert err.endswith("[INFO] [apex_tpu_torch] loaded x") and err.startswith("[20")
    finally:
        log.setLevel(level)
    record = logging.LogRecord("apex_tpu_torch", logging.DEBUG, "f.py", 7, "m %d", (1,), None)
    record.created = 0.0
    ours = logger_mod._BracketFormatter(color=True).format(record)
    theirs = jax_logger._BracketFormatter(color=True).format(record)
    assert ours == theirs and " f.py:7]" in ours


def test_section_timer_and_annotate(tmp_path):
    timer, ref = profiling.SectionTimer(), jax_profiling.SectionTimer()
    for _ in range(3):
        with timer.section("assemble"):
            pass
    with timer.section("solve"):
        pass
    assert dict(timer.counts) == {"assemble": 3, "solve": 1}
    for t in (timer, ref):
        t.totals.clear()
        t.counts.clear()
        t.totals.update(assemble=0.003, solve=0.25)
        t.counts.update(assemble=3, solve=1)
    assert timer.report() == ref.report()
    assert timer.report().splitlines()[1].split()[0] == "solve"

    @profiling.annotate("support.span")
    def work(x):
        return x @ x

    with profiling.trace(str(tmp_path), "t.json") as prof:
        work(torch.ones(8, 8))
    assert isinstance(prof, torch.profiler.profile)
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert any(e.get("name") == "support.span" for e in events)
    assert work.__name__ == "work"


# ---------------------------------------------------------------------------
# linalg utilities, detailed_summary, dump_debug
# ---------------------------------------------------------------------------


def test_linalg_utils_match_apex_tpu():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 6, 40)
    cols = rng.integers(0, 7, 40)
    vals = rng.normal(size=40)  # duplicates accumulate
    dense = lu.sparse_to_dense(torch.as_tensor(rows), torch.as_tensor(cols),
                               torch.as_tensor(vals), (6, 7))
    ref = np.asarray(jax_lu.sparse_to_dense(rows, cols, jnp.asarray(vals), (6, 7)))
    np.testing.assert_allclose(dense.numpy(), ref, rtol=1e-14, atol=1e-15)

    M = rng.normal(size=(9, 5))
    M[np.abs(M) < 0.7] = 0.0
    for threshold in (0.0, 1.0):
        ours = lu.dense_to_sparse(torch.as_tensor(M), threshold)
        theirs = jax_lu.dense_to_sparse(M, threshold)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert ours[0].dtype == np.int32

    blocks = rng.normal(size=(4, 3, 3))
    bases = np.array([0, 3, 9, 12], dtype=np.int32)
    x = rng.normal(size=16)
    y = lu.block_diag_matvec(torch.as_tensor(blocks), torch.as_tensor(bases), torch.as_tensor(x))
    y_ref = np.asarray(jax_lu.block_diag_matvec(jnp.asarray(blocks), jnp.asarray(bases),
                                                jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-13, atol=1e-15)
    assert np.all(y.numpy()[6:9] == 0.0)


def summary_run(pkg):
    return _solver(pkg, "lm").optimize(_graph(pkg))


def test_detailed_summary_matches_apex_tpu(jax_runs):
    """A solve's report equals the JAX package's but for the wall time; a
    result built from the same fields, with a per-iteration table, equals
    it exactly."""
    res, res_j = summary_run(apx), jax_runs(summary_run)

    def without_time(text):
        return [line for line in text.splitlines() if "wall time" not in line]

    ours, theirs = res.detailed_summary("LM"), res_j.detailed_summary("LM")
    assert without_time(ours) == without_time(theirs)
    assert len(ours.splitlines()) == 12 and ours.startswith("==== LM Summary ====")

    def built(mod):
        stats = [mod.IterationStats(iteration=i, cost=1.0 / (i + 1), cost_change=0.5,
                                    gradient_norm=1e-3, step_norm=1e-2, tr_ratio=0.9,
                                    tr_radius=1e-4, iter_time_ms=1.5, total_time_ms=3.0 * i,
                                    accepted=i != 1) for i in range(3)]
        return mod.SolverResult(
            status=mod.Status.COST_TOLERANCE_REACHED, iterations=3, initial_cost=2.0,
            final_cost=0.25, elapsed_seconds=0.0125, variables={}, final_gradient_norm=1e-3,
            final_step_norm=1e-2, cost_evaluations=4, jacobian_evaluations=3,
            successful_steps=2, unsuccessful_steps=1, iteration_stats=stats)

    for name in ("Optimizer", "A long optimizer name beyond forty-eight characters"):
        assert built(common).detailed_summary(name) == built(jax_common).detailed_summary(name)


def test_dump_debug_matches_apex_tpu(tmp_path):
    """The three files at a point away from the optimum (a step of 0.05 N(0,
    1) from a seed), parsed: each equals what the port computes exactly,
    and the JAX package's files at rtol 1e-12. The Jacobian's entries have
    a floor of 1e-11 of its largest: SE2's inverse right Jacobian takes
    (1 - cos t) / t^2 of the residual angle t, a few 1e-3 rad here, which
    loses eps / t^2 (~1e-11) to cancellation in both packages."""
    cp, cp_j = _graph(apx), _graph(jax_apx)
    dx = 0.05 * np.random.default_rng(5).normal(size=cp.total_dof)
    values = cp.apply_step(cp.initial_values(), torch.as_tensor(dx))
    values_j = cp_j.apply_step(cp_j.initial_values(), jnp.asarray(dx))
    cp.dump_debug(tmp_path / "port", values, with_jacobian=True)
    cp_j.dump_debug(tmp_path / "jax", values_j, with_jacobian=True)
    cp.dump_debug(tmp_path / "plain", values)
    assert sorted(p.name for p in (tmp_path / "plain").iterdir()) == ["residuals.txt",
                                                                      "variables.txt"]
    r, J = cp.assemble_dense_jacobian(values)
    for name, exact in (("residuals.txt", r), ("jacobian.txt", J)):
        a, b = np.loadtxt(tmp_path / "port" / name), np.loadtxt(tmp_path / "jax" / name)
        np.testing.assert_array_equal(a, exact.numpy())
        assert a.shape == b.shape
        floor = 1e-11 * np.abs(b).max() if name == "jacobian.txt" else 1e-14
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=floor, err_msg=name)

    def variables(path):
        lines = (path / "variables.txt").read_text().splitlines()
        return [line.split()[0] for line in lines], np.array(
            [[float(x) for x in line.split()[1:]] for line in lines])

    names, v = variables(tmp_path / "port")
    names_j, v_j = variables(tmp_path / "jax")
    assert names == names_j and len(names) == 30
    np.testing.assert_allclose(v, v_j, rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _checkpoint(mod, cp, seed=0):
    """A checkpoint of the package module ``mod`` for the port's problem
    ``cp``: its initial values perturbed from a seed."""
    rng = np.random.default_rng(seed)
    values = tuple(p.values0.numpy() + 0.01 * rng.normal(size=tuple(p.values0.shape))
                   for p in cp.pools)
    return mod.OptimizerCheckpoint(values=values, damping=3.5e-4, nu=4.0, cost=1.25,
                                   iteration=7)


def test_checkpoint_roundtrip_and_validation(tmp_path):
    cp = _graph(apx)
    c = _checkpoint(ck, cp)
    c.save(tmp_path / "a.npz")
    back = ck.OptimizerCheckpoint.load(tmp_path / "a.npz")
    assert (back.damping, back.nu, back.cost, back.iteration) == (3.5e-4, 4.0, 1.25, 7)
    for a, b in zip(back.values, c.values):
        np.testing.assert_array_equal(a, b)
    back.validate_against(cp)
    with pytest.raises(ValueError, match="pool 0: checkpoint shape"):
        ck.OptimizerCheckpoint(values=(c.values[0][:-1],), damping=1.0, nu=2.0, cost=0.0,
                               iteration=0).validate_against(cp)
    with pytest.raises(ValueError, match="checkpoint has 2 pools, problem has 1"):
        ck.OptimizerCheckpoint(values=c.values * 2, damping=1.0, nu=2.0, cost=0.0,
                               iteration=0).validate_against(cp)
    with pytest.raises(ValueError, match="checkpoint shape"):
        _solver(apx, "lm").optimize(cp, checkpoint=ck.OptimizerCheckpoint(
            values=(c.values[0][:, :2],), damping=1.0, nu=2.0, cost=0.0, iteration=0))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_files_cross_packages(tmp_path, writer):
    """A file written by one package loads in the other with equal arrays
    and scalars."""
    cp = _graph(apx)
    src, dst = (ck, jax_ck) if writer == "port" else (jax_ck, ck)
    c = _checkpoint(src, cp)
    c.save(tmp_path / "c.npz")
    back = dst.OptimizerCheckpoint.load(tmp_path / "c.npz")
    assert type(back).__module__ == dst.__name__
    assert (back.damping, back.nu, back.cost, back.iteration) == (c.damping, c.nu, c.cost,
                                                                 c.iteration)
    assert len(back.values) == len(c.values)
    for a, b in zip(back.values, c.values):
        np.testing.assert_array_equal(a, b)
    back.validate_against(_graph(jax_apx) if dst is jax_ck else cp)


def checkpointed_run(pkg, kind, path):
    """A solve with a ``CheckpointObserver(every=2)``: the result and the
    checkpoint it left (written by this package)."""
    mod = ck if pkg is apx else jax_ck
    cp = _graph(pkg)
    solver = _solver(pkg, kind, max_iterations=3)
    solver.add_observer(mod.CheckpointObserver(cp, path, every=2))
    return solver.optimize(cp), mod.OptimizerCheckpoint.load(path)


def resumed_run(pkg, kind, path, damping=None):
    """Resume from the checkpoint at ``path`` (optionally with its damping
    replaced): the result."""
    mod = ck if pkg is apx else jax_ck
    c = mod.OptimizerCheckpoint.load(path)
    if damping is not None:
        c.damping = damping
    return _solver(pkg, kind, collect_stats=True).optimize(_graph(pkg), checkpoint=c)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{kind: the path of the checkpoint the port's solve wrote}."""
    out = {}
    for kind in ("lm", "dl"):
        path = tmp_path_factory.mktemp(kind) / "ck.npz"
        res, c = checkpointed_run(apx, kind, str(path))
        assert res.iterations == 3 and c.iteration == 2 and c.nu == 2.0
        out[kind] = str(path)
    return out


def test_checkpoint_observer_matches_apex_tpu(jax_runs, checkpoints, tmp_path):
    """The observer's file: iteration 2 of 3, nu = 2.0 whatever the
    solver's, the damping and cost of that iteration, as the JAX package
    writes it."""
    c = ck.OptimizerCheckpoint.load(checkpoints["lm"])
    _, c_j = jax_runs(checkpointed_run, "lm", str(tmp_path / "jax.npz"))
    assert (c.iteration, c.nu) == (c_j.iteration, c_j.nu) == (2, 2.0)
    assert c.damping == c_j.damping
    np.testing.assert_allclose(c.cost, c_j.cost, rtol=1e-10)
    for a, b in zip(c.values, c_j.values):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_lm_resume_matches_apex_tpu(jax_runs, checkpoints):
    """Resuming LM from the same file in both packages: the initial cost is
    the checkpoint's cost (recomputed), the counter restarts at 0, the
    damping is restored; the same iterations and status, final cost at
    rtol 1e-10."""
    path = checkpoints["lm"]
    c = ck.OptimizerCheckpoint.load(path)
    res, res_j = resumed_run(apx, "lm", path), jax_runs(resumed_run, "lm", path)
    np.testing.assert_allclose(res.initial_cost, c.cost, rtol=1e-12)
    assert res.iteration_stats[0].iteration == 0
    assert (res.iterations, res.status.name) == (res_j.iterations, res_j.status.name)
    np.testing.assert_allclose(res.final_cost, res_j.final_cost, rtol=1e-10)
    assert res.converged
    # the restored damping is the one the first step used (Nielsen update of
    # an accepted step from it, as the statistics record)
    first = res.iteration_stats[0]
    t = np.float64
    coff = 2.0 * t(first.tr_ratio) - 1.0
    expected = t(c.damping) * max(t(1.0 / 3.0), 1.0 - coff * coff * coff)
    assert first.accepted and first.tr_radius == pytest.approx(expected, rel=1e-12)
    resumed_other = resumed_run(apx, "lm", path, damping=10.0)
    assert resumed_other.iteration_stats[0].tr_radius != first.tr_radius


def test_dogleg_resume_ignores_damping(jax_runs, checkpoints):
    """DogLeg's state is a trust region, not a damping: both packages
    resume it from the stored values only, so a different stored damping
    gives the same solve."""
    path = checkpoints["dl"]
    res = resumed_run(apx, "dl", path)
    other = resumed_run(apx, "dl", path, damping=1e6)
    res_j = jax_runs(resumed_run, "dl", path)
    other_j = jax_runs(resumed_run, "dl", path, 1e6)
    for a, b in ((res, other), (res_j, other_j)):
        assert (a.iterations, a.final_cost) == (b.iterations, b.final_cost)
        assert [s.tr_radius for s in a.iteration_stats] == [s.tr_radius for s in b.iteration_stats]
    assert (res.iterations, res.status.name) == (res_j.iterations, res_j.status.name)
    np.testing.assert_allclose(res.final_cost, res_j.final_cost, rtol=1e-10)


def test_resume_runs_python_mode_and_casts(checkpoints):
    """Under ``mode="jit"`` a resume runs python mode; f32 problems get the
    values in f32."""
    c = ck.OptimizerCheckpoint.load(checkpoints["lm"])
    jit = _solver(apx, "lm", mode="jit")
    res = jit.optimize(_graph(apx), checkpoint=c)
    assert not jit._jit_cache
    ref = _solver(apx, "lm").optimize(_graph(apx), checkpoint=c)
    assert (res.iterations, res.final_cost) == (ref.iterations, ref.final_cost)
    cp32 = synthetic.synthetic_pose_graph_2d(30, seed=3).to_problem(fix_first=True).compile(
        dtype=torch.float32, device="cpu")
    res32 = _solver(apx, "lm").optimize(cp32, checkpoint=c)
    assert res32.variables["x1"].dtype == np.float32
    np.testing.assert_allclose(res32.final_cost, ref.final_cost, rtol=1e-3)


def test_no_x64_compiles_f32():
    """``APEX_TPU_NO_X64=1`` at import: ``config.default_dtype()`` is f32 and
    ``Problem.compile`` without a dtype gives f32, as the JAX package does."""
    code = (
        "import torch, apex_tpu_torch as apx\n"
        "from apex_tpu_torch import config\n"
        "assert config.default_dtype() is torch.float32 is config.accum_dtype()\n"
        "assert config.small_angle_threshold(torch.float32) == 1e-6\n"
        "assert config.SMALL_ANGLE_THRESHOLD == 1e-10\n"
        "cp = apx.io.synthetic.synthetic_pose_graph_2d(10).to_problem().compile(device='cpu')\n"
        "assert cp.dtype is torch.float32 and cp.pools[0].values0.dtype is torch.float32\n"
        "r = apx.LevenbergMarquardt().optimize(cp)\n"
        "assert r.final_cost < r.initial_cost\n"
    )
    env = dict(__import__("os").environ, APEX_TPU_NO_X64="1")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120, env=env)
    from apex_tpu_torch import config

    assert config.default_dtype() is torch.float64
    cp = synthetic.synthetic_pose_graph_2d(10).to_problem().compile(device="cpu")
    assert cp.dtype is torch.float64
