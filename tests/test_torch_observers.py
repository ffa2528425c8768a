"""The port's observers (``apex_tpu_torch.observers``) against the JAX
package's on the same numpy inputs, f64 on the CPU: the visualization
helpers, ``HistoryObserver``'s records for LM, Gauss-Newton and DogLeg,
``RerunObserver``'s records through a headless sink on an SE3 pose graph,
a small bundle adjustment and an SE2 graph with ``expose_matrix_data``
(what ``tests/test_observers.py`` and ``test_misc.py`` cover in the JAX
package), ``mode="jit"`` with an observer, the ``RerunSink`` gate, and the
read-only host arrays that both packages hand out (ROADMAP C.1).

Each JAX solve runs once per module (``jax_runs``)."""

import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu.observers.visualization as jax_vis
import apex_tpu_torch as apx
import apex_tpu_torch.observers.visualization as vis
from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.observers import HistoryObserver
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

OPTIMIZERS = {"lm": ("LevenbergMarquardt", "LevenbergMarquardtConfig"),
              "gn": ("GaussNewton", "GaussNewtonConfig"),
              "dl": ("DogLeg", "DogLegConfig")}


def _solver(pkg, kind, **kw):
    cls, cfg = OPTIMIZERS[kind]
    return getattr(pkg, cls)(getattr(pkg, cfg)(**kw))


def _compile(pkg, problem):
    if pkg is apx:
        return problem.compile(dtype=torch.float64, device="cpu")
    return problem.compile(dtype=np.float64)


def _pixel_sink(mod):
    """The package's ``MemorySink`` that also keeps each image's pixels."""

    class PixelSink(mod.MemorySink):
        def log_image(self, path, rgb):
            super().log_image(path, rgb)
            self.records[-1][2]["pixels"] = np.array(rgb)

    return PixelSink()


# ---------------------------------------------------------------------------
# the solves, each package's in its own function
# ---------------------------------------------------------------------------


def history_run(pkg, kind):
    syn = synthetic if pkg is apx else jax_synthetic
    cp = _compile(pkg, syn.synthetic_pose_graph_2d(25, seed=6).to_problem(fix_first=True))
    solver = _solver(pkg, kind, collect_stats=True)
    h = (HistoryObserver if pkg is apx else jax_apx.observers.HistoryObserver)(
        record_variables=True)
    solver.add_observer(h)
    return solver.optimize(cp), h


def rerun_run(pkg, case):
    """One observed solve with the package's ``RerunObserver`` over a pixel
    sink: (result, observer)."""
    syn = synthetic if pkg is apx else jax_synthetic
    mod = vis if pkg is apx else jax_vis
    if case == "se3":
        cp = _compile(pkg, syn.synthetic_pose_graph_3d(n_poses=12, rings=2, seed=0).to_problem())
        cfg, solver_kw = mod.VisualizationConfig.for_pose_graph(), dict(expose_matrix_data=True)
    elif case == "ba":
        ds = syn.synthetic_ba(n_cameras=4, n_points=30, seed=0)
        cp = _compile(pkg, (build_ba_problem if pkg is apx else jax_build)(ds))
        cfg = mod.VisualizationConfig.for_bundle_adjustment()
        solver_kw = dict(linear_solver_type="schur_explicit")
    else:
        cp = _compile(pkg, syn.synthetic_pose_graph_2d(20, seed=9).to_problem())
        cfg, solver_kw = mod.VisualizationConfig(), dict(expose_matrix_data=True)
    solver = _solver(pkg, "lm", max_iterations=5, **solver_kw)
    obs = mod.RerunObserver(cfg, sink=_pixel_sink(mod))
    solver.add_observer(obs)
    initial = cp.values_dict(cp.initial_values())
    if case == "ba":
        obs.log_initial_ba_state(initial)
    else:
        obs.log_initial_graph(initial)
    res = solver.optimize(cp)
    obs.log_convergence(res.status.name)
    return res, obs


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def run(fn, *args):
        if (fn, args) not in cache:
            cache[(fn, args)] = fn(jax_apx, *args)
        return cache[(fn, args)]

    return run


def assert_records_equal(port, ref, initial_cost):
    """Paths and kinds in the same order exactly; scalars at rtol 1e-8, a
    camera position to 1e-8 of its norm; the step quality at rtol 1e-8 or its rounding
    floor, 1e-12 of the cost over the iteration's cost change (as in
    ``test_history_matches_apex_tpu``); images within 1 per channel; the
    rest equal."""
    assert [(p, k) for p, k, _ in port] == [(p, k) for p, k, _ in ref]
    costs = [d["value"] for p, _, d in ref if p == "metrics/cost"]
    change = np.abs(np.diff([initial_cost] + costs))
    floor = {i: 1e-12 * c / d if d > 0 else np.inf for i, (c, d) in enumerate(zip(costs, change))}
    for (path, kind, a), (_, _, b) in zip(port, ref):
        assert a.keys() == b.keys(), path
        for key in a:
            if key == "pixels":
                assert a[key].shape == b[key].shape, path
                diff = np.abs(a[key].astype(np.int32) - b[key].astype(np.int32))
                assert diff.max() <= 1, (path, diff.max())
            elif path == "metrics/step_quality":
                assert abs(a[key] - b[key]) <= max(1e-8 * abs(b[key]), floor[b["iteration"]]), \
                    (path, b["iteration"], a[key], b[key])
            elif key == "position":
                err = np.linalg.norm(np.subtract(a[key], b[key]))
                assert err <= 1e-8 * np.linalg.norm(b[key]) + 1e-12, (path, a[key], b[key])
            elif key == "value" or isinstance(a[key], float):
                np.testing.assert_allclose(a[key], b[key], rtol=1e-8, atol=1e-12, err_msg=path)
            else:
                assert a[key] == b[key], (path, key)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def test_helpers_match_apex_tpu():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.normal(size=40), [0.0, np.nan, np.inf, -3.5]])
    for max_abs in (0.0, 1.0, 2.5):
        np.testing.assert_array_equal(vis.value_to_rgb_heatmap(vals, max_abs),
                                      jax_vis.value_to_rgb_heatmap(vals, max_abs))
    H = rng.normal(size=(37, 53))
    H[np.abs(H) < 0.8] = 0.0
    for target in ((4, 7), (16, 16), (64, 64)):
        np.testing.assert_array_equal(vis.downsample_matrix(H, *target),
                                      jax_vis.downsample_matrix(H, *target))
    np.testing.assert_array_equal(vis.downsample_matrix(np.zeros((3, 3)), 2, 2),
                                  jax_vis.downsample_matrix(np.zeros((3, 3)), 2, 2))
    np.testing.assert_array_equal(vis.hessian_to_image(H, 16), jax_vis.hessian_to_image(H, 16))
    for n, width in ((200, 64), (3, 64), (513, 512)):
        g = rng.normal(size=n)
        np.testing.assert_array_equal(vis.gradient_to_image(g, width),
                                      jax_vis.gradient_to_image(g, width))
    init = {f"v{i}": rng.normal(size=3) for i in range(6)}
    final = {k: v + rng.normal(size=3) for k, v in list(init.items())[:4]}
    assert vis.displacement_statistics(init, final) == jax_vis.displacement_statistics(init, final)
    assert vis.displacement_statistics({}, {}) == jax_vis.displacement_statistics({}, {})


@pytest.mark.parametrize("invert", [False, True])
def test_se3_camera_pose_matches_apex_tpu(invert):
    rng = np.random.default_rng(1)
    for _ in range(5):
        q = rng.normal(size=4)
        v = np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])
        pos, quat = vis.se3_camera_pose(v, invert)
        pos_j, quat_j = jax_vis.se3_camera_pose(v, invert)
        np.testing.assert_allclose(pos, pos_j, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(quat, quat_j, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# observed solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lm", "gn", "dl"])
def test_history_matches_apex_tpu(jax_runs, kind):
    """The per-iteration records: the iteration and the damping exactly,
    the cost at rtol 1e-10, the other metrics at rtol 1e-10 or their
    rounding floor where that is larger. Near the optimum |g| and |step|
    are sums of terms of the first iteration's size, so they are held to
    1e-12 of the first iteration's value too; the step quality is the cost
    change over the predicted one, so to 1e-12 of the cost over the cost
    change (every step here is accepted). Also the recorded variables and
    the completion call."""
    res, h = history_run(apx, kind)
    res_j, h_j = jax_runs(history_run, kind)
    assert (res.iterations, res.status.name) == (res_j.iterations, res_j.status.name)
    assert res.successful_steps == res.iterations
    assert [r.iteration for r in h.history] == [r.iteration for r in h_j.history]
    assert [r.iteration for r in h.history] == list(range(res.iterations))
    assert [r.damping for r in h.history] == [r.damping for r in h_j.history]

    def field(hist, name):
        return np.array([getattr(r, name) for r in hist.history])

    costs = field(h_j, "cost")
    np.testing.assert_allclose(field(h, "cost"), costs, rtol=1e-10)
    change = np.abs(np.diff(np.concatenate([[res_j.initial_cost], costs])))
    floors = {"gradient_norm": 1e-12 * field(h_j, "gradient_norm")[0],
              "step_norm": 1e-12 * field(h_j, "step_norm")[0],
              "step_quality": 1e-12 * costs / change}
    for name, floor in floors.items():
        a, b = field(h, name), field(h_j, name)
        assert np.all(np.abs(a - b) <= np.maximum(1e-10 * np.abs(b), floor)), (name, a, b)
    np.testing.assert_allclose(h.costs, [s.cost for s in res.iteration_stats], rtol=0)
    assert h.total_iterations == h_j.total_iterations == res.iterations
    assert h.final_variables.keys() == h_j.final_variables.keys()
    assert len(h.variable_history) == len(h_j.variable_history) == res.iterations
    for snap, snap_j in zip(h.variable_history, h_j.variable_history):
        for name in snap_j:
            np.testing.assert_allclose(snap[name], snap_j[name], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", ["se3", "ba", "se2"])
def test_rerun_records_match_apex_tpu(jax_runs, case):
    res, obs = rerun_run(apx, case)
    res_j, obs_j = jax_runs(rerun_run, case)
    assert (res.iterations, res.status.name) == (res_j.iterations, res_j.status.name)
    assert_records_equal(obs.sink.records, obs_j.sink.records, res_j.initial_cost)
    for group, stats in obs_j.displacements.items():
        assert obs.displacements[group]["count"] == stats["count"]
        for key in ("avg", "min", "max"):
            np.testing.assert_allclose(obs.displacements[group][key], stats[key], rtol=1e-8,
                                       atol=1e-12)
    paths = obs.sink.paths()
    if case == "ba":
        assert "initial_graph/landmarks" in paths and "final_graph/landmarks" in paths
        assert obs.config.invert_camera_poses
    else:
        assert "optimization/matrices/hessian" in paths


def test_matrix_data_shapes():
    """``expose_matrix_data`` hands (H, g) at the new point to
    ``set_matrix_data`` before each ``on_step``, as numpy arrays."""
    calls = []

    class MatrixObserver(apx.observers.OptObserver):
        def set_matrix_data(self, H, g):
            calls.append(("matrix", H.shape, g.shape, type(H)))

        def on_step(self, variables, iteration, *metrics):
            calls.append(("step", iteration))

    cp = _compile(apx, synthetic.synthetic_pose_graph_2d(20, seed=9).to_problem())
    lm = _solver(apx, "lm", expose_matrix_data=True, max_iterations=3)
    lm.add_observer(MatrixObserver())
    res = lm.optimize(cp)
    assert calls[0] == ("matrix", (60, 60), (60,), np.ndarray)
    assert calls[1::2] == [("step", i) for i in range(res.iterations)]


@pytest.mark.parametrize("kind", ["lm", "gn", "dl"])
def test_jit_with_observer_runs_python_mode(kind):
    """``mode="jit"`` with an observer runs python mode: the same
    per-iteration statistics exactly, and no jit state is built."""
    cp = _compile(apx, synthetic.synthetic_pose_graph_2d(25, seed=6).to_problem(fix_first=True))
    ref = _solver(apx, kind, collect_stats=True).optimize(cp)
    jit = _solver(apx, kind, collect_stats=True, mode="jit")
    h = HistoryObserver()
    jit.add_observer(h)
    res = jit.optimize(cp)
    assert not jit._jit_cache

    def table(r):
        return [(s.iteration, s.cost, s.cost_change, s.gradient_norm, s.step_norm, s.tr_ratio,
                 s.tr_radius, s.accepted) for s in r.iteration_stats]

    assert table(res) == table(ref)
    assert (res.iterations, res.status, res.final_cost) == (ref.iterations, ref.status,
                                                            ref.final_cost)
    assert len(h.history) == res.iterations


def test_callback_and_vec_observers():
    seen, done = [], []
    cb = apx.observers.CallbackObserver(lambda v, it, m: seen.append((it, m["cost"])),
                                        on_complete=lambda v, n: done.append(n))
    vec = apx.observers.OptObserverVec([cb])
    h = HistoryObserver()
    vec.add(h)
    assert len(vec) == 2
    lm = _solver(apx, "lm")
    lm.add_observer(vec)
    res = lm.optimize(_compile(apx, synthetic.synthetic_pose_graph_2d(25, seed=6).to_problem(fix_first=True)))
    assert [c for _, c in seen] == list(h.costs)
    assert done == [res.iterations] and h.total_iterations == res.iterations


def test_rerun_sink_needs_rerun():
    with pytest.raises(ImportError, match="rerun"):
        vis.RerunSink("apex_tpu", False, None)
    with pytest.raises(ImportError, match="rerun"):
        apx.observers.RerunObserver()


class _Writer:
    """An observer that tries to write into every dict it is handed and
    keeps the error each write raised."""

    def __init__(self):
        self.errors = []

    def _write(self, variables):
        for v in variables.values():
            try:
                v += 1.0
            except ValueError as e:
                self.errors.append(str(e))
            try:
                v[0] = 0.0
            except ValueError as e:
                self.errors.append(str(e))

    def on_step(self, variables, *args):
        self._write(variables)

    def notify_complete(self, variables, iterations):
        self._write(variables)


@pytest.mark.parametrize("mode", ["python", "jit"])
def test_handed_out_arrays_are_read_only(mode):
    """ROADMAP C.1: every host array handed out (each ``on_step`` dict,
    ``notify_complete``'s dict, ``SolverResult.variables``) is read-only in
    both packages, and on the CPU the port's shares no memory with a pool
    tensor. After an observer has tried to write (a first step rejected
    under ``damping=1e30``, so the pools are still the compiled problem's
    own), the initial values' cost is unchanged."""
    results = {}
    for pkg in (apx, jax_apx):
        syn = synthetic if pkg is apx else jax_synthetic
        cp = _compile(pkg, syn.synthetic_pose_graph_2d(25, seed=6).to_problem(fix_first=True))
        cost0 = float(cp.cost(cp.initial_values()))
        for damping in (1e30, 1e-3):
            obs = _Writer()
            solver = pkg.LevenbergMarquardt(pkg.LevenbergMarquardtConfig(
                mode=mode, damping=damping, max_iterations=4))
            solver.add_observer(obs)
            res = solver.optimize(cp)
            n_dicts = res.iterations + 1  # one per iteration and the final one
            assert len(obs.errors) == 2 * 25 * n_dicts, (pkg.__name__, damping)
            assert all("read-only" in e for e in obs.errors)
            assert float(cp.cost(cp.initial_values())) == cost0
        plain = pkg.LevenbergMarquardt(pkg.LevenbergMarquardtConfig(mode=mode)).optimize(cp)
        for name, v in plain.variables.items():
            assert not v.flags.writeable, name
            with pytest.raises(ValueError, match="read-only"):
                v[0] = 0.0
        results[pkg] = plain
    cp = _compile(apx, synthetic.synthetic_pose_graph_2d(25, seed=6).to_problem(fix_first=True))
    handed = cp.values_dict(cp.initial_values())
    assert not any(np.shares_memory(v, t.numpy()) for v in handed.values()
                   for t in cp.initial_values())
    assert results[apx].iterations == results[jax_apx].iterations
    np.testing.assert_allclose(results[apx].final_cost, results[jax_apx].final_cost, rtol=1e-8)
