"""The port's benchmark harnesses (``apex_tpu_torch.benches``) against the
JAX package's ``bench.py`` rungs and ``benches/*.py`` harnesses, on the CPU
in f64 at reduced counts: the generators of the large rungs, the ladder's
solve functions (venice's and torus3d's configs) against the JAX package's
same configs, both harnesses' CSV rows, and the ladder's output line."""

import csv
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.io import datasets as jax_datasets
from apex_tpu.io import graph as jax_graph
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.benches import bundle_adjustment_benchmark as ba_bench
from apex_tpu_torch.benches import ladder
from apex_tpu_torch.benches import odometry_pose_benchmark as odo_bench
from apex_tpu_torch.io import datasets, synthetic
from apex_tpu_torch.linalg import banded, schur
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

REPO = Path(__file__).resolve().parent.parent
CPU = dict(dtype=torch.float64, device="cpu")
# venice's shape at 1/150 of its cameras: ~4 observations per point, some
# points seen by no camera, 0.3 px noise (its floor under the 0.46 px gate)
VENICE_SMALL = dict(n_cameras=12, n_points=4000, obs_per_camera=1200, pixel_noise=0.3)
# torus3d's shape (50 poses per ring, closures one ring apart) at 1/25
TORUS_SMALL = dict(n_poses=200, rings=4)


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    """An empty dataset cache, and a downloader that raises in both
    packages: no test may reach the network."""
    monkeypatch.setenv("APEX_TPU_DATA_DIR", str(tmp_path / "cache"))

    def no_network(url, dest, timeout=60.0):
        raise ConnectionError(f"no network in the tests: {url}")

    monkeypatch.setattr(datasets, "download_file", no_network)
    monkeypatch.setattr(jax_datasets, "download_file", no_network)


def _jax_module(name):
    """A script of the repository's ``benches/`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "benches" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_twin(graph):
    """The JAX package's ``Graph`` of the port's: the same arrays, so the
    solves start from the same bits (the generators are held to each other
    below)."""
    return jax_graph.Graph(vertices_se3=dict(graph.vertices_se3), edges_se3=[
        jax_graph.Edge(e.frm, e.to, e.measurement, e.information) for e in graph.edges_se3])


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's solves of the two reduced rungs with the ladder's
    configs, once per module: BA in python mode on its block path
    (APEX_TPU_UNIFORM=0, as tests/test_torch_ba_e2e.py), the torus in
    ``bench.py``'s jit mode (one compile of the whole loop: on the CPU a
    quarter of python mode's time, which compiles operation by operation)."""
    out = {}
    ds = jax_synthetic.synthetic_ba_large(seed=0, **VENICE_SMALL)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_UNIFORM", "0")
        cfg = jax_apx.LevenbergMarquardtConfig(
            linear_solver_type="schur_implicit", schur_preconditioner="schur_jacobi",
            max_iterations=8, mode="python", pcg_max_iterations=15,
            min_cost_threshold=(0.46 ** 2) * ds.num_observations)
        out["venice"] = jax_apx.LevenbergMarquardt(cfg).optimize(
            jax_build(ds, mode="self_calibration").compile(dtype=np.float64))
    g = _jax_twin(synthetic.synthetic_pose_graph_3d(seed=0, **TORUS_SMALL))
    cfg = jax_apx.LevenbergMarquardtConfig(
        mode="jit", max_iterations=100, cost_tolerance=1e-4,
        linear_solver_type="sparse_cholesky", damping="auto")
    out["torus3d"] = jax_apx.LevenbergMarquardt(cfg).optimize(g.to_problem().compile(
        dtype=np.float64))
    return out


@pytest.mark.parametrize("noise", [0.3, 0.5])
def test_synthetic_ba_large_matches_apex_tpu(noise):
    """venice's (0.3) and dubrovnik's (0.5) pixel noise: the same draws,
    indices and points exactly; the rotation-derived fields (axis-angle
    through a quaternion, the projected observations) within rtol 1e-12."""
    kw = dict(n_cameras=9, n_points=3000, obs_per_camera=1300, pixel_noise=noise, seed=0)
    t, j = synthetic.synthetic_ba_large(**kw), jax_synthetic.synthetic_ba_large(**kw)
    for field in ("translations", "focals", "k1", "k2", "points", "cam_indices",
                  "point_indices"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field), err_msg=field)
    for field in ("rotations", "observations"):
        np.testing.assert_allclose(getattr(t, field), getattr(j, field), rtol=1e-12,
                                   atol=1e-12, err_msg=field)
    # points that no camera sees, as at venice's full size
    assert (np.bincount(t.point_indices, minlength=t.num_points) == 0).sum() > 0


# both with 539 edges: the JAX generator compiles its edge operations once
@pytest.mark.parametrize("kw", [dict(n_poses=200, rings=10, closure_strides=(1, 2)),
                                dict(n_poses=150, rings=15, closure_strides=(1, 2, 3))])
def test_closure_strides_match_apex_tpu(kw):
    """cubicle's (1, 2) and parking-garage's (1, 2, 3) closures: the same
    edges and measurements exactly, the integrated vertices within 1e-10
    of the largest coordinate (rounding compounds along the chain)."""
    t = synthetic.synthetic_pose_graph_3d(seed=0, **kw)
    j = jax_synthetic.synthetic_pose_graph_3d(seed=0, **kw)
    per_ring = kw["n_poses"] // kw["rings"]
    n_edges = kw["n_poses"] - 1 + sum(kw["n_poses"] - s * per_ring for s in kw["closure_strides"])
    assert t.num_edges == j.num_edges == n_edges
    for te, je in zip(t.edges_se3, j.edges_se3, strict=True):
        assert (te.frm, te.to) == (je.frm, je.to)
        np.testing.assert_array_equal(te.measurement, je.measurement)
    vt = np.stack([t.vertices_se3[i] for i in range(kw["n_poses"])])
    vj = np.stack([j.vertices_se3[i] for i in range(kw["n_poses"])])
    np.testing.assert_allclose(vt, vj, rtol=1e-10, atol=1e-10 * np.abs(vj).max())


def test_venice_rung_matches_apex_tpu(jax_solves):
    """solve_venice's config (8 iterations, 15 PCG iterations, stop at 0.46
    px) on a reduced venice-shaped problem in python mode: the JAX
    package's iterations and status, costs within rtol 1e-8, the gate."""
    built = ladder.build_ba(**CPU, **VENICE_SMALL)
    calls, iterations = schur.pcg_calls, schur.pcg_iterations
    solved = ladder.solve_venice(built, runs=1, mode="python")
    rj, rt = jax_solves["venice"], solved.result
    # the library's counters: one PCG solve per LM iteration of both solves
    lm_iterations = rt.iterations + solved.first_result.iterations
    assert schur.pcg_calls - calls == lm_iterations
    assert lm_iterations <= schur.pcg_iterations - iterations <= 15 * lm_iterations
    assert solved.gate_passed and solved.row["vs_baseline"] > 0
    assert (rt.iterations, rt.status.name) == (rj.iterations, rj.status.name)
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    assert rt.final_cost < (0.46 ** 2) * built.data.num_observations


def test_torus_rung_matches_apex_tpu(jax_solves):
    """The pose-graph rungs' config (bench.py's _solve_pose_graph) on a
    reduced torus-shaped graph: the JAX package's iterations and status,
    costs within rtol 1e-8, the 97% reduction gate."""
    built = ladder.build_pose_graph(**CPU, **TORUS_SMALL)
    solves, retries = banded.cr_solves, banded.cr_retries
    solved = ladder.RUNGS["torus3d"].solve(built, runs=1, mode="python")
    rj, rt = jax_solves["torus3d"], solved.result
    # the library's counters: one CR solve per LM iteration, none retried
    assert banded.cr_solves - solves == rt.iterations + solved.first_result.iterations
    assert banded.cr_retries == retries
    assert (rt.iterations, rt.status.name) == (rj.iterations, rj.status.name)
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    assert solved.row["metric"] == "torus3d_synthetic_se3_lm_solve"
    assert solved.row["iters"] == rt.iterations


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_odometry_harness_matches_apex_tpu(tmp_path):
    """The harness on its smallest entry (ring, the synthetic stand-in: the
    downloader raises) against the JAX harness's CSV of the CPU in f64
    (``benches/results/odometry_cpu_f64.csv``): the same columns, and the
    same graph, status, iterations and costs (rtol 1e-8)."""
    odo_bench.main(["--datasets", "ring", "--runs", "1", "--platform", "cpu",
                    "--out", str(tmp_path / "port.csv")])
    (t,) = _read_csv(tmp_path / "port.csv")
    (j,) = [r for r in _read_csv(REPO / "benches" / "results" / "odometry_cpu_f64.csv")
            if r["dataset"] == "ring"]
    assert list(t) == list(j)
    for key in ("dataset", "source", "vertices", "edges", "optimizer", "dtype", "platform",
                "linear_solver", "damping", "status", "iterations", "baseline_ms"):
        assert t[key] == j[key], key
    assert t["source"] == "synthetic"
    for key in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(t[key]), float(j[key]), rtol=1e-8, err_msg=key)


def test_ba_harness_rows(tmp_path, monkeypatch):
    """The BA harness on its smallest entry with the synthetic stand-in cut
    to 6 cameras and 80 points in both packages (the harnesses' 380,870
    observations are the card's size): the JAX harness's columns, and the
    rows of the port's own solve of the same problem (status, iterations,
    RMSE at the CSV's 4 decimals)."""
    jax_ba = _jax_module("bundle_adjustment_benchmark")
    monkeypatch.setitem(ba_bench.SUITE, "ladybug-49", (6, 80))
    monkeypatch.setitem(jax_ba.SUITE, "ladybug-49", (6, 80))
    ds, source = jax_ba.load_problem("ladybug-49")
    assert source == "synthetic" and ds.num_cameras == 6
    rows = ba_bench.main(["--problems", "ladybug-49", "--platform", "cpu",
                          "--out", str(tmp_path / "port.csv")])
    (t,) = _read_csv(tmp_path / "port.csv")
    columns = ["problem", "source", "cameras", "points", "observations", "solver", "dtype",
               "status", "iterations", "initial_rmse_px", "final_rmse_px", "time_s",
               "baseline_s", "vs_baseline"]
    assert list(t) == columns and list(rows[0]) == columns
    assert (t["source"], t["cameras"], t["points"], t["observations"]) == (
        "synthetic", "6", "80", str(ds.num_observations))
    built_ds, _ = ba_bench.load_problem("ladybug-49")
    cfg = ladder.apx.LevenbergMarquardtConfig(
        linear_solver_type="schur_implicit", schur_preconditioner="schur_jacobi",
        max_iterations=30, timeout=600.0, mode="python")
    ref = ladder.apx.LevenbergMarquardt(cfg).optimize(
        ladder.build_ba_problem(built_ds, mode="self_calibration").compile(**CPU))
    assert (t["status"], int(t["iterations"])) == (ref.status.name, ref.iterations)
    n = ds.num_observations
    assert float(t["initial_rmse_px"]) == round(ladder.rmse(ref.initial_cost, n), 4)
    assert float(t["final_rmse_px"]) == round(ladder.rmse(ref.final_cost, n), 4)


def _tiny_rungs(fail):
    """A reduced sphere rung and a reduced BA rung, and one that fails: a
    pose graph that cannot reach its reduction (raises), or a BA rung
    whose RMSE gate cannot be met (a row with the ratio withheld)."""
    rungs = {
        "sphere2500": ladder._pose_rung("sphere2500_synthetic_lm_solve", 176.3, 0.99,
                                        n_poses=100, rings=5),
        "ba": ladder.Rung(lambda dtype, device: ladder.build_ba(
            dtype, device, n_cameras=5, n_points=150, obs_per_camera=100),
            ladder.solve_trafalgar),
    }
    if fail == "raises":
        rungs["torus3d"] = ladder._pose_rung("torus3d_synthetic_se3_lm_solve", 1780.5, 1.0,
                                             n_poses=60, rings=3)
    elif fail == "gate":
        rungs["venice"] = ladder.Rung(lambda dtype, device: ladder.build_ba(
            dtype, device, n_cameras=5, n_points=150, obs_per_camera=100, pixel_noise=1.0),
            ladder.solve_venice)
    return rungs


@pytest.mark.parametrize("fail", [None, "raises", "gate"])
def test_ladder_main(fail, tmp_path, monkeypatch, capsys):
    """``main`` on the CPU: one compact JSON line last on stdout, in
    bench.py's shape (the head row, the others under ``extra``), the full
    rows in ``--out``; a rung that raises stops the ladder, a missed gate
    keeps its row with the ratio withheld, and both exit non-zero after
    printing what the ladder has."""
    monkeypatch.setattr(ladder, "RUNGS", _tiny_rungs(fail))
    out = tmp_path / "full.json"
    argv = ["--platform", "cpu", "--runs", "1", "--out", str(out)]
    if fail is None:
        ladder.main(argv)
    elif fail == "raises":
        with pytest.raises(RuntimeError, match="did not converge"):
            ladder.main(argv)
    else:
        with pytest.raises(SystemExit, match="quality gate missed"):
            ladder.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    head = json.loads(line)
    assert head["metric"] == "sphere2500_synthetic_lm_solve" and head["unit"] == "ms"
    assert head["device"] == "cpu" and head["dtype"] == "f64"
    assert set(head) >= {"value", "vs_baseline", "iters", "s_per_iter", "extra"}
    assert [r["metric"] for r in head["extra"]][:1] == ["trafalgar257_synthetic_ba_solve"]
    rows = json.loads(out.read_text())["rows"]
    assert [r["rung"] for r in rows] == ["sphere2500", "ba"] + (["venice"] if fail == "gate"
                                                               else [])
    if fail == "gate":
        assert rows[-1]["gate_passed"] is False and rows[-1]["vs_baseline"] == 0.0
        assert "quality gate missed" in rows[-1]["note"]
