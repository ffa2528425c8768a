"""The traced pass and its readers, generators found as files, and the
pose-graph reference's memory: the readers against ``chip_probe``'s
``trace_summary`` on one fabricated trace, a rehearsal with ``--trace 1``
on the CPU, a generator file in a temporary directory, the reference's
step against its four-matrix form, and (marked ``cuda``) the reference on
the 20^3 lattice within two D x D matrices on a card."""

from types import SimpleNamespace

import numpy as np
import pytest
import small
import torch
from harness import cell, compare, generators, reference

import chip_probe

PG, BA = "pg_sphere2500.solve", "ba_venice1778.fixed5"
# the metrics the traced pass gives, by cell
TRACED = {
    PG: {"result_ms", "capture_s", "linearize_ms_per_iter", "linear_solve_ms_per_iter",
         "cr_extra_solves_share"},
    BA: {"result_ms", "capture_s", "linearize_ms_per_iter", "linear_solve_ms_per_iter",
         "pcg_iters_per_lm_iter", "pcg_masked_share", "assemble_kernel_row_share",
         "schur_assemble_roofline"},
}
# of those, the ones read from device stamps: none on the CPU
STAMPED = {"linearize_ms_per_iter", "linear_solve_ms_per_iter", "schur_assemble_roofline"}
# the per-layer metrics read from the window, as before the traced pass
WINDOW = {"lm_iters", "host_reads", "graph_ms_per_iter", "outside_graph_share",
          "landmark_inv_roofline", "spd_inv_roofline"}
H100 = "NVIDIA H100 80GB HBM3"
PHASES = {
    BA: {"schur.assemble": (9_250_000, 5), "schur.assemble>schur.assemble_kernel": (2_210_000, 30),
         "schur.assemble>camera.project": (1_000, 5), "schur.precondition": (52_000_000, 5),
         "schur.pcg": (172_900_000, 5), "schur.back_substitute": (15_200_000, 5),
         "lm.trial_cost": (15_400_000, 5)},
    PG: {"banded.linearize": (1_230_000, 4), "banded.assemble": (190_000, 4),
         "cr.eliminate": (4_760_000, 4), "cr.eliminate>cr.inner": (4_000_000, 4),
         "cr.dense_fold": (730_000, 4), "cr.back_substitute": (1_030_000, 4),
         "cr.residual": (60_000, 4), "cr.refine": (120_000, 1), "lm.trial_cost": (480_000, 4)},
}
COUNTERS = {
    BA: {"pcg_calls": 15, "pcg_iterations": 144, "pcg_executed": 168, "assemble_rows": 64_000,
         "assemble_kernel_rows": 48_000, "host_reads": 3},
    PG: {"cr_solves": 24, "cr_refines": 2, "cr_retries": 1, "host_reads": 3},
}


def _trace(workload, solves=3, dropped=0):
    """A trace as the program's ``collect_trace`` gives one: ``solves``
    solves of nested host spans (the tracer's own among them), one
    parent-graph launch each, the cell's stamped phases and counters."""
    spans, launches, t = [], [], 1_000_000
    for k in range(solves):
        root = 100 * k + 1
        spans += [
            dict(name="lm.launch", start_ns=t + 10, end_ns=t + 40, id=root + 1, parent=root,
                 solve=root),
            dict(name="tracer", start_ns=t + 40, end_ns=t + 45, id=root + 2, parent=root,
                 solve=root),
            dict(name="lm.read", start_ns=t + 50, end_ns=t + 900, id=root + 3, parent=root,
                 solve=root),
            dict(name="problem.values_dict", start_ns=t + 920, end_ns=t + 1_900 + 37 * k,
                 id=root + 5, parent=root + 4, solve=root),
            dict(name="lm.result", start_ns=t + 910, end_ns=t + 1_950 + 37 * k, id=root + 4,
                 parent=root, solve=root),
            dict(name="lm.solve", start_ns=t, end_ns=t + 2_000 + 37 * k, id=root, parent=None,
                 solve=root),
        ]
        launches.append(dict(device=0, start_ns=t + 30, end_ns=t + 800, solve=root))
        t += 5_000
    phases = [dict(device=0, path=path, name=path.rpartition(">")[2],
                   parent=path.rpartition(">")[0] or None, total_ns=ns, count=count,
                   first_ns=1_000_000, last_ns=t) for path, (ns, count) in PHASES[workload].items()]
    return {"spans": spans, "launches": launches, "phases": phases,
            "counters": dict(COUNTERS[workload]), "anchors": {0: dict(host_ns=0, uncertainty_ns=9)},
            "dropped": {"spans": dropped, "launches": 0, "phases": 0}}


SETUP = {"lm.capture": 4.25, "graphs.record": 1.5, "lm.launch": 0.01}
ITERATIONS = 15


def _record(workload, trace, device_kind=H100):
    kind = "bundle_adjustment" if workload == BA else "pose_graph"
    data = generators.ba_large(n_cameras=6, n_points=300, obs_per_camera=40, pixel_noise=0.3)
    record = SimpleNamespace(kind=kind, data=data, dtype=torch.float64, device_kind=device_kind,
                             trace=None)
    if trace is not None:
        record.trace = {"trace": trace, "solves": 3, "iterations": ITERATIONS,
                        "setup": dict(SETUP)}
    return record


def _readers(workload):
    return cell.load(small.ROOT, workload)["readers"]


@pytest.mark.parametrize("workload", [PG, BA])
def test_each_traced_reader_is_listed_for_its_cells(workload):
    assert TRACED[workload] <= set(_readers(workload))
    others = set().union(*TRACED.values()) - TRACED[workload]
    assert not others & set(_readers(workload))


@pytest.mark.parametrize("workload", [PG, BA])
def test_the_readers_give_trace_summarys_numbers(workload):
    trace = _trace(workload)
    want = chip_probe.trace_summary(workload, dict(SETUP), trace, ITERATIONS, 3)["metrics"]
    readers = _readers(workload)
    assert set(want) == TRACED[workload] - {"schur_assemble_roofline"}
    for name, value in want.items():
        assert readers[name](_record(workload, trace)) == pytest.approx(value, rel=1e-12), name


def test_the_assembly_roofline_reads_the_kernel_stamps_per_assemble():
    record = _record(BA, _trace(BA))
    data = record.data
    n_bytes = (data["observations"].shape[0] * (30 * 8 + 24)
               + np.unique(data["cam_indices"]).size * 106 * 8
               + np.unique(data["point_indices"]).size * 15 * 8 + 16)
    per_assemble = 2_210_000e-9 / 5
    want = 100.0 * n_bytes / 3.35e12 / per_assemble
    assert _readers(BA)["schur_assemble_roofline"](record) == pytest.approx(want, rel=1e-12)
    assert _readers(BA)["schur_assemble_roofline"](_record(BA, _trace(BA), "cpu")) is None


@pytest.mark.parametrize("case", ["no pass", "empty", "dropped"])
@pytest.mark.parametrize("workload", [PG, BA])
def test_a_reader_with_nothing_to_read_gives_none(workload, case):
    if case == "no pass":
        record = _record(workload, None)
    elif case == "empty":
        record = _record(workload, {"spans": [], "launches": [], "phases": [], "counters": {},
                                    "anchors": {}, "dropped": {"spans": 0}})
        record.trace["setup"] = {}
    else:
        record = _record(workload, _trace(workload, dropped=1))
    readers = _readers(workload)
    assert {name: readers[name](record) for name in TRACED[workload]} == dict.fromkeys(
        TRACED[workload])


@pytest.mark.parametrize("workload", [PG, BA])
def test_a_traced_rehearsal_adds_the_pass_and_leaves_the_window(workload):
    spec = small.spec(workload)
    rc, line = small.run(spec, seed=2**31 + 21, trace=1)
    assert rc == 0 and line["correct"], line
    metrics = set(line["metrics"])
    # the stamps need the card; the spans and counters do not
    assert metrics & TRACED[workload] == TRACED[workload] - STAMPED
    breakdown = line["breakdown"]
    assert all(len(entries) <= cell.BREAKDOWN_ENTRIES for entries in breakdown.values())
    assert any(name.startswith("traced pass, idle in") for name, _ in breakdown["idle_gaps"])
    # the same run without the traced pass: the window's readings as before
    spec["loop"].traced = None
    rc, before = small.run(spec, seed=2**31 + 21, trace=1)
    assert rc == 0 and before["correct"]
    assert not set(before["metrics"]) & TRACED[workload]
    for name in ("lm_iters", "host_reads"):
        assert line["metrics"][name] == before["metrics"][name]
    assert set(before["metrics"]) == metrics & WINDOW


def _write_generator(directory):
    directory.mkdir()
    (directory / "ring_toy.py").write_text(
        "from harness import generators\n"
        "SMALL = {'n_poses': 40}\n"
        "def generate(seed, n_poses=400):\n"
        "    return generators.pose_graph_3d(n_poses=n_poses, rings=4, seed=seed)\n")


def test_a_generator_file_is_found_rotated_and_shrunk(tmp_path, monkeypatch):
    _write_generator(tmp_path / "generators")
    monkeypatch.setattr(generators, "FILES", tmp_path / "generators")
    got = generators.make({"name": "ring_toy", "params": {"n_poses": 80}}, 2**31 + 5)
    want = generators.rotate(generators.pose_graph_3d(n_poses=80, rings=4, seed=0), 2**31 + 5)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert small.small_params("ring_toy") == {"n_poses": 40}
    spec = small.spec(PG)
    spec["config"]["generator"] = {"name": "ring_toy", "params": small.small_params("ring_toy")}
    rc, line = small.run(spec, seed=3)
    assert rc == 0 and line["correct"], line
    with pytest.raises(SystemExit, match="unknown generator"):
        generators.make({"name": "no_such_generator", "params": {}}, 1)


def test_the_harness_generators_stay_where_they_are():
    spec = {"name": "pose_graph_3d", "params": {"n_poses": 200, "rings": 8}}
    want = generators.rotate(generators.pose_graph_3d(n_poses=200, rings=8, seed=0), 9)
    got = generators.make(spec, 9)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def _four_matrix_step(problem, x, lam):
    """The step as it was: A = H + lam I beside H, the identity and its
    multiple."""
    H, g, cost = problem._normal(x)
    A = H + lam * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    del H
    L, info = torch.linalg.cholesky_ex(A)
    assert int(info) == 0
    dx = torch.cholesky_solve(-g[:, None], L)
    dx = (dx + torch.cholesky_solve(-g[:, None] - A @ dx, L))[:, 0]
    return (dx.view(-1, 6),), (g,), cost, float(0.5 * torch.sum(dx * (lam * dx - g)))


@pytest.mark.parametrize("lam", [1e-9, 1e-3, 10.0])
def test_the_pose_graph_step_is_the_four_matrix_step_to_the_bit(lam):
    data = generators.make({"name": "pose_graph_3d", "params": {"n_poses": 120, "rings": 6}}, 4)
    problem = reference.PoseGraph(data, torch.float64, torch.device("cpu"))
    x = problem.initial()
    for _ in range(2):
        (dx,), (g,), cost, predicted = problem.step(x, lam, 0, None, reference.Settings())
        (dx0,), (g0,), cost0, predicted0 = _four_matrix_step(problem, x, lam)
        assert torch.equal(dx, dx0) and torch.equal(g, g0) and torch.equal(cost, cost0)
        assert predicted == predicted0
        x = problem.apply(x, (dx,))


@pytest.mark.cuda
def test_the_reference_solves_the_20_cubed_lattice_within_two_matrices(cuda_device):
    from apex_tpu_torch.io import synthetic

    graph = synthetic.synthetic_pose_graph_grid3d(20, 20, 20, seed=0)
    n = len(graph.vertices_se3)
    data = {"vertices": np.stack([graph.vertices_se3[i] for i in range(n)]),
            "src": np.asarray([e.frm for e in graph.edges_se3]),
            "dst": np.asarray([e.to for e in graph.edges_se3]),
            "measurements": np.stack([e.measurement for e in graph.edges_se3])}
    D = 6 * n
    assert D == 48_000
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    problem = reference.PoseGraph(data, torch.float64, torch.device(cuda_device))
    result = reference.levenberg_marquardt(
        problem, reference.Settings(damping="auto", cost_tolerance=1e-4, max_iterations=100))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"lattice 20^3: {result.status} after {result.iterations} iterations, cost "
          f"{result.initial_cost:.6g} -> {result.final_cost:.6g}, peak {peak / 2**30:.3f} GiB "
          f"({peak / (D * D * 8):.4f} D x D matrices)")
    assert result.status in compare.CONVERGED and result.final_cost < result.initial_cost
    assert peak <= 2.2 * D * D * 8
