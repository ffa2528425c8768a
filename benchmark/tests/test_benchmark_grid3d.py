"""The grid3D cell (``pg_grid3d8000.solve_optimum``) on the CPU: its
generator file against the port's lattice, the published size and the
path through it, the general tier that ``sparse_cholesky`` routes it to,
the reference against the program's jit mode there, and the readers of
the tier's stamps and counters.

At ``SMALL`` (2 x 16 x 16) the name ordering's band is 1,542 columns,
wider than the banded tier's 1,536, but the auto ordering's reverse
Cuthill-McKee narrows it to a few hundred, so a CPU rehearsal solves it in
the banded tier. The tests that mean the general tier at ``SMALL`` hold
the auto ordering to the name order (``NAME_ORDER``); at the published
size the RCM band itself is wider than the banded tier takes."""

from types import SimpleNamespace

import numpy as np
import pytest
import small
import torch
from harness import cell, flops, generators, program, reference

from apex_tpu_torch.core.problem import Problem
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.linalg import banded
from apex_tpu_torch.linalg import sparse_general as sg

CELL = "pg_grid3d8000.solve_optimum"
GEN = generators.from_file("pose_graph_grid3d")
H100 = "NVIDIA H100 80GB HBM3"
# the cell's readers of the tier's stamps and counters
READERS = ("general_linear_solve_ms_per_iter", "general_assemble_ms_per_iter",
           "general_extra_solves_share", "general_core_roofline")
WORK = ("general_solves", "general_retries", "general_core_factors", "general_core_cols")


@pytest.fixture
def name_order(monkeypatch):
    """The auto ordering keeps the name order (no band is wide enough for
    it to try reverse Cuthill-McKee)."""
    monkeypatch.setattr(Problem, "_RCM_AUTO_BANDWIDTH", float("inf"))


def _edges(d):
    return list(zip(d["src"].tolist(), d["dst"].tolist()))


@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_the_generator_file_equals_the_programs_lattice(seed):
    mine = GEN.generate(seed=seed, **GEN.SMALL)
    graph = synthetic.synthetic_pose_graph_grid3d(
        GEN.SMALL["nx"], GEN.SMALL["ny"], GEN.SMALL["nz"], seed=seed)
    n = len(graph.vertices_se3)
    np.testing.assert_array_equal(mine["vertices"],
                                  np.stack([graph.vertices_se3[i] for i in range(n)]))
    theirs = {(e.frm, e.to): e.measurement for e in graph.edges_se3}
    kept = _edges(mine)
    assert len(kept) == len(theirs) - GEN.SMALL["dropped"] and set(kept) <= set(theirs)
    np.testing.assert_array_equal(mine["measurements"], np.stack([theirs[e] for e in kept]))


def test_the_generator_has_grid3ds_size_path_and_band():
    data = GEN.generate(seed=0)
    n, edges = data["vertices"].shape[0], _edges(data)
    assert (n, len(edges), len(set(edges))) == (8000, 22_236, 22_236)
    path = GEN.snake(20, 20, 20)
    assert sorted(path.tolist()) == list(range(n))
    odometry = set(zip(np.minimum(path[:-1], path[1:]).tolist(),
                       np.maximum(path[:-1], path[1:]).tolist()))
    assert len(odometry) == 7999 and odometry <= set(edges)
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components, reverse_cuthill_mckee

    A = sp.coo_matrix((np.ones(len(edges)), (data["src"], data["dst"])), shape=(n, n)).tocsr()
    assert connected_components(A, directed=False)[0] == 1
    # the auto ordering's RCM leaves a band wider than the banded tier's
    pos = np.empty(n, dtype=np.int64)
    pos[reverse_cuthill_mckee(A + A.T, symmetric_mode=True)] = np.arange(n)
    width = 6 * (int(np.abs(pos[data["src"]] - pos[data["dst"]]).max()) + 1)
    assert width > banded.MAX_BANDWIDTH
    # the same edges and arrays for every run's seed: only the frame turns
    spec = cell.load(small.ROOT, CELL)["config"]["generator"]
    assert spec == {"name": "pose_graph_grid3d",
                    "params": {"nx": 20, "ny": 20, "nz": 20, "dropped": 564}}


def _small_problem(seed=3):
    data = generators.make({"name": "pose_graph_grid3d", "params": GEN.SMALL}, seed)
    cp = program.compile_problem(program.build("pose_graph", program.to_input("pose_graph", data),
                                               {}), {"dtype": "float64"}, "cpu")
    return data, cp


def test_sparse_cholesky_routes_small_to_the_general_tier(name_order, monkeypatch):
    opts = cell.solver_options(small.spec(CELL), None)
    data, cp = _small_problem()
    assert banded.block_bandwidth(cp) == 6 * (16 * 16 + 1) > banded.MAX_BANDWIDTH
    solve_fn = program.solver(opts)._make_solve_fn(cp)
    assert isinstance(solve_fn.general_sparse, sg.GeneralSparseCholesky)
    monkeypatch.undo()
    _, cp = _small_problem()
    assert banded.block_bandwidth(cp) <= banded.MAX_BANDWIDTH


def test_the_reference_solve_follows_the_programs_jit_mode_in_the_general_tier(name_order):
    opts = cell.solver_options(small.spec(CELL), None)
    assert (opts["mode"], opts["linear_solver_type"]) == ("jit", "sparse_cholesky")
    data = generators.draw("pose_graph_grid3d", 5, GEN.SMALL)
    cp = program.compile_problem(program.to_input("pose_graph", data).to_problem(), opts, "cpu")
    before = {k: getattr(sg, k) for k in WORK}
    ours = program.solver(opts).optimize(cp)
    work = {k: getattr(sg, k) - before[k] for k in WORK}
    assert work["general_solves"] == ours.iterations == work["general_core_factors"]
    settings = cell.reference_settings(reference.builtin("pose_graph"), opts)
    ref = reference.levenberg_marquardt(reference.PoseGraph(data, torch.float64, "cpu"), settings)
    assert (ours.status.name, ours.iterations) == (ref.status, ref.iterations)
    assert ours.final_cost == pytest.approx(ref.final_cost, rel=1e-7)


def test_a_traced_rehearsal_in_the_general_tier_reads_its_counters(name_order):
    rc, line = small.run(small.spec(CELL), seed=2**31 + 23, trace=1)
    assert rc == 0 and line["correct"], line
    # the counters need no card; the stamps do
    assert line["metrics"]["general_extra_solves_share"]["value"] == 0.0
    assert not set(line["metrics"]) & (set(READERS) - {"general_extra_solves_share"})


# per LM iteration of a fabricated traced pass of 15 iterations
PHASES = {"general.assemble": 45_000_000, "general.eliminate": 14_000_000,
          "general.core": 2_100_000_000, "general.back_substitute": 2_000_000,
          "general.retry": 150_000_000, "general.retry>general.core": 140_000_000,
          "lm.trial_cost": 9_000_000}
CORE = 20_262
COUNTERS = {"general_solves": 15, "general_retries": 1, "general_core_factors": 16,
            "general_core_cols": 16 * CORE, "host_reads": 3}
ITERATIONS = 15


def _record(phases=PHASES, counters=COUNTERS, device_kind=H100, dropped=0):
    trace = {"spans": [], "launches": [], "anchors": {}, "counters": dict(counters),
             "phases": [dict(device=0, path=path, name=path.rpartition(">")[2],
                             parent=path.rpartition(">")[0] or None, total_ns=ns,
                             count=ITERATIONS, first_ns=0, last_ns=1)
                        for path, ns in phases.items()],
             "dropped": {"spans": dropped, "launches": 0, "phases": 0}}
    return SimpleNamespace(kind="pose_graph", dtype=torch.float64, device_kind=device_kind,
                           trace={"trace": trace, "solves": 3, "iterations": ITERATIONS,
                                  "setup": {}})


def _readers():
    return cell.load(small.ROOT, CELL)["readers"]


def test_the_cell_reports_its_readers_and_lm_iters_alone():
    assert set(_readers()) == {*READERS, "lm_iters"}


def test_the_readers_read_the_tiers_stamps_and_counters():
    readers, record = _readers(), _record()
    per_iter = (14_000_000 + 2_100_000_000 + 2_000_000 + 150_000_000) / 1e6 / ITERATIONS
    assert readers["general_linear_solve_ms_per_iter"](record) == pytest.approx(per_iter, rel=1e-12)
    assert readers["general_assemble_ms_per_iter"](record) == pytest.approx(3.0, rel=1e-12)
    assert readers["general_extra_solves_share"](record) == pytest.approx(100 / 15, rel=1e-12)
    # the core's work at the counted width over every general.core stamp
    work = 16 * (CORE ** 3 / 3 + 2 * CORE ** 2)
    want = 100.0 * work / 67e12 / 2.24
    assert flops.cholesky_solve_flops(CORE) == pytest.approx(CORE ** 3 / 3 + 2 * CORE ** 2)
    assert readers["general_core_roofline"](record) == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100


@pytest.mark.parametrize("case", ["no pass", "dropped", "off the card", "no counters",
                                  "another tier"])
def test_a_reader_with_nothing_to_read_gives_none(case):
    if case == "no pass":
        record = _record()
        record.trace = None
    elif case == "dropped":
        record = _record(dropped=1)
    elif case == "off the card":
        # the CPU stamps nothing; its counters count
        record = _record(phases={}, device_kind="cpu")
    elif case == "no counters":
        # a program without the tier's counters (the parent of the cell)
        record = _record(counters={"host_reads": 3})
    else:
        record = _record(phases={"banded.linearize": 1_000, "cr.eliminate": 4_000},
                         counters={"cr_solves": 15, "host_reads": 3})
    readers = _readers()
    got = {name: readers[name](record) for name in READERS}
    if case == "off the card":
        assert got.pop("general_extra_solves_share") == pytest.approx(100 / 15)
    if case == "no counters":
        # stamps without counters: the times read, the counted ones do not
        assert got.pop("general_linear_solve_ms_per_iter") > 0
        assert got.pop("general_assemble_ms_per_iter") > 0
    assert got == dict.fromkeys(got)


def test_the_readers_name_the_tiers_spans():
    """The readers' phase names are the tier's span names."""
    import inspect

    source = inspect.getsource(sg)
    for name in ("general.assemble", "general.eliminate", "general.core",
                 "general.back_substitute", "general.retry"):
        assert f'span("{name}")' in source
