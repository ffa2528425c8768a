"""The port's tracer (``apex_tpu_torch/utils/profiling.py``) and the work
counters that count where the work runs (``optim/graphs.py`` ``count`` and
``count_on_device``), on the CPU: spans, their nesting and solve ids,
nothing recorded with tracing off, jit mode's CR and PCG counts against
python mode's, the warm-up counting nothing, the counts a recorded program
tree adds once its device counts are read, and ``idle_by_span`` and the
Chrome trace on a fabricated trace. The card's side (phase stamps inside
captured graphs, the launches' device intervals) is in
``tests/test_torch_cuda.py``."""

import gc
import json

import pytest
import torch

import apex_tpu_torch as apx
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.linalg import banded, schur
from apex_tpu_torch.optim import graphs
from apex_tpu_torch.utils import profiling

WORK = ("cr_solves", "cr_refines", "cr_retries", "pcg_calls", "pcg_iterations")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.set_tracing(False)
    profiling.reset_trace()
    yield
    profiling.set_tracing(False)
    profiling.reset_trace()


@pytest.fixture(scope="module")
def ring():
    graph = synthetic.synthetic_pose_graph_3d(n_poses=60, rings=3, seed=0)
    return graph.to_problem().compile(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def ba():
    ds = synthetic.synthetic_ba_large(n_cameras=6, n_points=300, obs_per_camera=120,
                                      pixel_noise=0.3, seed=0)
    return build_ba_problem(ds).compile(dtype=torch.float64, device="cpu")


def _lm(mode, **kw):
    return apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode=mode, **kw))


def _counters():
    return {name: getattr(banded if name.startswith("cr_") else schur, name)
            for name in (*WORK, "pcg_executed")}


def _counted(solver, cp):
    before = _counters()
    result = solver.optimize(cp)
    return result, {k: v - before[k] for k, v in _counters().items()}


def test_spans_nest_and_share_the_solve_id(ring):
    """Every span of one optimize call lies inside its parent and carries
    the id of its root, ``lm.solve``; the jit solve's host spans are
    ``lm.launch`` (the first holding ``lm.capture``), ``lm.read`` and
    ``lm.result`` (holding ``problem.values_dict``). A pause of Python's
    garbage collector is a span of its own inside the innermost."""
    profiling.set_tracing(True)
    _lm("python", linear_solver_type="sparse_cholesky").optimize(ring)
    _lm("jit", linear_solver_type="sparse_cholesky").optimize(ring)
    with profiling.span("test.outer"):
        gc.collect()
    spans = profiling.collect_trace()["spans"]
    by_id = {s["id"]: s for s in spans}
    outer, = [s for s in spans if s["name"] == "test.outer"]
    assert any(s["name"] == profiling.GC_SPAN and s["parent"] == outer["id"] for s in spans)
    spans = [s for s in spans
             if s["name"] not in ("test.outer", profiling.GC_SPAN, profiling.TRACER_SPAN)]
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["lm.solve", "lm.solve"]
    for s in spans:
        parent = by_id.get(s["parent"])
        if parent is None:
            assert s["solve"] == s["id"]
            continue
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
        assert s["solve"] == parent["solve"]
    jit = roots[1]["id"]
    names = {(s["name"], by_id[s["parent"]]["name"]) for s in spans
             if s["solve"] == jit and s["parent"] is not None}
    assert {("lm.launch", "lm.solve"), ("lm.capture", "lm.launch"), ("lm.read", "lm.solve"),
            ("lm.result", "lm.solve"), ("problem.values_dict", "lm.result"),
            ("banded.linearize", "lm.solve"), ("cr.eliminate", "lm.solve")} <= names
    python = {s["name"] for s in spans if s["solve"] == roots[0]["id"]}
    assert {"banded.assemble", "cr.dense_fold", "lm.trial_cost"} <= python
    assert "lm.read" not in python


def test_the_tracers_bookkeeping_is_a_span_of_its_own(ring):
    """Where a host span opens and where it closes, the tracer's own time
    is a ``tracer`` span in the span around it, ending where the span
    starts and starting where it ends: no program span holds it."""
    profiling.set_tracing(True)
    _lm("jit", linear_solver_type="sparse_cholesky").optimize(ring)
    spans = profiling.collect_trace()["spans"]
    tracer = [s for s in spans if s["name"] == profiling.TRACER_SPAN]
    program = [s for s in spans
               if s["name"] not in (profiling.TRACER_SPAN, profiling.GC_SPAN)]
    assert program and len(tracer) == 2 * len(program)
    opens = {(s["end_ns"], s["parent"]) for s in tracer}
    closes = {(s["start_ns"], s["parent"]) for s in tracer}
    for s in program:
        assert (s["start_ns"], s["parent"]) in opens
        assert (s["end_ns"], s["parent"]) in closes
    assert all(s["start_ns"] <= s["end_ns"] for s in tracer)
    idle = profiling.idle_by_span({**profiling.collect_trace(), "launches": []})
    assert idle[profiling.TRACER_SPAN] > 0


def test_a_trace_reports_the_counters_the_code_counts():
    """``graphs.count`` names its counter to the tracer on its first
    count; a trace reports the change of each named counter since the
    reset, and of ``graphs``' own."""
    work = {"test_tracing_units": 5}
    profiling.set_tracing(True)
    graphs.count(work, "test_tracing_units", 3)
    graphs.count(work, "test_tracing_units")
    counters = profiling.collect_trace()["counters"]
    assert counters["test_tracing_units"] == 4
    assert {"launches", "replays", "host_reads"} <= counters.keys()
    profiling.reset_trace()
    graphs.count(work, "test_tracing_units", 2)
    assert profiling.collect_trace()["counters"]["test_tracing_units"] == 2


def test_tracing_off_records_nothing(ring, monkeypatch):
    """With tracing off a solve enters no tracer code and records nothing,
    and a span opens ``record_function`` only under the torch profiler."""
    def refuse(*args):
        raise AssertionError("the tracer ran with tracing off")

    monkeypatch.setattr(profiling, "_enter", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    before = graphs.device_counts(torch.device("cpu"))
    _lm("jit", linear_solver_type="sparse_cholesky").optimize(ring)
    trace = profiling.collect_trace()
    assert trace["spans"] == trace["launches"] == trace["phases"] == []
    assert graphs.device_counts(torch.device("cpu")) == before
    monkeypatch.undo()
    with torch.profiler.profile() as prof:
        with profiling.span("test.span"):
            torch.ones(4).sum()
    assert "test.span" in {e.key for e in prof.key_averages()}
    assert profiling.collect_trace()["spans"] == []


@pytest.mark.parametrize("case", ["ba", "ring", "ring_refined"])
def test_jit_counts_python_modes_work(case, ba, ring, monkeypatch):
    """jit mode on the CPU (the step eager, PCG in masked chunks) counts
    the CR solves, refinements and retries and the PCG solves and live
    iterations that python mode counts on the same problem; both modes run
    PCG_CHUNK iterations per trip of the PCG loop, so they execute the same
    PCG iterations. ``ring_refined`` forces a refinement pass on every CR
    solve."""
    if case == "ring_refined":
        monkeypatch.setitem(banded.REFINE_RTOL, torch.float64, 1e-300)
    kw = (dict(linear_solver_type="schur_implicit", max_iterations=4, pcg_max_iterations=15)
          if case == "ba" else dict(linear_solver_type="sparse_cholesky"))
    cp = ba if case == "ba" else ring
    rp, python = _counted(_lm("python", **kw), cp)
    rj, jit = _counted(_lm("jit", **kw), cp)
    assert (rj.iterations, rj.status) == (rp.iterations, rp.status)
    assert {k: jit[k] for k in WORK} == {k: python[k] for k in WORK}
    if case == "ba":
        assert python["pcg_calls"] == rp.iterations and python["pcg_iterations"] > rp.iterations
        assert python["pcg_executed"] == jit["pcg_executed"]
        assert jit["pcg_executed"] % graphs.PCG_CHUNK == 0
        assert jit["pcg_executed"] >= jit["pcg_iterations"]
    else:
        assert python["cr_solves"] == rp.iterations
        refines = python["cr_solves"] if case == "ring_refined" else 0
        assert python["cr_refines"] == refines


def test_warmup_counts_nothing(ba, ring):
    """The warm-up form of a step (every branch masked, before a capture)
    adds to no counter."""
    for cp, kind in ((ba, "schur_implicit"), (ring, "sparse_cholesky")):
        solver = _lm("jit", linear_solver_type=kind)
        step, state = solver._make_device_step(cp), solver._make_device_init(cp)()
        before = _counters()
        with graphs.warmup_mode():
            step(*state)
        assert _counters() == before


class _CpuRecorder(graphs._Recorder):
    """Records the program tree and captures nothing: each graph an empty
    stand-in that keeps what was counted while it was open."""

    def __init__(self):
        super().__init__(pool=None)

    def begin_graph(self):
        self.counted = []

    def end_graph(self):
        self.append(graphs._Graph(None, 1, {}, tuple(self.counted)))


def test_recorded_counts_follow_the_device_counts():
    """``graphs.count`` in a recorded program adds nothing at capture; the
    tally adds each count once per execution of its graph: per launch at
    the top, per taken branch, per loop trip. Eager form counts as it
    runs; the warm-up form counts nothing."""
    work = {"n": 0}

    def program(*state):
        graphs.count(work, "n")

        def branch(x):
            graphs.count(work, "n", 10)
            return (x + 1,)

        def trip(x):
            graphs.count(work, "n", 100)
            return (x + 1,)

        x = graphs.cond_update(state[0] < 1, branch, *state)
        x = graphs.while_update(lambda x: x < 5, trip, 8, *x)
        return graphs.assign(state, x)

    tree = graphs.record(program, (torch.zeros(()),), _CpuRecorder())
    assert work["n"] == 0
    slots = iter(range(8))
    for item in tree:
        if not isinstance(item, graphs._Graph):
            item.slot = next(slots)
    # two launches: the branch taken once, the loop's trips 4 and 5
    graphs._tally(tree, 2, [[1, 0], [9, 0]])
    assert work["n"] == 2 * 1 + 1 * 10 + 9 * 100
    work["n"] = 0
    program(torch.zeros(()))
    assert work["n"] == 1 + 10 + 4 * 100
    work["n"] = 0
    with graphs.warmup_mode():
        program(torch.zeros(()))
    assert work["n"] == 0


def _span(name, start, end, id_, parent=None):
    return dict(name=name, start_ns=start, end_ns=end, id=id_, parent=parent,
                solve=1 if id_ < 6 else 6)


FABRICATED = {
    "spans": [_span("lm.launch", 0, 10, 2, 1), _span("lm.read", 10, 60, 3, 1),
              _span("problem.values_dict", 70, 90, 5, 4), _span("lm.result", 60, 95, 4, 1),
              _span("lm.solve", 0, 100, 1), _span("lm.solve", 120, 150, 6)],
    "launches": [dict(device=0, start_ns=5, end_ns=50, solve=1),
                 dict(device=0, start_ns=125, end_ns=150, solve=6)],
    "phases": [dict(device=0, path="schur.pcg", name="schur.pcg", parent=None, total_ns=30,
                    count=2, first_ns=6, last_ns=149)],
    "counters": {"pcg_iterations": 7}, "anchors": {0: dict(host_ns=0, uncertainty_ns=3)},
    "dropped": {"spans": 0, "launches": 0, "phases": 0},
}


def test_idle_by_span_on_a_fabricated_trace():
    """Idle stretches (outside the launches) go to the innermost span over
    them; what no span covers to ``NO_SPAN``."""
    idle = profiling.idle_by_span(FABRICATED)
    want = {"lm.launch": 5, "lm.read": 10, "lm.result": 15, "problem.values_dict": 20,
            "lm.solve": 10, profiling.NO_SPAN: 20}
    assert idle.keys() == want.keys()
    for name, ns in want.items():
        assert idle[name] == pytest.approx(ns * 1e-9, rel=1e-12)


def test_chrome_trace_of_a_fabricated_trace(tmp_path):
    """One complete event per span, launch and phase, on one clock from
    the trace's first time, with the anchors and counters beside them."""
    path = profiling.export_chrome_trace(str(tmp_path / "t.json"), FABRICATED)
    doc = json.loads(open(path).read())
    events = doc["traceEvents"]
    assert len(events) == 6 + 2 + 1 and {e["ph"] for e in events} == {"X"}
    values_dict, = [e for e in events if e["name"] == "problem.values_dict"]
    assert (values_dict["ts"], values_dict["dur"]) == (0.07, 0.02)
    pcg, = [e for e in events if e["name"] == "schur.pcg"]
    assert pcg["args"] == {"total_ms": 30e-6, "count": 2} and pcg["pid"] == "cuda:0"
    assert doc["otherData"]["counters"] == {"pcg_iterations": 7}
    assert doc["otherData"]["anchors"]["0"]["uncertainty_ns"] == 3
