"""Probes of jit mode's device loop on one CUDA card, run one per process:

    python3 chip_probe.py toy [LAUNCHES]      # a parent graph with IF / WHILE
                                              # nodes under torch.profiler
    python3 chip_probe.py camera [--host]     # chip_smoke's camera_full phase
                                              # with every jit solve profiled
    python3 chip_probe.py grid20 [--root DIR] # the 20^3 lattice, python and
                                              # jit mode: seconds and memory
    python3 chip_probe.py small               # two small jit solves (BA
                                              # implicit, pcg), to run under
                                              # a memory checker
    python3 chip_probe.py trace CELL [SECONDS] [--seed N]
                                              # a benchmark cell's warm loop
                                              # traced (utils.profiling)
    python3 chip_probe.py trace_cost CELL [SECONDS]
                                              # the tracer's cost, in turns
                                              # in one process

``camera --host`` keeps every loop and branch on the host: the same steps
replayed as plain PyTorch CUDA graphs, no conditional node. ``grid20
--root DIR`` imports ``apex_tpu_torch`` from DIR (an older checkout) and
times python mode there too, with one potrf, against the panel
Cholesky of ``linalg/banded.py`` where DIR has one. ``trace`` builds a
cell of ``BENCHMARK.json`` with the benchmark's own generator and program
calls (``benchmark/harness``, read, not changed), switches tracing on before
the build, solves once (the capture), then re-solves for SECONDS (default
30) and reports the set-up's spans, the stamped phases per LM iteration,
the device's idle time by host span, the work counters and the anchor;
the parent-graph launches are timed by the tracer's own CUDA events, as
the benchmark's ``graph_ms_per_iter`` times them by its launch hook.
``trace_summary`` computes what the benchmark's traced per-layer metrics
would read; it goes once the benchmark has readers of its own, which must
give its numbers. ``trace_cost`` builds the cell once, captures it for two
solvers, one with tracing off and one with it on (stamps in its graphs),
and solves with each in turns for SECONDS each: the first with tracing off
for its host time and with tracing on (its graphs hold no stamp) for its
launches' device time, the second with tracing on. Each prints one JSON
object per result and a process that faults exits non-zero, so a fault
ends only its own probe.
"""

import argparse
import collections
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_kernels():
    from apex_tpu_torch.kernels import graph_conditional as gc
    from apex_tpu_torch.kernels import landmark_blocks as lb
    from apex_tpu_torch.kernels import spd_inverse as spd

    for m in (lb, spd, gc):
        m.build()


def probe_toy(launches):
    """The IF / WHILE program of tests/test_torch_cuda.py's parent-graph
    test (cuSOLVER, cuBLAS and index_add_ in an IF; a WHILE holding an IF),
    launched ``launches`` times under torch.profiler, each launch's values
    held to the eager program's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.optim import graphs

    def program(*state):
        x, y, c = state

        def heavy(x, y, c):
            M = x.reshape(8, 4, 4)
            L, _ = torch.linalg.cholesky_ex(M @ M.mT + torch.eye(4, dtype=x.dtype, device=x.device))
            z = torch.linalg.solve_triangular(L, y.reshape(8, 4, 1), upper=False).reshape(-1)
            w = torch.zeros_like(y).index_add_(0, torch.arange(32, device=x.device) % 7, z)
            return x * 0.5, w, c + 1

        x, y, c = graphs.cond_update(c < 100, heavy, x, y, c)

        def body(x, y, c):
            x, y, c = graphs.cond_update(c % 2 == 0, lambda x, y, c: (x + 1, y, c), x, y, c)
            return x * 0.9, y, c + 1

        x, y, c = graphs.while_update(lambda x, y, c: c < 10, body, 50, x, y, c)
        return graphs.assign(state, (x, y, c))

    gen = torch.Generator().manual_seed(0)
    start = (torch.randn(128, generator=gen, dtype=torch.float64).cuda(),
             torch.randn(32, generator=gen, dtype=torch.float64).cuda(),
             torch.zeros((), dtype=torch.int64, device="cuda"))
    want = program(*(t.clone() for t in start))
    state = tuple(t.clone() for t in start)
    cap = graphs.Captured(program, state, torch.cuda.graph_pool_handle())
    worst = 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            for t, t0 in zip(state, start):
                t.copy_(t0)
            cap.launch()
            torch.cuda.synchronize()
            worst = max(worst, max(float((a - b).abs().max()) for a, b in zip(state, want)))
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    emit(dict(probe="toy", launches=launches, max_abs_err=worst, device_events=len(device),
              parts=[type(p).__name__ for p in cap.parts]))


def probe_camera(host):
    """chip_smoke's camera_full phase with every jit solve that it times by
    CUDA events run under torch.profiler instead (as the smoke did before);
    ``host``: every loop and branch kept on the host."""
    import chip_smoke
    from apex_tpu_torch.optim import graphs, lm

    build_kernels()

    def profiled(solve):
        box = []
        out = chip_smoke.profile_solve(lambda: box.append(solve()) or box[-1])
        emit(dict(probe="camera", host=host, iterations=out["iterations"],
                  device_events=out["device_events"],
                  landmark_kernel_events=out["landmark_kernel_events"],
                  device_idle_share=out["device_idle_share"], wall_seconds=out["wall_seconds"]))
        return box[0], out["wall_seconds"], out["device_busy_seconds"]

    chip_smoke.graph_span_solve = profiled
    if host:
        device_program = lm.device_program

        def on_host(*args, **kw):
            args = list(args)
            if len(args) > 7:
                args[7] = args[7] or "probe: host loop"
            else:
                kw["host"] = kw.get("host") or "probe: host loop"
            return device_program(*args, **kw)

        lm.device_program = on_host
        graphs._Branch.host = "probe: host branch"
        # the device loop's bound on host reads does not apply
        chip_smoke.check_host_reads = lambda *args: None
    t0 = time.perf_counter()
    launches, iterations = chip_smoke.phase_camera_full()
    emit(dict(probe="camera", host=host, done=True, launches=launches, iterations=iterations,
              seconds=time.perf_counter() - t0))


def probe_grid20(root):
    """The 20^3 lattice (20,262-column core) through ``sparse_cholesky``,
    f64, bench.py's settings: per mode a first solve, then two timed; the
    graph pool's reserved bytes after jit's first solve."""
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.io import synthetic
    from apex_tpu_torch.optim import graphs

    cp = synthetic.synthetic_pose_graph_grid3d(20, 20, 20, seed=0).to_problem().compile(
        dtype=torch.float64, device="cuda")
    variants = [("python", False), ("jit", False)]
    if hasattr(graphs, "recording"):
        variants.insert(1, ("python", True))
    recording = getattr(graphs, "recording", None)
    for mode, panels in variants:
        if panels:
            graphs.recording = lambda: True
        solver = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_cholesky", damping="auto", mode=mode,
            max_iterations=100, cost_tolerance=1e-4))
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        first = solver.optimize(cp)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        pool = torch.cuda.memory_reserved() - reserved
        seconds = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            t0 = time.perf_counter()
            res = solver.optimize(cp)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        emit(dict(probe="grid20", root=root, mode=mode, panels_in_python=panels,
                  iterations=res.iterations, status=res.status.name,
                  final_cost=res.final_cost, first_final_cost=first.final_cost,
                  first_solve_seconds=first_s, solve_seconds=seconds,
                  reserved_after_first_mib=pool / 2 ** 20,
                  max_allocated_mib=torch.cuda.max_memory_allocated() / 2 ** 20))
        if recording is not None:
            graphs.recording = recording
        del solver, first, res
        torch.cuda.empty_cache()


def probe_small():
    """Two small jit solves, BA ``schur_implicit`` (the landmark and SPD
    kernels inside WHILE bodies) and the medium SE2 fixture through
    ``pcg``, each twice."""
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.ba import build_ba_problem
    from apex_tpu_torch.io import synthetic

    build_kernels()
    ds = synthetic.synthetic_ba_large(n_cameras=20, n_points=2000, obs_per_camera=300, seed=0)
    cfg = apx.LevenbergMarquardtConfig.for_bundle_adjustment()
    cfg.linear_solver_type, cfg.mode = "schur_implicit", "jit"
    cp = build_ba_problem(ds, mode="self_calibration").compile(dtype=torch.float64,
                                                                device="cuda")
    solver = apx.LevenbergMarquardt(cfg)
    for _ in range(2):
        res = solver.optimize(cp)
        emit(dict(probe="small", solve="ba schur_implicit", iterations=res.iterations,
                  status=res.status.name, final_cost=res.final_cost))
    cp = apx.load_g2o(os.path.join(REPO, "tests/fixtures/medium_se2_300.g2o")).to_problem() \
        .compile(dtype=torch.float64, device="cuda")
    solver = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="pcg", mode="jit", max_iterations=100, cost_tolerance=1e-4))
    for _ in range(2):
        res = solver.optimize(cp)
        emit(dict(probe="small", solve="medium_se2_300 pcg", iterations=res.iterations,
                  status=res.status.name, final_cost=res.final_cost))


def _ms(span):
    return (span["end_ns"] - span["start_ns"]) / 1e6


def trace_summary(cell, setup, trace, iterations, solves):
    """The traced numbers of ``probe_trace``: per-phase device ms per LM
    iteration, idle seconds by span, the set-up's spans and what the
    benchmark's traced metrics would read."""
    from apex_tpu_torch.utils import profiling

    phases = {p["path"]: dict(ms_per_iter=p["total_ns"] / 1e6 / iterations,
                              per_iter=p["count"] / iterations) for p in trace["phases"]}

    def ms(*names):
        return sum(phases[n]["ms_per_iter"] for n in names if n in phases)

    top = sum(v["ms_per_iter"] for k, v in phases.items() if ">" not in k)
    idle = profiling.idle_by_span(trace)
    inside = sum(v for k, v in idle.items() if k != profiling.NO_SPAN)
    unnamed = idle.get("lm.solve", 0.0)
    tracer = idle.get(profiling.TRACER_SPAN, 0.0)
    results = [_ms(s) for s in trace["spans"] if s["name"] == "lm.result"]
    # a counter that never counted is not in the trace
    work = collections.defaultdict(int, trace["counters"])
    bundle = "ba_" in cell
    if bundle:
        linearize = ms("schur.assemble")
        linear = ms("schur.precondition", "schur.pcg", "schur.back_substitute")
    else:
        linearize = ms("banded.linearize", "banded.assemble")
        linear = sum(v["ms_per_iter"] for k, v in phases.items()
                     if ">" not in k and k.startswith("cr."))
    metrics = dict(result_ms=sum(results) / len(results),
                   capture_s=setup.get("lm.capture"),
                   linearize_ms_per_iter=linearize, linear_solve_ms_per_iter=linear)
    if bundle:
        metrics.update(pcg_iters_per_lm_iter=work["pcg_iterations"] / iterations,
                       pcg_masked_share=100.0 * (work["pcg_executed"] - work["pcg_iterations"])
                       / work["pcg_executed"],
                       # the share of the assembled rows the assembly kernels took
                       assemble_kernel_row_share=100.0 * work["assemble_kernel_rows"]
                       / max(work["assemble_rows"], 1))
    else:
        metrics["cr_extra_solves_share"] = (100.0 * (work["cr_refines"] + work["cr_retries"])
                                            / work["cr_solves"])
    # host gaps inside each solve that no child span covers: before the
    # first child, between children, after the last (us)
    children = {}
    for s in trace["spans"]:
        if s["parent"] is not None and s["name"] not in (profiling.GC_SPAN,
                                                         profiling.TRACER_SPAN):
            children.setdefault(s["parent"], []).append(s)
    gaps = {"before": [], "between": [], "after": []}
    for root in (s for s in trace["spans"] if s["name"] == "lm.solve"):
        kids = sorted(children.get(root["id"], []), key=lambda s: s["start_ns"])
        if kids:
            gaps["before"].append(kids[0]["start_ns"] - root["start_ns"])
            gaps["after"].append(root["end_ns"] - kids[-1]["end_ns"])
            gaps["between"] += [b["start_ns"] - a["end_ns"] for a, b in zip(kids, kids[1:])]
    solve_gaps_us = {k: dict(median=statistics.median(v) / 1e3, max=max(v) / 1e3,
                             total=sum(v) / 1e3) for k, v in gaps.items() if v}
    return dict(metrics=metrics, setup_spans_s=setup, stamped_ms_per_iter=top, phases=phases,
                solve_gaps_us=solve_gaps_us,
                idle_s=idle, idle_inside_solves_s=inside,
                # the program's spans, without and with the tracer's own
                idle_named_share=(inside - unnamed - tracer) / inside if inside else None,
                idle_named_share_with_tracer=(inside - unnamed) / inside if inside else None,
                work_per_solve={k: v / solves for k, v in trace["counters"].items()},
                anchors=trace["anchors"], dropped=trace["dropped"])


def probe_trace(cell, seconds, seed, device="cuda", spec=None):
    """A benchmark cell's warm loop (``benchmark/loops/warm.py``'s calls),
    traced from before the build."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from harness import cell as bench_cell
    from harness import generators, program

    from apex_tpu_torch.utils import profiling

    spec = spec or bench_cell.load(REPO, cell)
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    data = generators.make(spec["config"]["generator"], seed)
    opts = bench_cell.solver_options(spec, data)
    kind = spec["config"]["problem"]
    profiling.set_tracing(True)
    try:
        problem = program.build(kind, program.to_input(kind, data),
                                spec["config"].get("build", {}))
        cp = program.compile_problem(problem, opts, device)
        lm = program.solver(opts)
        sync()
        reserved = torch.cuda.memory_reserved(device) if cuda else 0
        lm.optimize(cp)
        sync()
        out = dict(probe="trace", cell=cell, seed=seed,
                   graph_pool_reserved_gib=((torch.cuda.memory_reserved(device) - reserved)
                                            / 2**30 if cuda else None))
        setup = {}
        for s in profiling.collect_trace()["spans"]:
            if s["name"] not in ("lm.solve", profiling.TRACER_SPAN):
                setup[s["name"]] = setup.get(s["name"], 0.0) + _ms(s) / 1e3
        profiling.reset_trace()
        walls, iterations = [], 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            t0 = time.perf_counter()
            res = lm.optimize(cp)
            sync()
            walls.append(time.perf_counter() - t0)
            iterations += res.iterations
        window = time.perf_counter() - t_start
        trace = profiling.collect_trace()
    finally:
        profiling.set_tracing(False)
    graph_s = sum(x["end_ns"] - x["start_ns"] for x in trace["launches"]) / 1e9
    out.update(solves=len(walls), window_s=window, solve_s=window / len(walls),
               lm_iters=iterations / len(walls), graph_ms_per_iter=1e3 * graph_s / iterations,
               outside_graph_share=100.0 * (1.0 - graph_s / sum(walls)))
    out.update(trace_summary(cell, setup, trace, iterations, len(walls)))
    out["stamped_share_of_graph"] = (out["stamped_ms_per_iter"] / out["graph_ms_per_iter"]
                                     if graph_s else None)
    emit(out)


def probe_trace_cost(cell, seconds, seed=2**31 + 17):
    """The tracer's cost on a benchmark cell in one process: the problem
    built once and captured by two solvers, ``off`` with tracing off (no
    stamps in its graphs) and ``on`` with it on; then, in turns for
    ``seconds`` of each side: ``off`` with tracing off (its host seconds
    per solve), ``off`` with tracing on (its parent graphs' device ms per
    LM iteration, from the tracer's CUDA events around each launch, as
    ``graph_ms_per_iter``: no stamps), and ``on`` with tracing on (both)."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from harness import cell as bench_cell
    from harness import generators, program

    from apex_tpu_torch.utils import profiling

    spec = bench_cell.load(REPO, cell)
    device = torch.device("cuda")
    data = generators.make(spec["config"]["generator"], seed)
    opts = bench_cell.solver_options(spec, data)
    kind = spec["config"]["problem"]
    problem = program.build(kind, program.to_input(kind, data), spec["config"].get("build", {}))
    cp = program.compile_problem(problem, opts, device)
    solvers = {"off": program.solver(opts), "on": program.solver(opts)}
    for side, lm in solvers.items():
        profiling.set_tracing(side == "on")
        lm.optimize(cp)
        torch.cuda.synchronize()
    profiling.set_tracing(False)
    walls = {side: [] for side in solvers}
    graph_ns = dict.fromkeys(solvers, 0)
    iterations = dict.fromkeys(solvers, 0)

    def solve(side, traced):
        profiling.set_tracing(traced)
        try:
            t0 = time.perf_counter()
            res = solvers[side].optimize(cp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = profiling.collect_trace()["launches"] if traced else []
        finally:
            profiling.set_tracing(False)
        return res, wall, sum(x["end_ns"] - x["start_ns"] for x in launches)

    while min(sum(w) for w in walls.values()) < seconds:
        _, wall, _ = solve("off", False)
        walls["off"].append(wall)
        res, _, ns = solve("off", True)
        graph_ns["off"] += ns
        iterations["off"] += res.iterations
        res, wall, ns = solve("on", True)
        walls["on"].append(wall)
        graph_ns["on"] += ns
        iterations["on"] += res.iterations
    out = dict(probe="trace_cost", cell=cell, seed=seed)
    for side in solvers:
        out[side] = dict(solves=len(walls[side]),
                         solve_s_median=statistics.median(walls[side]),
                         solve_s_mean=sum(walls[side]) / len(walls[side]),
                         graph_ms_per_iter=graph_ns[side] / 1e6 / iterations[side])
    emit(out)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_probe: needs a CUDA card")
    if argv[0] in ("trace", "trace_cost"):
        p = argparse.ArgumentParser(prog=f"chip_probe.py {argv[0]}")
        p.add_argument("cell")
        p.add_argument("seconds", nargs="?", type=float, default=30.0)
        p.add_argument("--seed", type=int, default=2**31 + 17)
        args = p.parse_args(argv[1:])
        if argv[0] == "trace_cost":
            return probe_trace_cost(args.cell, args.seconds, args.seed)
        return probe_trace(args.cell, args.seconds, args.seed)
    root = REPO
    if "--root" in argv:
        root = os.path.abspath(argv[argv.index("--root") + 1])
    sys.path.insert(0, root)
    if root != REPO:
        sys.path.insert(1, REPO)
    what = argv[0]
    if what == "toy":
        probe_toy(int(argv[1]) if len(argv) > 1 else 20)
    elif what == "camera":
        probe_camera("--host" in argv)
    elif what == "grid20":
        probe_grid20(root)
    elif what == "small":
        probe_small()
    else:
        raise SystemExit(f"chip_probe: unknown probe {what}")


if __name__ == "__main__":
    main(sys.argv[1:])
