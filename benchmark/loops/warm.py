"""warm: one problem, built and compiled once, re-solved from the same
start in a closed loop by one caller. The set-up ends with one solve, which
captures and instantiates the program's CUDA graphs, so that the window
only replays them.

With ``--trace 1``, ``traced`` runs after the window has closed: a new
solver of the same compiled problem, captured with the program's tracing
on, so that its graphs stamp their phases on the device and keep their work
counts; re-solved for a while, then again from a reset for as long, which
is the pass the per-layer readers read (``Record.trace``)."""

import gc
import time

import torch

from harness import cell, program


def compared(spec, data, seed):
    """The problems whose answers the reference checks: the one problem."""
    return [data]


def window(spec, data, opts, device, seconds, seed, record, clock):
    """-> (t_window_start, [(data, answers)], attempted, failed)"""
    kind = spec["config"]["problem"]
    t0 = time.perf_counter()
    problem = program.build(kind, program.to_input(kind, data), spec["config"].get("build", {}))
    t1 = time.perf_counter()
    cp = program.compile_problem(problem, opts, device)
    record.compiled = cp
    cell.sync(device)
    t2 = time.perf_counter()
    lm = program.solver(opts)
    lm.optimize(cp)
    cell.sync(device)
    record.setup.update(build_s=t1 - t0, compile_s=t2 - t1,
                        warmup_s=time.perf_counter() - t2)
    sampler = cell.Sampler(seed, spec["traffic"].get("compare_sample", 4))
    answers = []
    if clock is not None:
        program.set_launch_hook(clock)
    t_start = time.perf_counter()
    try:
        while time.perf_counter() - t_start < seconds:
            reads = program.host_reads()
            t0 = time.perf_counter()
            result = lm.optimize(cp)
            cell.sync(device)
            wall = time.perf_counter() - t0
            ans = program.answer(result)
            record.solves.append({"wall_s": wall, "iterations": ans.iterations,
                                  "host_reads": program.host_reads() - reads})
            sampler.offer((len(answers), ans))
            answers.append(cell.strip(ans))
    finally:
        program.set_launch_hook(None)
    record.window_s = time.perf_counter() - t_start
    for i, ans in sampler.kept():
        answers[i] = ans
    return t_start, [(data, answers)], len(answers), 0


def _solve_for(lm, cp, device, seconds, solves):
    """Re-solve until ``seconds`` have passed and ``solves`` are done:
    -> (solves, LM iterations)."""
    n, iterations, t0 = 0, 0, time.perf_counter()
    while n < solves or time.perf_counter() - t0 < seconds:
        iterations += lm.optimize(cp).iterations
        cell.sync(device)
        n += 1
    return n, iterations


def traced(opts, device, record, seconds):
    """The traced pass over the window's compiled problem
    (``record.compiled``), its solver freed first: tracing on, a new solver
    whose first solve captures its graphs with stamps, at least ``seconds``
    and ``cell.TRACE_SOLVES`` solves, a reset, the same again, and the
    trace of that second stretch on ``record.trace`` with the capture
    solve's set-up spans (seconds by name). Nothing on a program without a
    tracer."""
    cp = record.compiled
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not program.set_tracing(True):
        return
    try:
        lm = program.solver(opts)
        lm.optimize(cp)
        cell.sync(device)
        setup = {}
        for s in program.collect_trace()["spans"]:
            setup[s["name"]] = setup.get(s["name"], 0.0) + (s["end_ns"] - s["start_ns"]) / 1e9
        _solve_for(lm, cp, device, seconds, cell.TRACE_SOLVES - 1)
        program.reset_trace()
        solves, iterations = _solve_for(lm, cp, device, seconds, cell.TRACE_SOLVES)
        trace = program.collect_trace()
    finally:
        program.set_tracing(False)
    record.trace = {"trace": trace, "solves": solves, "iterations": iterations, "setup": setup}
