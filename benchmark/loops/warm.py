"""warm: one problem, built and compiled once, re-solved from the same
start in a closed loop by one caller. The set-up ends with one solve, which
captures and instantiates the program's CUDA graphs, so that the window
only replays them."""

import time

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
