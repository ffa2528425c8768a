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

``camera --host`` keeps every loop and branch on the host: the same steps
replayed as plain PyTorch CUDA graphs, no conditional node. ``grid20
--root DIR`` imports ``apex_tpu_torch`` from DIR (an older checkout) and
times python mode there too, with one potrf, against the panel
Cholesky of ``linalg/banded.py`` where DIR has one. Each prints one JSON
object per result and a process that faults exits non-zero, so a fault
ends only its own probe.
"""

import json
import os
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


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_probe: needs a CUDA card")
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
