#!/usr/bin/env python3
"""Drive the PyTorch port's bundle-adjustment paths (implicit and explicit
Schur) and pose-graph paths (SE3, SE2, the robust-loss sweep with a prior,
the dense solvers, Gauss-Newton and DogLeg, sparse_qr, pcg, covariances,
the general-sparsity tier), lens self-calibration through the 8 camera
models, and pose graphs on the extended Lie groups once on one CUDA card,
in python mode and in ``mode="jit"`` (replayed CUDA graphs; phases 19-28).

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order,
each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: compile the landmark-block kernel from ``apex_tpu_torch/csrc``, and
   its launch configuration per dtype (tile, stages, residency, registers);
3. kernel: the CUDA landmark-block inverse against its plain PyTorch version
   on the card, at P = 65,132 (trafalgar's landmarks) and 993,923 (venice's),
   f32 and f64: bitwise equal, and timed (see ``phase_kernel``);
4. small-slice parity: ``synthetic_ba(8, 150, seed=0)`` solved exactly in
   f64 on the card and on the CPU: same iterations and status, final cost
   within rtol 1e-8 (CUDA index_add_ sums in atomic order, ~1e-15 apart);
5. full slice: the trafalgar-scale synthetic through ``build_ba_problem`` ->
   ``LevenbergMarquardt(for_bundle_adjustment())``, 10 iterations, in f64
   and in f32: finite cost, RMSE below 0.55x the initial, and at least one
   kernel launch per LM iteration;
6. pose-graph parity: ``tests/fixtures/medium_se3_250.g2o`` through
   ``sparse_cholesky`` in f64 on the card and on the CPU: both reach the
   certified 5.132992631561506e-01 (rtol 1e-8) in 6 LM iterations;
7. pose-graph full: the 2,500-pose / 50-ring synthetic sphere (sphere2500's
   shape) through ``Graph.to_problem`` -> LM ``sparse_cholesky``,
   ``damping="auto"``, ``cost_tolerance=1e-4``, in f64 then f32. Gates:
   converged with the cost reduced by more than 99%; in f64 also the JAX
   package's constants, initial cost 1830.5367061422921 (rtol 1e-10) and
   final 8.594121916326808 (rtol 1e-8) in 4 iterations. Each dtype is
   solved three times: the first solve (plan, library warm-up) is timed
   apart, the second runs under ``torch.profiler`` for the device busy
   share, the device events per LM iteration, the top device ops and the
   device time of the ``banded.*``/``cr.*``/``lm.*`` spans, and the third
   is the timed one;
8. SE2 parity: ``tests/fixtures/medium_se2_300.g2o`` in f64 through
   ``sparse_cholesky``, ``dense_cholesky`` and ``dense_qr``, on the card
   and on the CPU: each reaches the certified 5.668402411723587e-02 (rtol
   1e-8) in 9 LM iterations;
9. SE2 full: the M3500-shaped graph (``synthetic_pose_graph_2d(3500,
   "manhattan", loop_stride=2, seed=0)``, bench.py's m3500 rung) as phase
   7, f64 then f32, gated on convergence with more than 95% reduction and
   in f64 on the JAX package's 970.2833556685312 -> 0.6377173960659416 in
   6 iterations; then one f64 ``dense_cholesky`` solve of it (a dense H of
   10,500^2 entries), converged and within rtol 1e-6 of the banded cost;
10. robust sweep: the parking-garage-shaped SE3 graph (1,661 poses, 30
    rings, closures 1-3 rings apart) with each of the JAX package's 10
    sweep losses on every edge and a ``ManifoldPriorFactor`` on the first
    pose, f64, ``sparse_cholesky``: converged with the final cost below
    0.6x the initial; L2, Huber(1.0) and Cauchy(1.0) also at the JAX
    package's constants in 4 iterations;
11. explicit-Schur parity: ``synthetic_ba(8, 150)`` through
    ``schur_explicit`` on the card and the CPU (same iterations, rtol 1e-8),
    and within rtol 1e-6 of ``dense_cholesky`` and of the exact implicit
    solve on the card;
12. explicit-Schur full: phase 5's problem through ``schur``, f64 and f32,
    three solves each with a profile over the ``schur.*`` spans. Gates: the
    explicit variant chosen, RMSE below 0.55x, f64 within 2% of the
    implicit solve's, one kernel launch per LM iteration;
13. optimizers: DogLeg and Gauss-Newton on the sphere within rtol 1e-6 of
    LM's cost, and card against CPU on the medium SE3 fixture;
14. small solvers: ``sparse_qr`` and ``pcg`` at both medium fixtures'
    certified costs, then ``sparse_qr`` on the M3500-shaped graph and the
    sphere at the JAX package's constants;
15. covariances: card against CPU on the medium fixture (1e-8), the banded
    route against the dense one on the sphere (1e-6);
16. general parity: the 6x6x4 lattice (``synthetic_pose_graph_grid3d``,
    seed 1) through LM ``sparse_general`` with a dense core of at most 8
    blocks, so with elimination levels, on the card and the CPU (same
    iterations and status, rtol 1e-8); the medium SE3 fixture through
    ``sparse_general`` on the card at its certified cost;
17. general full: the 12^3 lattice (bench.py's grid3d rung: 1,728 poses,
    4,752 edges) through LM ``sparse_general``, ``damping="auto"``,
    ``cost_tolerance=1e-4``, f64 then f32, three solves each as phase 7
    with a profile over the ``general.*`` spans. Gates: converged with more
    than 50% reduction; in f64 the JAX package's 174.42628102979307 ->
    10.614117258370733 in 3 iterations; f32 within one iteration and 1% of
    f64. Prints the plan (levels, p and q per level, fill, R and R·d, plan
    seconds), retry stages and the per-LM-iteration time against the
    1,728-pose sphere through ``sparse_cholesky`` (bench.py's ratio);
18. general auto: the 20^3 lattice (8,000 poses, D = 48,000) through LM
    ``sparse_cholesky``, f64: its block bandwidth is above 1536, so the
    solve must take the general tier with a healthy plan whose core has the
    JAX package's 3,377 blocks, and converge with more than 50% reduction.
    Prints the plan, the solve seconds and the peak memory of the dense
    core (20,262 columns);
19. jit parity: the medium SE3 fixture in ``mode="jit"`` on the card
    against the CPU (same iterations and status, rtol 1e-8, certified); then
    both medium fixtures through DogLeg, ``sparse_qr``, ``pcg`` and
    ``sparse_general`` in jit mode, card against CPU: the same iterations
    and status, final costs within rtol 1e-10 (or 10x python mode's own
    spread over three solves on the card), the certified costs (1e-8);
20. jit pose graphs: the sphere and the M3500-shaped graph through LM
    ``sparse_cholesky`` (bench.py's settings) and Gauss-Newton on the
    sphere, f64 then f32; 21. jit general: the 12^3 lattice through
    ``sparse_general`` (f64 at the JAX package's 174.42628102979307 ->
    10.614117258370733 in 3 iterations) beside the 1,728-pose sphere
    through ``sparse_cholesky`` (bench.py's ratio of seconds per LM
    iteration, and the ladder stages of both modes), f64 then f32, and the
    20^3 lattice through ``sparse_cholesky``, f64, which must switch to the
    general tier in jit mode; 22. jit DogLeg on the sphere and the
    M3500-shaped graph (f64: python mode's reused steps too); 23. jit small
    solvers: LM ``sparse_qr`` on the sphere and the M3500-shaped graph (f64
    at the JAX package's constants), LM ``pcg`` on the medium SE2 fixture
    and GN ``sparse_qr`` on the medium SE3 fixture with its first pose
    fixed (f64 at the certified costs); 24. jit BA: the trafalgar-scale synthetic through ``schur`` and
    ``schur_implicit``, 10 iterations, f64 then f32. Each of 20-24 beside
    three python-mode solves of the same compiled problem (the last
    timed): f64 must give python mode's iterations, status and final cost
    (rtol 1e-10; 1e-8 for GN on the gauge-free sphere and 1e-7 for the
    explicit BA solve, where python mode's own solves spread by up to 4e-10
    and 1e-8: ``index_add_`` sums in atomic order, and the undamped GN
    solve and the Cholesky of S magnify it; or 10x python mode's spread
    over its three solves where that is larger); f32 the phase's quality
    gate. Each prints the first-solve (state, warm-up, capture),
    capture and timed-solve seconds, graphs, replays and host reads per LM
    iteration, the device-idle share (profiled, and the profiled solve's
    device time against the timed solve's wall time), device events per LM
    iteration, peak memory and the graph memory kept reserved; in the BA
    phases the landmark kernel runs at least once per LM iteration inside
    the replayed graphs, counted by name in the profile;
25. camera parity: tests/test_camera_selfcal.py's scene and problem (6
    cameras, 120 points, one shared intrinsics variable, ``HuberLoss(2.0)``)
    for its 7 models through ``schur_implicit`` with its config, f64, python
    and jit mode on the card against the CPU (same iterations and status,
    rtol 1e-8, focal within 1%), and DogLeg with covariances (pinhole);
26. camera full: a 257-camera, 65,132-point, 225,903-observation ring
    (``selfcal_ring``: bench's trafalgar rung's shape, every point seen by
    3 or 4 cameras from around the ring) with one intrinsics
    variable per camera refined as COLMAP's bundle adjuster does by
    default (``RING_FIXED``: the principal point held), for the pinhole and
    the 7 extended models (the extended ones with autodiff Jacobians),
    through ``schur`` (explicit) and ``schur_implicit``, up to 20 LM
    iterations, jit beside python mode in f64, Kannala-Brandt in f32 too:
    RMSE below 0.55x, jit equal to python mode (iterations, status, and
    rtol 1e-7 explicit, 1e-10 implicit, or 10x python mode's spread), the
    landmark kernel once per LM iteration and in the jit profile;
    prints s per LM iteration, the idle share and the camera spans' share
    of the device time;
27. lie full: Sim3 and SE23 pose graphs on sphere2500's edges
    (``lifted_sphere``) through LM ``sparse_cholesky``, f64, as phase 20;
28. lie small: tests/test_extended_manifolds_e2e.py's SGal3 chain and the
    Rosenbrock ``AutoDiffFactor`` (LM, GN, DogLeg), python and jit mode on
    the card against the CPU.

The pose-graph paths launch no kernel of the port's own (the TPU reference
ran them in XLA, outside Pallas): the landmark-block kernel, the one hand
kernel, runs on the BA paths only (the BAL and the self-calibration ones).
Then the kernel summary line (the python-mode and camera launches, the jit
BA launches, each per LM iteration), and last
``{"ok": true, "device": {...}}``. It needs one card, and refuses to run
without one.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CALL_RUNS = 25  # single calls timed one by one (median)
TIMED_LAUNCHES = 100  # back-to-back launches between two events
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}  # H100 SXM, no tensor cores
# operations per block in csrc/landmark_blocks.cu, each division, sqrt, acos
# and cos counted as one
OPS_PER_BLOCK = 105


def emit(obj):
    print(json.dumps(obj), flush=True)


def kernel_blocks(n, seed=0):
    """The JAX package's kernel-test recipe: random SPD blocks plus a
    near-singular, a zero and a 1e12-scaled block."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 3, 3))
    H = A @ np.transpose(A, (0, 2, 1)) + 0.1 * np.eye(3)
    H[5] = np.diag([1e-15, 1.0, 1.0])
    H[17] = np.zeros((3, 3))
    H[100] *= 1e12
    return H


def median_ms(fn, x):
    """Median of CALL_RUNS single calls, each between two CUDA events: the
    host's work for the call and the kernel together."""
    import torch

    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(CALL_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_and_host_us(fn, copies):
    """(device us per launch, host us per call) of TIMED_LAUNCHES calls of
    ``fn`` over ``copies`` in turn. The calls are queued behind a sleeping
    kernel, so the card runs them back to back between the two events
    whatever the host's pace; the host clock around the same calls gives
    the host's time. The sleep doubles until the start event is still
    pending when the last call is queued."""
    import torch

    for x in copies:
        fn(x)
    torch.cuda.synchronize()
    cycles = 20_000_000
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(TIMED_LAUNCHES):
            fn(copies[i % len(copies)])
        host_s = time.perf_counter() - t0
        queued_in_time = not start.query()
        end.record()
        end.synchronize()
        if queued_in_time:
            return (start.elapsed_time(end) * 1e3 / TIMED_LAUNCHES,
                    host_s * 1e6 / TIMED_LAUNCHES)
        cycles *= 2


def bound_us(P, dtype_name):
    """The least time the card could take: each input and output byte moved
    once at the HBM rate, or the operations at the peak rate of the dtype,
    whichever is longer."""
    size = 8 if dtype_name == "float64" else 4
    bytes_us = 2 * 9 * size * P / HBM_BYTES_PER_S * 1e6
    ops_us = OPS_PER_BLOCK * P / PEAK_OPS_PER_S[dtype_name] * 1e6
    return (bytes_us, "bytes") if bytes_us >= ops_us else (ops_us, "operations")


def phase_kernel(P, dtype):
    """Bitwise agreement with the plain version, then the kernel's device
    time per launch (rotating over enough input copies to exceed the 50 MB L2
    at venice scale; one warm copy at trafalgar scale, as the solve finds
    Hpp right after writing it), the host time per call, the single-call
    time, the plain version's time, and the device time of a plain copy of
    the same inputs."""
    import torch

    from apex_tpu_torch.kernels import landmark_blocks as lb

    name = str(dtype).replace("torch.", "")
    H = torch.as_tensor(kernel_blocks(P), dtype=dtype).cuda()
    k = lb.invert_landmark_blocks(H)
    p = lb.invert_landmark_blocks_plain(H)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(k).all()):
        raise AssertionError(f"kernel output not finite (P={P}, {name})")
    max_abs = float((k - p).abs().max())
    if not torch.equal(k, p):
        raise AssertionError(f"kernel differs from plain (P={P}, {name}): max abs {max_abs}")
    # four copies of a venice-scale input (143 MB in f32) are far beyond L2
    copies = [H] + ([H.clone() for _ in range(3)] if P > 65_132 else [])
    device_us, host_us = device_and_host_us(lb.invert_landmark_blocks, copies)
    # the same bytes read and written by a plain copy: the rate this card
    # streams in practice, a yardstick beside the bound (not the same function)
    copy_us, _ = device_and_host_us(torch.clone, copies)
    bound, bound_by = bound_us(P, name)
    out = dict(phase="kernel", P=P, dtype=name, max_abs_err=max_abs, bitwise=True,
               device_us=device_us, bound_us=bound, bound_by=bound_by,
               share=bound / device_us, copy_us=copy_us, host_us=host_us,
               call_ms=median_ms(lb.invert_landmark_blocks, H),
               plain_ms=median_ms(lb.invert_landmark_blocks_plain, H),
               copies=len(copies), launches_timed=TIMED_LAUNCHES, call_runs=CALL_RUNS)
    emit(out)
    return out


def phase_small_parity():
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.ba import build_ba_problem
    from apex_tpu_torch.io import synthetic

    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    problem = build_ba_problem(ds, mode="self_calibration")
    results = {}
    for device in ("cuda", "cpu"):
        cfg = apx.LevenbergMarquardtConfig(
            linear_solver_type="schur_implicit", max_iterations=30, pcg_forcing=False,
            pcg_tolerance=1e-10, pcg_max_iterations=500)
        results[device] = apx.LevenbergMarquardt(cfg).optimize(
            problem.compile(dtype=torch.float64, device=device))
    rc, rh = results["cuda"], results["cpu"]
    if (rc.iterations, rc.status) != (rh.iterations, rh.status):
        raise AssertionError(f"cuda {rc.summary()} vs cpu {rh.summary()}")
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)
    emit(dict(phase="small_parity", iterations=rc.iterations, status=rc.status.name,
              cost_cuda=rc.final_cost, cost_cpu=rh.final_cost,
              rel_diff=abs(rc.final_cost - rh.final_cost) / rh.final_cost))


def phase_full_slice():
    """The implicit solve of the trafalgar-scale synthetic: (dataset,
    problem, kernel launches, LM iterations, {dtype: final RMSE})."""
    import math

    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.ba import build_ba_problem, rmse
    from apex_tpu_torch.io import synthetic
    from apex_tpu_torch.kernels import landmark_blocks as lb

    t0 = time.perf_counter()
    ds = synthetic.synthetic_ba_large(n_cameras=257, n_points=65_132, obs_per_camera=879,
                                      seed=0)
    problem = build_ba_problem(ds, mode="self_calibration")
    emit(dict(phase="full_slice_build", cameras=ds.num_cameras, points=ds.num_points,
              observations=ds.num_observations, seconds=time.perf_counter() - t0))
    lb.launches = 0
    total = iterations = 0
    implicit = {}
    for dtype in (torch.float64, torch.float32):
        t0 = time.perf_counter()
        cp = problem.compile(dtype=dtype, device="cuda")
        compile_s = time.perf_counter() - t0
        cfg = apx.LevenbergMarquardtConfig.for_bundle_adjustment()
        cfg.max_iterations = 10
        before = lb.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = apx.LevenbergMarquardt(cfg).optimize(cp)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = lb.launches - before
        total += launched
        iterations += res.iterations
        r0 = rmse(res.initial_cost, ds.num_observations)
        r1 = rmse(res.final_cost, ds.num_observations)
        emit(dict(phase="full_slice", dtype=str(dtype).replace("torch.", ""),
                  status=res.status.name, iterations=res.iterations,
                  rows=cp.total_residual_dim, compile_seconds=compile_s,
                  solve_seconds=seconds, seconds_per_iteration=seconds / res.iterations,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  rmse_initial=r0, rmse_final=r1, kernel_launches=launched))
        if not math.isfinite(res.final_cost):
            raise AssertionError(f"{dtype}: final cost not finite")
        if not r1 < 0.55 * r0:
            raise AssertionError(f"{dtype}: RMSE {r0} -> {r1} misses the 0.55x gate")
        if launched < res.iterations:
            raise AssertionError(
                f"{dtype}: {launched} kernel launches for {res.iterations} LM iterations")
        implicit[dtype] = dict(rmse_final=r1, solve_seconds=seconds)
    return ds, problem, total, iterations, implicit


# tests/test_medium_fixture.py's certified optimum and the JAX package's
# sphere2500 result (f64, python mode; bench.py's configuration)
MEDIUM_SE3 = ("tests/fixtures/medium_se3_250.g2o", 5.132992631561506e-01, 6)
MEDIUM_SE2 = ("tests/fixtures/medium_se2_300.g2o", 5.668402411723587e-02, 9)
SPHERE_INITIAL, SPHERE_FINAL, SPHERE_ITERATIONS = 1830.5367061422921, 8.594121916326808, 4
# the JAX package on a CPU, f64, python mode, bench.py's settings: the
# M3500-shaped graph and the parking-garage-shaped sweep (initial, final)
M3500_INITIAL, M3500_FINAL, M3500_ITERATIONS = 970.2833556685312, 0.6377173960659416, 6
SWEEP = [("l2", ()), ("huber", (1.0,)), ("cauchy", (1.0,)), ("fair", (1.3998,)),
         ("geman_mcclure", (1.0,)), ("welsch", (2.9846,)), ("tukey_biweight", (4.6851,)),
         ("trimmed_mean", (2.0,)), ("barron_general", (-2.0, 1.0)), ("t_distribution", (5.0,))]
SWEEP_COSTS = {"l2": (6145.86441008718, 16.063378445855403),
               "huber": (3246.84568247429, 16.063378445809057),
               "cauchy": (1390.0683695360126, 15.935114237585939)}
# the JAX package on a CPU, f64, python mode: the 12^3 lattice through
# sparse_general (bench.py's grid3d rung), and the core size of its plan for
# the 20^3 lattice
GRID12_INITIAL, GRID12_FINAL, GRID12_ITERATIONS = 174.42628102979307, 10.614117258370733, 3
GRID20_CORE_BLOCKS = 3377
# the certified fixtures' solver settings
CERTIFIED = dict(max_iterations=100, cost_tolerance=1e-10, parameter_tolerance=1e-14,
                 gradient_tolerance=1e-14)
# bench.py's settings (bench.py:58-67); LM adds damping="auto"
BENCH = dict(max_iterations=100, cost_tolerance=1e-4)
PROFILE_SPANS = ("banded.linearize", "banded.assemble", "cr.eliminate", "cr.dense_fold",
                 "cr.back_substitute", "cr.residual", "cr.refine", "cr.retry", "lm.trial_cost",
                 "schur.assemble", "schur.pair_products", "schur.dense_solve",
                 "schur.back_substitute", "general.assemble", "general.eliminate",
                 "general.core", "general.back_substitute", "general.retry",
                 "dogleg.assemble", "dogleg.solve", "camera.project", "camera.jacobians")


def phase_pose_graph_parity():
    import numpy as np
    import torch

    import apex_tpu_torch as apx

    fname, certified, iterations = MEDIUM_SE3
    problem = apx.load_g2o(os.path.join(REPO, fname)).to_problem()
    results = {}
    for device in ("cuda", "cpu"):
        cfg = apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_cholesky", max_iterations=100, cost_tolerance=1e-10,
            parameter_tolerance=1e-14, gradient_tolerance=1e-14)
        results[device] = apx.LevenbergMarquardt(cfg).optimize(
            problem.compile(dtype=torch.float64, device=device))
    for device, r in results.items():
        if not (r.converged and r.iterations == iterations):
            raise AssertionError(f"{device}: {r.summary()}, expected {iterations} iterations")
        np.testing.assert_allclose(r.final_cost, certified, rtol=1e-8)
    rc, rh = results["cuda"], results["cpu"]
    emit(dict(phase="pose_graph_parity", file=fname, iterations=rc.iterations,
              status=rc.status.name, cost_cuda=rc.final_cost, cost_cpu=rh.final_cost,
              certified=certified, rel_diff_cuda=abs(rc.final_cost - certified) / certified,
              rel_diff_cpu=abs(rh.final_cost - certified) / certified))


# the landmark kernel's symbol, as the profiler names its device events
LANDMARK_KERNEL = "invert_landmark_blocks_kernel"


def profile_solve(solve):
    """One solve under torch.profiler: wall seconds, device busy seconds
    (the sum of device events: kernels, copies, sets; one stream, so they do
    not overlap), this solve's LM iterations and device events per LM
    iteration, the top device ops and the spans' device and host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iterations = solve().iterations
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name not in PROFILE_SPANS]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    spans = {}
    for e in events:
        if e.name in PROFILE_SPANS and e.device_type == DeviceType.CPU:
            d = spans.setdefault(e.name, {"calls": 0, "host_ms": 0.0, "device_ms": 0.0})
            d["calls"] += 1
            d["host_ms"] += e.time_range.elapsed_us() / 1e3
            d["device_ms"] += e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_seconds=wall, device_busy_seconds=busy_us / 1e6,
                device_idle_share=1.0 - busy_us / 1e6 / wall,
                iterations=iterations, device_events=len(device),
                device_events_per_lm_iteration=len(device) / iterations,
                landmark_kernel_events=sum(LANDMARK_KERNEL in e.name for e in device),
                top_device_ops_ms=[[name[:90], us / 1e3] for name, us in top], spans=spans)


def solve_three_times(lm, cp):
    """The first solve (plan, library warm-up), a solve under the profiler,
    and the timed solve: (result, [first s, timed s], profile, peak device
    memory of the timed solve, LM iterations of the three together)."""
    import torch

    timed = []
    iterations = 0
    for k in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if k == 1:
            profiled = profile_solve(lambda: lm.optimize(cp))
            iterations += profiled["iterations"]
            continue
        t0 = time.perf_counter()
        res = lm.optimize(cp)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        iterations += res.iterations
    return res, timed, profiled, torch.cuda.max_memory_allocated(), iterations


def banded_full(phase, graph, problem, dtype):
    """One dtype of a banded pose-graph phase: LM ``sparse_cholesky``,
    ``damping="auto"``, ``cost_tolerance=1e-4``, solved three times; emits
    the phase's line and returns the result."""
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.linalg import banded

    name = str(dtype).replace("torch.", "")
    t0 = time.perf_counter()
    cp = problem.compile(dtype=dtype, device="cuda")
    compile_s = time.perf_counter() - t0
    W = banded.block_bandwidth(cp)
    core = banded.make_blocktri_cr_core(cp.total_dof, banded.default_panel(W), dtype)
    lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", max_iterations=100, cost_tolerance=1e-4,
        damping="auto"))
    res, timed, profiled, peak, _ = solve_three_times(lm, cp)
    emit(dict(phase=phase, dtype=name, D=cp.total_dof, W=W, m=core.block,
              n=core.n_blocks, levels=core.levels, edges=graph.num_edges,
              status=res.status.name, iterations=res.iterations,
              initial_cost=res.initial_cost, final_cost=res.final_cost,
              compile_seconds=compile_s, first_solve_seconds=timed[0],
              solve_seconds=timed[1], seconds_per_lm_iteration=timed[1] / res.iterations,
              max_memory_allocated=peak, profile=profiled))
    return res


def check_costs(label, res, initial, final, iterations):
    """The JAX package's f64 constants: initial cost rtol 1e-10, final rtol
    1e-8, the iterations, and COST_TOLERANCE_REACHED."""
    import numpy as np

    np.testing.assert_allclose(res.initial_cost, initial, rtol=1e-10, err_msg=label)
    np.testing.assert_allclose(res.final_cost, final, rtol=1e-8, err_msg=label)
    if (res.iterations, res.status.name) != (iterations, "COST_TOLERANCE_REACHED"):
        raise AssertionError(f"{label}: {res.summary()}, expected {iterations} iterations")


def phase_pose_graph_full():
    import torch

    from apex_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    graph = synthetic.synthetic_pose_graph_3d(n_poses=2500, rings=50, seed=0)
    problem = graph.to_problem()
    emit(dict(phase="pose_graph_build", poses=graph.num_vertices, edges=graph.num_edges,
              seconds=time.perf_counter() - t0))
    for dtype in (torch.float64, torch.float32):
        res = banded_full("pose_graph_full", graph, problem, dtype)
        if not (res.converged and 1.0 - res.final_cost / res.initial_cost > 0.99):
            raise AssertionError(f"{dtype}: {res.summary()} misses the 99% gate")
        if dtype == torch.float64:
            check_costs("sphere f64", res, SPHERE_INITIAL, SPHERE_FINAL, SPHERE_ITERATIONS)
    return graph, problem


def phase_se2_parity():
    """The certified SE2 fixture through the three solvers, on the card and
    on the CPU."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx

    fname, certified, iterations = MEDIUM_SE2
    problem = apx.load_g2o(os.path.join(REPO, fname)).to_problem()
    for solver in ("sparse_cholesky", "dense_cholesky", "dense_qr"):
        results = {}
        for device in ("cuda", "cpu"):
            cfg = apx.LevenbergMarquardtConfig(
                linear_solver_type=solver, max_iterations=100, cost_tolerance=1e-10,
                parameter_tolerance=1e-14, gradient_tolerance=1e-14)
            results[device] = apx.LevenbergMarquardt(cfg).optimize(
                problem.compile(dtype=torch.float64, device=device))
        for device, r in results.items():
            if not (r.converged and r.iterations == iterations):
                raise AssertionError(
                    f"{solver} {device}: {r.summary()}, expected {iterations} iterations")
            np.testing.assert_allclose(r.final_cost, certified, rtol=1e-8)
        rc, rh = results["cuda"], results["cpu"]
        emit(dict(phase="se2_parity", file=fname, solver=solver, iterations=rc.iterations,
                  status=rc.status.name, cost_cuda=rc.final_cost, cost_cpu=rh.final_cost,
                  certified=certified,
                  rel_diff_cuda=abs(rc.final_cost - certified) / certified,
                  rel_diff_cpu=abs(rh.final_cost - certified) / certified))


def phase_se2_full():
    """The M3500-shaped SE2 graph through sparse_cholesky in f64 and f32,
    then one f64 dense_cholesky solve of it (a dense H of D^2 entries)."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    graph = synthetic.synthetic_pose_graph_2d(n_poses=3500, trajectory="manhattan",
                                              loop_stride=2, seed=0)
    problem = graph.to_problem()
    emit(dict(phase="se2_build", poses=graph.num_vertices, edges=graph.num_edges,
              seconds=time.perf_counter() - t0))
    banded_res = {}
    for dtype in (torch.float64, torch.float32):
        res = banded_res[dtype] = banded_full("se2_full", graph, problem, dtype)
        if not (res.converged and 1.0 - res.final_cost / res.initial_cost > 0.95):
            raise AssertionError(f"{dtype}: {res.summary()} misses the 95% gate")
        if dtype == torch.float64:
            check_costs("m3500 f64", res, M3500_INITIAL, M3500_FINAL, M3500_ITERATIONS)

    cp = problem.compile(dtype=torch.float64, device="cuda")
    lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="dense_cholesky", max_iterations=100, cost_tolerance=1e-4,
        damping="auto"))
    torch.cuda.reset_peak_memory_stats()
    res, timed = timed_solves(lm, cp)
    sparse = banded_res[torch.float64]
    emit(dict(phase="se2_dense", dtype="float64", D=cp.total_dof, status=res.status.name,
              iterations=res.iterations, initial_cost=res.initial_cost,
              final_cost=res.final_cost, first_solve_seconds=timed[0], solve_seconds=timed[1],
              seconds_per_lm_iteration=timed[1] / res.iterations,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              sparse_final_cost=sparse.final_cost, sparse_iterations=sparse.iterations,
              rel_diff_to_sparse=abs(res.final_cost - sparse.final_cost) / sparse.final_cost))
    if not res.converged:
        raise AssertionError(f"dense f64: {res.summary()}")
    np.testing.assert_allclose(res.final_cost, sparse.final_cost, rtol=1e-6)
    return problem


def phase_robust_sweep():
    """The parking-garage-shaped SE3 graph with each of the 10 losses of the
    JAX package's sweep on every edge and a ManifoldPriorFactor on the first
    pose, f64, sparse_cholesky: converged with the final cost below 0.6x
    the initial; L2, Huber(1.0) and Cauchy(1.0) also at the JAX package's
    constants."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.core import losses
    from apex_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    graph = synthetic.synthetic_pose_graph_3d(n_poses=1661, rings=30, seed=0,
                                              closure_strides=(1, 2, 3))
    first = sorted(graph.vertices_se3)[0]
    anchor = np.asarray(graph.vertices_se3[first])
    emit(dict(phase="robust_sweep_build", poses=graph.num_vertices, edges=graph.num_edges,
              seconds=time.perf_counter() - t0))
    lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", max_iterations=100, cost_tolerance=1e-4,
        damping="auto"))
    for name, args in SWEEP:
        problem = graph.to_problem(loss=losses.LOSS_BY_NAME[name](*args))
        problem.add_residual_block([f"x{first}"], apx.ManifoldPriorFactor("SE3", anchor))
        cp = problem.compile(dtype=torch.float64, device="cuda")
        res, timed = timed_solves(lm, cp)
        emit(dict(phase="robust_sweep", loss=name, params=list(args), D=cp.total_dof,
                  status=res.status.name, iterations=res.iterations,
                  initial_cost=res.initial_cost, final_cost=res.final_cost,
                  first_solve_seconds=timed[0], solve_seconds=timed[1]))
        if not (res.converged and res.final_cost < 0.6 * res.initial_cost):
            raise AssertionError(f"{name}: {res.summary()} misses the JAX test's gate")
        if name in SWEEP_COSTS:
            check_costs(name, res, *SWEEP_COSTS[name], 4)


def phase_schur_explicit_parity():
    """The explicit Schur solve on the small BA problem: card against CPU,
    then against the dense and the exact implicit solves on the card."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.ba import build_ba_problem
    from apex_tpu_torch.io import synthetic

    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    problem = build_ba_problem(ds, mode="self_calibration")

    def solve(device, solver, **kw):
        cfg = apx.LevenbergMarquardtConfig(linear_solver_type=solver, max_iterations=30, **kw)
        return apx.LevenbergMarquardt(cfg).optimize(
            problem.compile(dtype=torch.float64, device=device))

    rc, rh = solve("cuda", "schur_explicit"), solve("cpu", "schur_explicit")
    if (rc.iterations, rc.status) != (rh.iterations, rh.status):
        raise AssertionError(f"cuda {rc.summary()} vs cpu {rh.summary()}")
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)
    r_dense = solve("cuda", "dense_cholesky")
    r_imp = solve("cuda", "schur_implicit", pcg_forcing=False, pcg_tolerance=1e-10,
                  pcg_max_iterations=500)
    np.testing.assert_allclose(rc.final_cost, r_dense.final_cost, rtol=1e-6)
    np.testing.assert_allclose(rc.final_cost, r_imp.final_cost, rtol=1e-6)
    emit(dict(phase="schur_explicit_parity", iterations=rc.iterations, status=rc.status.name,
              cost_cuda=rc.final_cost, cost_cpu=rh.final_cost,
              rel_diff=abs(rc.final_cost - rh.final_cost) / rh.final_cost,
              cost_dense=r_dense.final_cost, cost_implicit=r_imp.final_cost,
              iterations_dense=r_dense.iterations, iterations_implicit=r_imp.iterations))


def phase_schur_explicit_full(ds, problem, implicit):
    """The trafalgar-scale synthetic through ``schur``: (kernel launches,
    LM iterations)."""
    import math

    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.ba import rmse
    from apex_tpu_torch.kernels import landmark_blocks as lb
    from apex_tpu_torch.linalg import dense, schur

    # pairs among the observations themselves: the bucketed layout's
    # weight-0 padding rows add theirs to the enumeration
    observation_pairs = int((np.bincount(ds.point_indices).astype(np.int64) ** 2).sum())

    # the retry stages of the dense solve: calls of the Cholesky solve
    # beyond one per reduced system
    calls = {"cho_solve": 0, "pairs_s": 0.0}
    cho_solve, enumerate_pairs = dense._cho_solve, schur.enumerate_pairs

    def counted_cho_solve(A, b):
        calls["cho_solve"] += 1
        return cho_solve(A, b)

    def timed_enumerate_pairs(lm_of_coupling):
        t0 = time.perf_counter()
        out = enumerate_pairs(lm_of_coupling)
        calls["pairs_s"] += time.perf_counter() - t0
        return out

    dense._cho_solve, schur.enumerate_pairs = counted_cho_solve, timed_enumerate_pairs
    lb.launches = 0
    total = iterations = 0
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        cp = problem.compile(dtype=dtype, device="cuda")
        cfg = apx.LevenbergMarquardtConfig.for_bundle_adjustment()
        cfg.linear_solver_type = "schur"
        cfg.max_iterations = 10
        lm = apx.LevenbergMarquardt(cfg)
        calls["pairs_s"] = 0.0
        calls["cho_solve"] = 0
        t0 = time.perf_counter()
        lm._step_cache[cp] = lm._make_step_fn(cp)  # the structure analysis, timed apart
        context_s = time.perf_counter() - t0
        ctx = lm._step_cache[cp].solve_fn.schur_context
        if ctx.variant != "sparse":
            raise AssertionError(f"schur chose {ctx.variant!r} at Dc = {ctx.Dc}")
        n_pairs = sum(int(ia.shape[0]) for ia, _ in ctx.pair_indices)
        before = lb.launches
        res, timed, profiled, peak, lm_iterations = solve_three_times(lm, cp)
        launched = lb.launches - before
        total += launched
        iterations += lm_iterations
        r0 = rmse(res.initial_cost, ds.num_observations)
        r1 = rmse(res.final_cost, ds.num_observations)
        ref = implicit[dtype]
        emit(dict(phase="schur_explicit_full", dtype=name, variant="sparse",
                  Dc=ctx.Dc, pairs=n_pairs, observation_pairs=observation_pairs,
                  pair_chunks=-(-n_pairs // schur.SchurContext.PAIR_CHUNK),
                  pair_enumeration_seconds=calls["pairs_s"], context_seconds=context_s,
                  status=res.status.name, iterations=res.iterations,
                  first_solve_seconds=timed[0], solve_seconds=timed[1],
                  seconds_per_lm_iteration=timed[1] / res.iterations,
                  max_memory_allocated=peak, rmse_initial=r0, rmse_final=r1,
                  implicit_rmse_final=ref["rmse_final"],
                  implicit_solve_seconds=ref["solve_seconds"],
                  lm_iterations_of_three_solves=lm_iterations,
                  dense_solve_retry_stages=calls["cho_solve"] - lm_iterations,
                  kernel_launches=launched, profile=profiled))
        if not math.isfinite(res.final_cost):
            raise AssertionError(f"{name}: final cost not finite")
        if not r1 < 0.55 * r0:
            raise AssertionError(f"{name}: RMSE {r0} -> {r1} misses the 0.55x gate")
        if dtype == torch.float64 and abs(r1 - ref["rmse_final"]) > 0.02 * ref["rmse_final"]:
            raise AssertionError(
                f"{name}: RMSE {r1} is not within 2% of the implicit solve's {ref['rmse_final']}")
        if launched != lm_iterations:
            raise AssertionError(
                f"{name}: {launched} kernel launches for {lm_iterations} LM iterations")
    dense._cho_solve, schur.enumerate_pairs = cho_solve, enumerate_pairs
    return total, iterations


def values_of(cp, variables):
    """A result's ``variables`` as the values tuple of ``cp``, on its device."""
    import numpy as np
    import torch

    return tuple(torch.as_tensor(np.stack([variables[n] for n in pool.names]),
                                 dtype=cp.dtype, device=cp.device) for pool in cp.pools)


def timed_solves(solver, cp, n=2):
    """``n`` solves: (last result, seconds of each)."""
    import torch

    timed = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.optimize(cp)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
    return res, timed


def phase_optimizers(sphere_problem):
    """DogLeg and Gauss-Newton: at full width on the sphere against LM's
    final cost, and card against CPU on the medium SE3 fixture."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx

    common = dict(linear_solver_type="sparse_cholesky", max_iterations=100, cost_tolerance=1e-4)
    cp = sphere_problem.compile(dtype=torch.float64, device="cuda")
    for name, solver in (("dogleg", apx.DogLeg(apx.DogLegConfig(**common))),
                         ("gauss_newton", apx.GaussNewton(apx.GaussNewtonConfig(**common)))):
        res, timed = timed_solves(solver, cp)
        emit(dict(phase="optimizers", optimizer=name, graph="sphere2500", D=cp.total_dof,
                  status=res.status.name, iterations=res.iterations,
                  initial_cost=res.initial_cost, final_cost=res.final_cost,
                  rel_diff_to_lm=abs(res.final_cost - SPHERE_FINAL) / SPHERE_FINAL,
                  first_solve_seconds=timed[0], solve_seconds=timed[1],
                  seconds_per_iteration=timed[1] / res.iterations,
                  reused_steps=getattr(solver, "reused_steps", None)))
        if not res.converged:
            raise AssertionError(f"{name}: {res.summary()}")
        np.testing.assert_allclose(res.final_cost, SPHERE_FINAL, rtol=1e-6, err_msg=name)

    problem = apx.load_g2o(os.path.join(REPO, MEDIUM_SE3[0])).to_problem()
    for name, make in (("dogleg", lambda: apx.DogLeg(apx.DogLegConfig(
                            linear_solver_type="sparse_cholesky"))),
                       ("gauss_newton", lambda: apx.GaussNewton(apx.GaussNewtonConfig(
                            linear_solver_type="sparse_cholesky")))):
        rc = make().optimize(problem.compile(dtype=torch.float64, device="cuda"))
        rh = make().optimize(problem.compile(dtype=torch.float64, device="cpu"))
        if (rc.iterations, rc.status) != (rh.iterations, rh.status) or not rc.converged:
            raise AssertionError(f"{name}: cuda {rc.summary()} vs cpu {rh.summary()}")
        np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)
        emit(dict(phase="optimizers_parity", optimizer=name, file=MEDIUM_SE3[0],
                  iterations=rc.iterations, status=rc.status.name, cost_cuda=rc.final_cost,
                  cost_cpu=rh.final_cost,
                  rel_diff=abs(rc.final_cost - rh.final_cost) / rh.final_cost))


def phase_small_solvers(sphere_problem, m3500_problem):
    """``sparse_qr`` and ``pcg`` under LM: the certified fixtures on the
    card, then ``sparse_qr`` at full width, timed."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx

    for fname, certified, iterations in (MEDIUM_SE3, MEDIUM_SE2):
        problem = apx.load_g2o(os.path.join(REPO, fname)).to_problem()
        cp = problem.compile(dtype=torch.float64, device="cuda")
        for solver in ("sparse_qr", "pcg"):
            lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
                linear_solver_type=solver, max_iterations=100, cost_tolerance=1e-10,
                parameter_tolerance=1e-14, gradient_tolerance=1e-14))
            res, timed = timed_solves(lm, cp, n=1)
            emit(dict(phase="small_solvers_parity", file=fname, solver=solver,
                      iterations=res.iterations, status=res.status.name,
                      final_cost=res.final_cost, certified=certified,
                      rel_diff=abs(res.final_cost - certified) / certified,
                      solve_seconds=timed[0]))
            if not res.converged:
                raise AssertionError(f"{solver} {fname}: {res.summary()}")
            np.testing.assert_allclose(res.final_cost, certified, rtol=1e-8)
            # the exact band solve takes the certified iteration count; CG
            # stops at its own tolerance and may take another LM step
            if solver == "sparse_qr" and res.iterations != iterations:
                raise AssertionError(f"{solver} {fname}: {res.iterations} iterations")

    for graph, problem, initial, final, its in (
            ("m3500", m3500_problem, M3500_INITIAL, M3500_FINAL, M3500_ITERATIONS),
            ("sphere2500", sphere_problem, SPHERE_INITIAL, SPHERE_FINAL, SPHERE_ITERATIONS)):
        cp = problem.compile(dtype=torch.float64, device="cuda")
        lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_qr", max_iterations=100, cost_tolerance=1e-4,
            damping="auto"))
        res, timed = timed_solves(lm, cp)
        emit(dict(phase="sparse_qr_full", graph=graph, D=cp.total_dof, status=res.status.name,
                  iterations=res.iterations, initial_cost=res.initial_cost,
                  final_cost=res.final_cost, first_solve_seconds=timed[0],
                  solve_seconds=timed[1], seconds_per_lm_iteration=timed[1] / res.iterations))
        check_costs(f"sparse_qr {graph}", res, initial, final, its)


def phase_covariance(sphere_graph):
    """Covariance blocks: the dense route card against CPU on the medium
    fixture, the banded route against the dense one on the sphere."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.core.covariance import compute_covariances, compute_covariances_for

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    problem = apx.load_g2o(os.path.join(REPO, MEDIUM_SE3[0])).to_problem(fix_first=True)
    results = {}
    for device in ("cuda", "cpu"):
        cp = problem.compile(dtype=torch.float64, device=device)
        lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_cholesky", compute_covariances=True))
        results[device] = lm.optimize(cp)
        if device == "cuda":
            values = values_of(cp, results[device].variables)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compute_covariances(cp, values)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    cc, ch = results["cuda"].covariances, results["cpu"].covariances
    worst = max(rel(cc[n], ch[n]) for n in ch if np.abs(ch[n]).max() > 0)
    fixed = [n for n in ch if np.abs(ch[n]).max() == 0]
    emit(dict(phase="covariance_parity", file=MEDIUM_SE3[0], blocks=len(cc),
              fixed_blocks=fixed, worst_rel_diff=worst, seconds_cuda=seconds,
              iterations=results["cuda"].iterations))
    if set(cc) != set(ch) or not all(np.abs(cc[n]).max() == 0 for n in fixed):
        raise AssertionError("covariance blocks differ between the card and the CPU")
    if not worst < 1e-8:
        raise AssertionError(f"covariance blocks differ by {worst} between card and CPU")

    cp = sphere_graph.to_problem(fix_first=True).compile(dtype=torch.float64, device="cuda")
    res = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", max_iterations=100, cost_tolerance=1e-4,
        damping="auto")).optimize(cp)
    values = values_of(cp, res.variables)
    ids = sorted(sphere_graph.vertices_se3)
    names = [f"x{ids[1]}", f"x{ids[len(ids) // 2]}", f"x{ids[-1]}"]
    out, timing, peaks = {}, {}, {}
    for route, fn in (("banded", compute_covariances_for), ("dense", compute_covariances)):
        for k in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out[route] = fn(cp, values, names)
            torch.cuda.synchronize()
            timing.setdefault(route, []).append(time.perf_counter() - t0)
        peaks[route] = torch.cuda.max_memory_allocated()
    worst = max(rel(out["banded"][n], out["dense"][n]) for n in names)
    emit(dict(phase="covariance_full", graph="sphere2500", D=cp.total_dof, poses=names,
              lm_iterations=res.iterations, worst_rel_diff=worst,
              banded_seconds=timing["banded"], dense_seconds=timing["dense"],
              banded_peak_memory=peaks["banded"], dense_peak_memory=peaks["dense"],
              trace_of_blocks={n: float(np.trace(out["dense"][n])) for n in names}))
    if not worst < 1e-6:
        raise AssertionError(f"banded covariance blocks differ from dense by {worst}")


def capped_general(base_cap):
    """GeneralSparseCholesky with ``base_cap`` blocks of dense core at most,
    so that a small graph runs elimination levels."""
    from apex_tpu_torch.linalg import sparse_general as sg

    class Capped(sg.GeneralSparseCholesky):
        def __init__(self, cp, deg_cap=24, min_picked=32, **_):
            super().__init__(cp, deg_cap=deg_cap, base_cap=base_cap, min_picked=min_picked)

    return Capped


def phase_general_parity():
    """The general tier with elimination levels on a small lattice, card
    against CPU; then the medium SE3 fixture at its certified cost on the
    card."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.io import synthetic
    from apex_tpu_torch.linalg import sparse_general as sg

    problem = synthetic.synthetic_pose_graph_grid3d(6, 6, 4, seed=1).to_problem()
    general = sg.GeneralSparseCholesky
    sg.GeneralSparseCholesky = capped_general(8)
    results, levels = {}, {}
    try:
        for device in ("cuda", "cpu"):
            lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
                linear_solver_type="sparse_general", max_iterations=30, cost_tolerance=1e-6))
            cp = problem.compile(dtype=torch.float64, device=device)
            lm._step_cache[cp] = lm._make_step_fn(cp)
            levels[device] = lm._step_cache[cp].solve_fn.general_sparse.sym.n_levels
            results[device] = lm.optimize(cp)
    finally:
        sg.GeneralSparseCholesky = general
    rc, rh = results["cuda"], results["cpu"]
    if (rc.iterations, rc.status) != (rh.iterations, rh.status) or not rc.converged:
        raise AssertionError(f"grid 6x6x4: cuda {rc.summary()} vs cpu {rh.summary()}")
    if not levels["cuda"] == levels["cpu"] > 0:
        raise AssertionError(f"grid 6x6x4: elimination levels {levels}")
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)

    fname, certified, _ = MEDIUM_SE3
    cfg = apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_general", max_iterations=100, cost_tolerance=1e-10,
        parameter_tolerance=1e-14, gradient_tolerance=1e-14)
    rm = apx.LevenbergMarquardt(cfg).optimize(apx.load_g2o(os.path.join(REPO, fname))
                                              .to_problem().compile(dtype=torch.float64))
    emit(dict(phase="general_parity", graph="grid3d 6x6x4 (seed 1, base_cap 8)",
              levels=levels["cuda"], iterations=rc.iterations, status=rc.status.name,
              cost_cuda=rc.final_cost, cost_cpu=rh.final_cost,
              rel_diff=abs(rc.final_cost - rh.final_cost) / rh.final_cost,
              medium_file=fname, medium_iterations=rm.iterations, medium_status=rm.status.name,
              medium_cost=rm.final_cost, medium_rel_diff=abs(rm.final_cost - certified) / certified))
    if not rm.converged:
        raise AssertionError(f"{fname} sparse_general: {rm.summary()}")
    np.testing.assert_allclose(rm.final_cost, certified, rtol=1e-8)


def plan_line(gs):
    """The printed shape of a general-tier plan."""
    return dict(levels=gs.sym.n_levels,
                level_p_q=[[len(lv.picked), int(lv.nbrs.shape[1])] for lv in gs.sym.levels],
                fill_ratio=gs.sym.fill_ratio(), slots=gs.sym.n_slots, R=gs.R,
                core_dof=gs.R * gs.dmax, healthy=gs.healthy())


def phase_general_full():
    """The 12^3 lattice (bench.py's grid3d rung) through LM sparse_general,
    f64 then f32, three solves each; then the per-LM-iteration time against
    the 1,728-pose sphere through sparse_cholesky, bench.py's ratio."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    graph = synthetic.synthetic_pose_graph_grid3d(12, 12, 12, seed=0)
    problem = graph.to_problem()
    trajectory = synthetic.synthetic_pose_graph_3d(n_poses=1728, rings=24, seed=0).to_problem()
    emit(dict(phase="general_build", poses=graph.num_vertices, edges=graph.num_edges,
              seconds=time.perf_counter() - t0))
    results = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        cp = problem.compile(dtype=dtype, device="cuda")
        lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_general", max_iterations=100, cost_tolerance=1e-4,
            damping="auto"))
        t0 = time.perf_counter()
        lm._step_cache[cp] = lm._make_step_fn(cp)  # the symbolic plan, timed apart
        plan_s = time.perf_counter() - t0
        gs = lm._step_cache[cp].solve_fn.general_sparse
        res, timed, profiled, peak, lm_iterations = solve_three_times(lm, cp)
        tcp = trajectory.compile(dtype=dtype, device="cuda")
        banded_lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_cholesky", max_iterations=100, cost_tolerance=1e-4,
            damping="auto"))
        tres, ttimed = timed_solves(banded_lm, tcp)
        per_it = timed[1] / res.iterations
        traj_per_it = ttimed[1] / tres.iterations
        results[dtype] = res
        emit(dict(phase="general_full", dtype=name, D=cp.total_dof, edges=graph.num_edges,
                  plan_seconds=plan_s, **plan_line(gs), status=res.status.name,
                  iterations=res.iterations, initial_cost=res.initial_cost,
                  final_cost=res.final_cost, first_solve_seconds=timed[0],
                  solve_seconds=timed[1], seconds_per_lm_iteration=per_it,
                  lm_iterations_of_three_solves=lm_iterations,
                  retry_stages_of_three_solves=gs.retry_stages, max_memory_allocated=peak,
                  trajectory_status=tres.status.name, trajectory_iterations=tres.iterations,
                  trajectory_solve_seconds=ttimed[1],
                  trajectory_seconds_per_lm_iteration=traj_per_it,
                  ratio_per_lm_iteration=per_it / traj_per_it, profile=profiled))
        if not (res.converged and 1.0 - res.final_cost / res.initial_cost > 0.5):
            raise AssertionError(f"grid3d {name}: {res.summary()} misses the 50% gate")
        if dtype == torch.float64:
            check_costs("grid3d f64", res, GRID12_INITIAL, GRID12_FINAL, GRID12_ITERATIONS)
    r64, r32 = results[torch.float64], results[torch.float32]
    if abs(r32.iterations - r64.iterations) > 1:
        raise AssertionError(f"grid3d f32 {r32.summary()} vs f64 {r64.summary()}")
    np.testing.assert_allclose(r32.final_cost, r64.final_cost, rtol=1e-2)


def phase_general_auto():
    """The 20^3 lattice through LM sparse_cholesky, f64: its block
    bandwidth is above 1536, so the solve takes the general tier, whose
    dense core (R blocks of 6) is the phase's memory."""
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.io import synthetic
    from apex_tpu_torch.linalg import banded

    start = time.perf_counter()
    graph = synthetic.synthetic_pose_graph_grid3d(20, 20, 20, seed=0)
    cp = graph.to_problem().compile(dtype=torch.float64, device="cuda")
    build_s = time.perf_counter() - start
    W = banded.block_bandwidth(cp)
    lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", max_iterations=100, cost_tolerance=1e-4,
        damping="auto"))
    t0 = time.perf_counter()
    lm._step_cache[cp] = lm._make_step_fn(cp)
    plan_s = time.perf_counter() - t0
    gs = getattr(lm._step_cache[cp].solve_fn, "general_sparse", None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = lm.optimize(cp)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    emit(dict(phase="general_auto", poses=graph.num_vertices, edges=graph.num_edges,
              D=cp.total_dof, W=W, build_seconds=build_s, plan_seconds=plan_s,
              **(plan_line(gs) if gs is not None else {}), status=res.status.name,
              iterations=res.iterations, initial_cost=res.initial_cost,
              final_cost=res.final_cost, solve_seconds=solve_s,
              seconds_per_lm_iteration=solve_s / res.iterations,
              retry_stages=gs.retry_stages if gs is not None else None,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              phase_seconds=time.perf_counter() - start))
    if not W > banded.MAX_BANDWIDTH:
        raise AssertionError(f"grid3d 20^3: block bandwidth {W}")
    if gs is None or not gs.healthy():
        raise AssertionError("grid3d 20^3: sparse_cholesky did not take the general tier")
    if gs.R != GRID20_CORE_BLOCKS:
        raise AssertionError(f"grid3d 20^3: core of {gs.R} blocks, the JAX package's "
                             f"plan has {GRID20_CORE_BLOCKS}")
    if not (res.converged and 1.0 - res.final_cost / res.initial_cost > 0.5):
        raise AssertionError(f"grid3d 20^3: {res.summary()} misses the 50% gate")


# -- mode="jit": the solve as replayed CUDA graphs ---------------------------------


def phase_jit_parity():
    """The medium fixtures in jit mode on the card against the CPU: SE3
    through sparse_cholesky (the same iterations and status, rtol 1e-8, the
    certified cost), then both fixtures through DogLeg, sparse_qr, pcg and
    sparse_general, each gated on the same iterations and status, a final
    cost within rtol 1e-10 of the CPU's, or 10x python mode's own spread
    over three solves on the card where that is larger, and the certified
    cost (rtol 1e-8)."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.optim import graphs

    fname, certified, iterations = MEDIUM_SE3
    problem = apx.load_g2o(os.path.join(REPO, fname)).to_problem()
    results = {}
    for device in ("cuda", "cpu"):
        cfg = apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_cholesky", mode="jit", **CERTIFIED)
        graphs.reset_counters()
        results[device] = apx.LevenbergMarquardt(cfg).optimize(
            problem.compile(dtype=torch.float64, device=device))
    rc, rh = results["cuda"], results["cpu"]
    if (rc.iterations, rc.status) != (rh.iterations, rh.status) or rc.iterations != iterations:
        raise AssertionError(f"cuda {rc.summary()} vs cpu {rh.summary()}")
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)
    np.testing.assert_allclose(rc.final_cost, certified, rtol=1e-8)
    emit(dict(phase="jit_parity", file=fname, iterations=rc.iterations,
              status=rc.status.name, cost_cuda=rc.final_cost, cost_cpu=rh.final_cost,
              rel_diff=abs(rc.final_cost - rh.final_cost) / rh.final_cost))

    def lm(solver):
        return lambda mode: apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type=solver, mode=mode, **CERTIFIED))

    paths = (("dogleg", lambda mode: apx.DogLeg(apx.DogLegConfig(
                 linear_solver_type="sparse_cholesky", mode=mode, **CERTIFIED))),
             ("sparse_qr", lm("sparse_qr")), ("pcg", lm("pcg")),
             ("sparse_general", lm("sparse_general")))
    for fname, certified, _ in (MEDIUM_SE3, MEDIUM_SE2):
        problem = apx.load_g2o(os.path.join(REPO, fname)).to_problem()
        cards = problem.compile(dtype=torch.float64, device="cuda")
        host = problem.compile(dtype=torch.float64, device="cpu")
        for path, make in paths:
            costs = [make("python").optimize(cards).final_cost for _ in range(3)]
            spread = (max(costs) - min(costs)) / costs[-1]
            rc, rh = make("jit").optimize(cards), make("jit").optimize(host)
            rtol = max(1e-10, 10.0 * spread)
            emit(dict(phase="jit_parity", file=fname, path=path, iterations=rc.iterations,
                      status=rc.status.name, cost_cuda=rc.final_cost, cost_cpu=rh.final_cost,
                      rel_diff=abs(rc.final_cost - rh.final_cost) / rh.final_cost,
                      python_run_to_run_spread=spread, parity_rtol=rtol,
                      rel_diff_to_certified=abs(rc.final_cost - certified) / certified))
            if (rc.iterations, rc.status) != (rh.iterations, rh.status) or not rc.converged:
                raise AssertionError(f"{fname} {path}: cuda {rc.summary()} vs cpu {rh.summary()}")
            np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=rtol,
                                       err_msg=f"{fname} {path} card against CPU")
            np.testing.assert_allclose(rc.final_cost, certified, rtol=1e-8,
                                       err_msg=f"{fname} {path} certified cost")


def graph_counters():
    from apex_tpu_torch.kernels import landmark_blocks as lb
    from apex_tpu_torch.optim import graphs

    return dict(captures=graphs.captures, graphs=graphs.graphs, replays=graphs.replays,
                uncaptured_calls=graphs.uncaptured_calls,
                host_reads=graphs.host_reads, status_reads=graphs.status_reads,
                replayed_kernel_launches=graphs.kernel_launches,
                eager_kernel_launches=lb.launches)


def counted_solve(solver, cp):
    """One synchronized solve: (result, seconds, counter increments)."""
    import torch

    before = graph_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.optimize(cp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, seconds, {k: v - before[k] for k, v in graph_counters().items()}


def jit_full(phase, label, problem, make, dtype, gate, rtol=1e-10):
    """One dtype of a jit phase: three python-mode solves (the last timed,
    the reference; the spread of their final costs is python mode's own
    run-to-run rounding, from ``index_add_``'s atomic order), then the jit
    solves: the first (state, warm-up and capture), one under the profiler
    and the timed one. f64 must give python mode's iterations and status
    and its final cost within ``rtol``, or within 10x python mode's own
    spread where that is larger, and DogLeg python mode's reused steps;
    ``gate(res)`` raises on a result below the phase's quality gate.
    Returns a dict: the jit iterations of the three solves, the landmark
    kernel launches in them (by the replay count), the profile, the emitted
    line, the compiled problem and the python and jit solvers."""
    import gc

    import numpy as np
    import torch

    name = str(dtype).replace("torch.", "")
    cp = problem.compile(dtype=dtype, device="cuda")
    python = make("python")
    costs = [counted_solve(python, cp)[0].final_cost for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    ref, python_s, _ = counted_solve(python, cp)
    python_peak = torch.cuda.max_memory_allocated()
    costs.append(ref.final_cost)
    spread = (max(costs) - min(costs)) / abs(ref.final_cost)
    jit = make("jit")
    # earlier phases' graphs die with their solvers: release their pools
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    python_reused = getattr(python, "reused_steps", None)
    first, first_s, first_n = counted_solve(jit, cp)
    first_peak = torch.cuda.max_memory_allocated()
    # what the captured programs keep reserved: their memory pool, and the
    # static state
    gc.collect()
    torch.cuda.empty_cache()
    graph_memory = torch.cuda.memory_reserved() - reserved
    before = graph_counters()
    profiled = profile_solve(lambda: jit.optimize(cp))
    profiled_n = {k: v - before[k] for k, v in graph_counters().items()}
    torch.cuda.reset_peak_memory_stats()
    res, seconds, n = counted_solve(jit, cp)
    peak = torch.cuda.max_memory_allocated()
    rtol = max(rtol, 10.0 * spread)
    line = dict(phase=phase, graph=label, dtype=name, D=cp.total_dof, status=res.status.name,
              iterations=res.iterations, initial_cost=res.initial_cost,
              final_cost=res.final_cost, python_iterations=ref.iterations,
              python_final_cost=ref.final_cost,
              rel_diff_to_python=abs(res.final_cost - ref.final_cost) / ref.final_cost,
              python_run_to_run_spread=spread, parity_rtol=rtol,
              first_solve_seconds=first_s,
              capture_seconds=jit._jit_cache[cp].capture_seconds,
              solve_seconds=seconds, seconds_per_lm_iteration=seconds / res.iterations,
              python_solve_seconds=python_s, speedup_over_python=python_s / seconds,
              graphs=first_n["graphs"], replays=n["replays"],
              replays_per_lm_iteration=n["replays"] / res.iterations,
              host_reads=n["host_reads"],
              host_reads_per_lm_iteration=n["host_reads"] / res.iterations,
              uncaptured_calls=n["uncaptured_calls"],
              device_idle_share=profiled["device_idle_share"],
              # the profiled solve's device time per LM iteration against the
              # timed solve's wall time per LM iteration: the idle share
              # without the profiler's overhead (f32 runs may differ in
              # iterations)
              device_idle_share_timed=1.0 - (
                  profiled["device_busy_seconds"] / profiled["iterations"]
                  / (seconds / res.iterations)),
              device_events_per_lm_iteration=profiled["device_events_per_lm_iteration"],
              max_memory_allocated=peak, max_memory_allocated_first_solve=first_peak,
              graph_memory_reserved=graph_memory,
              python_max_memory_allocated=python_peak,
              first_solve_counters=first_n, profiled_counters=profiled_n, profile=profiled)
    if python_reused is not None:
        # DogLeg: steps taken from the cache over the three solves of each mode
        line.update(reused_steps_python=python_reused, reused_steps_jit=jit.reused_steps)
    emit(line)
    if not np.isfinite(res.final_cost):
        raise AssertionError(f"{phase} {label} {name}: final cost not finite")
    if dtype == torch.float64:
        if (res.iterations, res.status) != (ref.iterations, ref.status):
            raise AssertionError(f"{label} jit {res.summary()} vs python {ref.summary()}")
        np.testing.assert_allclose(res.final_cost, ref.final_cost, rtol=rtol,
                                   err_msg=f"{label} jit against python mode")
        if python_reused is not None and jit.reused_steps != python_reused:
            raise AssertionError(f"{label}: jit reused {jit.reused_steps} steps, python "
                                 f"mode {python_reused}")
    gate(res)
    if first_n["captures"] != 2 or n["captures"] or profiled_n["captures"]:
        raise AssertionError(f"{label}: captures {first_n}, {profiled_n}, {n}")
    iterations = first.iterations + profiled["iterations"] + res.iterations
    launches = sum(c["replayed_kernel_launches"] + c["eager_kernel_launches"]
                   for c in (first_n, profiled_n, n))
    return dict(iterations=iterations, launches=launches, profiled=profiled, line=line, cp=cp,
                python=python, jit=jit)


def reduction(share):
    """A gate: converged with the cost reduced by more than ``share``."""
    def gate(res):
        if not (res.converged and 1.0 - res.final_cost / res.initial_cost > share):
            raise AssertionError(f"{res.summary()} misses the {share:.0%} gate")
    return gate


def phase_jit_pose_graphs(sphere_problem, m3500_problem):
    """jit mode on the sphere and the M3500-shaped graph through
    sparse_cholesky (bench.py's settings), and GN on the sphere, f64 then
    f32."""
    import torch

    import apex_tpu_torch as apx

    bench = dict(linear_solver_type="sparse_cholesky", max_iterations=100, cost_tolerance=1e-4)

    def lm(mode):
        return apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            damping="auto", mode=mode, **bench))

    def gn(mode):
        return apx.GaussNewton(apx.GaussNewtonConfig(mode=mode, **bench))

    # Undamped GN on the gauge-free sphere leans on the CR ladder's 1e-10
    # shift, which magnifies index_add_'s atomic rounding: python mode
    # itself spreads by up to ~4e-10 between solves on the H100.
    for label, problem, make, gate, rtol in (
            ("sphere2500", sphere_problem, lm, reduction(0.99), 1e-10),
            ("m3500", m3500_problem, lm, reduction(0.95), 1e-10),
            ("sphere2500 gauss_newton", sphere_problem, gn, reduction(0.99), 1e-8)):
        for dtype in (torch.float64, torch.float32):
            jit_full("jit_pose_graph", label, problem, make, dtype, gate, rtol)


def phase_jit_general():
    """jit mode on the general tier: the 12^3 lattice through
    ``sparse_general`` (bench.py's grid3d rung and settings), f64 then f32,
    gated in f64 on the JAX package's 174.42628102979307 ->
    10.614117258370733 in 3 iterations; beside it the 1,728-pose sphere
    through ``sparse_cholesky`` in jit, for bench.py's ratio of seconds
    per LM iteration. Then the 20^3 lattice through ``sparse_cholesky``,
    f64: its bandwidth is above 1536 columns, so jit mode must switch to
    the general tier (the JAX package's core of 3,377 blocks)."""
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.io import synthetic
    from apex_tpu_torch.linalg import banded

    def lm(solver):
        return lambda mode: apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type=solver, damping="auto", mode=mode, **BENCH))

    def grid_gate(dtype):
        def gate(res):
            reduction(0.5)(res)
            if dtype == torch.float64:
                check_costs("grid3d f64 jit", res, GRID12_INITIAL, GRID12_FINAL,
                            GRID12_ITERATIONS)
        return gate

    def retry_stages(out):
        """The general tier's ladder stages over each mode's three solves."""
        cp = out["cp"]
        return (out["python"]._step_cache[cp].solve_fn.general_sparse.retry_stages,
                out["jit"]._jit_cache[cp]._step.solve_fn.general_sparse.retry_stages)

    grid = synthetic.synthetic_pose_graph_grid3d(12, 12, 12, seed=0).to_problem()
    sphere = synthetic.synthetic_pose_graph_3d(n_poses=1728, rings=24, seed=0).to_problem()
    for dtype in (torch.float64, torch.float32):
        g = jit_full("jit_general", "grid3d 12^3 sparse_general", grid, lm("sparse_general"),
                     dtype, grid_gate(dtype))
        t = jit_full("jit_general", "sphere1728 sparse_cholesky", sphere, lm("sparse_cholesky"),
                     dtype, reduction(0.9))
        gl, tl = g["line"], t["line"]
        python_stages, jit_stages = retry_stages(g)
        emit(dict(phase="jit_general_ratio", dtype=gl["dtype"],
                  grid_seconds_per_lm_iteration=gl["seconds_per_lm_iteration"],
                  sphere_seconds_per_lm_iteration=tl["seconds_per_lm_iteration"],
                  ratio_per_lm_iteration=(gl["seconds_per_lm_iteration"]
                                          / tl["seconds_per_lm_iteration"]),
                  python_ratio_per_lm_iteration=(
                      gl["python_solve_seconds"] / gl["python_iterations"]
                      / (tl["python_solve_seconds"] / tl["python_iterations"])),
                  retry_stages_python=python_stages, retry_stages_jit=jit_stages))
        if dtype == torch.float64 and jit_stages != python_stages:
            raise AssertionError(f"grid3d: jit ran {jit_stages} ladder stages, python mode "
                                 f"{python_stages}")

    t0 = time.perf_counter()
    grid20 = synthetic.synthetic_pose_graph_grid3d(20, 20, 20, seed=0).to_problem()
    build_s = time.perf_counter() - t0
    out = jit_full("jit_general_auto", "grid3d 20^3 sparse_cholesky", grid20,
                   lm("sparse_cholesky"), torch.float64, reduction(0.5))
    cp = out["cp"]
    gs = getattr(out["jit"]._jit_cache[cp]._step.solve_fn, "general_sparse", None)
    emit(dict(phase="jit_general_auto_plan", build_seconds=build_s,
              W=banded.block_bandwidth(cp), **(plan_line(gs) if gs is not None else {})))
    if gs is None or not gs.healthy():
        raise AssertionError("grid3d 20^3: jit sparse_cholesky did not take the general tier")
    if gs.R != GRID20_CORE_BLOCKS:
        raise AssertionError(f"grid3d 20^3: core of {gs.R} blocks, the JAX package's plan "
                             f"has {GRID20_CORE_BLOCKS}")


def phase_jit_dogleg(sphere_problem, m3500_problem):
    """jit mode for DogLeg through ``sparse_cholesky`` on the sphere and the
    M3500-shaped graph (bench.py's tolerance), f64 then f32: in f64 python
    mode's iterations, status, cost and reused steps."""
    import torch

    import apex_tpu_torch as apx

    def dl(mode):
        return apx.DogLeg(apx.DogLegConfig(linear_solver_type="sparse_cholesky", mode=mode,
                                           **BENCH))

    for label, problem, gate in (("sphere2500 dogleg", sphere_problem, reduction(0.99)),
                                 ("m3500 dogleg", m3500_problem, reduction(0.95))):
        for dtype in (torch.float64, torch.float32):
            jit_full("jit_dogleg", label, problem, dl, dtype, gate)


def phase_jit_small_solvers(sphere_problem, m3500_problem):
    """jit mode for the QR sweep and plain PCG: LM ``sparse_qr`` on the
    sphere and the M3500-shaped graph (bench.py's settings; in f64 the JAX
    package's constants), LM ``pcg`` on the medium SE2 fixture and GN
    ``sparse_qr`` on the medium SE3 fixture with its first pose fixed (in
    f64 the certified settings and costs, in f32 bench.py's tolerance), f64
    then f32."""
    import torch

    import apex_tpu_torch as apx

    def lm(solver, **kw):
        return lambda mode: apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type=solver, mode=mode, **kw))

    def gn(**kw):
        return lambda mode: apx.GaussNewton(apx.GaussNewtonConfig(
            linear_solver_type="sparse_qr", mode=mode, **kw))

    def constants(label, share, dtype, *expected):
        def gate(res):
            reduction(share)(res)
            if dtype == torch.float64:
                check_costs(label, res, *expected)
        return gate

    def certified(fname, cost, dtype):
        def gate(res):
            if not res.converged:
                raise AssertionError(f"{fname}: {res.summary()}")
            if dtype == torch.float64 and not abs(res.final_cost - cost) <= 1e-8 * cost:
                raise AssertionError(f"{fname}: {res.final_cost}, certified {cost}")
        return gate

    # GN's fixture has its first pose fixed: undamped GN on the gauge-free
    # graph drifts along the gauge (steps of norm 0.08 at the optimum), and
    # index_add_'s atomic rounding moves its last iterations (7 or 8 on the
    # H100, either mode); the cost is the same with the gauge fixed
    fixtures = {f: apx.load_g2o(os.path.join(REPO, f[0])).to_problem(fix_first=f is MEDIUM_SE3)
                for f in (MEDIUM_SE3, MEDIUM_SE2)}
    for dtype in (torch.float64, torch.float32):
        # f32 stops at bench.py's tolerance: the certified one is below its
        # rounding
        tight = CERTIFIED if dtype == torch.float64 else BENCH
        for label, problem, make, gate in (
                ("sphere2500 sparse_qr", sphere_problem,
                 lm("sparse_qr", damping="auto", **BENCH),
                 constants("sparse_qr sphere", 0.99, dtype, SPHERE_INITIAL, SPHERE_FINAL,
                           SPHERE_ITERATIONS)),
                ("m3500 sparse_qr", m3500_problem, lm("sparse_qr", damping="auto", **BENCH),
                 constants("sparse_qr m3500", 0.95, dtype, M3500_INITIAL, M3500_FINAL,
                           M3500_ITERATIONS)),
                ("medium_se2_300 pcg", fixtures[MEDIUM_SE2], lm("pcg", **tight),
                 certified(MEDIUM_SE2[0], MEDIUM_SE2[1], dtype)),
                ("medium_se3_250 (first pose fixed) gauss_newton sparse_qr",
                 fixtures[MEDIUM_SE3], gn(**tight),
                 certified(MEDIUM_SE3[0], MEDIUM_SE3[1], dtype))):
            jit_full("jit_small_solvers", label, problem, make, dtype, gate)


def phase_jit_ba(ds, problem):
    """jit mode on the trafalgar-scale synthetic through ``schur`` (the
    explicit variant) and ``schur_implicit``, 10 LM iterations, f64 then
    f32: RMSE below 0.55x, and the landmark kernel launched inside the
    replayed graphs at least once per LM iteration, counted by name in the
    profile. Returns (kernel launches, LM iterations) of the jit solves."""
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.ba import rmse

    total = iterations = 0
    for solver in ("schur", "schur_implicit"):
        def make(mode, solver=solver):
            cfg = apx.LevenbergMarquardtConfig.for_bundle_adjustment()
            cfg.linear_solver_type = solver
            cfg.max_iterations = 10
            cfg.mode = mode
            return apx.LevenbergMarquardt(cfg)

        def gate(res):
            r0 = rmse(res.initial_cost, ds.num_observations)
            r1 = rmse(res.final_cost, ds.num_observations)
            if not r1 < 0.55 * r0:
                raise AssertionError(f"RMSE {r0} -> {r1} misses the 0.55x gate")

        # the dense Cholesky of S magnifies index_add_'s atomic rounding:
        # python mode's explicit solves spread by up to ~1e-8 on the H100
        rtol = 1e-7 if solver == "schur" else 1e-10
        for dtype in (torch.float64, torch.float32):
            out = jit_full("jit_ba", f"trafalgar257 {solver}", problem, make, dtype, gate, rtol)
            its, launches, profiled = out["iterations"], out["launches"], out["profiled"]
            if profiled["landmark_kernel_events"] < profiled["iterations"]:
                raise AssertionError(
                    f"{solver} {dtype}: {profiled['landmark_kernel_events']} landmark kernel "
                    f"events in the profile for {profiled['iterations']} LM iterations")
            if launches < its:
                raise AssertionError(f"{solver} {dtype}: {launches} launches, {its} iterations")
            total += launches
            iterations += its
    return total, iterations


# -- slice 9: the camera models, the extended groups and autodiff factors ------

# tests/test_camera_selfcal.py's models and true intrinsics, and the f-theta
# camera of tests/test_cameras.py (no focal: [cx, cy, k1, k2, k3, k4])
SELFCAL_MODELS = {
    "pinhole": [450.0, 455.0, 320.0, 240.0],
    "rad_tan": [450.0, 455.0, 320.0, 240.0, -0.2, 0.05, 1e-4, -1e-4, 0.0],
    "kannala_brandt": [380.0, 379.0, 318.0, 242.0, 0.01, -0.002, 1e-3, -2e-4],
    "fov": [350.0, 350.0, 320.0, 240.0, 0.8],
    "ucm": [460.0, 460.0, 320.0, 240.0, 0.55],
    "eucm": [460.0, 460.0, 320.0, 240.0, 0.55, 1.05],
    "double_sphere": [350.0, 350.0, 320.0, 240.0, -0.15, 0.57],
}
FTHETA = [320.0, 240.0, 300.0, 5.0, -2.0, 0.3]
# tests/test_camera_selfcal.py's LM config
SELFCAL_LM = dict(linear_solver_type="schur_implicit", max_iterations=60, pcg_tolerance=1e-8,
                  pcg_max_iterations=400)
SELFCAL_SLOTS = ("pose", "landmark", "intrinsics")
CAMERA_SPANS = ("camera.project", "camera.jacobians")
# The intrinsics each camera of ``camera_full`` holds, as COLMAP's bundle
# adjuster refines a camera by default (ba_refine_principal_point false):
# the principal point, RadTan's k3 (COLMAP's OPENCV model has none), and
# EUCM's (alpha, beta) and Double Sphere's (xi, alpha), which a view of 35
# degrees off axis cannot tell from the focal length (Double Sphere's are
# held at the JAX test's size too). With them free, EUCM's solves stall, and
# two implicit solves that differ only in the order of their sums
# (index_add_'s atomics) end far apart.
RING_FIXED = {"pinhole": [2, 3], "rad_tan": [2, 3, 8], "kannala_brandt": [2, 3], "fov": [2, 3],
              "ucm": [2, 3], "eucm": [2, 3, 4, 5], "double_sphere": [2, 3, 4, 5],
              "ftheta": [0, 1]}


def selfcal_scene(n_cams=6, n_pts=120, seed=0):
    """tests/test_camera_selfcal.py's ``make_scene`` through the port: a
    wall of points at z in [3.5, 4.5], cameras on a small arc looking down
    +Z. (poses [C, 7] world-to-camera, points [P, 3])."""
    import numpy as np
    import torch

    from apex_tpu_torch.manifolds import so3
    from apex_tpu_torch.manifolds.utils import mat_to_quat, quat_to_mat

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(3.5, 4.5, n_pts)], axis=1)
    poses = []
    for i in range(n_cams):
        c = np.array([0.6 * np.sin(i), 0.4 * np.cos(i), -0.3 + 0.1 * i])
        tilt = torch.tensor([0.05 * np.cos(i), 0.08 * np.sin(2 * i), 0.0], dtype=torch.float64)
        Rcw = quat_to_mat(so3.exp(tilt)).numpy()
        q = mat_to_quat(torch.from_numpy(Rcw)).numpy()
        poses.append(np.concatenate([-Rcw @ c, q]))
    return np.stack(poses), pts


def selfcal_ring(n_cams=257, n_pts=65_132, per_camera=879, seed=0):
    """A full-width self-calibration scene shaped as bench's trafalgar rung
    (``synthetic_ba_large``): ``n_pts`` points uniform in [-2, 2]^3 and
    ``n_cams`` cameras on a ring of radius 6 (height 0.25 sin 3a) looking
    at its centre, +Z forward, so that every point lies within 35 degrees
    of every camera's axis. Each point is seen by 3 or 4 cameras drawn at
    random from around the ring (``n_cams * per_camera`` observations,
    exactly ``per_camera`` per camera): camera slots shuffled against point
    slots, a camera drawn twice for one point swapped away. (poses [C, 7]
    world-to-camera, points [P, 3], camera index, point index), sorted by
    camera."""
    import numpy as np
    import torch

    from apex_tpu_torch.manifolds.utils import mat_to_quat

    rng = np.random.default_rng(seed)
    C, P, N = n_cams, n_pts, n_cams * per_camera
    if not 2 * P <= N <= 4 * P:
        raise ValueError(f"{N} observations for {P} points")
    pts = rng.uniform(-2.0, 2.0, (P, 3))
    views = np.full(P, N // P)
    views[rng.permutation(P)[:N % P]] += 1
    pt_idx = np.repeat(np.arange(P), views)
    cam_idx = rng.permutation(np.repeat(np.arange(C), per_camera))
    while True:
        # a point's slots are adjacent: a camera drawn twice sits twice in a run
        order = np.lexsort((cam_idx, pt_idx))
        c, q = cam_idx[order], pt_idx[order]
        dup = order[1:][(c[1:] == c[:-1]) & (q[1:] == q[:-1])]
        if not len(dup):
            break
        for i, j in zip(dup, rng.integers(0, N, len(dup))):
            cam_idx[i], cam_idx[j] = cam_idx[j], cam_idx[i]
    a = 2 * np.pi * np.arange(C) / C
    centres = 6.0 * np.stack([np.cos(a), np.sin(a), 0.25 * np.sin(3 * a)], axis=1)
    fwd = -centres / np.linalg.norm(centres, axis=1, keepdims=True)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    down = np.cross(fwd, right)
    Rcw = np.stack([right, down, fwd], axis=1)  # rows: the camera's x, y, z in the world
    q = mat_to_quat(torch.from_numpy(Rcw)).numpy()
    poses = np.concatenate([-np.einsum("cij,cj->ci", Rcw, centres), q], axis=1)
    order = np.lexsort((pt_idx, cam_idx))
    return poses, pts, cam_idx[order], pt_idx[order]


def selfcal_arrays(model, intr_true, poses, pts, pairs=None, shared=True, seed=1,
                   pixel_noise=0.3):
    """The arrays of tests/test_camera_selfcal.py's ``build_problem``
    (self-calibration) through the port: observations projected through the
    true intrinsics plus ``pixel_noise``; poses, points and focal lengths
    perturbed. ``pairs`` (camera index, point index) are the observations
    (None: every valid projection within 400 px of the principal point, as
    the test selects); ``shared``: one intrinsics row for all views, else
    one per camera. dict(cam_idx, pt_idx, obs, poses0, pts0, intr0)."""
    import numpy as np
    import torch

    from apex_tpu_torch import cameras
    from apex_tpu_torch.manifolds import SE3

    cam = cameras.get(model)
    intr_true = np.asarray(intr_true, dtype=np.float64)
    rng = np.random.default_rng(seed)
    C, P = poses.shape[0], pts.shape[0]
    if pairs is None:
        cam_idx, pt_idx = (a.reshape(-1) for a in np.meshgrid(np.arange(C), np.arange(P),
                                                              indexing="ij"))
    else:
        cam_idx, pt_idx = pairs
    p_cam = SE3.act(torch.from_numpy(poses[cam_idx]), torch.from_numpy(pts[pt_idx]))
    uv, valid = cam.project(torch.from_numpy(intr_true)[None], p_cam)
    uv, valid = uv.numpy(), valid.numpy()
    centre = intr_true[0 if model == "ftheta" else 2]
    keep = valid & (np.abs(uv[:, 0] - centre) < 400)
    if pairs is not None and not keep.all():
        raise AssertionError(f"{model}: {int((~keep).sum())} observations outside the view")
    cam_idx, pt_idx, uv = cam_idx[keep], pt_idx[keep], uv[keep]
    obs = uv + rng.normal(0, pixel_noise, uv.shape)
    poses0 = SE3.plus(torch.from_numpy(poses), torch.from_numpy(
        rng.normal(0, 0.01, (C, 6)))).numpy()
    pts0 = pts + rng.normal(0, 0.02, pts.shape)
    intr0 = np.tile(intr_true, (C, 1))
    intr0[:, :2] *= 1.0 + rng.normal(0, 0.02, (C, 2))
    return dict(cam_idx=cam_idx, pt_idx=pt_idx, obs=obs, poses0=poses0, pts0=pts0,
                intr0=intr0[:1] if shared else intr0)


def selfcal_problem(model, intr_true, poses, pts, pairs=None, shared=True, seed=1,
                    pixel_noise=0.3, fixed=None):
    """tests/test_camera_selfcal.py's ``build_problem`` (self-calibration)
    through the port, from ``selfcal_arrays``: every view one
    ``ProjectionFactor`` with ``HuberLoss(2.0)``; one intrinsics variable
    (``intr_shared``), or one per camera (``intr_NNNN``) where not
    ``shared``; ``fixed``: the indices of every intrinsics variable held
    (None: the test's, Double Sphere's distortion); the first pose fixed,
    and the second pose's x for the scale. (problem, observations)."""
    import apex_tpu_torch as apx
    from apex_tpu_torch import cameras
    from apex_tpu_torch.factors.projection import ProjectionFactor

    arrays = selfcal_arrays(model, intr_true, poses, pts, pairs, shared, seed, pixel_noise)
    problem = build_selfcal(apx, ProjectionFactor.template(cameras.get(model), SELFCAL_SLOTS),
                            arrays, model, fixed)
    return problem, len(arrays["obs"])


def build_selfcal(pkg, template, arrays, model, fixed=None):
    """A self-calibration problem of package ``pkg`` (its ``Problem`` and
    ``HuberLoss``) from ``selfcal_arrays``' output, each view a block of
    ``template``; ``fixed`` as in ``selfcal_problem``."""
    cam_idx, pt_idx, intr0 = arrays["cam_idx"], arrays["pt_idx"], arrays["intr0"]
    C, P = arrays["poses0"].shape[0], arrays["pts0"].shape[0]
    problem = pkg.Problem()
    pose_names = [f"pose_{i:03d}" for i in range(C)]
    pt_names = [f"pt_{j:04d}" for j in range(P)]
    shared = intr0.shape[0] == 1
    intr_names = ["intr_shared"] if shared else [f"intr_{i:04d}" for i in range(C)]
    problem.add_variables_batch(pose_names, "SE3", arrays["poses0"])
    problem.add_variables_batch(pt_names, "R3", arrays["pts0"])
    problem.add_variables_batch(intr_names, f"R{intr0.shape[1]}", intr0)
    intr_of = [0] * len(cam_idx) if shared else cam_idx
    slot_keys = [[pose_names[i] for i in cam_idx], [pt_names[j] for j in pt_idx],
                 [intr_names[i] for i in intr_of]]
    if fixed is None and model == "double_sphere":
        # (f, xi, alpha) are degenerate on a narrow view: distortion fixed
        fixed = [4, 5]
    if fixed:
        for name in intr_names:
            problem.fix_variable(name, indices=fixed)
    problem.add_residual_block_batch(slot_keys, template, {"obs": arrays["obs"]},
                                     loss=pkg.HuberLoss(2.0))
    problem.fix_variable(pose_names[0])
    problem.fix_variable(pose_names[1], indices=[0])
    return problem


def phase_camera_parity():
    """tests/test_camera_selfcal.py's scene and problem (6 cameras, 120
    points, one shared intrinsics variable) for each of its 7 models,
    through ``schur_implicit`` with its config in f64, python and jit mode
    on the card against python mode on the CPU: the same iterations and
    status, final cost within rtol 1e-8, the focal within 1% of the truth;
    then DogLeg with covariances on the pinhole scene, card against CPU
    (covariance of the intrinsics within rtol 1e-6 of its largest entry)."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx

    poses, pts = selfcal_scene()
    for model, intr in SELFCAL_MODELS.items():
        problem, n_obs = selfcal_problem(model, intr, poses, pts)
        res = {}
        for key, device, mode in (("cpu", "cpu", "python"), ("cuda", "cuda", "python"),
                                  ("cuda_jit", "cuda", "jit")):
            res[key] = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
                mode=mode, **SELFCAL_LM)).optimize(
                problem.compile(dtype=torch.float64, device=device))
        rh = res["cpu"]
        emit(dict(phase="camera_parity", model=model, observations=n_obs,
                  iterations=rh.iterations, status=rh.status.name,
                  **{f"cost_{k}": r.final_cost for k, r in res.items()},
                  **{f"iterations_{k}": r.iterations for k, r in res.items()},
                  focal=float(res["cuda"].variables["intr_shared"][0]), focal_true=intr[0]))
        for key in ("cuda", "cuda_jit"):
            rc = res[key]
            if (rc.iterations, rc.status) != (rh.iterations, rh.status):
                raise AssertionError(f"{model} {key} {rc.summary()} vs cpu {rh.summary()}")
            np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8,
                                       err_msg=f"{model} {key}")
            np.testing.assert_allclose(rc.variables["intr_shared"][0], intr[0], rtol=0.01,
                                       err_msg=f"{model} {key} focal")
    problem, _ = selfcal_problem("pinhole", SELFCAL_MODELS["pinhole"], poses, pts)
    res = {device: apx.DogLeg(apx.DogLegConfig(max_iterations=40, compute_covariances=True))
           .optimize(problem.compile(dtype=torch.float64, device=device))
           for device in ("cuda", "cpu")}
    rc, rh = res["cuda"], res["cpu"]
    cov_c, cov_h = rc.covariances["intr_shared"], rh.covariances["intr_shared"]
    emit(dict(phase="camera_parity", model="pinhole", optimizer="dogleg",
              iterations=rc.iterations, status=rc.status.name, cost_cuda=rc.final_cost,
              cost_cpu=rh.final_cost, covariance_diag_cuda=np.diag(cov_c).tolist(),
              covariance_max_abs_diff=float(np.abs(cov_c - cov_h).max())))
    if (rc.iterations, rc.status) != (rh.iterations, rh.status):
        raise AssertionError(f"dogleg: cuda {rc.summary()} vs cpu {rh.summary()}")
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)
    np.testing.assert_allclose(cov_c, cov_h, rtol=1e-6, atol=1e-6 * np.abs(cov_h).max())


def camera_solve(phase, label, problem, n_obs, solver, dtype, rtol):
    """One (model, Schur variant, dtype) of ``camera_full``: two python-mode
    solves (the second timed; their costs' spread is python mode's own
    rounding, from ``index_add_``'s atomic order), then jit mode: the first
    solve (warm-up and capture) and the timed one. f64 must give python
    mode's iterations and status and its final cost within ``rtol`` (or 10x
    python mode's spread). Every solve must bring the RMSE below 0.55x the
    initial, and the landmark kernel must run at least once per LM
    iteration. Profiles: for ``schur``, a python-mode solve (the camera
    spans' share of the device time) and a jit solve; for
    ``schur_implicit`` (thousands of device events per LM iteration, whose
    trace takes the profiler long to read) a jit solve of its first 3 LM
    iterations, captured by a solve before it. The landmark
    kernel must appear in the jit profile once per LM iteration. Returns (kernel launches, LM
    iterations) over its solves."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.ba import rmse

    name = str(dtype).replace("torch.", "")
    t0 = time.perf_counter()
    cp = problem.compile(dtype=dtype, device="cuda")
    compile_s = time.perf_counter() - t0

    def make(mode, iterations=None):
        cfg = apx.LevenbergMarquardtConfig.for_bundle_adjustment()
        cfg.linear_solver_type = solver
        cfg.max_iterations = iterations or cfg.max_iterations
        cfg.mode = mode
        return apx.LevenbergMarquardt(cfg)

    def profiled_solve(lm):
        before = graph_counters()
        t0 = time.perf_counter()
        out = profile_solve(lambda: lm.optimize(cp))
        out["profile_seconds"] = time.perf_counter() - t0
        return out, {k: v - before[k] for k, v in graph_counters().items()}

    python, jit = make("python"), make("jit")
    again, _, again_n = counted_solve(python, cp)
    ref, python_s, python_n = counted_solve(python, cp)
    spread = abs(again.final_cost - ref.final_cost) / abs(ref.final_cost)
    counts = [again_n, python_n]
    iterations = again.iterations + ref.iterations
    camera = {}
    if solver == "schur":
        python_profile, n_profile = profiled_solve(python)
        counts.append(n_profile)
        iterations += python_profile["iterations"]
        camera_ms = sum(python_profile["spans"].get(s, {}).get("device_ms", 0.0)
                        for s in CAMERA_SPANS)
        camera = dict(camera_device_ms=camera_ms,
                      camera_share_of_device_time=camera_ms / 1e3
                      / python_profile["device_busy_seconds"],
                      python_device_idle_share=python_profile["device_idle_share"],
                      landmark_kernel_events_python=python_profile["landmark_kernel_events"])
    first, first_s, first_n = counted_solve(jit, cp)
    torch.cuda.reset_peak_memory_stats()
    res, seconds, n = counted_solve(jit, cp)
    peak = torch.cuda.max_memory_allocated()
    if solver == "schur":
        short = jit
    else:
        # its own warm-up and capture first, outside the profile
        short = make("jit", iterations=3)
        warm, _, warm_n = counted_solve(short, cp)
        counts.append(warm_n)
        iterations += warm.iterations
    profiled, profiled_n = profiled_solve(short)
    counts += [first_n, n, profiled_n]
    iterations += first.iterations + res.iterations + profiled["iterations"]
    rtol = max(rtol, 10.0 * spread)
    ctx = jit._jit_cache[cp]._step.solve_fn.schur_context
    r0, r1 = rmse(res.initial_cost, n_obs), rmse(res.final_cost, n_obs)
    line = dict(phase=phase, model=label, solver=solver, variant=ctx.variant, Dc=ctx.Dc,
                dtype=name, observations=n_obs, status=res.status.name,
                iterations=res.iterations, python_iterations=ref.iterations,
                initial_cost=res.initial_cost, final_cost=res.final_cost,
                python_final_cost=ref.final_cost,
                rel_diff_to_python=abs(res.final_cost - ref.final_cost) / ref.final_cost,
                python_run_to_run_spread=spread, parity_rtol=rtol, rmse_initial=r0,
                rmse_final=r1, compile_seconds=compile_s, first_solve_seconds=first_s,
                capture_seconds=jit._jit_cache[cp].capture_seconds, solve_seconds=seconds,
                seconds_per_lm_iteration=seconds / res.iterations,
                python_solve_seconds=python_s,
                python_seconds_per_lm_iteration=python_s / ref.iterations,
                speedup_over_python=python_s / seconds,
                profiled_iterations=profiled["iterations"],
                device_idle_share=profiled["device_idle_share"],
                device_idle_share_timed=1.0 - (
                    profiled["device_busy_seconds"] / profiled["iterations"]
                    / (seconds / res.iterations)),
                landmark_kernel_events_jit=profiled["landmark_kernel_events"],
                host_reads_per_lm_iteration=n["host_reads"] / res.iterations,
                device_events_per_lm_iteration=profiled["device_events_per_lm_iteration"],
                top_device_ops_ms=profiled["top_device_ops_ms"][:6],
                profile_seconds=profiled["profile_seconds"], max_memory_allocated=peak,
                **camera)
    emit(line)
    for r in (again, ref, first, res):
        if not (np.isfinite(r.final_cost) and rmse(r.final_cost, n_obs) < 0.55 * r0):
            raise AssertionError(f"{label} {solver} {name}: RMSE {r0} -> "
                                 f"{rmse(r.final_cost, n_obs)} misses the 0.55x gate")
    if dtype == torch.float64:
        if (res.iterations, res.status) != (ref.iterations, ref.status):
            raise AssertionError(f"{label} {solver}: jit {res.summary()} vs python "
                                 f"{ref.summary()}")
        np.testing.assert_allclose(res.final_cost, ref.final_cost, rtol=rtol,
                                   err_msg=f"{label} {solver} jit against python mode")
    if profiled["landmark_kernel_events"] < profiled["iterations"]:
        raise AssertionError(f"{label} {solver} {name}: {profiled['landmark_kernel_events']} "
                             f"landmark kernel events for {profiled['iterations']} iterations")
    if first_n["captures"] != 2 or n["captures"] or profiled_n["captures"]:
        raise AssertionError(f"{label} {solver}: captures {first_n}, {n}, {profiled_n}")
    launches = sum(c["replayed_kernel_launches"] + c["eager_kernel_launches"] for c in counts)
    if launches < iterations:
        raise AssertionError(f"{label} {solver} {name}: {launches} landmark kernel launches "
                             f"for {iterations} LM iterations")
    return launches, iterations


def phase_camera_full():
    """Self-calibration at full width: ``selfcal_ring``'s 257 cameras,
    65,132 points and 225,903 observations (the trafalgar rung's counts),
    one intrinsics variable per camera (the BAL convention: a camera entity
    of 6 + K DOF) with ``RING_FIXED``'s entries held, for the pinhole and
    the 7 extended models, through ``schur`` (the explicit variant:
    Dc = 257 (6 + K) <= 3,855) and ``schur_implicit``, LM with the bundle
    adjustment config (up to 20 iterations), jit mode in f64 beside python
    mode; Kannala-Brandt in f32 as well. Returns (kernel launches, LM
    iterations) over all its solves."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    poses, pts, cam_idx, pt_idx = selfcal_ring()
    seen = np.bincount(pt_idx, minlength=pts.shape[0])
    emit(dict(phase="camera_full_scene", cameras=poses.shape[0], points=pts.shape[0],
              observations=len(pt_idx), views_per_point_min=int(seen.min()),
              views_per_point_mean=float(seen.mean()), views_per_point_max=int(seen.max()),
              seconds=time.perf_counter() - t0))
    if seen.min() < 2:
        raise AssertionError(f"a point is seen by {seen.min()} cameras")
    launches = iterations = 0
    models = dict(SELFCAL_MODELS, ftheta=FTHETA)
    for model, intr in models.items():
        t0 = time.perf_counter()
        problem, n_obs = selfcal_problem(model, intr, poses, pts, pairs=(cam_idx, pt_idx),
                                         shared=False, fixed=RING_FIXED[model])
        build_s = time.perf_counter() - t0
        dtypes = (torch.float64, torch.float32) if model == "kannala_brandt" else (
            torch.float64,)
        for dtype in dtypes:
            # as phase_jit_ba: python mode's explicit solves spread by up to
            # ~1e-8 (the Cholesky of S magnifies atomic-order rounding)
            for solver, rtol in (("schur", 1e-7), ("schur_implicit", 1e-10)):
                n, its = camera_solve("camera_full", model, problem, n_obs, solver, dtype, rtol)
                launches += n
                iterations += its
        emit(dict(phase="camera_full_build", model=model, build_seconds=build_s))
    return launches, iterations


# tangent noise of the lifted sphere's measurements: translation 0.01,
# rotation 0.002, and 0.001 on log s (Sim3) or 0.01 on the velocity (SE23)
LIE_NOISE = {"Sim3": [0.01] * 3 + [0.002] * 3 + [0.001],
             "SE23": [0.01] * 3 + [0.002] * 3 + [0.01] * 3}


def lifted_sphere(group, n_poses=2500, rings=50, seed=0):
    """sphere2500's graph (``synthetic_pose_graph_3d(2500, 50, seed=0)``'s
    edges) on Sim3 or SE23: the truth is the graph's SE3 poses lifted with a
    seeded scale drift (Sim3: log s a random walk, steps N(0, 0.002)) or
    velocities (SE23: the next pose's position minus this one's); each
    edge's measurement is the true relative element perturbed by a
    tangent noise (``LIE_NOISE``), and the initial values integrate the odometry edges
    from the first pose, as the SE3 graph's do. The first pose is fixed."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.io import synthetic
    from apex_tpu_torch.manifolds import get

    graph = synthetic.synthetic_pose_graph_3d(n_poses=n_poses, rings=rings, seed=0)
    se3 = np.stack([graph.vertices_se3[i] for i in range(graph.num_vertices)])
    n = se3.shape[0]
    rng = np.random.default_rng(seed)
    if group == "Sim3":
        extra = np.exp(np.cumsum(rng.normal(0, 0.002, n)))[:, None]
    else:
        extra = np.diff(se3[:, :3], axis=0, append=se3[-1:, :3])
    G = get(group)
    truth = torch.from_numpy(np.concatenate([se3, extra], axis=1))
    src = np.array([e.frm for e in graph.edges_se3])
    dst = np.array([e.to for e in graph.edges_se3])
    noise = rng.normal(size=(len(src), G.dof)) * np.asarray(LIE_NOISE[group])
    meas = G.plus(G.between(truth[src], truth[dst]), torch.from_numpy(noise))
    init = [truth[0]]
    for k in range(n - 1):  # the odometry edges come first, k -> k + 1
        init.append(G.compose(init[-1], meas[k]))
    problem = apx.Problem()
    names = [f"x{i}" for i in range(n)]
    problem.add_variables_batch(names, group, torch.stack(init).numpy())
    for k in range(len(src)):
        problem.add_residual_block([names[src[k]], names[dst[k]]],
                                   apx.BetweenFactor(group, meas[k].numpy()))
    problem.fix_variable(names[0])
    return problem


def phase_lie_full():
    """The extended groups at full width: Sim3 and SE23 pose graphs on
    sphere2500's edges (``lifted_sphere``) through LM ``sparse_cholesky``
    (the banded tier: 7- and 9-wide blocks), ``damping="auto"``,
    ``cost_tolerance=1e-4``, f64, jit mode beside python mode: converged
    with the cost reduced by more than 99%, and jit equal to python mode.
    Prints the bandwidth and the panel."""
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.linalg import banded

    def lm(mode):
        return apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type="sparse_cholesky", damping="auto", mode=mode, **BENCH))

    for group in ("Sim3", "SE23"):
        t0 = time.perf_counter()
        problem = lifted_sphere(group)
        build_s = time.perf_counter() - t0
        out = jit_full("lie_full", f"sphere2500 {group}", problem, lm, torch.float64,
                       reduction(0.99))
        W = banded.block_bandwidth(out["cp"])
        emit(dict(phase="lie_full_band", group=group, build_seconds=build_s,
                  bandwidth_columns=W, panel=banded.default_panel(W),
                  max_bandwidth=banded.MAX_BANDWIDTH))
        if W > banded.MAX_BANDWIDTH:
            raise AssertionError(f"{group}: bandwidth {W} is above the banded tier's")


def autodiff_rosenbrock():
    """The Rosenbrock residual r = [10 (y - x^2), 1 - x] over one R2
    variable (tests/test_optimizers.py's) as an ``AutoDiffFactor`` class:
    its residual only, the Jacobian by ``torch.func``."""
    import torch

    from apex_tpu_torch.factors import AutoDiffFactor

    class AutoDiffRosenbrock(AutoDiffFactor):
        kind = "rosenbrock"

        def signature(self):
            return ("rosenbrock",)

        def var_manifolds(self):
            return ["R2"]

        def residual_dim(self):
            return 2

        @classmethod
        def residual(cls, manifolds, data, params):
            x, y = params[0][..., 0], params[0][..., 1]
            return torch.stack([10.0 * (y - x * x), 1.0 - x], dim=-1)

    return AutoDiffRosenbrock


def rosenbrock_problem():
    """``autodiff_rosenbrock``'s factor from (-1.2, 1)."""
    import numpy as np

    import apex_tpu_torch as apx

    problem = apx.Problem()
    problem.add_variable("xy", "R2", np.array([-1.2, 1.0]))
    problem.add_residual_block(["xy"], autodiff_rosenbrock()())
    return problem


def extended_chain(gname, n=8, seed=0):
    """tests/test_extended_manifolds_e2e.py's chain on ``gname`` through
    the port: ``n`` poses from steps 0.3 N(0, 1) and initial noise 0.05
    (numpy, ``seed``), the first pose fixed, a between factor per step and
    a loop closure."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.manifolds import get

    G = get(gname)
    rng = np.random.default_rng(seed)
    truth = [G.identity()]
    for _ in range(n - 1):
        truth.append(G.plus(truth[-1], torch.from_numpy(0.3 * rng.normal(size=G.dof))))
    problem = apx.Problem()
    for i, t in enumerate(truth):
        init = t if i == 0 else G.plus(t, torch.from_numpy(rng.normal(0, 0.05, G.dof)))
        problem.add_variable(f"x{i}", gname, init.numpy())
    problem.fix_variable("x0")
    for a, b in [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]:
        problem.add_residual_block([f"x{a}", f"x{b}"],
                                   apx.BetweenFactor(G, G.between(truth[a], truth[b]).numpy()))
    return problem


def phase_lie_small():
    """SGal3 and the autodiff Rosenbrock at the JAX tests' sizes, card
    against CPU: tests/test_extended_manifolds_e2e.py's 8-pose chain with a
    loop closure (steps 0.3 N(0, 1), initial noise 0.05, from numpy) through
    LM, python and jit mode, converged below 1e-12 with the CPU's
    iterations; the Rosenbrock ``AutoDiffFactor`` through LM, GN and DogLeg
    with the CPU's iterations and final cost (rtol 1e-8)."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx

    chain, rosen = extended_chain("SGal3"), rosenbrock_problem()
    cases = [("sgal3_chain lm", chain, lambda mode: apx.LevenbergMarquardt(
                 apx.LevenbergMarquardtConfig(max_iterations=60, mode=mode)))]
    for kind, make in (("lm", lambda mode: apx.LevenbergMarquardt(
                            apx.LevenbergMarquardtConfig(max_iterations=100, mode=mode))),
                       ("gn", lambda mode: apx.GaussNewton(
                            apx.GaussNewtonConfig(max_iterations=100, mode=mode))),
                       ("dl", lambda mode: apx.DogLeg(
                            apx.DogLegConfig(max_iterations=200, mode=mode)))):
        cases.append((f"rosenbrock {kind}", rosen, make))
    for label, problem, make in cases:
        host = make("python").optimize(problem.compile(dtype=torch.float64, device="cpu"))
        cp = problem.compile(dtype=torch.float64, device="cuda")
        for mode in ("python", "jit"):
            res = make(mode).optimize(cp)
            emit(dict(phase="lie_small", case=label, mode=mode, iterations=res.iterations,
                      status=res.status.name, final_cost=res.final_cost,
                      cpu_iterations=host.iterations, cpu_final_cost=host.final_cost))
            if (res.iterations, res.status) != (host.iterations, host.status) or not res.converged:
                raise AssertionError(f"{label} {mode}: cuda {res.summary()} vs cpu "
                                     f"{host.summary()}")
            if label.startswith("sgal3"):
                if not res.final_cost < 1e-12:
                    raise AssertionError(f"{label} {mode}: final cost {res.final_cost}")
            else:
                np.testing.assert_allclose(res.final_cost, host.final_cost, rtol=1e-8,
                                           atol=1e-25, err_msg=f"{label} {mode}")
                np.testing.assert_allclose(res.variables["xy"], [1.0, 1.0], atol=1e-6)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card")
    start = time.perf_counter()
    sys.path.insert(0, REPO)
    from apex_tpu_torch.kernels import landmark_blocks as lb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi, torch_device_name=kind,
              torch=torch.__version__, cuda=torch.version.cuda,
              allow_tf32=torch.backends.cuda.matmul.allow_tf32))

    t0 = time.perf_counter()
    lb.build()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              source=os.path.relpath(str(lb.SOURCE), REPO),
              config={str(d).replace("torch.", ""): lb.launch_config(d)
                      for d in (torch.float32, torch.float64)}))

    measured = {}
    for P in (65_132, 993_923):
        for dtype in (torch.float32, torch.float64):
            measured[(P, dtype)] = phase_kernel(P, dtype)

    phase_small_parity()
    ds, ba_problem, launches, iterations, implicit = phase_full_slice()
    phase_pose_graph_parity()
    sphere_graph, sphere_problem = phase_pose_graph_full()
    phase_se2_parity()
    m3500_problem = phase_se2_full()
    phase_robust_sweep()
    phase_schur_explicit_parity()
    explicit_launches, explicit_iterations = phase_schur_explicit_full(ds, ba_problem, implicit)
    launches += explicit_launches
    iterations += explicit_iterations
    phase_optimizers(sphere_problem)
    phase_small_solvers(sphere_problem, m3500_problem)
    phase_covariance(sphere_graph)
    phase_general_parity()
    phase_general_full()
    phase_general_auto()

    from apex_tpu_torch.optim import graphs

    phase_jit_parity()
    phase_jit_pose_graphs(sphere_problem, m3500_problem)
    phase_jit_general()
    phase_jit_dogleg(sphere_problem, m3500_problem)
    phase_jit_small_solvers(sphere_problem, m3500_problem)
    # the jit path's kernel count, from 0: eager launches in its solves (the
    # warm-up before each capture) and launches made by graph replays
    lb.launches = 0
    graphs.reset_counters()
    launches_jit, iterations_jit = phase_jit_ba(ds, ba_problem)

    seconds = {"earlier_phases": time.perf_counter() - start}
    t0 = time.perf_counter()
    phase_camera_parity()
    seconds["camera_parity"] = time.perf_counter() - t0
    # the camera path's kernel count, from 0, python and jit mode together
    lb.launches = 0
    graphs.reset_counters()
    t0 = time.perf_counter()
    launches_camera, iterations_camera = phase_camera_full()
    seconds["camera_full"] = time.perf_counter() - t0
    if lb.launches + graphs.kernel_launches != launches_camera:
        raise AssertionError(f"camera_full: {lb.launches} + {graphs.kernel_launches} kernel "
                             f"launches counted, {launches_camera} summed over its solves")
    t0 = time.perf_counter()
    phase_lie_full()
    phase_lie_small()
    seconds["lie"] = time.perf_counter() - t0
    emit(dict(phase="seconds", **seconds))

    main_shape = measured[(65_132, torch.float64)]
    emit({"kernels": [{
        "name": "invert_landmark_blocks",
        "route": "cuda",
        "source": "apex_tpu_torch/csrc/landmark_blocks.cu",
        "replaces": "apex_tpu/kernels/landmark_blocks.py:101",
        "launches": launches + launches_camera,
        "launches_per_lm_iteration": (launches + launches_camera) / (iterations
                                                                   + iterations_camera),
        "launches_camera": launches_camera,
        "launches_per_lm_iteration_camera": launches_camera / iterations_camera,
        "launches_jit": launches_jit,
        "launches_per_lm_iteration_jit": launches_jit / iterations_jit,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["device_us"] / 1e3,
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_us"] / 1e3,
        "bound_by": main_shape["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the regularized inverse
        "device_us": main_shape["device_us"],
        "bound_us": main_shape["bound_us"],
        "share": main_shape["share"],
        "host_us": main_shape["host_us"],
        "call_ms": main_shape["call_ms"],
        "smoke_seconds": time.perf_counter() - start,
        "shape": [65_132, 3, 3],
        "dtype": "float64",
        "shapes": [{key: m[key] for key in ("P", "dtype", "device_us", "bound_us", "share",
                                            "copy_us", "host_us", "call_ms", "plain_ms")}
                   for m in measured.values()],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
