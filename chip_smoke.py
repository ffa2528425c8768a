#!/usr/bin/env python3
"""Drive the PyTorch port's bundle-adjustment paths (implicit and explicit
Schur) and pose-graph paths (SE3, SE2, the robust-loss sweep with a prior,
the dense solvers, Gauss-Newton and DogLeg, sparse_qr, pcg, covariances,
the general-sparsity tier), lens self-calibration through the 8 camera
models, and pose graphs on the extended Lie groups once on one CUDA card,
in python mode and in ``mode="jit"`` (replayed CUDA graphs; phases 19-28),
then the solver's support surface: observers, checkpoint / resume and the
CLIs' ``--dataset`` (phases 29-31), the ported examples and a mobile
robot's ROS2 recording through the bag and DDS layers (phases 32-33), the
multi-device solves over ``torch.distributed`` (phase 34), and last the
JAX package's scale ladder at full size (phase 35).

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order,
each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: compile the four CUDA sources of ``apex_tpu_torch/csrc`` (the
   landmark-block kernel, the SPD inverse kernel, the conditional graph
   builder, the assembly kernels), one nvcc each, started together; the landmark kernel's launch
   configuration per dtype (tile, stages, residency, registers) and the SPD
   kernel's per block size; then capture_census: which library calls hold
   memory nodes in a CUDA graph capture (none of those jit mode puts in a
   conditional body may);
3. kernel: the CUDA landmark-block inverse against its plain PyTorch version
   on the card, at P = 65,132 (trafalgar's landmarks) and 993,923 (venice's),
   f32 and f64: bitwise equal, and timed (see ``phase_kernel``); at 226,730
   and 156,502 (dubrovnik's and ladybug's) bitwise equal;
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
    capture, instantiate and timed-solve seconds, graphs, replays and host
    reads (at most 2 per solve; the QR solvers' loop stays on the host), the
    share of a solve's wall time outside its graph launches (CUDA events;
    torch.profiler traces no jit solve: it misses kernels of conditional
    graphs), peak memory and the graph memory kept reserved; in the BA
    phases the landmark kernel runs once per LM iteration inside the
    graphs, counted on the device;
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
    landmark kernel once per LM iteration, counted on the device, and at
    most 2 host reads per jit solve; prints s per LM iteration, the share of
    the jit solve outside its graph launches and the camera spans' share of
    python mode's device time;
27. lie full: Sim3 and SE23 pose graphs on sphere2500's edges
    (``lifted_sphere``) through LM ``sparse_cholesky``, f64, as phase 20;
28. lie small: tests/test_extended_manifolds_e2e.py's SGal3 chain and the
    Rosenbrock ``AutoDiffFactor`` (LM, GN, DogLeg), python and jit mode on
    the card against the CPU;
29. support BA: phase 5's problem and config in f64, solved twice without
    observers (the reference and its spread), once with a
    ``HistoryObserver``, a ``CheckpointObserver(every=3)`` and a
    ``RerunObserver`` on a ``MemorySink``, the same under ``mode="jit"``
    (which must run python mode: no graph captured or replayed), and
    resumed from the last checkpoint. Gates: the observed solves give the
    reference's iterations and status, the history its costs (rtol 1e-10,
    or 10x the spread); the resume's initial cost is the checkpoint's
    (rtol 1e-10) and it passes the BA gate; one kernel launch per LM
    iteration in every solve. Prints the observers' host seconds per LM
    iteration, the checkpoint's bytes and save seconds, the sink's records
    and the peak memory;
30. support pose graph: the sphere with ``expose_matrix_data`` (a dense H of
    15,000^2 to the host each iteration), a ``RerunObserver`` and a
    ``HistoryObserver``: the JAX package's constants as in phase 7, H and g
    of 15,000, a 256 x 256 x 3 heat map; seconds per iteration with and
    without the hook;
31. support CLI: the trafalgar-scale synthetic and the sphere written with
    ``save_bal`` / ``save_g2o`` into a temporary ``APEX_TPU_DATA_DIR``
    under the registry's names (nothing is fetched), then ``python -m
    apex_tpu_torch.cli.bundle_adjustment --dataset trafalgar-257 --solver
    explicit`` (exit 0, the RMSE gate, one kernel launch per LM iteration)
    and ``python -m apex_tpu_torch.cli.pose_graph --dataset sphere2500``
    (exit 0, the library's solve of the same file, the sphere's constants),
    and one sphere solve under ``utils.profiling.trace``;
32. examples: the eight ported examples (``apex_tpu_torch.examples``) in
    one subprocess on the card (their default platform) and one with
    ``--platform cpu``, each example's ``main`` in turn: exit 0, the card's
    rows equal the CPU's (status and iterations, and every value within
    rtol 1e-8), and in ``compare_solvers`` one landmark-kernel launch per LM
    iteration of the two Schur rows and none in the dense rows (counted
    per solve); prints each example's seconds on both devices;
33. bags: a 10-minute recording of a mobile robot (/imu at 200 Hz, /odom at
    50 Hz, /tf at 100 Hz, /scan at 40 Hz with 1,081 beams: 234,000
    messages, 275.6 MB of CDR) written through the port's ``Writer``
    as sqlite3, MCAP and MCAP with zlib chunks, one process per storage at
    once, each read back whole and held to the recording (float64 fields
    exact, float32 fields at their float32 rounding) with its
    ``metadata.yaml`` counts; then ``bag_tools`` info, filter and extract
    (30,000 CSV rows) and a replay of /odom through ``LoopbackTransport``
    into a ``DdsListener``. Prints per storage the write and read seconds,
    messages/s, MB/s and file bytes, with the host's CPU model;
34. multidevice: ``apex_tpu_torch.parallel`` with its ranks as processes
    spawned from the smoke (``parallel.launch``), first 1 NCCL rank, then
    2 gloo ranks sharing the card (their all-reduces through host memory):
    the trafalgar-scale synthetic of phase 5 in its default layout through
    the landmark-partitioned Schur step, 10 LM iterations with the forcing
    sequence and the warm start, f64 (twice on 1 rank), f32 on 2 ranks; its
    flat layout through the observation-sharded block path on 2 ranks; the
    sphere2500-shaped graph through the banded sharded step and the medium
    SE3 fixture through the dense one, 8 steps each (twice on 1 rank); then
    ``graft_entry.dryrun_multichip(2, backend="gloo")`` and the
    ``multichip_ba`` example on 2 gloo ranks. Each rank prints one line per
    run (costs, kernel launches, all-reduces, bytes and seconds per LM
    iteration, the all-reduce share, s per LM iteration, peak memory).
    Gates: the path taken, the BA gate, 2 ranks against 1 (rtol 1e-8 BA,
    1e-10 pose graphs, or 10x the two 1-rank runs' spread), both ranks'
    final values bitwise equal, one kernel launch per rank per LM
    iteration on both Schur routes, the sphere reduced by 99%;
35. scale: bench.py's ladder at full size through
    ``apex_tpu_torch.benches.ladder``'s build and solve functions (its
    configs and gates): torus3d (5,000 poses), cubicle (5,750) and pose50k
    (50,000 poses, D = 300,000) through LM ``sparse_cholesky``, then
    dubrovnik-356 (1,255,256 observations), ladybug-1723 (678,862) and
    venice-1778 (5,001,514; P = 993,923, 6,351 of them seen by no camera)
    through ``schur_implicit``; each f64 in python mode and in jit mode
    (the first solve timed apart, then one timed solve), f32 in jit mode
    and once in python mode for its counts; dubrovnik also once through
    ``schur`` (the explicit variant, Dc = 3,204). One line per rung: the
    card, the host CPU, build, compile, first-solve, capture and solve
    seconds, LM iterations, costs and RMSE, peak allocated and reserved
    memory, graph memory, host reads, kernel launches, PCG iterations and
    CR retries per LM iteration, and for the venice f64 jit solve the share
    of its wall time outside its graph launches (CUDA events); venice
    also in f64 for 5 fixed LM iterations in both modes (peak memory of a
    solve that iterates), and pose50k's and that venice run's first jit
    solves under the allocator's history (the graph pool's peak and what
    the captured programs keep, by allocating line). Gates:
    f64 in both modes the JAX package's initial cost (rtol 1e-12), status,
    LM iterations and final cost (rtol 1e-8; ``SCALE_JAX``); jit mode python
    mode's (rtol 1e-10, or 10x python mode's spread); every dtype and mode
    bench.py's gate; one kernel launch per BA LM iteration in python mode;
    venice's unseen landmarks at their initial values; the 5-iteration
    venice below 0.46 px, jit mode python mode's;
36. spd_inverse: the SPD inverse kernel against its plain version at every
    (B, n) the main path gave it, f32 and f64 (``SPD_RTOL``), timed beside
    the plain version and its ``torch.linalg.eigh``. After jit BA (phase
    24), pcg_chunk holds ``graphs.PCG_CHUNK`` 1 against 4;
37. schur_assemble: the assembly kernels at venice's six groups, f64 and
    f32: the same bits twice, within ``ASSEMBLY_RTOL`` of the generic path
    they replace (their plain version), and timed (each group and the
    whole assemble) against their byte bound and the generic path (see
    ``phase_schur_assemble``);
38. schur_apply: the coupling kernels at venice's six groups, f64 and f32:
    W^T x (alone and fused with Hpp^-1), W u, the Schur-Jacobi blocks and
    one S-apply, each the same bits twice, within ``COUPLING_RTOL`` of the
    plain path, and timed against its byte bound and the plain path (see
    ``phase_schur_apply``).

The landmark-block kernel, the port of the one TPU kernel, runs on the BA
paths only; the SPD inverse kernel (``spd_clamped_inv``, which the reference
left to XLA) in both PCG preconditioners (implicit BA, ``pcg``); the
assembly kernels (``schur_assemble``, the linearization and the Schur sums
the reference left to XLA) in every BAL pinhole BA group of a CUDA problem;
the coupling kernels (``schur_apply``, the sums over W of the implicit Schur
solve) in every coupling group of a CUDA problem at De = 9 or 6.
Then the kernels line (each kernel's launches on the main path, its time, bound and
plain version's time), and last
``{"ok": true, "device": {...}}``. It needs one card, and refuses to run
without one.
"""

import functools
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CALL_RUNS = 25  # single calls timed one by one (median)
# The SPD inverse kernel against its plain version (spd_errors): an SPD
# block relative to its largest entry, a clamped block's clamped and cross
# terms in its eigenbasis relative to 1/floor. Two eigensolvers (Jacobi
# rotations, cuSOLVER's syevj) agree to the dtype's rounding times the
# conditioning of the eigenvectors, which spd_blocks keeps well separated
SPD_RTOL = {"float64": 1e-10, "float32": 1e-3}
# the assembly kernels against the generic path: each output's largest
# error over its largest entry (tests/test_torch_cuda.py ASSEMBLY_RTOL)
ASSEMBLY_RTOL = {"float64": 1e-12, "float32": 1e-3}
# The kept spectrum of a block with a clamped eigenvalue, relative to its
# largest kept 1/w: that inverse holds entries of 1/floor, each stored to
# the dtype's rounding eps / floor, which is eps / rel_floor of the kept
# scale (4 times that; the plain version's own error reaches 0.75 times)
SPD_KEPT_RTOL = {"float64": 4 * 2.220446049250313e-16 / 1e-12,
                 "float32": 4 * 1.1920928955078125e-07 / 1e-6}
# the coupling kernels against the plain path (gathers, batched products,
# index_add_): each result's largest error over the largest entry of the
# same sum taken over |W|, |x|, |u|, |Hpp^-1| (and |H_cc|). Each order of
# summation rounds within (n + 9) units of the dtype's rounding of that
# scale, n the rows of one sum: at venice at most 2,213 (an entity's rows
# in one group), so the two within 2 x 2,222 units, 4.9e-13 in f64 and
# 2.6e-4 in f32 (tests/test_torch_cuda.py COUPLING_RTOL, at its scenes' 150)
COUPLING_RTOL = {"float64": 1e-12, "float32": 5e-4}
SPD_PLAIN_BATCH = 16_384
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


def median_ms(fn, x, runs=CALL_RUNS):
    """Median of ``runs`` single calls, each between two CUDA events: the
    host's work for the call and the kernel together."""
    import torch

    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_and_host_us(fn, copies, calls=TIMED_LAUNCHES):
    """(device us per launch, host us per call) of ``calls`` calls of
    ``fn`` over ``copies`` in turn (a call of several launches: the calls'
    launches together at most ~300). The calls are queued behind a sleeping
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
        for i in range(calls):
            fn(copies[i % len(copies)])
        host_s = time.perf_counter() - t0
        queued_in_time = not start.query()
        end.record()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) * 1e3 / calls, host_s * 1e6 / calls
        cycles *= 2


def bound_us(P, dtype_name):
    """The least time the card could take: each input and output byte moved
    once at the HBM rate, or the operations at the peak rate of the dtype,
    whichever is longer."""
    size = 8 if dtype_name == "float64" else 4
    bytes_us = 2 * 9 * size * P / HBM_BYTES_PER_S * 1e6
    ops_us = OPS_PER_BLOCK * P / PEAK_OPS_PER_S[dtype_name] * 1e6
    return (bytes_us, "bytes") if bytes_us >= ops_us else (ops_us, "operations")


def kernel_bitwise(P, dtype):
    """The kernel's output finite and bitwise equal to the plain version's
    on ``kernel_blocks(P)``: (the input on the card, the max abs error). The
    work split (full tiles per CTA, the CTA that takes the ragged edge)
    depends on P, so each P of the main path gets this gate."""
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
    return H, max_abs


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
    H, max_abs = kernel_bitwise(P, dtype)
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


def spd_blocks(B, n, seed=0):
    """Seeded symmetric [B, n, n] blocks for the SPD kernel's check, of three
    kinds by index modulo 3, so that every batch, B = 1 too, starts with an
    SPD block: SPD (A A^T + 0.1 I), near-singular (one eigenvalue of 1e-15
    against ones in [0.5, 3)), and indefinite (eigenvalues of magnitude
    [0.5, 3), at least one negative and, for n > 1, one positive: the
    entity-merged Schur-Jacobi blocks can be indefinite). No kept
    eigenvalue lies near the clamp floor, and every kept one is separated
    from every clamped one."""
    import numpy as np

    rng = np.random.default_rng(seed + 1000 * n + B)
    A = rng.normal(size=(B, n, n))
    H = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(n)
    Q, _ = np.linalg.qr(A)
    w = rng.uniform(0.5, 3.0, size=(B, n))
    sign = np.where(rng.random((B, n)) < 0.5, -1.0, 1.0)
    sign[:, 0] = -1.0
    if n > 1:
        sign[:, 1] = 1.0
    near = w.copy()
    near[:, 0] = 1e-15
    kind = np.arange(B) % 3
    for k, spectrum in ((1, near), (2, sign * w)):
        H[kind == k] = ((Q * spectrum[:, None, :]) @ Q.transpose(0, 2, 1))[kind == k]
    return H


def spd_eigh(H):
    """f64 eigenvalues and eigenvectors of H in pieces of SPD_PLAIN_BATCH
    blocks (see ``spd_plain``)."""
    import torch

    parts = [torch.linalg.eigh(H[i:i + SPD_PLAIN_BATCH].double())
             for i in range(0, H.shape[0], SPD_PLAIN_BATCH)]
    return torch.cat([w for w, _ in parts]), torch.cat([V for _, V in parts])


def spd_errors(H, got, want):
    """The SPD inverse ``got`` against ``want`` on the blocks H, each kind of
    block at its own scale: (spd, kept, clamped) relative errors, each the
    largest over its blocks (0 where there is none).

    - spd: a block with no eigenvalue below the clamp floor, |got - want|
      over its largest entry (gate SPD_RTOL);
    - clamped, kept: a block with one, in its own f64 eigenbasis V, E =
      V^T (got - want) V. The entries between two kept eigenvalues are held
      to the block's largest kept 1/w (gate SPD_KEPT_RTOL: a clamped block's
      inverse holds entries of 1/floor, stored to the dtype's rounding of
      that), the rest, clamped and cross terms, to 1/floor (gate SPD_RTOL).
      So the large clamped entries cannot hide an error in the kept
      spectrum beyond that rounding."""
    import torch

    from apex_tpu_torch.kernels import spd_inverse as spd

    w, V = spd_eigh(H)
    floor = spd.default_floor(H.dtype) * w.abs().amax(-1, keepdim=True).clamp_min(1.0)
    kept = w > floor
    clamped = ~kept.all(-1)
    diff = got.double() - want.double()
    full = diff.abs().amax((1, 2)) / want.double().abs().amax((1, 2))
    both = kept[:, :, None] & kept[:, None, :]
    E = (V.mT @ diff @ V).abs()
    kept_scale = torch.where(kept, 1.0 / w, 0.0).amax(-1)[:, None, None].clamp_min(1e-300)
    kept_err = torch.where(both, E / kept_scale, 0.0).amax((1, 2))
    clamped_err = torch.where(both, 0.0, E * floor[:, :, None]).amax((1, 2))

    def largest(x, where):
        return float(torch.where(where, x, 0.0).max()) if x.numel() else 0.0

    return largest(full, ~clamped), largest(kept_err, clamped), largest(clamped_err, clamped)


def spd_plain(H):
    """The plain version in pieces of SPD_PLAIN_BATCH blocks: torch.linalg.eigh
    on the card (cuSOLVER's batched syevj) fails on one batch of 65,132
    f32 3x3 blocks."""
    import torch

    from apex_tpu_torch.kernels import spd_inverse as spd

    return torch.cat([spd.spd_clamped_inv_plain(H[i:i + SPD_PLAIN_BATCH])
                      for i in range(0, H.shape[0], SPD_PLAIN_BATCH)])


def spd_bound_us(B, n, dtype_name):
    """The SPD inverse's least time: each block read and written once at the
    HBM rate, or at least (4/3) n^3 operations for the eigendecomposition
    (a dense tridiagonal reduction's count) and 2 n^3 for V diag(1/w) V^T
    at the dtype's peak rate, whichever is longer."""
    size = 8 if dtype_name == "float64" else 4
    bytes_us = 2 * B * n * n * size / HBM_BYTES_PER_S * 1e6
    ops_us = B * (10.0 / 3.0) * n ** 3 / PEAK_OPS_PER_S[dtype_name] * 1e6
    return (bytes_us, "bytes") if bytes_us >= ops_us else (ops_us, "operations")


def phase_spd_inverse(shapes):
    """The SPD inverse kernel against its plain version at every (B, n) the
    main path gave it, f32 and f64, on ``spd_blocks``: finite, and within
    SPD_RTOL / SPD_KEPT_RTOL of the plain version, each kind of block at
    its own scale (``spd_errors``); then its device time per launch (100
    launches queued behind a sleep), its bound, the plain version's time
    and that of the ``torch.linalg.eigh`` call inside it (one call per
    SPD_PLAIN_BATCH blocks). ``shapes`` maps (B, n, dtype) to the main
    path's calls. Returns {(B, n, dtype): line}."""
    import torch

    from apex_tpu_torch.kernels import spd_inverse as spd

    out = {}
    for B, n in sorted({(B, n) for B, n, _ in shapes}):
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).replace("torch.", "")
            H = torch.as_tensor(spd_blocks(B, n), dtype=dtype).cuda()
            k = spd.spd_clamped_inv(H)
            p = spd_plain(H)
            torch.cuda.synchronize()
            full, kept, clamped = spd_errors(H, k, p)
            max_abs = float((k - p).abs().max())
            if (not bool(torch.isfinite(k).all()) or not full <= SPD_RTOL[name]
                    or not clamped <= SPD_RTOL[name] or not kept <= SPD_KEPT_RTOL[name]):
                raise AssertionError(
                    f"spd_clamped_inv [{B}, {n}, {n}] {name}: relative errors SPD {full}, "
                    f"clamped {clamped} (gate {SPD_RTOL[name]}), kept {kept} "
                    f"(gate {SPD_KEPT_RTOL[name]})")
            device_us, host_us = device_and_host_us(spd.spd_clamped_inv, [H])
            bound, bound_by = spd_bound_us(B, n, name)
            line = dict(phase="spd_inverse", B=B, n=n, dtype=name, max_abs_err=max_abs,
                        spd_rel_err=full, clamped_rel_err=clamped, rtol=SPD_RTOL[name],
                        kept_rel_err=kept, kept_rtol=SPD_KEPT_RTOL[name],
                        device_us=device_us, bound_us=bound, bound_by=bound_by,
                        share=bound / device_us,
                        host_us=host_us, call_ms=median_ms(spd.spd_clamped_inv, H),
                        plain_ms=median_ms(spd_plain, H),
                        eigh_ms=median_ms(lambda x: [torch.linalg.eigh(x[i:i + SPD_PLAIN_BATCH])
                                                     for i in range(0, B, SPD_PLAIN_BATCH)], H),
                        config=spd.launch_config(dtype, n),
                        main_path_calls=shapes.get((B, n, name), 0))
            emit(line)
            out[(B, n, name)] = line
    return out


class SpdShapes(dict):
    """The SPD kernel's wrapper, wrapped while this is installed: counts its
    launching calls (a CUDA tensor of B > 0 blocks) by (B, n, dtype).
    Callers reach the wrapper through its module, so this sees them all."""

    def __init__(self):
        from apex_tpu_torch.kernels import spd_inverse as spd

        super().__init__()
        self.module, self.wrapped = spd, spd.spd_clamped_inv

        def counted(blocks, rel_floor=None):
            if blocks.device.type == "cuda" and blocks.shape[0]:
                key = (blocks.shape[0], blocks.shape[-1],
                       str(blocks.dtype).replace("torch.", ""))
                self[key] = self.get(key, 0) + 1
            return self.wrapped(blocks, rel_floor)

        spd.spd_clamped_inv = counted

    def remove(self):
        self.module.spd_clamped_inv = self.wrapped


def assembly_bound_us(ctx, plan, values):
    """The least time one group's assembly could take on the card: the
    bytes the function itself needs, each moved once at the HBM rate. Per
    row the observation, the weight, the pool indices and W (written); the
    pool rows the group reads; the free masks and constants once per
    variable (a camera's per entity, a landmark's per landmark) and the
    loss parameter once; H_pp and g_p per landmark, H_cc and g_c per entity
    and the cost, written. The arithmetic, under 1,000 operations per row,
    is far below it at the FP64 rate. Beside it, the bytes the kernels'
    design moves on top of those: the masks, loss parameters and constant
    intrinsics stored per row, each row's entity id, the camera-major and
    landmark-major orders, the run and tile bounds and entity columns, the
    record each row leaves for the entity pass (written and read), the
    tiles' partial sums (written and read), and the reads of the blocks the
    kernels add into. (microseconds, bytes, the design's extra bytes)"""
    import torch

    g, kp = ctx.cp.groups[plan.group_idx], plan.kernel
    size = torch.finfo(ctx.cp.dtype).bits // 8
    K, De = g.count, ctx.entity_dof
    o = kp.orders
    S, E, T = o.seg_lm.shape[0], o.fin_ent.shape[0], o.tiles
    pools = sum(int(torch.unique(idx).numel()) * values[pid].shape[1]
                for pid, idx in zip(g.pool_ids, g.indices))
    # the masks of the pose, landmark and intrinsics slots: per row as
    # stored, per variable as the function needs them
    masks = tuple(g.free_masks) + (None,) * (3 - len(g.free_masks))
    per_row_masks = sum(m.shape[1] for m in masks if m is not None)
    per_variable_masks = sum(n * m.shape[1] for n, m in zip((E, S, E), masks) if m is not None)
    const = "const_intrinsics" in g.data
    huber = g.loss_kind == "huber"
    blocks = 12 * S + (De * De + De) * E + 1
    floats = (K * (2 + (g.weights is not None) + 3 * De) + pools + per_variable_masks
              + 3 * E * const + huber + blocks)
    nbytes = floats * size + 8 * K * len(g.indices)
    design_floats = (K * per_row_masks - per_variable_masks + (K - 1) * huber
                     + 3 * (K - E) * const + 2 * K * (2 * kp.nc + 2) + 2 * T * kp.sums
                     + blocks - 1)
    design_ints = (8 * K + 4 * K * (1 + (o.lm_perm is not None)) + 4 * (2 * S + 1)
                   + 4 * (T + 1) + 4 * (2 * E + 1) + 4 * kp.ent_cols.numel())
    return nbytes / HBM_BYTES_PER_S * 1e6, nbytes, design_floats * size + design_ints


def phase_schur_assemble():
    """Phase 37: the assembly kernels at venice's size and groups (the
    ladder's venice rung: 1,778 cameras, 993,923 landmarks, six bucketed
    groups of 640 to 3,934,024 rows), f64 and f32, at the initial values:
    two assembles give the same bits, and every output is within
    ``ASSEMBLY_RTOL`` of the generic path's (``group_linearize`` and
    ``index_add_``, the port's plain version, which the kernels replace) on
    the same card tensors; then the device time of each group's call
    (TIMED_LAUNCHES, queued behind a sleep) and their sum over the
    assemble's six, the byte bound (``assembly_bound_us``) and share, the
    bytes of the kernels' design on top of the bound's, the host time per
    call, and the single-call times of the kernels' assemble and of the
    generic path's. Returns {dtype: line}."""
    import torch

    from apex_tpu_torch.ba import build_ba_problem
    from apex_tpu_torch.benches import ladder
    from apex_tpu_torch.io import synthetic
    from apex_tpu_torch.kernels import schur_assemble as sa
    from apex_tpu_torch.linalg.schur import SchurContext

    problem = build_ba_problem(synthetic.synthetic_ba_large(
        seed=0, **ladder.RUNGS["venice"].build.keywords))
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        cp = problem.compile(dtype=dtype, device="cuda")
        ctx = SchurContext(cp)
        if not all(p.kernel is not None for p in ctx.plans):
            raise AssertionError(f"schur_assemble {name}: a venice group takes the generic path")
        # the same structure on the generic path
        generic = SchurContext(cp, whole_groups=False)
        values = cp.initial_values()

        def assembled(c):
            o = c.assemble(values, 0.1)
            return list(o[:4]) + [o[5]] + list(o[4])

        got, again, want = assembled(ctx), assembled(ctx), assembled(generic)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        labels = ["Hcc", "gc", "Hpp", "gp", "cost"] + [f"W{i}" for i in range(len(got) - 5)]
        errors = {k: float((a - b).abs().max() / b.abs().max())
                  for k, a, b in zip(labels, got, want)}
        worst = max(errors.values())
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        del got, again, want
        if not (bitwise and finite and worst <= ASSEMBLY_RTOL[name]):
            raise AssertionError(f"schur_assemble {name}: bitwise {bitwise}, finite {finite}, "
                                 f"errors {errors} (gate {ASSEMBLY_RTOL[name]})")

        E, De, P = ctx.num_entities, ctx.entity_dof, ctx.num_landmarks
        bufs = [torch.zeros(shape, dtype=dtype, device="cuda")
                for shape in ((E, De, De), (E, De), (P, 3, 3), (P, 3), ())]
        groups, total_bound, total_bytes, total_design = [], 0.0, 0, 0
        for plan in ctx.plans:
            g = cp.groups[plan.group_idx]

            def call(_, plan=plan, g=g):
                sa.assemble_group(plan.kernel, g, values, *bufs)

            device_us, host_us = device_and_host_us(call, [None])
            bound, nbytes, design = assembly_bound_us(ctx, plan, values)
            total_bound, total_bytes = total_bound + bound, total_bytes + nbytes
            total_design += design
            o = plan.kernel.orders
            groups.append(dict(K=g.count, width=o.width, runs=o.seg_lm.shape[0],
                               tiles=o.tiles, device_us=device_us,
                               bound_us=bound, bytes=nbytes, design_bytes=design,
                               share=bound / device_us, host_us=host_us))

        # the whole assemble's six calls: their sum (all six queued at once
        # would exceed the launch queue behind the sleep)
        device_us = sum(g["device_us"] for g in groups)
        host_us = sum(g["host_us"] for g in groups)
        line = dict(phase="schur_assemble", dtype=name, rows=sum(g.count for g in cp.groups),
                    groups=groups, errors=errors, max_rel_err=worst, rtol=ASSEMBLY_RTOL[name],
                    bitwise_twice=bitwise, device_us=device_us, bound_us=total_bound,
                    bytes=total_bytes, bound_by="bytes", share=total_bound / device_us,
                    design_bytes=total_design,
                    design_bound_us=(total_bytes + total_design) / HBM_BYTES_PER_S * 1e6,
                    host_us=host_us,
                    call_ms=median_ms(lambda _: ctx.assemble(values, 0.1), None),
                    generic_ms=median_ms(lambda _: generic.assemble(values, 0.1), None, runs=5))
        emit(line)
        out[name] = line
        del ctx, generic, cp, values, bufs
        release_cuda()
    return out


def coupling_bytes(ctx, Ws, op):
    """The bytes one coupling sum over every group needs, each moved once:
    W (twice for an S-apply, whose two products each read it), each row's
    entity and landmark as int32, the input vector or blocks, the output;
    an S-apply also H_cc and x for its H_cc x and the vector u between its
    two products, written and read. The arithmetic, 27 multiply-adds a row
    (about 220 for the Schur-Jacobi blocks), is far below it at the FP64
    rate."""
    size = Ws[0].element_size()
    E, De, P = ctx.num_entities, ctx.entity_dof, ctx.num_landmarks
    w = sum(W.numel() for W in Ws) * size + 8 * sum(W.shape[0] for W in Ws)
    x, u, hinv, blocks = E * De * size, P * 3 * size, P * 9 * size, E * De * De * size
    return {"wt_x": w + x + u, "hinv_wt_x": w + x + hinv + u, "w_u": w + u + x,
            "schur_diagonal": w + hinv + 2 * blocks,
            "apply_S": 2 * w + hinv + blocks + 2 * x + 2 * u + x}[op]


def phase_schur_apply():
    """Phase 38: the coupling kernels at venice's size and groups (the
    ladder's venice rung: six bucketed groups of 640 to 3,934,024 rows,
    6,491,429 in all, De = 9), f64 and f32, on the couplings W and landmark
    blocks of the initial values' assemble: W^T x (``wt_x``; fused with
    Hpp^-1, ``hinv_wt_x``), W u, the Schur-Jacobi blocks and one S-apply
    (H_cc x - W Hpp^-1 W^T x) with random x and u. Each through the kernels
    twice (the same bits) and through the plain path (the same context
    built with ``whole_groups=False``: gathers, batched products,
    ``index_add_``), within ``COUPLING_RTOL``; then the device time of a
    call over the six groups (calls queued behind a sleep), the byte bound
    (``coupling_bytes``) and share, the host time per call and the plain
    path's time. Returns {dtype: line}."""
    import torch

    from apex_tpu_torch.ba import build_ba_problem
    from apex_tpu_torch.benches import ladder
    from apex_tpu_torch.io import synthetic
    from apex_tpu_torch.kernels import schur_apply as ap
    from apex_tpu_torch.linalg.schur import SchurContext, landmark_inverse

    problem = build_ba_problem(synthetic.synthetic_ba_large(
        seed=0, **ladder.RUNGS["venice"].build.keywords))
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        cp = problem.compile(dtype=dtype, device="cuda")
        ctx = SchurContext(cp)
        if not (all(map(ctx._kernel_takes, ctx.couplings)) and ctx._disjoint_landmarks):
            raise AssertionError(f"schur_apply {name}: a venice group takes the plain path")
        plain = SchurContext(cp, whole_groups=False)
        Hcc, _, Hpp, _, Ws, _ = ctx.assemble(cp.initial_values(), 0.1)
        Hinv = landmark_inverse(Hpp)
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(ctx.Dc, dtype=dtype, device="cuda", generator=gen)
        u = torch.randn((ctx.num_landmarks, 3), dtype=dtype, device="cuda", generator=gen)

        absW, zero = [W.abs() for W in Ws], torch.zeros_like(Hcc)
        # each result of a context, and its rounding scale: the same sum
        # over absolute values
        sums = {"wt_x": (lambda c: c._wt_x(Ws, x), lambda: plain._wt_x(absW, x.abs())),
                "hinv_wt_x": (lambda c: c._wt_x(Ws, x, Hinv),
                              lambda: plain._wt_x(absW, x.abs(), Hinv.abs())),
                "w_u": (lambda c: c._w_u(Ws, u), lambda: plain._w_u(absW, u.abs())),
                "schur_diagonal": (lambda c: c._schur_diagonal(Hcc, Hinv, Ws),
                                   lambda: Hcc.abs() - plain._schur_diagonal(
                                       zero, Hinv.abs(), absW)),
                "apply_S": (lambda c: c._hcc_matvec(Hcc, x) - c._w_u(Ws, c._wt_x(Ws, x, Hinv)),
                            lambda: plain._hcc_matvec(Hcc.abs(), x.abs()) + plain._w_u(
                                absW, plain._wt_x(absW, x.abs(), Hinv.abs())))}
        ops_line = {}
        for op, (of, scale) in sums.items():
            fn = functools.partial(of, ctx)
            got, again, want, ref = fn(), fn(), of(plain), scale()
            torch.cuda.synchronize()
            bitwise = torch.equal(got, again)
            err = float((got - want).abs().max())
            rel = err / float(ref.abs().max())
            finite = bool(torch.isfinite(got).all())
            del got, again, want, ref
            if not (bitwise and finite and rel <= COUPLING_RTOL[name]):
                raise AssertionError(f"schur_apply {name} {op}: bitwise {bitwise}, finite "
                                     f"{finite}, error {rel} (gate {COUPLING_RTOL[name]})")
            before = ap.launches
            fn()
            per_call = ap.launches - before
            # at most ~300 launches behind the sleep: under 25 a call
            device_us, host_us = device_and_host_us(lambda _: fn(), [None], calls=10)
            nbytes = coupling_bytes(ctx, Ws, op)
            bound = nbytes / HBM_BYTES_PER_S * 1e6
            ops_line[op] = dict(rel_err=rel, max_abs_err=err, bitwise_twice=bitwise,
                                kernel_calls=per_call, device_us=device_us, bound_us=bound,
                                bytes=nbytes, bound_by="bytes", share=bound / device_us,
                                host_us=host_us,
                                plain_ms=median_ms(lambda _: of(plain), None, runs=5))
        line = dict(phase="schur_apply", dtype=name, rows=sum(W.shape[0] for W in Ws),
                    groups=[W.shape[0] for W in Ws],
                    widths=[p.orders.width for p in ctx.couplings],
                    tiles=[p.orders.tiles for p in ctx.couplings], ops=ops_line,
                    rtol=COUPLING_RTOL[name],
                    max_rel_err=max(o["rel_err"] for o in ops_line.values()))
        emit(line)
        out[name] = line
        del ctx, plain, cp, Hcc, Hpp, Ws, Hinv, x, u, absW, zero, sums
        release_cuda()
    return out


def capture_census(fn):
    """What one CUDA graph capture of ``fn()`` holds on the card
    (``graph_conditional.census``), ``fn`` warmed up twice first."""
    import torch

    from apex_tpu_torch.kernels import graph_conditional as gc

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(side):
        graph.capture_begin()
        fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return gc.census(graph.raw_cuda_graph())


def phase_capture_census():
    """The library calls that jit mode's conditional bodies hold, each
    captured alone at the widest size of the path: no memory node in any
    (a conditional node's body can hold none): cuSOLVER's potrf at
    ``banded.CHOLESKY_PANEL`` columns, the panel Cholesky (what
    ``banded._cholesky`` takes in a captured step) and ``banded.cho_solve``
    at the 20^3 lattice's 20,262. Beside them, what the
    port keeps out of those bodies, and why: a potrf 20,262 wide, cuSOLVER's
    ``cholesky_solve`` (potrs) and ``qr`` (the QR solvers' loop stays on the
    host) allocate inside a capture."""
    import torch

    from apex_tpu_torch.linalg import banded

    def spd(n):
        R = torch.rand(n, n, dtype=torch.float64, device="cuda", generator=gen)
        return (R + R.T) / 2 + n * torch.eye(n, dtype=torch.float64, device="cuda")

    gen = torch.Generator(device="cuda").manual_seed(0)
    wide = spd(20_262)
    b = torch.rand(20_262, 1, dtype=torch.float64, device="cuda", generator=gen)
    L = banded._cholesky(wide)
    panel = spd(banded.CHOLESKY_PANEL)
    small = spd(1_500)
    J = torch.rand(1_800, 900, dtype=torch.float64, device="cuda", generator=gen)
    held = {"potrf at CHOLESKY_PANEL": lambda: torch.linalg.cholesky_ex(panel),
            "panel Cholesky at 20262": lambda: banded.cholesky_panels((wide + wide.mT) / 2),
            "cho_solve at 20262": lambda: banded.cho_solve(L, b)}
    kept_out = {"potrf at 20262": lambda: torch.linalg.cholesky_ex(wide),
                "cholesky_solve at 1500": lambda: torch.cholesky_solve(small[:, :1], small),
                "qr 1800x900": lambda: torch.linalg.qr(J)}
    line = dict(phase="capture_census", cholesky_panel=banded.CHOLESKY_PANEL,
                held={k: capture_census(f) for k, f in held.items()},
                kept_out={k: capture_census(f) for k, f in kept_out.items()})
    emit(line)
    for k, c in line["held"].items():
        if c.get("mem_alloc") or c.get("mem_free"):
            raise AssertionError(f"capture_census: {k} holds memory nodes: {c}")


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
    problem, kernel launches, LM iterations, {dtype: final RMSE}). The
    assembly kernels run once per group and LM iteration."""
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
        before, counters = lb.launches, graph_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = apx.LevenbergMarquardt(cfg).optimize(cp)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = lb.launches - before
        # every group is a BAL pinhole group: all take the assembly kernels
        assembled = assembly_calls("full_slice", f"full_slice {dtype}",
                                   {k: v - counters[k] for k, v in graph_counters().items()},
                                   len(cp.groups), res.iterations)
        total += launched
        iterations += res.iterations
        r0 = rmse(res.initial_cost, ds.num_observations)
        r1 = rmse(res.final_cost, ds.num_observations)
        emit(dict(phase="full_slice", dtype=str(dtype).replace("torch.", ""),
                  status=res.status.name, iterations=res.iterations,
                  rows=cp.total_residual_dim, compile_seconds=compile_s,
                  solve_seconds=seconds, seconds_per_iteration=seconds / res.iterations,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  rmse_initial=r0, rmse_final=r1, kernel_launches=launched,
                  assembly_kernel_calls=assembled))
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
# the sphere's tangent dimension: the dense H of expose_matrix_data is D^2
SPHERE_DOF = 15_000
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
                landmark_kernel_ms=sum(e.time_range.elapsed_us() for e in device
                                       if LANDMARK_KERNEL in e.name) / 1e3,
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
        lm._python_step(cp)  # the structure analysis, timed apart
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
            lm._python_step(cp)
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
        lm._python_step(cp)  # the symbolic plan, timed apart
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
    lm._python_step(cp)
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
            jit = make("jit")
            rc, _, n = counted_solve(jit, cards)
            rh = make("jit").optimize(host)
            rtol = max(1e-10, 10.0 * spread)
            emit(dict(phase="jit_parity", file=fname, path=path, iterations=rc.iterations,
                      host_reads=n["host_reads"],
                      host_read_bound=check_host_reads(f"jit_parity {fname} {path}", n, 1,
                                                       rc.iterations,
                                                       host_loop_reason(jit, cards)),
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
    from apex_tpu_torch.kernels import schur_assemble as sa
    from apex_tpu_torch.kernels import spd_inverse as spd
    from apex_tpu_torch.optim import graphs

    return dict(captures=graphs.captures, graphs=graphs.graphs, launches=graphs.launches,
                replays=graphs.replays, host_reads=graphs.host_reads,
                status_reads=graphs.status_reads,
                replayed_kernel_launches=graphs.replayed["landmark_blocks"],
                eager_kernel_launches=lb.launches,
                replayed_spd_launches=graphs.replayed["spd_clamped_inv"],
                eager_spd_launches=spd.launches,
                replayed_assemble_launches=graphs.replayed["schur_assemble"],
                eager_assemble_launches=sa.launches)


# the assembly kernels' calls checked on each main path, by path
# (``assembly_calls``)
ASSEMBLY_CALLS = {}


def assembly_calls(path, label, n, groups, iterations, jit=False):
    """The assembly kernels' calls in the counter increments ``n`` of
    solves of ``iterations`` LM iterations on ``path``: one per group they
    take (``groups``) and LM iteration, eager in python mode, replayed by
    graphs in jit mode (the warm-up's eager calls aside). Adds the calls,
    eager and replayed, to ``ASSEMBLY_CALLS[path]`` and returns them."""
    key = "replayed_assemble_launches" if jit else "eager_assemble_launches"
    if n[key] != groups * iterations:
        raise AssertionError(f"{label}: {n[key]} assembly kernel calls ({key}) for {groups} "
                             f"groups and {iterations} LM iterations")
    calls = n["eager_assemble_launches"] + n["replayed_assemble_launches"]
    ASSEMBLY_CALLS[path] = ASSEMBLY_CALLS.get(path, 0) + calls
    return calls


def host_loop_reason(jit, cp):
    """Why the jit solver keeps its LM loop on the host on a card (the QR
    solvers), or None."""
    return getattr(jit._jit_cache[cp]._step, "host_loop", None)


def check_host_reads(label, n, solves, iterations, host_loop):
    """The host reads of ``solves`` jit solves without a timeout, of
    ``iterations`` LM iterations in all: one read each (the result) where
    the LM loop runs on the device, at most 2; where it stays on the host
    (``host_loop``), the loop's flag once per iteration and once more, the
    QR sweep's retry ladder's flag once per stage it takes and once more
    (``banded.RETRY_STAGES`` stages at most) per iteration, and the
    result."""
    from apex_tpu_torch.linalg import banded

    bound = (2 * solves if host_loop is None
             else (banded.RETRY_STAGES + 2) * iterations + 2 * solves)
    if n["host_reads"] > bound:
        raise AssertionError(f"{label}: {n['host_reads']} host reads in {solves} solves of "
                             f"{iterations} LM iterations, bound {bound}")
    return bound


def counted_solve(solver, cp, **kw):
    """One synchronized solve (``kw`` to ``optimize``): (result, seconds,
    counter increments)."""
    import torch

    before = graph_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.optimize(cp, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, seconds, {k: v - before[k] for k, v in graph_counters().items()}


def graph_span_solve(solve):
    """One synchronized jit solve with tracing on (``utils.profiling``),
    whose CUDA events around each launch of a parent graph give its device
    intervals: (result, wall seconds, device seconds between the events).
    The solver's graphs were captured before, with tracing off, so they
    hold no stamp. The share of the wall time outside the launches is time
    the card spent on no graph of the solve: the host's set-up, reads and
    result. torch.profiler sees no kernel of the BA solves' parent graphs
    (PERF.md, section 6), so its busy time cannot give the idle share
    there."""
    import torch

    from apex_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    profiling.set_tracing(True)
    try:
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = profiling.collect_trace()["launches"]
    finally:
        profiling.set_tracing(False)
    return res, wall, sum(x["end_ns"] - x["start_ns"] for x in launches) / 1e9


def jit_full(phase, label, problem, make, dtype, gate, rtol=1e-10, landmark=False):
    """One dtype of a jit phase: three python-mode solves (the last timed,
    the reference; the spread of their final costs is python mode's own
    run-to-run rounding, from ``index_add_``'s atomic order), then the jit
    solves: the first (state, warm-up and capture), the timed one and one
    with CUDA events around its graph launches (``graph_span_solve``). f64
    must give python mode's iterations and status and its final cost
    within ``rtol``, or within 10x python mode's own
    spread where that is larger, and DogLeg python mode's reused steps;
    ``gate(res)`` raises on a result below the phase's quality gate. Each
    jit solve makes at most 2 host reads (``check_host_reads``); with
    ``landmark`` (a BAL problem) each launches the landmark kernel once per
    LM iteration, and the assembly kernels once per group and LM iteration,
    counted on the device. Returns a dict: the jit iterations of the three
    solves, the landmark kernel launches in them (by the device counts), the
    emitted line, the compiled problem and the python and jit solvers."""
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
    torch.cuda.reset_peak_memory_stats()
    res, seconds, n = counted_solve(jit, cp)
    peak = torch.cuda.max_memory_allocated()
    before = graph_counters()
    spanned, span_wall, span_device = graph_span_solve(lambda: jit.optimize(cp))
    span_n = {k: v - before[k] for k, v in graph_counters().items()}
    rtol = max(rtol, 10.0 * spread)
    host_loop = host_loop_reason(jit, cp)
    line = dict(phase=phase, graph=label, dtype=name, D=cp.total_dof, status=res.status.name,
              iterations=res.iterations, initial_cost=res.initial_cost,
              final_cost=res.final_cost, python_iterations=ref.iterations,
              python_final_cost=ref.final_cost,
              rel_diff_to_python=abs(res.final_cost - ref.final_cost) / ref.final_cost,
              python_run_to_run_spread=spread, parity_rtol=rtol,
              first_solve_seconds=first_s,
              solve_seconds=seconds, seconds_per_lm_iteration=seconds / res.iterations,
              python_solve_seconds=python_s, speedup_over_python=python_s / seconds,
              graphs=first_n["graphs"], parent_launches=n["launches"], replays=n["replays"],
              replays_per_lm_iteration=n["replays"] / res.iterations,
              host_reads=n["host_reads"],
              host_reads_per_lm_iteration=n["host_reads"] / res.iterations,
              host_loop=host_loop,
              host_read_bound=check_host_reads(f"{phase} {label} {name}", n, 1,
                                               res.iterations, host_loop),
              spd_launches_per_lm_iteration=(n["replayed_spd_launches"]
                                             + n["eager_spd_launches"]) / res.iterations,
              landmark_launches_per_lm_iteration=(n["replayed_kernel_launches"]
                                                  + n["eager_kernel_launches"])
              / res.iterations,
              graph_device_seconds=span_device, graph_span_wall_seconds=span_wall,
              device_idle_share_outside_graphs=1.0 - span_device / span_wall,
              max_memory_allocated=peak, max_memory_allocated_first_solve=first_peak,
              graph_memory_reserved=graph_memory,
              python_max_memory_allocated=python_peak,
              first_solve_counters=first_n, span_counters=span_n)
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
    if first_n["captures"] != 1 or n["captures"] or span_n["captures"]:
        raise AssertionError(f"{label}: captures {first_n}, {span_n}, {n}")
    check_host_reads(f"{phase} {label} {name} first", first_n, 1, first.iterations, host_loop)
    check_host_reads(f"{phase} {label} {name} span", span_n, 1, spanned.iterations, host_loop)
    if landmark:
        # one launch per LM iteration, the warm-up's one eager launch aside
        for c, its in ((first_n, first.iterations), (n, res.iterations),
                       (span_n, spanned.iterations)):
            if c["replayed_kernel_launches"] != its:
                raise AssertionError(f"{label} {name}: {c['replayed_kernel_launches']} "
                                     f"landmark launches on the device for {its} LM iterations")
            assembly_calls(phase, f"{label} {name}", c, len(cp.groups), its, jit=True)
    iterations = first.iterations + res.iterations + spanned.iterations
    launches = sum(c["replayed_kernel_launches"] + c["eager_kernel_launches"]
                   for c in (first_n, n, span_n))
    return dict(iterations=iterations, launches=launches, line=line, cp=cp,
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
            out = jit_full("jit_ba", f"trafalgar257 {solver}", problem, make, dtype, gate, rtol,
                           landmark=True)
            its, launches = out["iterations"], out["launches"]
            if launches < its:
                raise AssertionError(f"{solver} {dtype}: {launches} launches, {its} iterations")
            total += launches
            iterations += its
    return total, iterations


def phase_pcg_chunk(problem):
    """``graphs.PCG_CHUNK`` under the device loop: the trafalgar-scale
    implicit BA solve (10 LM iterations, f64) and LM ``pcg`` on the medium
    SE2 fixture, each with PCG chunks of 1 and of 4 iterations (a chunk is
    one trip of PCG's WHILE node; its iterations after PCG stops are masked
    by ``torch.where``), in turns 1, 4, 4, 1: a new solver per turn (its
    capture takes the chunk), its first solve apart, then two timed solves.
    Gates: every turn gives the same iterations and status, and costs
    within rtol 1e-10. One line per problem: seconds per LM iteration per
    chunk (the two turns' medians), and the WHILE trips."""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.optim import graphs

    def implicit():
        cfg = apx.LevenbergMarquardtConfig.for_bundle_adjustment()
        cfg.linear_solver_type = "schur_implicit"
        cfg.max_iterations = 10
        cfg.mode = "jit"
        return apx.LevenbergMarquardt(cfg)

    def pcg():
        return apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type="pcg", mode="jit", **CERTIFIED))

    se2 = apx.load_g2o(os.path.join(REPO, MEDIUM_SE2[0])).to_problem()
    default = graphs.PCG_CHUNK
    try:
        for label, prob, make in (("trafalgar257 schur_implicit", problem, implicit),
                                  ("medium_se2_300 pcg", se2, pcg)):
            cp = prob.compile(dtype=torch.float64, device="cuda")
            seconds, results = {1: [], 4: []}, []
            replays = {}
            for chunk in (1, 4, 4, 1):
                graphs.PCG_CHUNK = chunk
                lm = make()
                counted_solve(lm, cp)
                for _ in range(2):
                    res, s_, n = counted_solve(lm, cp)
                    seconds[chunk].append(s_ / res.iterations)
                    results.append(res)
                    replays[chunk] = n["replays"] / res.iterations
                del lm
            ref = results[0]
            for r in results:
                if (r.iterations, r.status) != (ref.iterations, ref.status):
                    raise AssertionError(f"pcg chunk {label}: {r.summary()} vs {ref.summary()}")
                np.testing.assert_allclose(r.final_cost, ref.final_cost, rtol=1e-10,
                                           err_msg=f"pcg chunk {label}")
            emit(dict(phase="pcg_chunk", problem=label, iterations=ref.iterations,
                      seconds_per_lm_iteration={c: sorted(v) for c, v in seconds.items()},
                      median_seconds_per_lm_iteration={c: float(np.median(v))
                                                       for c, v in seconds.items()},
                      replays_per_lm_iteration=replays, chunk_in_use=default))
    finally:
        graphs.PCG_CHUNK = default


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
            lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode=mode, **SELFCAL_LM))
            cp = problem.compile(dtype=torch.float64, device=device)
            if device == "cpu":
                res[key] = lm.optimize(cp)
            else:
                res[key], _, n = counted_solve(lm, cp)
        rh = res["cpu"]
        # n: the jit solve's counts, the last counted_solve
        check_host_reads(f"camera_parity {model}", n, 1, res["cuda_jit"].iterations, None)
        emit(dict(phase="camera_parity", model=model, observations=n_obs,
                  iterations=rh.iterations, status=rh.status.name, host_reads_jit=n["host_reads"],
                  entity_dof=lm._jit_cache[cp]._step.solve_fn.schur_context.entity_dof,
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
    initial, and the landmark kernel must run once per LM iteration (in jit
    mode counted on the device); no group of these models takes the
    assembly kernels. For ``schur`` a python-mode solve under
    the profiler (the camera spans' share of the device time); then a jit
    solve with CUDA events around its graph launches. Returns (kernel
    launches, LM iterations) over its solves."""
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
    before = graph_counters()
    spanned, span_wall, span_device = graph_span_solve(lambda: jit.optimize(cp))
    span_n = {k: v - before[k] for k, v in graph_counters().items()}
    counts += [first_n, n, span_n]
    iterations += first.iterations + res.iterations + spanned.iterations
    # no group of these camera models takes the assembly kernels
    for c in counts:
        assembly_calls(phase, f"{phase} {label} {solver} {name}", c, 0, 0)
        assembly_calls(phase, f"{phase} {label} {solver} {name}", c, 0, 0, jit=True)
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
                solve_seconds=seconds,
                seconds_per_lm_iteration=seconds / res.iterations,
                python_solve_seconds=python_s,
                python_seconds_per_lm_iteration=python_s / ref.iterations,
                speedup_over_python=python_s / seconds,
                host_reads=n["host_reads"],
                host_reads_per_lm_iteration=n["host_reads"] / res.iterations,
                graph_device_seconds=span_device, graph_span_wall_seconds=span_wall,
                device_idle_share_outside_graphs=1.0 - span_device / span_wall,
                max_memory_allocated=peak, **camera)
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
    if first_n["captures"] != 1 or n["captures"] or span_n["captures"]:
        raise AssertionError(f"{label} {solver}: captures {first_n}, {n}, {span_n}")
    for c, its in ((first_n, first.iterations), (n, res.iterations),
                   (span_n, spanned.iterations)):
        check_host_reads(f"{label} {solver} {name}", c, 1, its, None)
        if c["replayed_kernel_launches"] != its:
            raise AssertionError(f"{label} {solver} {name}: {c['replayed_kernel_launches']} "
                                 f"landmark launches on the device for {its} LM iterations")
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


class TimedObserver:
    """Wraps an observer and adds up the host seconds of its hooks."""

    def __init__(self, inner):
        self.inner = inner
        self.seconds = 0.0
        self.calls = 0

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        self.seconds += time.perf_counter() - t0
        self.calls += 1

    def on_step(self, *args):
        self._timed(self.inner.on_step, *args)

    def set_matrix_data(self, hessian, gradient):
        if hasattr(self.inner, "set_matrix_data"):
            self._timed(self.inner.set_matrix_data, hessian, gradient)

    def notify_complete(self, *args):
        self._timed(self.inner.notify_complete, *args)


def support_observers(cp, config, checkpoint_path=None):
    """{name: TimedObserver} over a ``HistoryObserver``, a ``RerunObserver``
    on a ``MemorySink`` with ``config``, and (with a path) a
    ``CheckpointObserver(every=3)``."""
    from apex_tpu_torch.core.checkpoint import CheckpointObserver
    from apex_tpu_torch.observers import HistoryObserver, RerunObserver
    from apex_tpu_torch.observers.visualization import MemorySink

    observers = {"history": HistoryObserver(),
                 "rerun": RerunObserver(config, sink=MemorySink())}
    if checkpoint_path is not None:
        observers["checkpoint"] = CheckpointObserver(cp, checkpoint_path, every=3)
    return {name: TimedObserver(obs) for name, obs in observers.items()}


def support_solve(cfg, cp, observers=(), checkpoint=None):
    """One synchronized solve through the public entry point: (result,
    seconds, kernel launches, graph captures and replays)."""
    import apex_tpu_torch as apx

    lm = apx.LevenbergMarquardt(cfg)
    for obs in observers:
        lm.add_observer(obs)
    res, seconds, counts = counted_solve(lm, cp, checkpoint=checkpoint)
    return (res, seconds, counts["eager_kernel_launches"], counts["captures"],
            counts["replays"])


def phase_support_ba(ds, problem, workdir):
    """Observers, checkpoint / resume on the trafalgar-scale BA (phase 5's
    problem and config, f64): (kernel launches, LM iterations) summed over
    the phase's solves."""
    import dataclasses
    import os

    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.ba import rmse
    from apex_tpu_torch.core.checkpoint import OptimizerCheckpoint
    from apex_tpu_torch.observers import VisualizationConfig

    cp = problem.compile(dtype=torch.float64, device="cuda")
    cfg = apx.LevenbergMarquardtConfig.for_bundle_adjustment()
    cfg.max_iterations = 10
    cfg.collect_stats = True
    path = os.path.join(workdir, "support_ba.npz")
    launches = iterations = 0

    def counted(label, res, launched):
        nonlocal launches, iterations
        launches += launched
        iterations += res.iterations
        if launched != res.iterations:
            raise AssertionError(f"support_ba {label}: {launched} kernel launches for "
                                 f"{res.iterations} LM iterations")

    # (a) two solves without observers: the reference and its spread
    plain = []
    for k in range(2):
        res, seconds, launched, _, _ = support_solve(cfg, cp)
        counted(f"plain {k}", res, launched)
        plain.append((res, seconds))
    ref = plain[0][0]
    ref_costs = np.array([s.cost for s in ref.iteration_stats])
    spread = float(np.max(np.abs(np.array([s.cost for s in plain[1][0].iteration_stats])
                                 - ref_costs) / ref_costs))
    rtol = max(1e-10, 10 * spread)
    plain_s = min(s for _, s in plain)

    # (b) observed, (c) observed under mode="jit": python mode, no graph
    observed = {}
    for mode in ("python", "jit"):
        observers = support_observers(cp, VisualizationConfig.for_bundle_adjustment(), path)
        torch.cuda.reset_peak_memory_stats()
        res, seconds, launched, captures, replays = support_solve(
            dataclasses.replace(cfg, mode=mode), cp, list(observers.values()))
        counted(mode, res, launched)
        history = observers["history"].inner
        if (res.iterations, res.status) != (ref.iterations, ref.status):
            raise AssertionError(f"support_ba {mode}: {res.summary()} vs {ref.summary()}")
        if (captures, replays) != (0, 0):
            raise AssertionError(f"support_ba {mode}: {captures} captures, {replays} replays")
        np.testing.assert_allclose(history.costs, ref_costs, rtol=rtol,
                                   err_msg=f"support_ba {mode}")
        if history.total_iterations != res.iterations:
            raise AssertionError(f"support_ba {mode}: history completed at "
                                 f"{history.total_iterations}")
        observed[mode] = (res, seconds, observers)
        ck_bytes = os.path.getsize(path)
        sink = observers["rerun"].inner.sink
        emit(dict(phase="support_ba", run=f"observed_{mode}", status=res.status.name,
                  iterations=res.iterations, solve_seconds=seconds,
                  plain_solve_seconds=[s for _, s in plain],
                  observer_host_seconds_per_lm_iteration=(seconds - plain_s) / res.iterations,
                  observer_hook_seconds={n: o.seconds for n, o in observers.items()},
                  checkpoint_saves=(res.iterations - 1) // 3 + 1, checkpoint_bytes=ck_bytes,
                  checkpoint_save_seconds_each=observers["checkpoint"].seconds
                  / ((res.iterations - 1) // 3 + 1),
                  sink_records=len(sink.records), graph_captures=captures, graph_replays=replays,
                  history_cost_rtol=rtol, plain_spread=spread,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  kernel_launches=launched))

    # (d) resume from the last checkpoint the observer wrote
    t0 = time.perf_counter()
    ck = OptimizerCheckpoint.load(path)
    load_s = time.perf_counter() - t0
    expected = 3 * ((ref.iterations - 1) // 3)
    if ck.iteration != expected or ck.nu != 2.0:
        raise AssertionError(f"support_ba: checkpoint at iteration {ck.iteration}, nu {ck.nu}; "
                             f"expected {expected}, 2.0")
    res, seconds, launched, _, _ = support_solve(cfg, cp, checkpoint=ck)
    counted("resume", res, launched)
    r0 = rmse(ref.initial_cost, ds.num_observations)
    r1 = rmse(res.final_cost, ds.num_observations)
    emit(dict(phase="support_ba", run="resume", from_iteration=ck.iteration,
              checkpoint_cost=ck.cost, initial_cost=res.initial_cost,
              rel_diff=abs(res.initial_cost - ck.cost) / ck.cost, status=res.status.name,
              iterations=res.iterations, solve_seconds=seconds, load_seconds=load_s,
              rmse_initial=r0, rmse_checkpoint=rmse(ck.cost, ds.num_observations),
              rmse_final=r1, uninterrupted_rmse_final=rmse(ref.final_cost, ds.num_observations),
              kernel_launches=launched))
    np.testing.assert_allclose(res.initial_cost, ck.cost, rtol=1e-10, err_msg="support_ba resume")
    if not r1 < 0.55 * r0:
        raise AssertionError(f"support_ba resume: RMSE {r0} -> {r1} misses the 0.55x gate")
    return launches, iterations


class MatrixShapes:
    """Records the shapes ``set_matrix_data`` receives."""

    def __init__(self):
        self.shapes = []

    def set_matrix_data(self, hessian, gradient):
        self.shapes.append((hessian.shape, gradient.shape, str(hessian.dtype)))

    def on_step(self, *args):
        pass

    def notify_complete(self, *args):
        pass


def phase_support_pose_graph(sphere_problem):
    """The sphere (sphere2500's shape) with ``expose_matrix_data``: the dense
    H (15,000^2, 1.8 GB in f64) assembled and copied to the host each
    iteration, into a ``RerunObserver``'s heat map."""
    import dataclasses

    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.observers import VisualizationConfig

    cp = sphere_problem.compile(dtype=torch.float64, device="cuda")
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type="sparse_cholesky", damping="auto",
                                       **BENCH)
    support_solve(cfg, cp)  # the plan and the library warm-up
    res, plain_s, _, _, _ = support_solve(cfg, cp)
    check_costs("support_pose_graph plain", res, SPHERE_INITIAL, SPHERE_FINAL,
                SPHERE_ITERATIONS)
    observers = support_observers(cp, VisualizationConfig.for_pose_graph())
    shapes = MatrixShapes()
    torch.cuda.reset_peak_memory_stats()
    res, seconds, _, _, _ = support_solve(dataclasses.replace(cfg, expose_matrix_data=True), cp,
                                          [shapes, *observers.values()])
    check_costs("support_pose_graph observed", res, SPHERE_INITIAL, SPHERE_FINAL,
                SPHERE_ITERATIONS)
    D = cp.total_dof
    if shapes.shapes != [((D, D), (D,), "float64")] * res.iterations or D != SPHERE_DOF:
        raise AssertionError(f"support_pose_graph: set_matrix_data got {shapes.shapes[:2]}...")
    sink = observers["rerun"].inner.sink
    images = dict(sink.by_kind("image"))
    if images["optimization/matrices/hessian"]["shape"] != (256, 256, 3):
        raise AssertionError(f"support_pose_graph: heat map {images}")
    emit(dict(phase="support_pose_graph", D=D, status=res.status.name,
              iterations=res.iterations, final_cost=res.final_cost,
              seconds_per_lm_iteration=seconds / res.iterations,
              plain_seconds_per_lm_iteration=plain_s / res.iterations,
              hessian_bytes=D * D * 8, observer_hook_seconds={n: o.seconds
                                                              for n, o in observers.items()},
              sink_records=len(sink.records), hessian_image=images[
                  "optimization/matrices/hessian"]["shape"],
              max_memory_allocated=torch.cuda.max_memory_allocated()))


def run_cli(module, argv, env, label):
    """``python -m module argv`` in a subprocess from the repository root,
    started through ``runpy`` so that the landmark kernel's launch count
    is printed to stderr at exit: (stdout, launches, seconds)."""
    code = ("import json, runpy, sys\n"
            "from apex_tpu_torch.kernels import landmark_blocks as lb\n"
            f"sys.argv = [{module!r}] + {argv!r}\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "finally:\n"
            "    print('LAUNCHES ' + json.dumps(lb.launches), file=sys.stderr)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    launches = [line for line in proc.stderr.splitlines() if line.startswith("LAUNCHES ")]
    return proc.stdout, int(launches[-1].split()[1]), seconds


def phase_support_cli(ds, sphere_graph, workdir):
    """Both CLIs' ``--dataset`` from a cache of synthetic stand-ins written
    under the registry's names (nothing is fetched), and
    ``utils.profiling.trace`` around one sphere solve: (kernel launches, LM
    iterations) of the BA CLI."""
    import os

    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.io import datasets, load_g2o, save_bal, save_g2o
    from apex_tpu_torch.utils import profiling

    timer = profiling.SectionTimer()
    cache = os.path.join(workdir, "cache")
    env = dict(os.environ, APEX_TPU_DATA_DIR=cache)
    os.makedirs(cache, exist_ok=True)
    with timer.section("write_bal"):
        save_bal(os.path.join(cache, datasets.BAL_PROBLEMS["trafalgar-257"][1].removesuffix(
            ".bz2")), ds)
    with timer.section("write_g2o"):
        save_g2o(os.path.join(cache, "sphere2500.g2o"), sphere_graph)
    with timer.section("ba_cli"):
        out, launches, ba_s = run_cli(
            "apex_tpu_torch.cli.bundle_adjustment",
            ["--dataset", "trafalgar-257", "--solver", "explicit", "--platform", "cuda"], env,
            "support_cli ba")
    report = dict(line.strip().split(": ", 1) for line in out.splitlines() if ": " in line)
    iterations = int(report["Iterations"])
    r0, r1 = (float(report[k].split()[0]) for k in ("Initial RMSE", "Final RMSE"))
    if not r1 < 0.55 * r0:
        raise AssertionError(f"support_cli ba: RMSE {r0} -> {r1} misses the 0.55x gate")
    if launches != iterations:
        raise AssertionError(f"support_cli ba: {launches} kernel launches for {iterations} "
                             "LM iterations")
    with timer.section("pose_graph_cli"):
        out, _, pg_s = run_cli("apex_tpu_torch.cli.pose_graph",
                               ["--dataset", "sphere2500", "--platform", "cuda"], env,
                               "support_cli pose_graph")
    row = out.strip().splitlines()[-1].split()
    # the library on the same file with the CLI's settings (the constant's
    # solve takes damping="auto"; the CLI keeps LM's default damping)
    cli_cfg = apx.LevenbergMarquardtConfig(linear_solver_type="sparse_cholesky",
                                           max_iterations=100, cost_tolerance=1e-4)
    cp = load_g2o(os.path.join(cache, "sphere2500.g2o")).to_problem().compile(device="cuda")
    lib = apx.LevenbergMarquardt(cli_cfg).optimize(cp)
    if (row[0], row[1], int(row[2])) != ("lm", lib.status.name, lib.iterations):
        raise AssertionError(f"support_cli pose_graph: {row} vs {lib.summary()}")
    np.testing.assert_allclose([float(row[3]), float(row[4])],
                               [lib.initial_cost, lib.final_cost], rtol=5e-5)
    np.testing.assert_allclose(float(row[3]), SPHERE_INITIAL, rtol=5e-5)
    np.testing.assert_allclose(float(row[4]), SPHERE_FINAL, rtol=1e-3)
    with timer.section("traced_solve"):
        with profiling.trace(workdir, "sphere_trace.json"):
            traced = apx.LevenbergMarquardt(cli_cfg).optimize(cp)
            torch.cuda.synchronize()
    trace_bytes = os.path.getsize(os.path.join(workdir, "sphere_trace.json"))
    emit(dict(phase="support_cli", ba_cli_seconds=ba_s, ba_iterations=iterations,
              ba_rmse_initial=r0, ba_rmse_final=r1, ba_status=report["Status"],
              ba_kernel_launches=launches, pose_graph_cli_seconds=pg_s, pose_graph_row=row,
              library_iterations=lib.iterations, library_final_cost=lib.final_cost,
              traced_iterations=traced.iterations, trace_bytes=trace_bytes,
              bal_bytes=os.path.getsize(os.path.join(cache, "problem-257-65132-pre.txt")),
              section_timer=timer.report().splitlines()))
    if trace_bytes <= 0 or not traced.converged:
        raise AssertionError(f"support_cli trace: {trace_bytes} bytes, {traced.summary()}")
    return launches, iterations


EXAMPLES = ("compare_solvers", "compare_optimizers", "covariance_estimation", "custom_factor",
            "load_graph_file", "loss_function_comparison", "visualize_graph_file",
            "visualize_optimization")
EXAMPLE_GRAPHS = ("load_graph_file", "visualize_graph_file")


def run_examples(argv, workdir, label):
    """The eight examples in one subprocess (``main(argv)`` of each, in
    ``workdir``), with ``LevenbergMarquardt.optimize`` wrapped to count the
    landmark kernel's launches per solve: {name: {rows, solves [[launches,
    iterations], ...], seconds}} and the process's whole launch count, both
    printed to stderr at exit."""
    code = (
        "import json, sys, time\n"
        "import numpy as np\n"
        "import apex_tpu_torch as apx\n"
        "from apex_tpu_torch.kernels import landmark_blocks as lb\n"
        "optimize = apx.LevenbergMarquardt.optimize\n"
        "solves = []\n"
        "def counted(self, *a, **kw):\n"
        "    before = lb.launches\n"
        "    res = optimize(self, *a, **kw)\n"
        "    solves.append([lb.launches - before, res.iterations])\n"
        "    return res\n"
        "apx.LevenbergMarquardt.optimize = counted\n"
        "out = {}\n"
        f"for name in {EXAMPLES!r}:\n"
        "    example = __import__('apex_tpu_torch.examples.' + name, fromlist=['main'])\n"
        f"    args = (['{workdir}/' + name + '.g2o'] if name in {EXAMPLE_GRAPHS!r} else [])\n"
        "    solves.clear()\n"
        "    t0 = time.perf_counter()\n"
        f"    rows = example.main(args + {argv!r})\n"
        "    out[name] = dict(rows=rows, solves=list(solves), seconds=time.perf_counter() - t0)\n"
        "print('EXAMPLES ' + json.dumps(dict(examples=out, launches=lb.launches),\n"
        "                               default=lambda x: np.asarray(x).tolist()),\n"
        "      file=sys.stderr)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=workdir, env=env,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    line = [s for s in proc.stderr.splitlines() if s.startswith("EXAMPLES ")][-1]
    return json.loads(line.split(" ", 1)[1]), proc.stdout, seconds


def same_rows(a, b, where):
    """Rows of two runs equal: strings and ints exactly, floats within rtol
    1e-8 (f64), the ``seconds`` column aside."""
    import math

    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise AssertionError(f"{where}: keys {sorted(a)} vs {sorted(b)}")
        for k in a:
            if k != "seconds":
                same_rows(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        if len(a) != len(b):
            raise AssertionError(f"{where}: {len(a)} vs {len(b)} entries")
        for i, (x, y) in enumerate(zip(a, b)):
            same_rows(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if not math.isclose(a, b, rel_tol=1e-8, abs_tol=1e-300):
            raise AssertionError(f"{where}: {a!r} vs {b!r} (rtol 1e-8)")
    elif a != b:
        raise AssertionError(f"{where}: {a!r} vs {b!r}")


def phase_examples(workdir):
    """Phase 32: the eight ported examples as a user runs them, once on the
    card (their default platform) and once with ``--platform cpu``, each
    device in its own process: exit 0, the card's rows equal the CPU's,
    and in ``compare_solvers`` one landmark-kernel launch per LM iteration
    of the two Schur rows and none in the dense rows. Returns (kernel
    launches, LM iterations of the Schur rows) of the card's process."""
    from apex_tpu_torch.io import save_g2o, synthetic

    save_g2o(os.path.join(workdir, "load_graph_file.g2o"),
             synthetic.synthetic_pose_graph_2d(n_poses=100, seed=7))
    save_g2o(os.path.join(workdir, "visualize_graph_file.g2o"),
             synthetic.synthetic_pose_graph_3d(n_poses=150, rings=6))
    card, card_out, card_s = run_examples([], workdir, "examples cuda")
    cpu, _, cpu_s = run_examples(["--platform", "cpu"], workdir, "examples cpu")
    for name in EXAMPLES:
        same_rows(card["examples"][name]["rows"], cpu["examples"][name]["rows"], name)
    if cpu["launches"] != 0 or any(s[0] for e in cpu["examples"].values()
                                   for s in e["solves"]):
        raise AssertionError(f"examples cpu: {cpu['launches']} kernel launches on the CPU")
    cs = card["examples"]["compare_solvers"]
    solvers = [r["solver"] for r in cs["rows"]]
    want = [0 if s.startswith("dense") else r["iterations"] for s, r in zip(solvers, cs["rows"])]
    if [s[0] for s in cs["solves"]] != want or card["launches"] != sum(want) or not all(want[2:]):
        raise AssertionError(f"examples compare_solvers: launches {cs['solves']} per solve, "
                             f"{card['launches']} in all, for the rows' iterations {want}")
    others = sum(s[0] for n, e in card["examples"].items() if n != "compare_solvers"
                 for s in e["solves"])
    if others:
        raise AssertionError(f"examples: {others} kernel launches outside compare_solvers")
    emit(dict(phase="examples", process_seconds={"cuda": card_s, "cpu": cpu_s},
              seconds={name: {"cuda": card["examples"][name]["seconds"],
                              "cpu": cpu["examples"][name]["seconds"]} for name in EXAMPLES},
              compare_solvers=[dict(solver=r["solver"], status=r["status"],
                                    iterations=r["iterations"], final_cost=r["final_cost"],
                                    rmse=r["rmse"], launches=s[0], cuda_seconds=r["seconds"],
                                    cpu_seconds=c["seconds"])
                               for r, s, c in zip(cs["rows"], cs["solves"],
                                                  cpu["examples"]["compare_solvers"]["rows"])],
              kernel_launches=card["launches"], stdout_lines=len(card_out.splitlines())))
    return card["launches"], sum(want[2:])


# the recording of phase 33: (topic, type, rate in Hz, phase offset in ms)
BAG_TOPICS = (("/imu", "sensor_msgs/msg/Imu", 200, 0),
              ("/odom", "nav_msgs/msg/Odometry", 50, 1),
              ("/tf", "tf2_msgs/msg/TFMessage", 100, 2),
              ("/scan", "sensor_msgs/msg/LaserScan", 40, 3))
BAG_T0_NS = 1_700_000_000 * 10**9
SCAN_BEAMS = 1081  # a Hokuyo UTM-30LX: 270 degrees at 0.25 degrees


class Recording:
    """A mobile robot's recording, drawn from numpy generators of one seed:
    an IMU at 200 Hz, wheel odometry at 50 Hz, odom -> base_link on /tf at
    100 Hz and a 1,081-beam laser scanner at 40 Hz. Each message is built
    on demand from the arrays, as written (``message``) or as it reads back
    (``expected``: float32 fields at their float32 rounding). Each topic's
    stamps sit on its own millisecond phase, so no two messages share a
    timestamp and every storage gives one order."""

    def __init__(self, seconds, seed=0):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.n = {topic: int(seconds * rate) for topic, _, rate, _ in BAG_TOPICS}
        self.period_ns = {topic: 10**9 // rate for topic, _, rate, _ in BAG_TOPICS}
        self.offset_ns = {topic: ms * 10**6 for topic, _, _, ms in BAG_TOPICS}
        n_imu, n_odom = self.n["/imu"], self.n["/odom"]
        self.imu_rpy = np.cumsum(rng.normal(0, 1e-3, (n_imu, 3)), axis=0)
        self.imu_gyro = rng.normal(0, 0.05, (n_imu, 3))
        self.imu_acc = rng.normal(0, 0.2, (n_imu, 3)) + [0.0, 0.0, 9.80665]
        heading = np.cumsum(rng.normal(0, 0.01, n_odom))
        speed = 1.0 + 0.2 * np.sin(np.arange(n_odom) / 500.0)
        self.odom_xy = np.cumsum(np.stack([speed * np.cos(heading),
                                           speed * np.sin(heading)], axis=1) / 50.0, axis=0)
        self.odom_yaw = heading
        self.odom_twist = np.stack([speed, rng.normal(0, 0.01, n_odom)], axis=1)
        self.odom_cov = np.diag([1e-3, 1e-3, 1e6, 1e6, 1e6, 3e-3]).ravel().tolist()
        n_tf = self.n["/tf"]
        self.tf_xyz = rng.normal(0, 1.0, (n_tf, 3))
        self.tf_yaw = rng.uniform(-np.pi, np.pi, n_tf)
        n_scan = self.n["/scan"]
        self.ranges = rng.uniform(0.1, 30.0, (n_scan, SCAN_BEAMS))
        self.intensities = rng.uniform(0.0, 8000.0, (n_scan, SCAN_BEAMS))

    @property
    def count(self):
        return sum(self.n.values())

    def stamp(self, topic, i):
        return BAG_T0_NS + self.offset_ns[topic] + i * self.period_ns[topic]

    def order(self):
        """(timestamp, topic, index) of every message, in time order."""
        return sorted((self.stamp(topic, i), topic, i)
                      for topic, _, _, _ in BAG_TOPICS for i in range(self.n[topic]))

    def index(self, topic, t_ns):
        i, rem = divmod(t_ns - BAG_T0_NS - self.offset_ns[topic], self.period_ns[topic])
        if rem or not 0 <= i < self.n[topic]:
            raise AssertionError(f"bags: {topic} stamp {t_ns} is not one of the recording's")
        return i

    @staticmethod
    def _header(t_ns, frame):
        return {"stamp": {"sec": t_ns // 10**9, "nanosec": t_ns % 10**9}, "frame_id": frame}

    @staticmethod
    def _quat(roll, pitch, yaw):
        import math

        cr, sr = math.cos(roll / 2), math.sin(roll / 2)
        cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
        cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
        return {"x": sr * cp * cy - cr * sp * sy, "y": cr * sp * cy + sr * cp * sy,
                "z": cr * cp * sy - sr * sp * cy, "w": cr * cp * cy + sr * sp * sy}

    def message(self, topic, i, f32=float):
        t = self.stamp(topic, i)
        if topic == "/imu":
            g, a = self.imu_gyro[i].tolist(), self.imu_acc[i].tolist()
            return {"header": self._header(t, "imu_link"),
                    "orientation": self._quat(*self.imu_rpy[i].tolist()),
                    "orientation_covariance": [1e-4, 0.0, 0.0, 0.0, 1e-4, 0.0, 0.0, 0.0, 1e-4],
                    "angular_velocity": {"x": g[0], "y": g[1], "z": g[2]},
                    "angular_velocity_covariance": [2.5e-5, 0.0, 0.0, 0.0, 2.5e-5, 0.0, 0.0,
                                                    0.0, 2.5e-5],
                    "linear_acceleration": {"x": a[0], "y": a[1], "z": a[2]},
                    "linear_acceleration_covariance": [0.04, 0.0, 0.0, 0.0, 0.04, 0.0, 0.0,
                                                       0.0, 0.04]}
        if topic == "/odom":
            x, y = self.odom_xy[i].tolist()
            v, w = self.odom_twist[i].tolist()
            return {"header": self._header(t, "odom"), "child_frame_id": "base_link",
                    "pose": {"pose": {"position": {"x": x, "y": y, "z": 0.0},
                                      "orientation": self._quat(0.0, 0.0, float(
                                          self.odom_yaw[i]))},
                             "covariance": self.odom_cov},
                    "twist": {"twist": {"linear": {"x": v, "y": 0.0, "z": 0.0},
                                        "angular": {"x": 0.0, "y": 0.0, "z": w}},
                              "covariance": self.odom_cov}}
        if topic == "/tf":
            x, y, z = self.tf_xyz[i].tolist()
            return {"transforms": [{
                "header": self._header(t, "odom"), "child_frame_id": "base_link",
                "transform": {"translation": {"x": x, "y": y, "z": z},
                              "rotation": self._quat(0.0, 0.0, float(self.tf_yaw[i]))}}]}
        if f32 is float:
            ranges, intensities = self.ranges[i].tolist(), self.intensities[i].tolist()
        else:
            ranges = self.ranges[i].astype(f32).tolist()
            intensities = self.intensities[i].astype(f32).tolist()
        rnd = (lambda v: v) if f32 is float else (lambda v: float(f32(v)))
        return {"header": self._header(t, "laser"),
                "angle_min": rnd(-2.356194490192345), "angle_max": rnd(2.356194490192345),
                "angle_increment": rnd(0.004363323129985824),
                "time_increment": rnd(1.7361111111111112e-05), "scan_time": rnd(0.025),
                "range_min": rnd(0.1), "range_max": rnd(30.0),
                "ranges": ranges, "intensities": intensities}

    def expected(self, topic, i):
        import numpy as np

        return self.message(topic, i, f32=np.float32)


def host_cpu():
    """The host's CPU model, as ``lscpu`` names it (or ``/proc/cpuinfo``)."""
    import platform
    import shutil

    lscpu = (subprocess.run(["lscpu"], capture_output=True, text=True).stdout
             if shutil.which("lscpu") else "")
    names = [line.split(":", 1)[1].strip() for line in lscpu.splitlines()
             if line.startswith(("Model name", "Vendor ID"))]
    if not names and os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            names = [line.split(":", 1)[1].strip() for line in f
                     if line.startswith("model name")][:1]
    return " / ".join(names) or platform.machine()


def check_bag(rec, bag, label):
    """Every message of ``bag`` read back (decoded, in time order) equals
    the recording's, each once: (seconds in the reader: opening the bag and
    yielding decoded messages, the check aside; CDR bytes)."""
    from apex_tpu_torch.io.rosbag import Reader

    seen = {topic: 0 for topic in rec.n}
    t0 = time.perf_counter()
    with Reader(bag) as r:
        messages = r.messages()
        seconds = time.perf_counter() - t0
        last = -1
        while True:
            t0 = time.perf_counter()
            item = next(messages, None)
            seconds += time.perf_counter() - t0
            if item is None:
                break
            topic, _, ts, msg = item
            if ts <= last:
                raise AssertionError(f"{label}: messages out of time order at {ts}")
            last = ts
            if msg != rec.expected(topic, rec.index(topic, ts)):
                raise AssertionError(f"{label}: {topic} at {ts} differs from the recording")
            seen[topic] += 1
    if seen != rec.n:
        raise AssertionError(f"{label}: read {seen}, wrote {rec.n}")
    with Reader(bag) as r:
        nbytes = sum(len(raw) for _, _, _, raw in r.messages(decode=False))
    return seconds, nbytes


BAG_STORAGES = {"sqlite3": ("sqlite3", None), "mcap": ("mcap", None),
                "mcap_zlib": ("mcap", "zlib")}


def bag_storage(workdir, name, seconds, seed):
    """One storage of phase 33, in a process of its own: the recording
    written through the port's ``Writer``, its ``metadata.yaml`` read back
    through the port's reader, and every message read back and held to the
    recording. Prints one JSON line of timings."""
    from apex_tpu_torch.io.rosbag import Writer, read_metadata

    storage, compression = BAG_STORAGES[name]
    rec = Recording(seconds, seed)
    order = rec.order()
    bag = os.path.join(workdir, f"bag_{name}")
    t0 = time.perf_counter()
    with Writer(bag, storage=storage, compression=compression) as w:
        for topic, type_name, _, _ in BAG_TOPICS:
            w.add_topic(topic, type_name)
        for ts, topic, i in order:
            w.write(topic, ts, rec.message(topic, i))
    write_s = time.perf_counter() - t0
    meta = read_metadata(bag)
    counts = {t["topic_metadata"]["name"]: t["message_count"]
              for t in meta["topics_with_message_count"]}
    if (meta["message_count"], counts, meta["storage_identifier"],
            meta["starting_time"]["nanoseconds_since_epoch"], meta["duration"]["nanoseconds"]) != (
                rec.count, rec.n, storage, order[0][0], order[-1][0] - order[0][0]):
        raise AssertionError(f"bags {name}: metadata.yaml {meta}")
    read_s, nbytes = check_bag(rec, bag, f"bags {name}")
    file_bytes = sum(os.path.getsize(os.path.join(bag, f)) for f in os.listdir(bag))
    print(json.dumps(dict(write_seconds=write_s, read_seconds=read_s,
                          write_messages_per_s=rec.count / write_s,
                          read_messages_per_s=rec.count / read_s,
                          write_mb_per_s=nbytes / write_s / 1e6,
                          read_mb_per_s=nbytes / read_s / 1e6,
                          cdr_bytes=nbytes, file_bytes=file_bytes)), flush=True)


def phase_bags(workdir, seconds=600.0, seed=0):
    """Phase 33: a ``seconds``-long recording (234,000 messages, about
    0.28 GB of CDR at 600 s) written through the port's ``Writer`` as
    sqlite3, MCAP and MCAP with zlib chunks, one process per storage, all
    three at once (``bag_storage``); then, on the sqlite3 bag, ``bag_tools``
    info, filter (/odom and /tf) and extract (/odom), and a replay of /odom
    through ``LoopbackTransport`` into a ``DdsListener``, each held to the
    recording. Host work only."""
    import contextlib
    import csv
    import io

    from apex_tpu_torch.cli import bag_tools
    from apex_tpu_torch.io.dds import DdsListener, LoopbackTransport
    from apex_tpu_torch.io.rosbag import Reader

    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke\n"
         "chip_smoke.bag_storage(sys.argv[1], sys.argv[2], float(sys.argv[3]), int(sys.argv[4]))",
         workdir, name, repr(seconds), str(seed)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in BAG_STORAGES}
    per_storage = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"bags {name}: exit {proc.returncode}\n{out}\n{err}")
            per_storage[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    storages_s = time.perf_counter() - t0
    rec = Recording(seconds, seed)

    bag = os.path.join(workdir, "bag_sqlite3")
    tools = {}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        if bag_tools.main(["info", bag]) != 0:
            raise AssertionError("bags: bag_tools info failed")
    tools["info_seconds"] = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for topic, type_name, _, _ in BAG_TOPICS:
        want = f"  {topic:<30} {type_name:<40} {rec.n[topic]:>8} msgs [cdr]"
        if want not in lines:
            raise AssertionError(f"bags: info misses {want!r}:\n{out.getvalue()}")
    if f"messages: {rec.count}" not in lines or "storage: sqlite3" not in lines:
        raise AssertionError(f"bags: info\n{out.getvalue()}")
    filtered = os.path.join(workdir, "bag_filtered")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        bag_tools.main(["filter", bag, filtered, "--topics", "/odom", "/tf"])
    tools["filter_seconds"] = time.perf_counter() - t0
    with Reader(bag) as r:
        kept = list(r.messages(topics=["/odom", "/tf"], decode=False))
    with Reader(filtered) as r:
        if list(r.messages(decode=False)) != kept or len(kept) != rec.n["/odom"] + rec.n["/tf"]:
            raise AssertionError("bags: the filtered bag is not the source's /odom and /tf")
    table = os.path.join(workdir, "odom.csv")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        bag_tools.main(["extract", bag, "--topic", "/odom", "--out", table])
    tools["extract_seconds"] = time.perf_counter() - t0
    with open(table, newline="") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != rec.n["/odom"]:
        raise AssertionError(f"bags: extract wrote {len(rows)} rows")
    for i, row in enumerate(rows):
        msg = rec.message("/odom", i)
        if (int(row["timestamp_ns"]) != rec.stamp("/odom", i)
                or float(row["pose.pose.position.x"]) != msg["pose"]["pose"]["position"]["x"]
                or float(row["twist.twist.angular.z"]) != msg["twist"]["twist"]["angular"]["z"]):
            raise AssertionError(f"bags: extract row {i} {row}")
    tools["extract_rows"] = len(rows)

    bus = LoopbackTransport()
    listener = DdsListener(transport=bus)
    got = []
    listener.subscribe("/odom", "nav_msgs/msg/Odometry", lambda t, m: got.append(m))
    t0 = time.perf_counter()
    with Reader(bag) as r:
        for _, type_name, _, raw in r.messages(topics=["/odom"], decode=False):
            bus.publish("/odom", type_name, raw[4:])  # a DDS stack strips the header
    dds_s = time.perf_counter() - t0
    if len(got) != rec.n["/odom"] or any(m != rec.expected("/odom", i)
                                        for i, m in enumerate(got)):
        raise AssertionError(f"bags: DDS delivered {len(got)} of {rec.n['/odom']} /odom "
                             "messages, or one differs")
    if listener.subscriptions["rt/odom"]["received"] != rec.n["/odom"]:
        raise AssertionError("bags: the listener's count")
    emit(dict(phase="bags", recording_seconds=seconds, messages=rec.count, per_topic=rec.n,
              host_cpu=host_cpu(), cpu_count=os.cpu_count(), storages=per_storage,
              storages_wall_seconds=storages_s, bag_tools=tools, dds_seconds=dds_s,
              dds_messages_per_s=len(got) / dds_s))


# phase 34: the multi-device solves on the one card (apex_tpu_torch.parallel)
MD_BA_STEPS = 10  # LM iterations of each BA run
MD_SPHERE_STEPS = 8  # of the banded sphere run
MD_MEDIUM_STEPS = 8  # of the dense medium-fixture run
# (name, kind, dtype, layout): the runs of each world, in order
MD_ONE_RANK = (("partitioned_f64", "ba", "float64", "bucketed"),
               ("partitioned_f64_again", "ba", "float64", "bucketed"),
               ("banded_sphere", "banded", "float64", None),
               ("banded_sphere_again", "banded", "float64", None),
               ("dense_medium", "dense", "float64", None),
               ("dense_medium_again", "dense", "float64", None))
MD_TWO_RANKS = (("partitioned_f64", "ba", "float64", "bucketed"),
                ("partitioned_f32", "ba", "float32", "bucketed"),
                ("block_flat_f64", "ba", "float64", "flat"),
                ("banded_sphere", "banded", "float64", None),
                ("dense_medium", "dense", "float64", None))


def md_problem(kind, dtype, layout, device, cache):
    """(compiled problem, LM iterations, observations or None) of a run."""
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.ba import build_ba_problem
    from apex_tpu_torch.io import synthetic

    dt = getattr(torch, dtype)
    if kind == "ba":
        if "ds" not in cache:
            cache["ds"] = synthetic.synthetic_ba_large(n_cameras=257, n_points=65_132,
                                                       obs_per_camera=879, seed=0)
        ds = cache["ds"]
        problem = build_ba_problem(ds, mode="self_calibration", layout=layout)
        return problem.compile(dtype=dt, device=device), MD_BA_STEPS, ds.num_observations
    if kind == "banded":
        g = synthetic.synthetic_pose_graph_3d(n_poses=2500, rings=50, seed=0)
        return g.to_problem().compile(dtype=dt, device=device), MD_SPHERE_STEPS, None
    g = apx.load_g2o(os.path.join(REPO, MEDIUM_SE3[0]))
    return g.to_problem().compile(dtype=dt, device=device), MD_MEDIUM_STEPS, None


def md_rank(mesh, runs):
    """Phase 34 on one rank: each run's steps, timed one by one, with the
    landmark kernel's launches and the mesh's all-reduces counted from 0
    just before the first step. Each rank prints one JSON line per run, in
    rank order; returns {run: result}."""
    import hashlib

    import torch
    import torch.distributed as dist

    from apex_tpu_torch.ba import rmse
    from apex_tpu_torch.kernels import landmark_blocks as lb
    from apex_tpu_torch.parallel import (make_sharded_banded_lm_step, make_sharded_lm_step,
                                         make_sharded_schur_step)

    dev = mesh.device
    cache, out = {}, {}
    for name, kind, dtype, layout in runs:
        cp, n_steps, n_obs = md_problem(kind, dtype, layout, dev, cache)
        if kind == "ba":
            step, _ = make_sharded_schur_step(cp, mesh)
        elif kind == "banded":
            step = make_sharded_banded_lm_step(cp, mesh)
        else:
            step = make_sharded_lm_step(cp, mesh)
        partitioned = hasattr(step, "solve")
        values = cp.initial_values()
        damping = torch.tensor(1e-3, dtype=cp.dtype, device=dev)
        nu = torch.tensor(2.0, dtype=cp.dtype, device=dev)
        cost = cp.cost(values)
        costs, step_s = [float(cost)], []
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        lb.launches = 0
        mesh.all_reduces, mesh.all_reduce_bytes, mesh.all_reduce_seconds = 0, 0, 0.0
        for i in range(n_steps):
            t0 = time.perf_counter()
            if partitioned:
                values, damping, nu, cost = step(values, damping, nu, cost, iteration=i,
                                                 dx_prev=step.last_dx)
            else:
                values, damping, nu, cost = step(values, damping, nu, cost)
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t0)
            costs.append(float(cost))
        launches = lb.launches
        seconds = sum(step_s)
        res = dict(phase="multidevice_rank", world=mesh.size, rank=mesh.rank,
                   backend=dist.get_backend(), run=name, kind=kind, dtype=dtype,
                   partitioned=partitioned, steps=n_steps, costs=costs,
                   kernel_launches=launches,
                   all_reduces_per_iteration=mesh.all_reduces / n_steps,
                   all_reduce_bytes_per_iteration=mesh.all_reduce_bytes / n_steps,
                   all_reduce_seconds_per_iteration=mesh.all_reduce_seconds / n_steps,
                   all_reduce_share=mesh.all_reduce_seconds / seconds,
                   seconds_per_iteration=seconds / n_steps,
                   seconds_per_iteration_after_first=sum(step_s[1:]) / (n_steps - 1),
                   first_step_seconds=step_s[0],
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                   values_sha256=hashlib.sha256(b"".join(
                       v.cpu().numpy().tobytes() for v in values)).hexdigest())
        if n_obs is not None:
            res.update(observations=n_obs, rmse_initial=rmse(costs[0], n_obs),
                       rmse_final=rmse(costs[-1], n_obs))
        for r in range(mesh.size):
            if r == mesh.rank:
                emit(res)
            dist.barrier()
        out[name] = res
    return out


def md_close(label, got, want, rtol, spread):
    """Costs of two runs within max(rtol, 10x the spread of two one-rank
    runs): ``index_add_`` sums in atomic order on the card."""
    import numpy as np

    tol = max(rtol, 10.0 * spread)
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    if not err <= tol:
        raise AssertionError(f"multidevice {label}: relative difference {err} above {tol}")
    return err


def md_spread(a, b):
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(a)))


def phase_multidevice(workdir):
    """Phase 34: the multi-device solves, ranks as processes spawned from
    the smoke (``parallel.launch``), the mesh timing each all-reduce:

    (a) the trafalgar-scale synthetic in the default (bucketed) layout
        through the landmark-partitioned Schur step, 10 LM iterations with
        the forcing sequence and the warm start, f64 on 1 NCCL rank (twice)
        and on 2 gloo ranks sharing the card, f32 on the 2 gloo ranks;
    (b) its flat layout through the observation-sharded block path, 2 gloo
        ranks;
    (c) the sphere2500-shaped graph through the banded sharded step, 8
        steps, and the medium SE3 fixture through the dense sharded step, 8
        steps, 1 NCCL rank (twice) against 2 gloo ranks;
    (d) ``graft_entry.dryrun_multichip(2, backend="gloo")`` and the
        ``multichip_ba`` example on 2 gloo ranks on the card, each in a
        process of its own.

    Gates: the path; the BA gate (RMSE below 0.55x); 2 ranks against 1 at
    rtol 1e-8 (BA) and 1e-10 (pose graphs), or 10x the spread of the two
    1-rank runs where that is larger; the ranks' final values bitwise
    equal; one landmark-kernel launch per rank per LM iteration on both
    Schur routes; the sphere's cost reduced by more than 99%; exit 0 of
    (d). Returns (kernel launches, rank LM iterations) of the BA runs."""
    from apex_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    one = launch(md_rank, 1, "nccl", "cuda", MD_ONE_RANK, timed=True)[0]
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = launch(md_rank, 2, "gloo", "cuda", MD_TWO_RANKS, timed=True)
    two_s = time.perf_counter() - t0

    launches = iterations = 0
    for world in ([one], two):
        for res in (r for rank in world for r in rank.values()):
            if res["kind"] != "ba":
                if res["kernel_launches"]:
                    raise AssertionError(f"multidevice {res['run']}: kernel launches "
                                         "in a pose-graph run")
                continue
            want_path = not res["run"].startswith("block")
            if res["partitioned"] != want_path:
                raise AssertionError(f"multidevice {res['run']}: partitioned path "
                                     f"{res['partitioned']}")
            if not res["rmse_final"] < 0.55 * res["rmse_initial"]:
                raise AssertionError(f"multidevice {res['run']} on {res['world']} ranks: "
                                     f"RMSE {res['rmse_initial']} -> {res['rmse_final']}")
            if res["kernel_launches"] != res["steps"]:
                raise AssertionError(f"multidevice {res['run']}: {res['kernel_launches']} "
                                     f"kernel launches in {res['steps']} LM iterations")
            launches += res["kernel_launches"]
            iterations += res["steps"]
    for name, _, _, _ in MD_TWO_RANKS:
        if two[0][name]["values_sha256"] != two[1][name]["values_sha256"]:
            raise AssertionError(f"multidevice {name}: the two ranks' values differ")
    errors = {}
    for name, rtol in (("partitioned_f64", 1e-8), ("banded_sphere", 1e-10),
                       ("dense_medium", 1e-10)):
        spread = md_spread(one[name]["costs"], one[f"{name}_again"]["costs"])
        errors[name] = dict(spread_one_rank=spread, two_against_one=md_close(
            name, two[0][name]["costs"], one[name]["costs"], rtol, spread))
    sphere = one["banded_sphere"]["costs"]
    if not sphere[-1] < 0.01 * sphere[0]:
        raise AssertionError(f"multidevice banded_sphere: {sphere[0]} -> {sphere[-1]}")

    from apex_tpu_torch.graft_entry import dryrun_multichip

    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device="cuda", backend="gloo")
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "apex_tpu_torch.examples.multichip_ba", "2",
                           "--backend", "gloo"], cwd=workdir, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    example_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"multichip_ba: exit {proc.returncode}\n{proc.stdout}\n"
                             f"{proc.stderr}")

    def summary(res):
        keys = ("seconds_per_iteration", "seconds_per_iteration_after_first",
                "all_reduces_per_iteration", "all_reduce_bytes_per_iteration",
                "all_reduce_share", "max_memory_allocated", "kernel_launches")
        return {k: res[k] for k in keys}

    emit(dict(phase="multidevice", host_cpu=host_cpu(),
              world_seconds={"nccl_1": one_s, "gloo_2": two_s},
              one_rank={name: summary(res) for name, res in one.items()},
              two_ranks={name: [summary(rank[name]) for rank in two]
                         for name, _, _, _ in MD_TWO_RANKS},
              costs={"one_rank": {k: v["costs"] for k, v in one.items()},
                     "two_ranks": {k: two[0][k]["costs"] for k, _, _, _ in MD_TWO_RANKS}},
              cost_errors=errors, dryrun=dry, dryrun_seconds=dry_s,
              example_seconds=example_s, example_stdout=proc.stdout.splitlines()[-1],
              kernel_launches=launches, rank_iterations=iterations))
    return launches, iterations


# -- slice 13: the scale ladder -------------------------------------------------

# The JAX package on a CPU, f64, bench.py's configs in python mode, its own
# build and compile of each rung (tests/scale_reference.py): the initial
# cost, and the status, LM iterations and final cost of the solve.
SCALE_JAX = {
    "torus3d": (4004.0589871703596, ("COST_TOLERANCE_REACHED", 4, 17.429097497226966)),
    "cubicle": (5392.174001638021, ("COST_TOLERANCE_REACHED", 4, 41.08180132334645)),
    "pose50k": (71610.69869060852, ("COST_TOLERANCE_REACHED", 6, 190.75766379995434)),
    "dubrovnik": (5788301.604063559, ("MIN_COST_THRESHOLD_REACHED", 1, 249197.43422463295)),
    "ladybug": (3168343.3709838716, ("MAX_ITERATIONS_REACHED", 5, 290041.1614633131)),
    "venice": (23052186.548304845, ("MIN_COST_THRESHOLD_REACHED", 1, 393137.332888945)),
}
SCALE_RUNGS = ("torus3d", "cubicle", "pose50k", "dubrovnik", "ladybug", "venice")
SCALE_BA = ("dubrovnik", "ladybug", "venice")
GiB = 2 ** 30
# half the card's 80 GB: a scale run reserving more is a fault to chase
SCALE_RESERVED_GIB = 40


def solve_counts():
    """The library's counts of CR solves, refinements and retries
    (``linalg/banded.py``) and of PCG solves and iterations
    (``linalg/schur.py``): exact over python-mode solves."""
    from apex_tpu_torch.linalg import banded, schur

    return dict(cr_solves=banded.cr_solves, cr_refines=banded.cr_refines,
                cr_retries=banded.cr_retries, pcg_calls=schur.pcg_calls,
                pcg_iterations=schur.pcg_iterations)


def counts_line(before, lm_iterations):
    n = {k: v - before[k] for k, v in solve_counts().items()}
    return dict(n, pcg_iterations_per_lm_iteration=n["pcg_iterations"] / lm_iterations,
                cr_retries_per_lm_iteration=n["cr_retries"] / lm_iterations)


def port_frame(frames):
    """The innermost frame of the port in an allocation's stack, as
    ``module path:line function``."""
    for f in frames:
        name = f["filename"].replace("\\", "/")
        if "apex_tpu_torch/" in name:
            return f"{name.split('apex_tpu_torch/')[-1]}:{f['line']} {f['name']}"
    return "outside the port"


def graph_memory_trace(solve, top=6):
    """``solve()`` (a first jit solve: each program's warm-up, then its
    capture into the problem's graph pool) with the allocator's history
    recorded: (its result, a dict). The dict has the peak reserved bytes
    over the solve, and for the graph pool (the segments of a private pool
    after the solve) and for the default pool the peak of live bytes, with
    the ``top`` lines of the port that allocated most of the bytes live at
    that peak; and the pool's bytes still allocated after the solve, by
    line: what the captured programs keep alive."""
    import bisect

    import torch

    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.memory._record_memory_history(stacks="python", max_entries=4_000_000,
                                             clear_history=True)
    out = solve()
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    pool = sorted((sg["address"], sg["address"] + sg["total_size"]) for sg in snap["segments"]
                  if tuple(sg["segment_pool_id"]) != (0, 0))
    starts = [a for a, _ in pool]

    def in_pool(addr):
        k = bisect.bisect_right(starts, addr) - 1
        return k >= 0 and addr < pool[k][1]

    def replay(stop=None):
        """Live blocks after the events up to ``stop`` (per pool); without
        ``stop``, the index of each pool's peak of live bytes and the peak
        reserved bytes."""
        live, totals, peak = {}, {True: 0, False: 0}, {True: (0, -1), False: (0, -1)}
        reserved = peak_reserved = reserved0
        for i, ev in enumerate(events):
            action, addr, size = ev["action"], ev["addr"], ev["size"]
            if action == "segment_alloc":
                reserved += size
                peak_reserved = max(peak_reserved, reserved)
            elif action == "segment_free":
                reserved -= size
            elif action == "alloc":
                g = in_pool(addr)
                if stop is not None and i > stop[g]:
                    continue
                live[addr] = (size, ev["frames"], g)
                totals[g] += size
                if totals[g] > peak[g][0]:
                    peak[g] = (totals[g], i)
            elif action == "free_completed" and addr in live:
                g = live[addr][2]
                if stop is not None and i > stop[g]:
                    continue
                totals[g] -= live.pop(addr)[0]
        return live, peak, peak_reserved

    events = snap["device_traces"][0]
    _, peak, peak_reserved = replay()
    live, _, _ = replay({g: peak[g][1] for g in peak})
    peaks = {g: (peak[g][0], [v for v in live.values() if v[2] == g]) for g in peak}

    def by_line(blocks):
        lines = {}
        for size, frames, _ in blocks:
            where = port_frame(frames)
            lines[where] = lines.get(where, 0) + size
        return [[where, size / GiB] for where, size in
                sorted(lines.items(), key=lambda kv: -kv[1])[:top]]

    pool_kept = [(b["size"], b.get("frames", []), True)
                 for sg in snap["segments"] if tuple(sg["segment_pool_id"]) != (0, 0)
                 for b in sg["blocks"] if b["state"] == "active_allocated"]
    return out, dict(
        peak_reserved_gib=peak_reserved / GiB,
        graph_pool_reserved_gib=sum(b - a for a, b in pool) / GiB,
        graph_pool_peak_live_gib=peaks[True][0] / GiB,
        graph_pool_peak_by_line_gib=by_line(peaks[True][1]),
        graph_pool_kept_gib=sum(b[0] for b in pool_kept) / GiB,
        graph_pool_kept_by_line_gib=by_line(pool_kept),
        default_pool_peak_live_gib=peaks[False][0] / GiB,
        default_pool_peak_by_line_gib=by_line(peaks[False][1]))


def peak_memory(label):
    """Peak allocated and reserved GiB since the last ``release_cuda``. A
    run that reserves more than SCALE_RESERVED_GIB fails."""
    import torch

    out = dict(max_memory_allocated_gib=torch.cuda.max_memory_allocated() / GiB,
               max_memory_reserved_gib=torch.cuda.max_memory_reserved() / GiB)
    if out["max_memory_reserved_gib"] > SCALE_RESERVED_GIB:
        raise AssertionError(f"{label}: {out}, above {SCALE_RESERVED_GIB} GiB")
    return out


def release_cuda():
    """Drop the memory of solvers and graphs no longer referenced, so that
    each run's peak and reserved bytes are its own."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def scale_run(rung, built, mode, runs, ba, span=False):
    """One dtype and mode of a scale rung through the ladder's solve
    function (the first solve timed apart, then ``runs`` timed solves):
    (the ``Solved``, its line, kernel launches, LM iterations). A BA rung's
    groups take the assembly kernels, once per LM iteration each. python
    mode counts the CR solves and retries and the PCG iterations; jit mode its graphs, host
    reads and graph memory; ``span`` adds one solve with CUDA events around
    its graph launches (``graph_span_solve``)."""
    import torch

    from apex_tpu_torch.benches import ladder
    from apex_tpu_torch.kernels import landmark_blocks as lb

    release_cuda()
    reserved0 = torch.cuda.memory_reserved()
    before, counts = graph_counters(), solve_counts()
    solved = rung.solve(built, runs=runs, mode=mode)
    n = {k: v - before[k] for k, v in graph_counters().items()}
    res, first = solved.result, solved.first_result
    iterations = first.iterations + (res.iterations if runs else 0)
    launches = n["eager_kernel_launches"] + n["replayed_kernel_launches"]
    line = dict(mode=mode, status=res.status.name, iterations=res.iterations,
                first_solve_iterations=first.iterations, initial_cost=res.initial_cost,
                final_cost=res.final_cost, first_solve_seconds=solved.first_seconds,
                **peak_memory(f"{built.cp.total_dof} DOF, {mode}"))
    if runs:
        line.update(solve_seconds=solved.seconds,
                    seconds_per_lm_iteration=solved.seconds / res.iterations,
                    python_run_to_run_spread=abs(res.final_cost - first.final_cost)
                    / abs(res.final_cost))
    if ba:
        line.update(rmse_initial=ladder.rmse(res.initial_cost, built.data.num_observations),
                    rmse_final=ladder.rmse(res.final_cost, built.data.num_observations),
                    kernel_launches=launches,
                    kernel_launches_per_lm_iteration=launches / iterations,
                    assembly_kernel_calls=assembly_calls(
                        "scale", f"scale {built.cp.total_dof} DOF, {mode}", n,
                        len(built.cp.groups), iterations, jit=mode == "jit"))
    if mode == "python":
        line.update(counts_line(counts, iterations))
        if ba and lb.launches - before["eager_kernel_launches"] != iterations:
            raise AssertionError(f"python mode: {launches} kernel launches for {iterations} "
                                 "LM iterations")
    else:
        solves = 1 + (1 if runs else 0)
        line.update(graphs=n["graphs"],
                    replays_per_lm_iteration=n["replays"] / iterations,
                    host_reads=n["host_reads"], solves=solves,
                    host_reads_per_lm_iteration=n["host_reads"] / iterations,
                    host_read_bound=check_host_reads(
                        f"scale {built.cp.total_dof} DOF", n, solves, iterations,
                        host_loop_reason(solved.solver, built.cp)))
        if n["captures"] != 1:
            raise AssertionError(f"jit: {n['captures']} captures")
        if ba and n["replayed_kernel_launches"] != iterations:
            raise AssertionError(f"jit: {n['replayed_kernel_launches']} landmark launches on "
                                 f"the device for {iterations} LM iterations")
        if ba and launches < iterations:
            raise AssertionError(f"jit: {launches} launches for {iterations} LM iterations")
        if span:
            before = graph_counters()
            spanned, wall, device = graph_span_solve(lambda: solved.solver.optimize(built.cp))
            s_n = {k: v - before[k] for k, v in graph_counters().items()}
            s_launches = s_n["eager_kernel_launches"] + s_n["replayed_kernel_launches"]
            launches += s_launches
            iterations += spanned.iterations
            line["span"] = dict(iterations=spanned.iterations, graph_device_seconds=device,
                                graph_span_wall_seconds=wall, kernel_launches=s_launches,
                                assembly_kernel_calls=assembly_calls(
                                    "scale", f"scale {built.cp.total_dof} DOF, span", s_n,
                                    len(built.cp.groups) if ba else 0, spanned.iterations,
                                    jit=True),
                                device_idle_share_outside_graphs=1.0 - device / wall)
            if ba and s_launches != spanned.iterations:
                raise AssertionError(f"span: {s_launches} landmark launches on the device "
                                     f"for {spanned.iterations} LM iterations")
        release_cuda()
        line["graph_memory_reserved_gib"] = (torch.cuda.memory_reserved() - reserved0) / GiB
    return solved, line, (launches if ba else 0), (iterations if ba else 0)


def scale_gates(name, label, res, python=None, spread=0.0):
    """f64: the JAX package's initial cost (rtol 1e-12), and its status,
    iterations and final cost (rtol 1e-8) where its CPU solve was run; jit
    mode also python mode's iterations, status and final cost (rtol 1e-10,
    or 10x python mode's own spread)."""
    import numpy as np

    initial, final = SCALE_JAX[name]
    np.testing.assert_allclose(res.initial_cost, initial, rtol=1e-12,
                               err_msg=f"{name} {label}: initial cost")
    if final is not None:
        status, iterations, cost = final
        if (res.status.name, res.iterations) != (status, iterations):
            raise AssertionError(f"{name} {label}: {res.summary()}, the JAX package: {final}")
        np.testing.assert_allclose(res.final_cost, cost, rtol=1e-8,
                                   err_msg=f"{name} {label}: final cost")
    if python is not None:
        if (res.iterations, res.status) != (python.iterations, python.status):
            raise AssertionError(f"{name} {label}: {res.summary()} vs python {python.summary()}")
        np.testing.assert_allclose(res.final_cost, python.final_cost,
                                   rtol=max(1e-10, 10.0 * spread),
                                   err_msg=f"{name} {label} against python mode")


def scale_quality(name, solved):
    """bench.py's gates: the pose-graph rungs raise inside their solve
    (converged, 97% reduction); dubrovnik's and venice's RMSE gates;
    ladybug's five LM iterations with the cost falling."""
    res = solved.result
    if not solved.gate_passed:
        raise AssertionError(f"{name}: {solved.row.get('note')}")
    if name == "ladybug" and not (res.iterations == 5 and res.final_cost < res.initial_cost):
        raise AssertionError(f"ladybug: {res.summary()}")


def scale_explicit(built):
    """dubrovnik through ``schur`` (explicit below 4096 camera DOF), once in
    f64 python mode with dubrovnik's config: RMSE below 0.60, one kernel
    launch per LM iteration, the assembly kernels once per group and LM
    iteration; (line, launches, iterations)."""
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.benches import ladder
    from apex_tpu_torch.kernels import landmark_blocks as lb

    release_cuda()
    target_cost = (0.533 ** 2) * built.data.num_observations
    cfg = ladder._ba_config("python", 30, min_cost_threshold=target_cost)
    cfg.linear_solver_type = "schur"
    lm = apx.LevenbergMarquardt(cfg)
    before = lb.launches
    res, seconds, n = counted_solve(lm, built.cp)
    launches = lb.launches - before
    assembled = assembly_calls("scale", "dubrovnik schur", n, len(built.cp.groups),
                               res.iterations)
    ctx = lm._step_cache[built.cp].solve_fn.schur_context
    r1 = ladder.rmse(res.final_cost, built.data.num_observations)
    line = dict(mode="python", solver="schur", variant=ctx.variant, Dc=ctx.Dc,
                pairs=sum(int(ia.numel()) for ia, _ in ctx.pair_indices),
                status=res.status.name, iterations=res.iterations, final_cost=res.final_cost,
                rmse_final=r1, solve_seconds=seconds, kernel_launches=launches,
                assembly_kernel_calls=assembled, **peak_memory("dubrovnik schur"))
    if ctx.variant != "sparse" or not r1 < 0.60 or launches != res.iterations:
        raise AssertionError(f"dubrovnik schur: {line}")
    return line, launches, res.iterations


def scale_fixed_iterations(built, iterations=5):
    """venice f64 with ladybug's config (``iterations`` LM iterations, 15
    PCG iterations, no cost threshold), so that memory that grows from one
    LM iteration to the next shows: python mode (a first solve and one
    more), then jit mode (its first solve under ``graph_memory_trace``, one
    more); peak allocated and reserved memory per mode. Gates: the cost
    falls below the 0.46 px gate, one kernel launch per LM iteration in
    python mode, the assembly kernels once per group and LM iteration, jit
    mode python mode's iterations, status and cost (rtol
    1e-10 or 10x python mode's spread). (line, launches, LM iterations)"""
    import numpy as np
    import torch

    import apex_tpu_torch as apx
    from apex_tpu_torch.benches import ladder
    from apex_tpu_torch.kernels import landmark_blocks as lb

    n_obs = built.data.num_observations
    line, launches, lm_iterations = {}, 0, 0
    for mode in ("python", "jit"):
        release_cuda()
        lm = apx.LevenbergMarquardt(ladder._ba_config(mode, iterations, pcg_max_iterations=15))
        before, counts = graph_counters(), solve_counts()
        if mode == "python":
            res, first_s, seconds, first = ladder.timed(lm, built.cp, 1)
            spread = abs(res.final_cost - first.final_cost) / abs(res.final_cost)
            python = res
        else:
            first, trace = graph_memory_trace(lambda: lm.optimize(built.cp))
            t0 = time.perf_counter()
            res = lm.optimize(built.cp)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        n = {k: v - before[k] for k, v in graph_counters().items()}
        its = first.iterations + res.iterations
        run = n["eager_kernel_launches"] + n["replayed_kernel_launches"]
        launches, lm_iterations = launches + run, lm_iterations + its
        out = dict(status=res.status.name, iterations=res.iterations,
                   final_cost=res.final_cost, rmse_final=ladder.rmse(res.final_cost, n_obs),
                   solve_seconds=seconds, seconds_per_lm_iteration=seconds / res.iterations,
                   kernel_launches=run,
                   assembly_kernel_calls=assembly_calls(
                       "scale", f"venice {iterations} iterations, {mode}", n,
                       len(built.cp.groups), its, jit=mode == "jit"),
                   **peak_memory(f"venice {iterations} iterations, {mode}"))
        if not (res.final_cost < res.initial_cost and out["rmse_final"] < 0.46):
            raise AssertionError(f"venice {iterations} iterations, {mode}: {out}")
        if mode == "python":
            out.update(counts_line(counts, its), first_solve_seconds=first_s,
                       python_run_to_run_spread=spread)
            if run != its:
                raise AssertionError(f"venice python: {run} launches for {its} LM iterations")
        else:
            out.update(trace,
                       host_reads=n["host_reads"],
                       host_reads_per_lm_iteration=n["host_reads"] / its,
                       host_read_bound=check_host_reads("venice fixed iterations", n, 2, its,
                                                        None))
            if n["replayed_kernel_launches"] != its:
                raise AssertionError(f"venice jit: {n['replayed_kernel_launches']} landmark "
                                     f"launches on the device for {its} LM iterations")
            if (res.iterations, res.status) != (python.iterations, python.status):
                raise AssertionError(f"venice jit: {res.summary()} vs python {python.summary()}")
            np.testing.assert_allclose(res.final_cost, python.final_cost,
                                       rtol=max(1e-10, 10.0 * spread),
                                       err_msg="venice jit against python mode")
            if run < its:
                raise AssertionError(f"venice jit: {run} launches for {its} LM iterations")
        line[f"f64_{mode}"] = out
        del lm, res, first
    release_cuda()
    return line, launches, lm_iterations


def unseen_landmarks_kept(built, res):
    """The landmarks no camera observes (zero Hpp blocks, inverted by the
    kernel's regularization) end at their initial values, bit for bit."""
    import numpy as np

    seen = np.bincount(built.data.point_indices, minlength=built.data.num_points) > 0
    P = built.data.num_points
    # the bucketed layout numbers unseen landmarks last
    names = [f"pt_{j:05d}" for j in range(int(seen.sum()), P)]
    moved = [n for n in names if not np.array_equal(res.variables[n],
                                                    built.problem._values[n])]
    if moved or not all(np.isfinite(res.variables[n]).all() for n in names):
        raise AssertionError(f"{len(moved)} of {len(names)} unseen landmarks moved")
    return len(names)


def phase_scale(smi, cpu):
    """Phase 35: the JAX package's scale ladder on the card, through the
    ladder's build and solve functions (``apex_tpu_torch.benches.ladder``),
    at full size: torus3d, cubicle and pose50k (LM ``sparse_cholesky``),
    dubrovnik, ladybug and venice (``schur_implicit``), each f64 in python
    then jit mode (the first solve timed apart, then one timed solve), f32
    in jit mode and once more in python mode for its counts; dubrovnik also
    through ``schur`` (explicit) once. One line per rung as it ends. Gates:
    ``scale_gates`` (f64), ``scale_quality`` (every dtype and mode), one
    kernel launch per BA LM iteration in python mode; venice's unseen
    landmarks kept; one more venice f64 jit solve with CUDA events around
    its graph launches, the kernel in it once per LM iteration;
    ``scale_fixed_iterations`` at venice;
    ``graph_memory_trace`` of pose50k's first f64 jit solve. Returns (kernel
    launches, BA LM iterations)."""
    import dataclasses

    import torch

    from apex_tpu_torch.benches import ladder

    launches = iterations = 0
    for name in SCALE_RUNGS:
        t0 = time.perf_counter()
        rung, ba = ladder.RUNGS[name], name in SCALE_BA
        built = rung.build(torch.float64, "cuda")
        line = dict(phase="scale", rung=name, nvidia_smi=smi, host_cpu=cpu,
                    D=built.cp.total_dof, build_seconds=built.build_seconds,
                    compile_seconds_f64=built.compile_seconds)
        if ba:
            line.update(cameras=built.data.num_cameras, points=built.data.num_points,
                        observations=built.data.num_observations,
                        rows=built.cp.total_residual_dim // 2)
        else:
            line.update(poses=built.data.num_vertices, edges=built.data.num_edges)
        t1 = time.perf_counter()
        built.cp.values_dict(built.cp.initial_values())
        line["values_dict_seconds"] = time.perf_counter() - t1

        python, line["f64_python"], n, its = scale_run(rung, built, "python", 1, ba)
        launches, iterations = launches + n, iterations + its
        scale_gates(name, "f64 python", python.result)
        scale_gates(name, "f64 python (first)", python.first_result)
        scale_quality(name, python)
        spread = line["f64_python"]["python_run_to_run_spread"]
        if name == "venice":
            line["unseen_landmarks"] = unseen_landmarks_kept(built, python.result)
        reference = python.result
        del python
        jit, line["f64_jit"], n, its = scale_run(rung, built, "jit", 1, ba,
                                                 span=name == "venice")
        launches, iterations = launches + n, iterations + its
        scale_gates(name, "f64 jit", jit.result, reference, spread)
        scale_quality(name, jit)
        del jit
        if name == "dubrovnik":
            line["f64_schur"], n, its = scale_explicit(built)
            launches, iterations = launches + n, iterations + its
        if name == "venice":
            line["f64_5_iterations"], n, its = scale_fixed_iterations(built)
            launches, iterations = launches + n, iterations + its
        if name == "pose50k":
            release_cuda()
            # [1]: the solver and its graphs are dropped right away
            line["f64_jit_memory_trace"] = graph_memory_trace(
                lambda: rung.solve(built, runs=0, mode="jit"))[1]

        release_cuda()
        t1 = time.perf_counter()
        cp32 = built.problem.compile(dtype=torch.float32, device=built.cp.device)
        built = dataclasses.replace(built, cp=cp32, compile_seconds=time.perf_counter() - t1)
        line["compile_seconds_f32"] = built.compile_seconds
        f32, line["f32_jit"], n, its = scale_run(rung, built, "jit", 1, ba)
        launches, iterations = launches + n, iterations + its
        scale_quality(name, f32)
        del f32
        # counts only: the first solve of python mode
        f32, line["f32_python"], n, its = scale_run(rung, built, "python", 0, ba)
        launches, iterations = launches + n, iterations + its
        del f32, built
        line["seconds"] = time.perf_counter() - t0
        emit(line)
    return launches, iterations


def main():
    import tempfile

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

    from concurrent.futures import ThreadPoolExecutor

    from apex_tpu_torch.kernels import graph_conditional as gc
    from apex_tpu_torch.kernels import schur_apply as ap
    from apex_tpu_torch.kernels import schur_assemble as sa
    from apex_tpu_torch.kernels import spd_inverse as spd
    from apex_tpu_torch.optim import graphs

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        for job in [pool.submit(m.build) for m in (lb, spd, gc, sa, ap)]:
            job.result()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              sources=[os.path.relpath(str(m.SOURCE), REPO) for m in (lb, spd, gc, sa, ap)],
              cuda_runtime_and_driver=gc.versions(),
              config={str(d).replace("torch.", ""): lb.launch_config(d)
                      for d in (torch.float32, torch.float64)},
              spd_config={n: spd.launch_config(torch.float64, n) for n in (3, 9, 15, 44)}))

    measured = {}
    for P in (65_132, 993_923):
        for dtype in (torch.float32, torch.float64):
            measured[(P, dtype)] = phase_kernel(P, dtype)
    # the landmark counts of the dubrovnik and ladybug rungs (phase 35): the
    # bitwise gate alone
    for P in (226_730, 156_502):
        for dtype in (torch.float32, torch.float64):
            emit(dict(phase="kernel", P=P, dtype=str(dtype).replace("torch.", ""),
                      max_abs_err=kernel_bitwise(P, dtype)[1], bitwise=True))

    phase_capture_census()
    release_cuda()

    # the SPD inverse kernel's count, from 0: the main path's launches, eager
    # and replayed by graphs (graphs.replayed: no reset_counters clears it),
    # and the shapes it was called at
    spd.launches = 0
    graphs.replayed["spd_clamped_inv"] = 0
    # the assembly kernels' count, from 0 as well: the main path's calls,
    # each path's own checked by ``assembly_calls``
    sa.launches = 0
    graphs.replayed["schur_assemble"] = 0
    # and the coupling kernels'
    ap.launches = 0
    graphs.replayed["schur_apply"] = 0
    ASSEMBLY_CALLS.clear()
    spd_shapes = SpdShapes()
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
    phase_pcg_chunk(ba_problem)

    seconds = {"earlier_phases": time.perf_counter() - start}
    t0 = time.perf_counter()
    phase_camera_parity()
    seconds["camera_parity"] = time.perf_counter() - t0
    # the camera path's kernel count, from 0, python and jit mode together
    lb.launches = 0
    graphs.reset_counters()
    replayed0 = graphs.replayed["landmark_blocks"]
    t0 = time.perf_counter()
    launches_camera, iterations_camera = phase_camera_full()
    seconds["camera_full"] = time.perf_counter() - t0
    if lb.launches + graphs.replayed["landmark_blocks"] - replayed0 != launches_camera:
        raise AssertionError(f"camera_full: {lb.launches} + "
                             f"{graphs.replayed['landmark_blocks'] - replayed0} kernel "
                             f"launches counted, {launches_camera} summed over its solves")
    t0 = time.perf_counter()
    phase_lie_full()
    phase_lie_small()
    seconds["lie"] = time.perf_counter() - t0
    # the support path's kernel count, from 0: the observed, checkpointed and
    # resumed BA solves in this process, then the BA CLI's in its own
    lb.launches = 0
    graphs.reset_counters()
    replayed0 = graphs.replayed["landmark_blocks"]
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        launches_support, iterations_support = phase_support_ba(ds, ba_problem, workdir)
        seconds["support_ba"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_support_pose_graph(sphere_problem)
        seconds["support_pose_graph"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches_cli, iterations_cli = phase_support_cli(ds, sphere_graph, workdir)
        seconds["support_cli"] = time.perf_counter() - t0
    if lb.launches + graphs.replayed["landmark_blocks"] - replayed0 != launches_support:
        raise AssertionError(f"support: {lb.launches} + "
                             f"{graphs.replayed['landmark_blocks'] - replayed0} kernel "
                             f"launches counted, {launches_support} summed over its solves")
    launches_support += launches_cli
    iterations_support += iterations_cli
    # the examples' kernel count: from 0 in the card's process of phase 32
    launches_before = lb.launches
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        launches_examples, iterations_examples = phase_examples(workdir)
        seconds["examples"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_bags(workdir)
        seconds["bags"] = time.perf_counter() - t0
        # the multi-device path's kernel count: from 0 in each rank's process,
        # per run (phase 34)
        t0 = time.perf_counter()
        launches_md, iterations_md = phase_multidevice(workdir)
        seconds["multidevice"] = time.perf_counter() - t0
    if lb.launches != launches_before:
        raise AssertionError("examples / bags / multidevice: kernel launches in the smoke's "
                             "own process")
    # the scale path's kernel count, from 0: python, jit and profiled solves
    lb.launches = 0
    graphs.reset_counters()
    replayed0 = graphs.replayed["landmark_blocks"]
    t0 = time.perf_counter()
    launches_scale, iterations_scale = phase_scale(smi, host_cpu())
    seconds["scale"] = time.perf_counter() - t0
    if lb.launches + graphs.replayed["landmark_blocks"] - replayed0 != launches_scale:
        raise AssertionError(f"scale: {lb.launches} + "
                             f"{graphs.replayed['landmark_blocks'] - replayed0} kernel "
                             f"launches counted, {launches_scale} summed over its solves")
    emit(dict(phase="seconds", **seconds))
    # the SPD kernel's launches on the main path, before its own check
    spd_launches = spd.launches + graphs.replayed["spd_clamped_inv"]
    spd_shapes.remove()
    if not spd_launches:
        raise AssertionError("spd_clamped_inv: no launch on the main path")
    spd_measured = phase_spd_inverse(spd_shapes)
    # the assembly kernels' calls on the main path in this process, eager
    # and replayed by graphs, before their own phase; the paths checked
    # one by one hold part of them
    sa_launches = sa.launches + graphs.replayed["schur_assemble"]
    if not sa_launches or sum(ASSEMBLY_CALLS.values()) > sa_launches:
        raise AssertionError(f"schur_assemble: {sa_launches} calls on the main path, by path "
                             f"{ASSEMBLY_CALLS}")
    t0 = time.perf_counter()
    sa_measured = phase_schur_assemble()["float64"]
    seconds_assemble = time.perf_counter() - t0
    # the coupling kernels' calls on the main path, eager and replayed
    ap_launches = ap.launches + graphs.replayed["schur_apply"]
    if not ap_launches:
        raise AssertionError("schur_apply: no call on the main path")
    t0 = time.perf_counter()
    ap_measured = phase_schur_apply()["float64"]
    seconds_apply = time.perf_counter() - t0

    main_shape = measured[(65_132, torch.float64)]
    # the SPD kernel's headline: its f64 shape called most on the main path
    spd_key = max((k for k in spd_shapes if k[2] == "float64"), key=spd_shapes.get)
    spd_main = spd_measured[spd_key]
    emit({"kernels": [{
        "name": "invert_landmark_blocks",
        "route": "cuda",
        "source": "apex_tpu_torch/csrc/landmark_blocks.cu",
        "replaces": "apex_tpu/kernels/landmark_blocks.py:101",
        "launches": launches + launches_camera + launches_support + launches_examples
        + launches_md + launches_scale,
        "launches_per_lm_iteration": (
            launches + launches_camera + launches_support + launches_examples + launches_md
            + launches_scale) / (
            iterations + iterations_camera + iterations_support + iterations_examples
            + iterations_md + iterations_scale),
        "launches_camera": launches_camera,
        "launches_per_lm_iteration_camera": launches_camera / iterations_camera,
        "launches_support": launches_support,
        "launches_per_lm_iteration_support": launches_support / iterations_support,
        "launches_examples": launches_examples,
        "launches_per_lm_iteration_examples": launches_examples / iterations_examples,
        "launches_jit": launches_jit,
        "launches_per_lm_iteration_jit": launches_jit / iterations_jit,
        "launches_multidevice": launches_md,
        "launches_per_lm_iteration_multidevice": launches_md / iterations_md,
        "launches_scale": launches_scale,
        "launches_per_lm_iteration_scale": launches_scale / iterations_scale,
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
    }, {
        "name": "spd_clamped_inv",
        "route": "cuda",
        "source": "apex_tpu_torch/csrc/spd_clamped_inv.cu",
        # the reference leaves it to XLA: no Pallas kernel; the function
        "replaces": "apex_tpu/linalg/utils.py:34",
        "launches": spd_launches,
        "max_abs_err": spd_main["max_abs_err"],
        "ms": spd_main["device_us"] / 1e3,
        "plain_ms": spd_main["plain_ms"],
        "bound_ms": spd_main["bound_us"] / 1e3,
        "bound_by": spd_main["bound_by"],
        # no single PyTorch call computes the clamped inverse; eigh_ms is
        # the torch.linalg.eigh call inside the plain version
        "library_ms": None,
        "eigh_ms": spd_main["eigh_ms"],
        "device_us": spd_main["device_us"],
        "share": spd_main["share"],
        "shape": [spd_key[0], spd_key[1], spd_key[1]],
        "dtype": "float64",
        "main_path_shapes": [list(k) + [c] for k, c in sorted(spd_shapes.items())],
        "shapes": [{key: m[key] for key in ("B", "n", "dtype", "spd_rel_err", "kept_rel_err",
                                            "clamped_rel_err", "device_us", "bound_us",
                                            "share", "call_ms", "plain_ms", "eigh_ms")}
                   for m in spd_measured.values()],
    }, {
        "name": "schur_assemble",
        "route": "cuda",
        "source": "apex_tpu_torch/csrc/schur_assemble.cu",
        # the reference leaves the linearization and the Schur sums to XLA
        "replaces": "apex_tpu/linalg/schur.py (assembly), apex_tpu/core/problem.py "
                    "(group linearization)",
        "launches": sa_launches,
        "launches_by_path": dict(ASSEMBLY_CALLS),
        "max_rel_err": sa_measured["max_rel_err"],
        "ms": sa_measured["device_us"] / 1e3,
        # the generic path (group_linearize and index_add_) is its plain
        # version: what the kernels replace
        "plain_ms": sa_measured["generic_ms"],
        "bound_ms": sa_measured["bound_us"] / 1e3,
        "bound_by": sa_measured["bound_by"],
        # no single PyTorch call computes it
        "library_ms": None,
        "device_us": sa_measured["device_us"],
        "share": sa_measured["share"],
        "design_bytes": sa_measured["design_bytes"],
        "design_bound_ms": sa_measured["design_bound_us"] / 1e3,
        "rows": sa_measured["rows"],
        "dtype": "float64",
        "phase_seconds": seconds_assemble,
    }, {
        "name": "schur_apply",
        "route": "cuda",
        "source": "apex_tpu_torch/csrc/schur_apply.cu",
        # the reference leaves the sums over W to XLA
        "replaces": "apex_tpu/linalg/schur.py (W^T x, W u, Schur-Jacobi blocks)",
        "launches": ap_launches,
        "max_rel_err": ap_measured["max_rel_err"],
        "ms": ap_measured["ops"]["apply_S"]["device_us"] / 1e3,
        "plain_ms": ap_measured["ops"]["apply_S"]["plain_ms"],
        "bound_ms": ap_measured["ops"]["apply_S"]["bound_us"] / 1e3,
        "bound_by": "bytes",
        # no single PyTorch call computes it
        "library_ms": None,
        "share": ap_measured["ops"]["apply_S"]["share"],
        "ops": {op: {k: o[k] for k in ("device_us", "bound_us", "share", "plain_ms")}
                for op, o in ap_measured["ops"].items()},
        "rows": ap_measured["rows"],
        "dtype": "float64",
        "phase_seconds": seconds_apply,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
