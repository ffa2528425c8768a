#!/usr/bin/env python3
"""Drive the PyTorch port's bundle-adjustment path once on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order,
each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: compile the landmark-block kernel from ``apex_tpu_torch/csrc``;
3. kernel: the CUDA landmark-block inverse against its plain PyTorch version
   on the card, at P = 65,132 (trafalgar's landmarks) and 993,923 (venice's),
   f32 and f64, with the median time of 25 CUDA-event-timed runs of each;
4. small-slice parity: ``synthetic_ba(8, 150, seed=0)`` solved exactly in
   f64 on the card and on the CPU: same iterations and status, final cost
   within rtol 1e-8 (CUDA index_add_ sums in atomic order, ~1e-15 apart);
5. full slice: the trafalgar-scale synthetic through ``build_ba_problem`` ->
   ``LevenbergMarquardt(for_bundle_adjustment())``, 10 iterations, in f64
   and in f32: finite cost, RMSE below 0.55x the initial, and at least one
   kernel launch per LM iteration.

Then the kernel summary line, and last ``{"ok": true, "device": {...}}``.
It needs one card, and refuses to run without one.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_RUNS = 25


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
    import torch

    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(KERNEL_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel(P, dtype):
    import numpy as np
    import torch

    from apex_tpu_torch.kernels import landmark_blocks as lb

    H = torch.as_tensor(kernel_blocks(P), dtype=dtype).cuda()
    k = lb.invert_landmark_blocks(H)
    p = lb.invert_landmark_blocks_plain(H)
    torch.cuda.synchronize()
    kn, pn = k.double().cpu().numpy(), p.double().cpu().numpy()
    if not np.all(np.isfinite(kn)):
        raise AssertionError(f"kernel output not finite (P={P}, {dtype})")
    rel = float(np.max(np.abs(kn - pn) / (np.abs(pn) + 1.0)))
    if dtype == torch.float64:
        if not rel < 1e-10:
            raise AssertionError(f"f64 kernel vs plain: max rel {rel} >= 1e-10 (P={P})")
    else:
        np.testing.assert_allclose(kn, pn, rtol=1e-3, atol=1e-4)
    out = dict(phase="kernel", P=P, dtype=str(dtype).replace("torch.", ""),
               max_abs_err=float(np.max(np.abs(kn - pn))), max_rel_err=rel,
               ms=median_ms(lb.invert_landmark_blocks, H),
               plain_ms=median_ms(lb.invert_landmark_blocks_plain, H), runs=KERNEL_RUNS)
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
    total = 0
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
    return total


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card")
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
              source=os.path.relpath(str(lb.SOURCE), REPO)))

    measured = {}
    for P in (65_132, 993_923):
        for dtype in (torch.float32, torch.float64):
            measured[(P, dtype)] = phase_kernel(P, dtype)

    phase_small_parity()
    launches = phase_full_slice()

    main_shape = measured[(65_132, torch.float64)]
    emit({"kernels": [{
        "name": "invert_landmark_blocks",
        "route": "cuda",
        "source": "apex_tpu_torch/csrc/landmark_blocks.cu",
        "replaces": "apex_tpu/kernels/landmark_blocks.py:101",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "shape": [65_132, 3, 3],
        "dtype": "float64",
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
