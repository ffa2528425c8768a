"""Bundle adjustment benchmark harness (counterpart of the repository's
``benches/bundle_adjustment_benchmark.py``, which mirrors the Rust
reference's benches/bundle_adjustment_benchmark.rs): BAL problems, Schur
self-calibration, a CSV, a per-problem timeout. A problem is the registry's
file when it is in the cache (``io.datasets``), else a synthetic problem
with the camera and point counts capped at 256 and 20,000; nothing is
downloaded.

    python -m apex_tpu_torch.benches.bundle_adjustment_benchmark [--out results.csv]
        [--problems ladybug-49 ...] [--solver implicit|explicit] [--dtype f32|f64]
        [--timeout S] [--platform cpu|cuda]

``--platform`` is the torch device (default ``cuda``, which raises without a
card; nothing falls back to the CPU).
"""

from __future__ import annotations

import argparse
import csv

import apex_tpu_torch as apx
from apex_tpu_torch.ba import build_ba_problem, rmse
from apex_tpu_torch.benches import DTYPES
from apex_tpu_torch.benches.ladder import timed
from apex_tpu_torch.device import resolve_device
from apex_tpu_torch.io import datasets, load_bal, synthetic

SUITE = {
    # name -> (n_cameras, n_points) for the synthetic fallback
    "ladybug-49": (49, 7776),
    "trafalgar-21": (21, 11315),
    "ladybug-1723": (1723, 156502),
    "trafalgar-257": (257, 65132),
    "dubrovnik-356": (356, 226730),
    "venice-1778": (1778, 993923),
}

# Reference wall times in s (BASELINE.md, the Rust reference on an M4 Mac Mini).
BASELINE_S = {
    "trafalgar-257": 10.39, "dubrovnik-356": 47.16,
    "ladybug-1723": 146.69, "venice-1778": 83.17,
}


def load_problem(name):
    """(dataset, "real") from the cached registry file (decompressed on
    first use), else (the capped synthetic stand-in, "synthetic")."""
    if name in datasets.BAL_PROBLEMS:
        fname = datasets.BAL_PROBLEMS[name][1]
        cached = datasets.cache_dir()
        if (cached / fname).exists() or (cached / fname.removesuffix(".bz2")).exists():
            return load_bal(datasets.ensure_ba_dataset(name)), "real"
    c, p = SUITE[name]
    # cap synthetic point counts for tractable generation
    return synthetic.synthetic_ba(n_cameras=min(c, 256), n_points=min(p, 20000)), "synthetic"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--out", default="ba_benchmark_results.csv")
    ap.add_argument("--problems", nargs="+", default=["ladybug-49", "trafalgar-21"])
    ap.add_argument("--solver", default="implicit", choices=["implicit", "explicit"])
    ap.add_argument("--dtype", default="f64", choices=["f32", "f64"])
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                    help="torch device (default cuda; no fallback to cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.platform)

    dtype = DTYPES[args.dtype]
    rows = []
    for name in args.problems:
        ds, source = load_problem(name)
        problem = build_ba_problem(ds, mode="self_calibration")
        cp = problem.compile(dtype=dtype, device=device)
        cfg = apx.LevenbergMarquardtConfig(
            linear_solver_type=f"schur_{args.solver}",
            schur_preconditioner="schur_jacobi",
            max_iterations=30,
            timeout=args.timeout,
            mode="jit",
        )
        # one solve after the warm-up (graph capture)
        result, _, dt, _ = timed(apx.LevenbergMarquardt(cfg), cp, 1)
        r0 = rmse(result.initial_cost, ds.num_observations)
        r1 = rmse(result.final_cost, ds.num_observations)
        base = BASELINE_S.get(name)
        rows.append(dict(
            problem=name, source=source, cameras=ds.num_cameras,
            points=ds.num_points, observations=ds.num_observations,
            solver=args.solver, dtype=args.dtype, status=result.status.name,
            iterations=result.iterations, initial_rmse_px=round(r0, 4),
            final_rmse_px=round(r1, 4), time_s=round(dt, 3),
            baseline_s=base, vs_baseline=round(base / dt, 3) if base else None,
        ))
        print(f"{name:>16} [{source}]: {result.status.name} {result.iterations} iters "
              f"RMSE {r0:.3f} -> {r1:.3f} px in {dt:.2f}s")

    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"\nresults written to {args.out}")
    return rows


if __name__ == "__main__":
    main()
