"""Pose-graph optimization benchmark harness (counterpart of the
repository's ``benches/odometry_pose_benchmark.py``, which mirrors the Rust
reference's benches/odometry_pose_benchmark.rs): runs the solver over a
suite of pose-graph datasets and writes a CSV. A dataset is the registry's
file when it is in the cache (``io.datasets``), else a synthetic graph at
the same scale; nothing is downloaded.

    python -m apex_tpu_torch.benches.odometry_pose_benchmark [--out results.csv]
        [--datasets ring intel ...] [--optimizer lm|gn|dl] [--dtype f32|f64]
        [--runs N] [--platform cpu|cuda]

``--platform`` is the torch device (default ``cuda``, which raises without a
card; nothing falls back to the CPU).
"""

from __future__ import annotations

import argparse
import csv

import apex_tpu_torch as apx
from apex_tpu_torch.benches import DTYPES
from apex_tpu_torch.benches.ladder import timed
from apex_tpu_torch.device import resolve_device
from apex_tpu_torch.io import datasets, load_g2o, synthetic

# Scale-matched synthetic stand-ins for the reference datasets
# (name -> (manifold, generator kwargs)).
SUITE = {
    "ring": ("SE2", dict(n_poses=434, trajectory="ring")),
    "intel": ("SE2", dict(n_poses=1228, trajectory="manhattan", loop_stride=15)),
    "M3500": ("SE2", dict(n_poses=3500, trajectory="manhattan", loop_stride=12)),
    "mit": ("SE2", dict(n_poses=808, trajectory="manhattan", loop_stride=40)),
    "sphere2500": ("SE3", dict(n_poses=2500, rings=50)),
    "parking-garage": ("SE3", dict(n_poses=1661, rings=30,
                                   closure_strides=(1, 2, 3))),  # 6,313 edges ~ real 6,275
    "torus3D": ("SE3", dict(n_poses=5000, rings=100)),  # the ladder's rung (9,949 edges)
    "cubicle": ("SE3", dict(n_poses=5750, rings=230, closure_strides=(1, 2))),
}

# Reference wall times in ms (BASELINE.md, the Rust reference on an M4 Mac Mini).
BASELINE_MS = {
    "ring": 8.5, "intel": 28.5, "M3500": 103.5, "mit": 140.7,
    "sphere2500": 176.3, "parking-garage": 153.1, "torus3D": 1780.5,
    "cubicle": 512.0,
}


def load_dataset(name):
    """(graph, "real") from the cached registry file, else (the synthetic
    stand-in, "synthetic")."""
    path = datasets.cache_dir() / f"{name}.g2o"
    if name in datasets.POSE_GRAPH_DATASETS and path.exists():
        return load_g2o(str(path)), "real"
    manifold, kw = SUITE[name]
    gen = (synthetic.synthetic_pose_graph_2d if manifold == "SE2"
           else synthetic.synthetic_pose_graph_3d)
    return gen(seed=0, **kw), "synthetic"


SOLVERS = {
    "lm": (apx.LevenbergMarquardt, apx.LevenbergMarquardtConfig),
    "gn": (apx.GaussNewton, apx.GaussNewtonConfig),
    "dl": (apx.DogLeg, apx.DogLegConfig),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--out", default="odometry_benchmark_results.csv")
    ap.add_argument("--datasets", nargs="+", default=list(SUITE))
    ap.add_argument("--optimizer", default="lm", choices=["lm", "gn", "dl"])
    ap.add_argument("--dtype", default="f64", choices=["f32", "f64"])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                    help="torch device (default cuda; no fallback to cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.platform)

    dtype = DTYPES[args.dtype]
    rows = []
    for name in args.datasets:
        g, source = load_dataset(name)
        cp = g.to_problem().compile(dtype=dtype, device=device)
        cls, ccls = SOLVERS[args.optimizer]
        kw = dict(max_iterations=100, cost_tolerance=1e-4, mode="jit",
                  linear_solver_type="sparse_cholesky")
        if args.optimizer == "lm":
            kw["damping"] = "auto"  # Madsen-Nielsen, as the ladder's rungs
        # the best of --runs solves after the warm-up (graph capture)
        result, _, best, _ = timed(cls(ccls(**kw)), cp, args.runs)
        ms = best * 1e3
        speedup = BASELINE_MS.get(name, float("nan")) / ms
        rows.append(dict(
            dataset=name, source=source, vertices=g.num_vertices,
            edges=g.num_edges, optimizer=args.optimizer, dtype=args.dtype,
            platform=args.platform,
            # BASELINE_MS was measured by the reference under its defaults;
            # each row says what config produced its own number
            linear_solver=kw["linear_solver_type"],
            damping=kw.get("damping", "fixed"),
            status=result.status.name, iterations=result.iterations,
            initial_cost=result.initial_cost, final_cost=result.final_cost,
            time_ms=round(ms, 2), baseline_ms=BASELINE_MS.get(name),
            vs_baseline=round(speedup, 3),
        ))
        print(f"{name:>16} [{source}]: {result.status.name} {result.iterations} iters "
              f"cost {result.initial_cost:.3e} -> {result.final_cost:.3e} "
              f"{ms:.1f} ms ({speedup:.2f}x baseline)")

    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"\nresults written to {args.out}")
    return rows


if __name__ == "__main__":
    main()
