"""Bundle adjustment CLI of the port (counterpart of
``apex_tpu/cli/bundle_adjustment.py``, same flags and report).

``--platform`` picks the torch device: ``cuda`` (default) or ``cpu``.
Asking for ``cuda`` on a machine without a card raises. ``--dataset NAME``
loads a BAL registry entry (``io.datasets``) from the cache,
``$APEX_TPU_DATA_DIR`` or ``~/.cache/apex_tpu``, downloading and
decompressing it where it is absent. Progress goes to stderr through
``utils.init_logger`` (level from ``APEX_LOG``).

Usage:
    python -m apex_tpu_torch.cli.bundle_adjustment --file problem.txt
    python -m apex_tpu_torch.cli.bundle_adjustment --dataset trafalgar-257 --solver explicit
    python -m apex_tpu_torch.cli.bundle_adjustment --synthetic --cameras 20 --points 500 --platform cpu
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="bundle_adjustment", description="apex-tpu bundle adjustment (PyTorch port)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--file", help="BAL problem file")
    src.add_argument("--dataset", help="named BAL dataset (downloads; see io.datasets)")
    src.add_argument("--synthetic", action="store_true", help="synthetic BA (offline)")
    p.add_argument("--cameras", type=int, default=20, help="synthetic camera count")
    p.add_argument("--points", type=int, default=500, help="synthetic point count")
    p.add_argument("-n", "--max-points", type=int, default=None, help="limit points")
    p.add_argument("--solver", default="implicit", choices=["explicit", "implicit", "dense"])
    p.add_argument(
        "--type", dest="mode", default="self_calibration",
        choices=["bundle_adjustment", "self_calibration", "only_pose",
                 "only_landmarks", "only_intrinsics"])
    p.add_argument("--loss", default="huber", help="robust loss (or 'none')")
    p.add_argument("--loss-scale", type=float, default=1.0)
    p.add_argument("--max-iterations", type=int, default=20)
    p.add_argument("--pcg-tolerance", type=float, default=1e-6)
    p.add_argument("--pcg-max-iterations", type=int, default=200)
    p.add_argument("--jit", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="torch device (default cuda; no fallback to cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import apex_tpu_torch as apx
    from apex_tpu_torch.ba import build_ba_problem, rmse
    from apex_tpu_torch.core.losses import loss_by_name
    from apex_tpu_torch.device import resolve_device
    from apex_tpu_torch.factors.projection import OPTIMIZE_MODES
    from apex_tpu_torch.io import load_bal, synthetic
    from apex_tpu_torch.io.datasets import ensure_ba_dataset
    from apex_tpu_torch.utils import init_logger

    log = init_logger()
    device = resolve_device(args.platform)
    if args.synthetic:
        ds = synthetic.synthetic_ba(n_cameras=args.cameras, n_points=args.points)
    elif args.dataset:
        ds = load_bal(ensure_ba_dataset(args.dataset))
    else:
        ds = load_bal(args.file)
    log.info("BA problem: %d cameras, %d points, %d observations",
             ds.num_cameras, ds.num_points, ds.num_observations)

    loss = None if args.loss == "none" else loss_by_name(args.loss, args.loss_scale)
    problem = build_ba_problem(ds, mode=args.mode, loss=loss, max_points=args.max_points)

    solver_type = {"implicit": "schur_implicit", "explicit": "schur_explicit",
                   "dense": "dense_cholesky"}[args.solver]
    if "landmark" not in OPTIMIZE_MODES[args.mode] and solver_type != "dense_cholesky":
        log.info("mode %s has no landmark block to eliminate; using dense solver", args.mode)
        solver_type = "dense_cholesky"
    cfg = apx.LevenbergMarquardtConfig(
        linear_solver_type=solver_type,
        schur_preconditioner="schur_jacobi",
        max_iterations=args.max_iterations,
        pcg_tolerance=args.pcg_tolerance,
        pcg_max_iterations=args.pcg_max_iterations,
        mode="jit" if args.jit else "python",
        verbose=args.verbose,
    )
    cp = problem.compile(device=device)
    t0 = time.perf_counter()
    result = apx.LevenbergMarquardt(cfg).optimize(cp)
    elapsed = time.perf_counter() - t0

    if args.max_points is None:
        n_obs = ds.num_observations
    else:
        n_obs = int((ds.point_indices < args.max_points).sum())

    print()
    print("Optimization completed!")
    print(f"Status: {result.status.name}")
    print(f"Iterations: {result.iterations}")
    print(f"Time: {elapsed:.2f} seconds")
    print()
    print("Metrics:")
    print(f"  Initial cost: {result.initial_cost:.6e}")
    print(f"  Final cost: {result.final_cost:.6e}")
    print(f"  Initial RMSE: {rmse(result.initial_cost, n_obs):.3f} pixels")
    print(f"  Final RMSE: {rmse(result.final_cost, n_obs):.3f} pixels")
    imp = (result.initial_cost - result.final_cost) / max(result.initial_cost, 1e-300) * 100
    print(f"  Improvement: {imp:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
