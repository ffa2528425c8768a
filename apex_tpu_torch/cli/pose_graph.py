"""Pose-graph CLI of the port (counterpart of ``apex_tpu/cli/pose_graph.py``,
same flags and report table).

It takes G2O files (SE2 or SE3) and TORO files (by the suffix ``.toro`` or
``.graph``), the synthetic ``ring``, ``manhattan`` (SE2) and ``sphere``
(SE3) graphs, every loss of ``LOSS_BY_NAME``, the optimizers ``lm``, ``gn``
and ``dl`` (``all`` runs the three and prints one row each), and the linear
solvers ``sparse_cholesky``, ``sparse_qr``, ``sparse_general``,
``dense_cholesky``, ``dense_qr`` and ``pcg`` (DogLeg, which has neither
``sparse_general`` nor ``pcg``, takes ``sparse_cholesky`` instead).
``--platform`` picks the torch device: ``cuda`` (default) or ``cpu``. Asking
for ``cuda`` on a machine without a card raises. ``--profile`` writes a
``torch.profiler`` trace of the last solve under the system's temporary
directory. ``--jit`` runs every optimizer with every linear solver in
``mode="jit"`` (the whole solve on the device, replayed CUDA graphs on a
card). Not ported yet, and raising ``NotImplementedError`` with its ROADMAP
item: ``--dataset`` (A.10).

Usage:
    python -m apex_tpu_torch.cli.pose_graph --file graph.g2o
    python -m apex_tpu_torch.cli.pose_graph --synthetic sphere --poses 2500
    python -m apex_tpu_torch.cli.pose_graph --synthetic sphere --poses 2500 --jit
    python -m apex_tpu_torch.cli.pose_graph --synthetic manhattan --poses 3500
    python -m apex_tpu_torch.cli.pose_graph --file graph.toro --loss cauchy --platform cpu
    python -m apex_tpu_torch.cli.pose_graph --file graph.g2o --optimizer all --platform cpu
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TRACE_PATH = Path(tempfile.gettempdir()) / "apex_tpu_torch_profile" / "pose_graph_trace.json"


def build_parser():
    p = argparse.ArgumentParser(
        prog="pose_graph", description="apex-tpu pose graph optimization (PyTorch port)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--file", help="g2o or TORO file path")
    src.add_argument("--dataset", help="named dataset (downloads; not ported)")
    src.add_argument("--synthetic", choices=["ring", "manhattan", "sphere"],
                     help="generate a synthetic dataset (offline)")
    p.add_argument("--poses", type=int, default=500, help="synthetic pose count")
    p.add_argument("--optimizer", default="lm", choices=["lm", "gn", "dl", "all"])
    p.add_argument("--loss", default="none", help="robust loss by name (or 'none')")
    p.add_argument("--loss-scale", type=float, default=None, help="loss scale parameter")
    p.add_argument(
        "--linear-solver", default="sparse_cholesky",
        choices=["sparse_cholesky", "sparse_qr", "sparse_general",
                 "dense_cholesky", "dense_qr", "pcg"],
        help="linear solver tier (sparse_cholesky / sparse_qr ride the band; "
             "sparse_general takes any sparsity; dense tiers for small problems)")
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--cost-tolerance", type=float, default=1e-4)
    p.add_argument("--fix-first", action="store_true", help="fix the first vertex")
    p.add_argument("--save-output", help="write the optimized graph to this g2o path")
    p.add_argument("--profile", action="store_true",
                   help=f"write a torch.profiler trace to {TRACE_PATH}")
    p.add_argument("--jit", action="store_true",
                   help="whole solve on the device (every optimizer; replayed CUDA graphs on a card)")
    p.add_argument("--verbose", action="store_true", help="per-iteration table")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="torch device (default cuda; no fallback to cpu)")
    return p


def load_graph(args):
    from apex_tpu_torch.io import load_g2o, load_toro, synthetic

    if args.dataset:
        raise NotImplementedError(
            "the dataset registry (downloads) is not ported yet (ROADMAP A.10); use --file")
    if args.synthetic:
        if args.synthetic == "sphere":
            return synthetic.synthetic_pose_graph_3d(n_poses=args.poses), args.synthetic
        return (synthetic.synthetic_pose_graph_2d(n_poses=args.poses, trajectory=args.synthetic),
                args.synthetic)
    loader = load_toro if str(args.file).endswith((".toro", ".graph")) else load_g2o
    return loader(args.file), args.file


def make_loss(args):
    from apex_tpu_torch.core.losses import LOSS_BY_NAME, loss_by_name

    if args.loss == "none":
        return None
    if args.loss not in LOSS_BY_NAME:
        sys.exit(f"unknown loss {args.loss!r}; known: none, {', '.join(sorted(LOSS_BY_NAME))}")
    return loss_by_name(args.loss, args.loss_scale)


def make_solver(kind, args):
    import apex_tpu_torch as apx

    common = dict(max_iterations=args.max_iterations, cost_tolerance=args.cost_tolerance,
                  mode="jit" if args.jit else "python", verbose=args.verbose)
    if kind == "lm":
        return apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
            linear_solver_type=args.linear_solver, **common))
    if kind == "gn":
        return apx.GaussNewton(apx.GaussNewtonConfig(
            linear_solver_type=args.linear_solver, **common))
    dl_solver = args.linear_solver
    if dl_solver in ("sparse_general", "pcg"):  # not in DogLeg's menu
        dl_solver = "sparse_cholesky"
    return apx.DogLeg(apx.DogLegConfig(linear_solver_type=dl_solver, **common))


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from apex_tpu_torch.device import resolve_device
    from apex_tpu_torch.io import save_g2o

    device = resolve_device(args.platform)
    graph, name = load_graph(args)
    print(f"loaded {name}: {graph.num_vertices} vertices, {graph.num_edges} edges "
          f"({'SE3' if graph.is_se3 else 'SE2'})", file=sys.stderr)
    loss = make_loss(args)
    optimizers = ["lm", "gn", "dl"] if args.optimizer == "all" else [args.optimizer]
    cp = graph.to_problem(loss=loss, fix_first=args.fix_first).compile(device=device)
    chi2_before = graph.chi2()

    def solve(solver):
        t0 = time.perf_counter()
        result = solver.optimize(cp)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return result, time.perf_counter() - t0

    rows = []
    for kind in optimizers:
        solver = make_solver(kind, args)
        if args.profile:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                result, elapsed = solve(solver)
            TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(TRACE_PATH))
            print(f"profiler trace written to {TRACE_PATH}", file=sys.stderr)
        else:
            result, elapsed = solve(solver)
        rows.append((kind, result, elapsed, graph.chi2(result.variables)))
        print(f"{kind}: {result.summary()}", file=sys.stderr)

    print(f"\n{'optimizer':>9} {'status':>28} {'iters':>5} {'init cost':>12} "
          f"{'final cost':>12} {'chi2 before':>12} {'chi2 after':>12} {'time':>9}")
    for kind, res, elapsed, chi2_after in rows:
        print(f"{kind:>9} {res.status.name:>28} {res.iterations:>5} "
              f"{res.initial_cost:>12.4e} {res.final_cost:>12.4e} "
              f"{chi2_before:>12.4e} {chi2_after:>12.4e} {elapsed * 1e3:>8.1f}m")

    if args.save_output:
        vertices = graph.vertices_se3 if graph.is_se3 else graph.vertices_se2
        for vid in vertices:
            vertices[vid] = np.asarray(result.variables[f"x{vid}"])
        save_g2o(args.save_output, graph)
        print(f"optimized graph written to {args.save_output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
