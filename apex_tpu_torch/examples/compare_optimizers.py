"""Compare LM / Gauss-Newton / DogLeg on a pose graph (reference:
examples/compare_optimizers.rs)."""

import time

import apex_tpu_torch as apx
from apex_tpu_torch.examples import parse, result_row, synchronize
from apex_tpu_torch.io import synthetic


def main(argv=None):
    _, device = parse(__doc__, argv)
    g = synthetic.synthetic_pose_graph_3d(n_poses=200, rings=8, seed=0)
    print(f"pose graph: {g.num_vertices} vertices, {g.num_edges} edges\n")

    solvers = [
        ("LM", apx.LevenbergMarquardt()),
        ("GN", apx.GaussNewton()),
        ("DogLeg", apx.DogLeg()),
    ]
    print(f"{'optimizer':>9} {'status':>26} {'iters':>5} {'init cost':>11} "
          f"{'final cost':>11} {'time':>8}")
    rows = []
    for name, solver in solvers:
        t0 = time.perf_counter()
        res = solver.optimize(g.to_problem().compile(device=device))
        synchronize(device)
        dt = time.perf_counter() - t0
        rows.append(dict(optimizer=name, **result_row(res), seconds=dt))
        print(f"{name:>9} {res.status.name:>26} {res.iterations:>5} "
              f"{res.initial_cost:>11.4e} {res.final_cost:>11.4e} {dt:>7.2f}s")
    return rows


if __name__ == "__main__":
    main()
