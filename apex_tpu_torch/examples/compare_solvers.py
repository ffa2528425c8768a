"""Compare linear solvers on the same problem (reference:
examples/compare_solvers.rs).

Runs LM with dense Cholesky / dense QR / explicit Schur / implicit Schur on
a synthetic BA problem and prints a comparison table. The two Schur solvers
invert the landmark blocks with the landmark-block kernel (on a card, one
CUDA launch per LM iteration).
"""

import time

import apex_tpu_torch as apx
from apex_tpu_torch.ba import build_ba_problem, rmse
from apex_tpu_torch.examples import parse, result_row, synchronize
from apex_tpu_torch.io import synthetic

SOLVERS = ("dense_cholesky", "dense_qr", "schur_explicit", "schur_implicit")


def main(argv=None):
    _, device = parse(__doc__, argv)
    ds = synthetic.synthetic_ba(n_cameras=12, n_points=300, seed=0)
    print(f"BA problem: {ds.num_cameras} cams, {ds.num_points} pts, "
          f"{ds.num_observations} obs\n")

    rows = []
    for solver in SOLVERS:
        cfg = apx.LevenbergMarquardtConfig(linear_solver_type=solver, max_iterations=30)
        t0 = time.perf_counter()
        res = apx.LevenbergMarquardt(cfg).optimize(build_ba_problem(ds).compile(device=device))
        synchronize(device)
        dt = time.perf_counter() - t0
        rows.append(dict(solver=solver, **result_row(res),
                         rmse=rmse(res.final_cost, ds.num_observations), seconds=dt))

    print(f"{'solver':>16} {'status':>26} {'iters':>5} {'final cost':>12} "
          f"{'RMSE px':>8} {'time':>8}")
    for r in rows:
        print(f"{r['solver']:>16} {r['status']:>26} {r['iterations']:>5} "
              f"{r['final_cost']:>12.4e} {r['rmse']:>8.3f} {r['seconds']:>7.2f}s")
    return rows


if __name__ == "__main__":
    main()
