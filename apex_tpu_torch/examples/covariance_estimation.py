"""Covariance estimation after convergence (reference:
examples/covariance_estimation.rs): uncertainty grows with graph distance
from the fixed anchor."""

import numpy as np

import apex_tpu_torch as apx
from apex_tpu_torch.examples import parse, result_row
from apex_tpu_torch.io import synthetic


def main(argv=None):
    _, device = parse(__doc__, argv)
    g = synthetic.synthetic_pose_graph_2d(n_poses=40, trajectory="ring", seed=3)
    cp = g.to_problem(fix_first=True).compile(device=device)
    cfg = apx.LevenbergMarquardtConfig(compute_covariances=True)
    res = apx.LevenbergMarquardt(cfg).optimize(cp)
    print(res.summary(), "\n")
    rows = [result_row(res)]
    print(f"{'pose':>6} {'sigma_x':>9} {'sigma_y':>9} {'sigma_theta':>11}")
    for i in range(0, 40, 5):
        C = res.covariances[f"x{i}"]
        sx, sy, st = np.sqrt(np.diag(C))
        rows.append(dict(pose=f"x{i}", sigma_x=sx, sigma_y=sy, sigma_theta=st))
        print(f"x{i:<5} {sx:>9.5f} {sy:>9.5f} {st:>11.5f}")
    return rows


if __name__ == "__main__":
    main()
