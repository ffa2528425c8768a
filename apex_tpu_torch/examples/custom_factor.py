"""Define a custom factor with autodiff Jacobians (the reference's
Rosenbrock extension path, levenberg_marquardt.rs:1103-1137)."""

import numpy as np
import torch

import apex_tpu_torch as apx
from apex_tpu_torch.examples import parse, result_row
from apex_tpu_torch.factors.base import AutoDiffFactor


class RangeBearingFactor(AutoDiffFactor):
    """2D range-bearing observation of a landmark from an SE2 pose."""

    kind = "range_bearing"

    def __init__(self, rng, bearing):
        self.meas = np.array([rng, bearing])

    def signature(self):
        return ("range_bearing",)

    def var_manifolds(self):
        return ["SE2", "R2"]

    def residual_dim(self):
        return 2

    def data(self):
        return {"meas": self.meas}

    @classmethod
    def residual(cls, manifolds, data, params):
        pose, lm = params
        dx = lm[..., 0] - pose[..., 0]
        dy = lm[..., 1] - pose[..., 1]
        rng = torch.sqrt(dx * dx + dy * dy)
        bearing = torch.atan2(dy, dx) - pose[..., 2]
        bearing = torch.atan2(torch.sin(bearing), torch.cos(bearing))
        return torch.stack([rng, bearing], dim=-1) - data["meas"]


def main(argv=None):
    _, device = parse(__doc__, argv)
    rng = np.random.default_rng(0)
    truth_lm = np.array([3.0, 4.0])
    poses = [np.array([0.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.5]),
             np.array([2.0, 1.0, 1.0])]

    problem = apx.Problem()
    for i, p in enumerate(poses):
        problem.add_variable(f"x{i}", "SE2", p)
        problem.fix_variable(f"x{i}")
    problem.add_variable("lm", "R2", truth_lm + rng.normal(0, 0.5, 2))
    for i, p in enumerate(poses):
        d = truth_lm - p[:2]
        r = np.linalg.norm(d) + rng.normal(0, 0.01)
        b = np.arctan2(d[1], d[0]) - p[2] + rng.normal(0, 0.01)
        problem.add_residual_block([f"x{i}", "lm"], RangeBearingFactor(r, b))

    res = apx.LevenbergMarquardt().optimize(problem.compile(device=device))
    print(res.summary())
    print("landmark estimate:", res.variables["lm"], "truth:", truth_lm)
    return [dict(result_row(res), landmark=res.variables["lm"])]


if __name__ == "__main__":
    main()
