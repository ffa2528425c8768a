"""Robust loss comparison under outlier contamination (reference:
examples/loss_function_comparison.rs)."""

import numpy as np

import apex_tpu_torch as apx
from apex_tpu_torch.core import losses as L
from apex_tpu_torch.examples import parse, result_row
from apex_tpu_torch.io import synthetic

LOSSES = [
    ("none", None),
    ("huber", L.HuberLoss(1.0)),
    ("cauchy", L.CauchyLoss(1.0)),
    ("geman_mcclure", L.GemanMcClureLoss(1.0)),
    ("tukey", L.TukeyBiweightLoss(4.685)),
    ("welsch", L.WelschLoss(2.985)),
]


def main(argv=None):
    _, device = parse(__doc__, argv)
    # Clean reference solution
    g_clean = synthetic.synthetic_pose_graph_2d(n_poses=150, trajectory="ring", seed=5)
    clean = apx.LevenbergMarquardt().optimize(g_clean.to_problem().compile(device=device))

    # Contaminate 5% of edges
    g = synthetic.synthetic_pose_graph_2d(n_poses=150, trajectory="ring", seed=5)
    rng = np.random.default_rng(1)
    n_out = len(g.edges_se2) // 20
    for e in rng.choice(len(g.edges_se2), n_out, replace=False):
        g.edges_se2[e].measurement = g.edges_se2[e].measurement + rng.normal(0, 2.0, 3)
    print(f"{n_out} of {len(g.edges_se2)} edges corrupted\n")

    print(f"{'loss':>14} {'status':>26} {'iters':>5} {'final cost':>11} "
          f"{'ATE vs clean':>12}")
    rows = []
    for name, loss in LOSSES:
        res = apx.LevenbergMarquardt().optimize(g.to_problem(loss=loss).compile(device=device))
        ate = np.mean([
            np.linalg.norm(res.variables[k][:2] - clean.variables[k][:2])
            for k in res.variables
        ])
        rows.append(dict(loss=name, **result_row(res), ate=ate))
        print(f"{name:>14} {res.status.name:>26} {res.iterations:>5} "
              f"{res.final_cost:>11.4e} {ate:>12.4f}")
    return rows


if __name__ == "__main__":
    main()
