"""Multi-device bundle adjustment: the landmark-partitioned Schur step
(reference: examples/multichip_ba.py).

Runs the sharded LM step on ``n_ranks`` processes. Each rank owns 1/n of
the landmarks and their observations; only the camera-entity system and
one ``all_reduce`` per PCG iteration cross the ranks.

Usage: python -m apex_tpu_torch.examples.multichip_ba [n_ranks]
       [--platform cuda|cpu] [--backend nccl|gloo]

``--backend`` defaults to ``nccl`` on ``cuda`` (one card per rank) and to
``gloo`` on the CPU; ``--backend gloo`` lets the ranks share one card.
"""

import argparse

import torch

from apex_tpu_torch.ba import build_ba_problem, rmse
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.parallel import launch, make_sharded_schur_step

ITERATIONS = 8


def _rank(mesh):
    """One rank's solve: the partition's shape and, per LM iteration, the
    cost and the damping."""
    ds = synthetic.synthetic_ba(n_cameras=8, n_points=200, seed=0)
    cp = build_ba_problem(ds, mode="self_calibration").compile(device=mesh.device)
    step, _ = make_sharded_schur_step(cp, mesh)
    values = cp.initial_values()
    damping = torch.tensor(1e-3, dtype=cp.dtype, device=cp.device)
    nu = torch.tensor(2.0, dtype=cp.dtype, device=cp.device)
    cost = cp.cost(values)
    costs, dampings = [float(cost)], []
    for _ in range(ITERATIONS):
        values, damping, nu, cost = step(values, damping, nu, cost)
        costs.append(float(cost))
        dampings.append(float(damping))
    return dict(partitioned=hasattr(step, "solve"),
                per_rank=max((m.n_loc for m in getattr(step, "metas", ())), default=0),
                observations=ds.num_observations, landmarks=ds.num_points,
                costs=costs, dampings=dampings)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("n_ranks", nargs="?", type=int, default=2)
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="torch device (default cuda; no fallback to cpu)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on cuda, gloo on cpu")
    args = p.parse_args(argv)
    backend = args.backend or ("nccl" if args.platform == "cuda" else "gloo")
    res = launch(_rank, args.n_ranks, backend, args.platform)[0]
    n_obs = res["observations"]
    print(f"ranks: {args.n_ranks} ({backend} on {args.platform}) | partitioned path: "
          f"{res['partitioned']} | {n_obs} observations, {res['landmarks']} landmarks "
          f"(~{res['per_rank']} per rank)")
    cost = res["costs"][0]
    print(f"initial cost {cost:.6e} (RMSE {rmse(cost, n_obs):.3f} px)")
    rows = [dict(iteration=-1, cost=cost, rmse=rmse(cost, n_obs), damping=1e-3)]
    for it, (cost, damping) in enumerate(zip(res["costs"][1:], res["dampings"])):
        print(f"iter {it}: cost {cost:.6e} (RMSE {rmse(cost, n_obs):.3f} px, "
              f"damping {damping:.2e})")
        rows.append(dict(iteration=it, cost=cost, rmse=rmse(cost, n_obs), damping=damping))
    return rows


if __name__ == "__main__":
    main()
