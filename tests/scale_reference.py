"""The JAX package's numbers for ``chip_smoke.SCALE_JAX``: one rung of the
scale ladder per process, built by ``apex_tpu`` from the generator
arguments of ``apex_tpu_torch.benches.ladder.RUNGS`` and solved on the CPU
in f64, python mode, with the ladder's config of that rung (``bench.py``'s).
Not a test: run it by hand, one rung at a time (venice and pose50k need
tens of GB of host memory; run nothing else beside them):

    python tests/scale_reference.py torus3d

prints one JSON line: the initial cost, status, LM iterations, final cost,
seconds and the process's peak resident memory.
"""

import json
import resource
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import apex_tpu as apx  # noqa: E402
from apex_tpu.ba import build_ba_problem  # noqa: E402
from apex_tpu.io import synthetic  # noqa: E402
from apex_tpu_torch.benches import ladder  # noqa: E402

# the ladder's BA configs: (max_iterations, pcg_max_iterations, RMSE stop)
BA = {"dubrovnik": (30, None, 0.533), "ladybug": (5, 15, None), "venice": (8, 15, 0.46)}


def main(name):
    kw = dict(ladder.RUNGS[name].build.keywords)
    t0 = time.perf_counter()
    if name in BA:
        ds = synthetic.synthetic_ba_large(seed=0, **kw)
        cp = build_ba_problem(ds, mode="self_calibration").compile(dtype=np.float64)
        its, pcg, stop = BA[name]
        extra = {} if pcg is None else dict(pcg_max_iterations=pcg)
        if stop is not None:
            extra["min_cost_threshold"] = stop ** 2 * ds.num_observations
        cfg = apx.LevenbergMarquardtConfig(
            linear_solver_type="schur_implicit", schur_preconditioner="schur_jacobi",
            max_iterations=its, mode="python", **extra)
    else:
        kw.pop("dims")
        cp = synthetic.synthetic_pose_graph_3d(seed=0, **kw).to_problem().compile(
            dtype=np.float64)
        cfg = apx.LevenbergMarquardtConfig(
            mode="python", max_iterations=100, cost_tolerance=1e-4,
            linear_solver_type="sparse_cholesky", damping="auto")
    res = apx.LevenbergMarquardt(cfg).optimize(cp)
    print(json.dumps(dict(
        rung=name, initial_cost=res.initial_cost, status=res.status.name,
        iterations=res.iterations, final_cost=res.final_cost,
        seconds=time.perf_counter() - t0,
        max_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6)))


if __name__ == "__main__":
    main(sys.argv[1])
