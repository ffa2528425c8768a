"""Small sizes of the benchmark's configurations, for runs on the CPU."""

import copy
import time

from harness import cell

ROOT = cell.Path(__file__).resolve().parents[2]
SMALL = {
    "pose_graph_3d": {"n_poses": 200, "rings": 8},
    "ba_large": {"n_cameras": 20, "n_points": 3000, "obs_per_camera": 200, "pixel_noise": 0.3},
}


def spec(workload):
    """The cell's specification with its generator at a small size."""
    s = copy.deepcopy(cell.load(ROOT, workload))
    gen = s["config"]["generator"]
    gen["params"] = SMALL[gen["name"]]
    return s


def workloads():
    import json

    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(spec, seed=7, seconds=0.5, trace=0, control=False, device="cpu"):
    """One run on ``device``; -> (exit code, parsed last line)."""
    import io
    import json

    out = io.StringIO()
    rc = cell.run(spec, seed, seconds, trace, time.perf_counter(), device=device,
                  control=control, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
