"""Visualize a pose graph file (reference: examples/visualize_graph_file.rs).

Streams the graph to Rerun when the SDK is installed; otherwise prints an
ASCII summary of the trajectory extent (computed on the ``--platform``
device). Usage: python -m apex_tpu_torch.examples.visualize_graph_file
[path.g2o] [--platform cpu|cuda]
"""

import os
import tempfile

import numpy as np
import torch

from apex_tpu_torch.examples import parse
from apex_tpu_torch.io import load_g2o, save_g2o, synthetic


def main(argv=None):
    args, device = parse(__doc__, argv, path_help="g2o file (default: a generated one)")
    path = args.path
    if path is None:
        path = os.path.join(tempfile.gettempdir(), "example_vis.g2o")
        save_g2o(path, synthetic.synthetic_pose_graph_3d(n_poses=150, rings=6))
        print(f"(generated synthetic graph at {path})")
    g = load_g2o(path)
    verts = g.vertices_se3 if g.is_se3 else g.vertices_se2
    pts = np.stack([verts[k][:3 if g.is_se3 else 2] for k in sorted(verts)])
    on_device = torch.as_tensor(pts, device=device)
    lo = on_device.amin(dim=0).cpu().numpy()
    hi = on_device.amax(dim=0).cpu().numpy()
    print(f"{path}: {g.num_vertices} vertices, {g.num_edges} edges")
    print(f"extent: min {lo} max {hi}")
    row = dict(vertices=g.num_vertices, edges=g.num_edges, min=lo, max=hi, rerun=False)

    try:
        import rerun as rr

        rr.init("apex_tpu_graph", spawn=True)
        if g.is_se3:
            rr.log("graph/vertices", rr.Points3D(pts))
        else:
            rr.log("graph/vertices", rr.Points3D(
                np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)))
        print("streamed to rerun viewer")
        row["rerun"] = True
    except ImportError:
        print("(rerun-sdk not installed; summary only)")
    return [row]


if __name__ == "__main__":
    main()
