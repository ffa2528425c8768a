"""Load, inspect, and optimize a g2o/TORO graph file (reference:
examples/load_graph_file.rs). Usage: python -m
apex_tpu_torch.examples.load_graph_file [path.g2o] [--platform cpu|cuda] —
generates a synthetic file in the temporary directory if no path is
given."""

import os
import tempfile

import apex_tpu_torch as apx
from apex_tpu_torch.examples import parse, result_row
from apex_tpu_torch.io import load_g2o, save_g2o, synthetic


def main(argv=None):
    args, device = parse(__doc__, argv, path_help="g2o file (default: a generated one)")
    path = args.path
    if path is None:
        path = os.path.join(tempfile.gettempdir(), "example_graph.g2o")
        save_g2o(path, synthetic.synthetic_pose_graph_2d(n_poses=100, seed=7))
        print(f"(generated synthetic graph at {path})")

    g = load_g2o(path)
    kind = "SE3" if g.is_se3 else "SE2"
    chi2_before = g.chi2()
    print(f"{path}: {g.num_vertices} {kind} vertices, {g.num_edges} edges")
    print(f"chi2 before: {chi2_before:.6e}")

    res = apx.LevenbergMarquardt().optimize(g.to_problem().compile(device=device))
    chi2_after = g.chi2(res.variables)
    print(res.summary())
    print(f"chi2 after: {chi2_after:.6e}")
    return [dict(result_row(res), vertices=g.num_vertices, edges=g.num_edges, kind=kind,
                 chi2_before=chi2_before, chi2_after=chi2_after)]


if __name__ == "__main__":
    main()
