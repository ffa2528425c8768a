"""Stream optimization progress to Rerun (reference:
examples/visualize_optimization.rs). Produces every reference panel:
metric time series, Hessian heatmap + gradient bar, camera frusta /
SE2 boxes / landmark clouds, displacement statistics, and the
convergence banner. Requires the optional rerun-sdk for a live viewer
or .rrd recording; falls back to a MemorySink (same artifacts, held in
memory) when it's missing."""

import apex_tpu_torch as apx
from apex_tpu_torch.examples import parse, result_row
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.observers import RerunObserver, VisualizationConfig
from apex_tpu_torch.observers.visualization import MemorySink


def main(argv=None):
    _, device = parse(__doc__, argv)
    g = synthetic.synthetic_pose_graph_3d(n_poses=150, rings=6, seed=0)
    cfg = apx.LevenbergMarquardtConfig(mode="python", expose_matrix_data=True)
    lm = apx.LevenbergMarquardt(cfg)

    vis_cfg = VisualizationConfig.for_pose_graph()
    vis_cfg.save_path = "optimization.rrd"
    try:
        obs = RerunObserver(vis_cfg)
        print("streaming to rerun viewer / optimization.rrd")
    except ImportError:
        obs = RerunObserver(vis_cfg, sink=MemorySink())
        print("rerun-sdk not installed; recording artifacts to a MemorySink")

    lm.add_observer(obs)
    cp = g.to_problem().compile(device=device)
    obs.log_initial_graph(cp.values_dict(cp.initial_values()))

    res = lm.optimize(cp)
    obs.log_convergence(res.status.name)
    print(res.summary())
    print("camera displacement stats:", obs.displacements.get("cameras"))
    row = dict(result_row(res), displacements=obs.displacements)
    if isinstance(obs.sink, MemorySink):
        kinds = {}
        for _, k, _ in obs.sink.records:
            kinds[k] = kinds.get(k, 0) + 1
        print("logged records by kind:", kinds)
        print("entity paths:", obs.sink.paths()[:12], "...")
        row.update(records_by_kind=kinds, paths=obs.sink.paths())
    return [row]


if __name__ == "__main__":
    main()
