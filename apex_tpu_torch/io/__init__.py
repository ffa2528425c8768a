"""Host-side I/O of the port: BAL, G2O and TORO files, the pose-graph
container, the synthetic generators, and the dataset registry
(``io.datasets``). rosbag/DDS are ROADMAP A.10b."""

from . import synthetic
from .bal import BalDataset, load_bal, save_bal
from .g2o import load_g2o, save_g2o
from .graph import Edge, Graph
from .synthetic import synthetic_pose_graph_grid3d
from .toro import load_toro, save_toro

__all__ = ["BalDataset", "Edge", "Graph", "load_bal", "load_g2o", "load_toro", "save_bal",
           "save_g2o", "save_toro", "synthetic", "synthetic_pose_graph_grid3d"]
