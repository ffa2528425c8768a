"""Host-side I/O of the port: BAL, G2O and TORO files, the pose-graph
container, the synthetic generators, the dataset registry (``io.datasets``),
ROS2 bags (``io.rosbag``: sqlite3 and MCAP storage, the CDR codec, the
message registry, metadata.yaml) and DDS subscription (``io.dds``)."""

from . import datasets, synthetic
from .bal import BalDataset, load_bal, save_bal
from .g2o import load_g2o, save_g2o
from .graph import Edge, Graph
from .synthetic import synthetic_pose_graph_grid3d
from .toro import load_toro, save_toro

__all__ = ["BalDataset", "Edge", "Graph", "load_bal", "load_g2o", "load_toro", "save_bal",
           "save_g2o", "save_toro", "datasets", "synthetic", "synthetic_pose_graph_grid3d"]
