"""Host-side I/O of the port: BAL and G2O files, the pose-graph container,
and the synthetic generators. TORO files are ROADMAP A.2; the dataset
registry and rosbag/DDS A.10."""

from . import synthetic
from .bal import BalDataset, load_bal, save_bal
from .g2o import load_g2o, save_g2o
from .graph import Edge, Graph

__all__ = ["BalDataset", "Edge", "Graph", "load_bal", "load_g2o", "save_bal", "save_g2o",
           "synthetic"]
