"""Host-side I/O of the port: BAL files and the synthetic BA generators.
G2O/TORO are ROADMAP A.1; the dataset registry and rosbag/DDS A.10."""

from . import synthetic
from .bal import BalDataset, load_bal, save_bal

__all__ = ["BalDataset", "load_bal", "save_bal", "synthetic"]
