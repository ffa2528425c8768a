from .base import CallbackObserver, HistoryObserver, OptObserver, OptObserverVec
from .visualization import RerunObserver, VisualizationConfig

__all__ = [
    "OptObserver",
    "OptObserverVec",
    "CallbackObserver",
    "HistoryObserver",
    "RerunObserver",
    "VisualizationConfig",
]
