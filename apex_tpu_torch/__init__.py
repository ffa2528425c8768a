"""apex_tpu_torch: the PyTorch / CUDA port of ``apex_tpu``, for one NVIDIA
H100. It keeps ``apex_tpu``'s module tree and names. Ported so far, with
Levenberg-Marquardt in python loop mode:

- the bundle-adjustment solve (implicit Schur with the Schur-Jacobi
  preconditioner), with the landmark block inverse as a hand-written CUDA
  kernel;
- the SE3 pose-graph solve (G2O files or the synthetic sphere,
  ``BetweenFactor``, ``linear_solver_type="sparse_cholesky"``: band assembly
  and block cyclic reduction).

The dtype (f64 by default) and the device (``"cuda"`` by default) are
arguments of ``Problem.compile(dtype=..., device=...)``; ``"cuda"`` without a
card raises, and nothing falls back to the CPU unless ``device="cpu"`` is
asked for. TF32 is turned off at import.
"""

from .device import disable_tf32

disable_tf32()

from .core import HuberLoss, L2Loss, Loss  # noqa: E402
from .core.problem import CompiledProblem, Problem  # noqa: E402
from .factors import BetweenFactor  # noqa: E402
from .io import Graph, load_g2o, save_g2o  # noqa: E402
from .manifolds import SE3, SO3, Rn  # noqa: E402
from .optim import (  # noqa: E402
    LevenbergMarquardt,
    LevenbergMarquardtConfig,
    SolverResult,
    Status,
)

__version__ = "0.1.0"

__all__ = [
    "SE3", "SO3", "Rn",
    "Problem", "CompiledProblem", "BetweenFactor",
    "Graph", "load_g2o", "save_g2o",
    "Loss", "L2Loss", "HuberLoss",
    "LevenbergMarquardt", "LevenbergMarquardtConfig", "SolverResult", "Status",
]
