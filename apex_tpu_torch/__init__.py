"""apex_tpu_torch: the PyTorch / CUDA port of ``apex_tpu``, for one NVIDIA
H100. It keeps ``apex_tpu``'s module tree and names; the first slice is the
bundle-adjustment solve (implicit Schur with the Schur-Jacobi
preconditioner, Levenberg-Marquardt in python loop mode), with the landmark
block inverse as a hand-written CUDA kernel.

Everything is explicit: the dtype (f64 by default) and the device are
passed to ``Problem.compile(dtype=..., device=...)``, and ``device="cuda"``
without a card raises. TF32 is turned off at import.
"""

from .device import disable_tf32

disable_tf32()

from .core import HuberLoss, L2Loss, Loss  # noqa: E402
from .core.problem import CompiledProblem, Problem  # noqa: E402
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
    "Problem", "CompiledProblem",
    "Loss", "L2Loss", "HuberLoss",
    "LevenbergMarquardt", "LevenbergMarquardtConfig", "SolverResult", "Status",
]
