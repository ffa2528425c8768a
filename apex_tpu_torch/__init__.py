"""apex_tpu_torch: the PyTorch / CUDA port of ``apex_tpu``, for one NVIDIA
H100. It keeps ``apex_tpu``'s module tree and names. Ported so far, in
python loop mode:

- the three outer optimizers: Levenberg-Marquardt, Gauss-Newton, DogLeg;
- the bundle-adjustment solve, implicit Schur (PCG with the Schur-Jacobi
  preconditioner) or explicit Schur (the dense reduced camera matrix;
  ``schur`` picks it up to 4096 camera DOF), with the landmark block
  inverse as a hand-written CUDA kernel;
- SE2 and SE3 pose graphs (G2O and TORO files, the synthetic ring,
  manhattan, sphere and 3D-lattice graphs, ``BetweenFactor``, the prior
  factors, the 15 robust losses), solved by ``sparse_cholesky`` (band
  assembly and block cyclic reduction, or above a 1536-column bandwidth the
  general tier), ``sparse_qr`` (the same band, a QR sweep),
  ``sparse_general`` (independent-set block elimination, any sparsity), the
  dense tier, ``dense_cholesky`` (LM's default) and ``dense_qr``, or ``pcg``
  (matrix-free CG on the normal equations);
- covariance blocks after a solve (``compute_covariances=True``,
  ``core.covariance``);
- the support surface: observers (``observers``: history, callbacks, the
  visualization observer with its headless sink), checkpoint / resume
  (``core.checkpoint``, ``optimize(..., checkpoint=)``), the error
  hierarchy (``errors``), ``config``, ``utils`` (logger, profiling), the
  dataset registry (``io.datasets``, behind both CLIs' ``--dataset``);
- the host-side ROS2 layers: bags (``io.rosbag``: sqlite3 and MCAP
  storage, the CDR codec and message registry, metadata.yaml; the JAX
  package's bytes), DDS subscription (``io.dds``) and ``cli.bag_tools``;
- the JAX package's eight single-device example scripts, as
  ``apex_tpu_torch.examples`` (``python -m
  apex_tpu_torch.examples.compare_solvers [--platform cpu]``).

The dtype (f64 by default) and the device (``"cuda"`` by default) are
arguments of ``Problem.compile(dtype=..., device=...)``; ``"cuda"`` without a
card raises, and nothing falls back to the CPU unless ``device="cpu"`` is
asked for. TF32 is turned off at import.
"""

from .device import disable_tf32

disable_tf32()

from . import errors, observers  # noqa: E402
from .core import CauchyLoss, HuberLoss, L1Loss, L2Loss, Loss  # noqa: E402
from .core.problem import CompiledProblem, Problem  # noqa: E402
from .factors import BetweenFactor, ManifoldPriorFactor, PriorFactor  # noqa: E402
from .io import Graph, load_g2o, load_toro, save_g2o, save_toro  # noqa: E402
from .manifolds import SE2, SE3, SO2, SO3, Rn  # noqa: E402
from .optim import (  # noqa: E402
    DogLeg,
    DogLegConfig,
    GaussNewton,
    GaussNewtonConfig,
    LevenbergMarquardt,
    LevenbergMarquardtConfig,
    SolverResult,
    Status,
)

__version__ = "0.1.0"

__all__ = [
    "errors", "observers",
    "SE2", "SE3", "SO2", "SO3", "Rn",
    "Problem", "CompiledProblem", "BetweenFactor", "PriorFactor", "ManifoldPriorFactor",
    "Graph", "load_g2o", "save_g2o", "load_toro", "save_toro",
    "Loss", "L2Loss", "L1Loss", "HuberLoss", "CauchyLoss",
    "LevenbergMarquardt", "LevenbergMarquardtConfig", "SolverResult", "Status",
    "GaussNewton", "GaussNewtonConfig", "DogLeg", "DogLegConfig",
]
