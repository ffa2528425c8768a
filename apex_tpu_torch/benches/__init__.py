"""The JAX package's benchmark harnesses, ported: ``ladder`` (the rungs of
the repository's ``bench.py``), ``odometry_pose_benchmark`` and
``bundle_adjustment_benchmark`` (the two harnesses of ``benches/``). Each is
a module with ``main(argv=None)`` and ``--platform cpu|cuda`` (default
``cuda``, which raises without a card; nothing falls back to the CPU), run
as ``python -m apex_tpu_torch.benches.<name>``."""

from __future__ import annotations

import torch

DTYPES = {"f32": torch.float32, "f64": torch.float64}
