"""Multi-device solves over ``torch.distributed`` (counterpart of
``apex_tpu/parallel``): factor-sharded pose-graph LM steps (dense and
banded normal equations) and bundle adjustment, landmark-partitioned or
observation-sharded. One rank is one process; ``launch`` starts a world
and ``ProcessMesh`` is a rank's place in it."""

from .mesh import ProcessMesh, launch
from .schur_sharded import make_sharded_schur_step
from .sharding import (make_sharded_banded_lm_step, make_sharded_lm_step,
                       make_sharded_normal_fn, pad_groups_for_mesh)

__all__ = [
    "make_sharded_normal_fn",
    "make_sharded_lm_step",
    "make_sharded_banded_lm_step",
    "make_sharded_schur_step",
    "pad_groups_for_mesh",
    "ProcessMesh",
    "launch",
]
