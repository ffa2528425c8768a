"""ProjectionFactor: reprojection residual over (pose, landmark, intrinsics)
(counterpart of ``apex_tpu/factors/projection.py``).

- the pose is world-to-camera SE3: p_cam = R p_world + t
- residual = project(p_cam) - observation, 2 rows per observation
- an invalid projection gives zero residual rows and zero Jacobian rows
- ∂uv/∂pose = ∂uv/∂p_cam · [R | -R [p_w]x], ∂uv/∂landmark = ∂uv/∂p_cam · R
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..cameras import CameraModel
from ..cameras import get as get_camera
from ..manifolds.utils import quat_to_mat, skew
from .base import Factor

OPTIMIZE_MODES = {
    "bundle_adjustment": ("pose", "landmark"),
    "self_calibration": ("pose", "landmark", "intrinsics"),
    "only_pose": ("pose",),
    "only_landmarks": ("landmark",),
    "only_intrinsics": ("intrinsics",),
    "pose_and_intrinsics": ("pose", "intrinsics"),
    "landmarks_and_intrinsics": ("landmark", "intrinsics"),
}

_SLOT_ORDER = ("pose", "landmark", "intrinsics")


class ProjectionFactor(Factor):
    """Only the bulk template form is ported: per-observation data goes
    through ``Problem.add_residual_block_batch`` as stacked arrays ('obs',
    and 'const_<slot>' for each slot that is not optimized)."""

    kind = "projection"

    def __init__(self, camera: CameraModel | str,
                 optimize: Tuple[str, ...] | str = _SLOT_ORDER):
        if isinstance(camera, str):
            camera = get_camera(camera)
        if isinstance(optimize, str):
            optimize = OPTIMIZE_MODES[optimize]
        self.camera = camera
        self.optimize = tuple(s for s in _SLOT_ORDER if s in optimize)

    @classmethod
    def template(cls, camera, optimize=_SLOT_ORDER):
        return cls(camera, optimize)

    def signature(self):
        return ("projection", self.camera.name, self.optimize)

    def var_manifolds(self) -> List[str]:
        dims = {"pose": "SE3", "landmark": "R3",
                "intrinsics": f"R{self.camera.intrinsic_dim}"}
        return [dims[s] for s in self.optimize]

    def residual_dim(self) -> int:
        return 2

    def data(self) -> Dict[str, np.ndarray]:
        raise RuntimeError(
            "a template ProjectionFactor carries no per-factor data; use "
            "Problem.add_residual_block_batch")

    def group_kernel(self):
        camera = self.camera
        optimize = self.optimize

        def kernel(manifolds, data, params, compute_jacobian):
            by_slot = {}
            it = iter(params)
            for slot in _SLOT_ORDER:
                by_slot[slot] = next(it) if slot in optimize else data[f"const_{slot}"]
            pose, p_w, intr = by_slot["pose"], by_slot["landmark"], by_slot["intrinsics"]

            R = quat_to_mat(pose[..., 3:])
            p_cam = torch.einsum("...ij,...j->...i", R, p_w) + pose[..., :3]
            uv, valid = camera.project(intr, p_cam)
            # Overflow guard on top of cheirality: a trial step that sweeps a
            # landmark past a camera's focal plane gives |uv| ~ 1/z -> inf,
            # and in f32 one squared residual then NaNs the whole cost. Mask
            # with `where`, not a multiply: NaN * 0 == NaN.
            ok = (valid
                  & torch.isfinite(uv).all(dim=-1)
                  & (torch.abs(uv) < 1e8).all(dim=-1))
            r = torch.where(ok[..., None], uv - data["obs"], torch.zeros_like(uv))
            if not compute_jacobian:
                return r, None

            J_pc, J_intr = camera.jacobians(intr, p_cam)
            vm = ok[..., None, None]

            def mask(j):
                return torch.where(vm, j, torch.zeros_like(j))

            jacs = []
            for slot in optimize:
                if slot == "pose":
                    dp = torch.cat([R, -(R @ skew(p_w))], dim=-1)
                    jacs.append(mask(J_pc @ dp))
                elif slot == "landmark":
                    jacs.append(mask(J_pc @ R))
                else:
                    jacs.append(mask(J_intr))
            return r, jacs

        return kernel
