"""ProjectionFactor: reprojection residual over (pose, landmark, intrinsics)
(counterpart of ``apex_tpu/factors/projection.py``).

- the pose is world-to-camera SE3: p_cam = R p_world + t
- residual = project(p_cam) - observation, 2 rows per observation
- an invalid projection gives zero residual rows and zero Jacobian rows
- ∂uv/∂pose = ∂uv/∂p_cam · [R | -R [p_w]x], ∂uv/∂landmark = ∂uv/∂p_cam · R
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..cameras import CameraModel
from ..cameras import get as get_camera
from ..manifolds.utils import quat_to_mat, skew
from ..utils.profiling import span
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
    """One observation of a landmark by a camera. The slots that are not
    optimized are constants: pass them to the constructor (``pose=``,
    ``landmark=``, ``intrinsics=``). ``template(camera, optimize)`` makes
    the data-free instance for ``Problem.add_residual_block_batch``, whose
    stacked arrays supply 'obs' and 'const_<slot>'."""

    kind = "projection"

    @classmethod
    def template(cls, camera, optimize=_SLOT_ORDER):
        return cls(camera, None, optimize)

    def __init__(
        self,
        camera: CameraModel | str,
        observation,
        optimize: Tuple[str, ...] | str = _SLOT_ORDER,
        *,
        pose: Optional[np.ndarray] = None,
        landmark: Optional[np.ndarray] = None,
        intrinsics: Optional[np.ndarray] = None,
    ):
        if isinstance(camera, str):
            camera = get_camera(camera)
        if isinstance(optimize, str):
            optimize = OPTIMIZE_MODES[optimize]
        self.camera = camera
        self.optimize = tuple(s for s in _SLOT_ORDER if s in optimize)
        self.observation = (None if observation is None
                            else np.asarray(observation, dtype=np.float64).reshape(2))
        consts = {"pose": pose, "landmark": landmark, "intrinsics": intrinsics}
        self._const = {}
        self._is_template = observation is None
        for slot in _SLOT_ORDER:
            if slot in self.optimize:
                if consts[slot] is not None:
                    raise ValueError(f"{slot} is optimized; do not pass a constant value")
            elif consts[slot] is None:
                if self._is_template:
                    continue  # the bulk path supplies const_* arrays in data
                raise ValueError(
                    f"{slot} is not optimized; pass its constant value to the constructor")
            else:
                self._const[slot] = np.asarray(consts[slot], dtype=np.float64)

    def signature(self):
        return ("projection", self.camera.name, self.optimize)

    def var_manifolds(self) -> List[str]:
        dims = {"pose": "SE3", "landmark": "R3",
                "intrinsics": f"R{self.camera.intrinsic_dim}"}
        return [dims[s] for s in self.optimize]

    def residual_dim(self) -> int:
        return 2

    def data(self) -> Dict[str, np.ndarray]:
        if self._is_template:
            raise RuntimeError(
                "a template ProjectionFactor carries no per-factor data; use "
                "Problem.add_residual_block_batch")
        d = {"obs": self.observation}
        for slot, v in self._const.items():
            d[f"const_{slot}"] = v
        return d

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
            with span("camera.project"):
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

            with span("camera.jacobians"):
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
