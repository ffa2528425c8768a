"""Standard pinhole camera (counterpart of ``apex_tpu/cameras/pinhole.py``):
4 intrinsics [fx, fy, cx, cy], +Z forward, closed-form Jacobians."""

from __future__ import annotations

import numpy as np
import torch

from .base import CameraModel, host_array, unit


class PinholeCamera(CameraModel):
    name = "pinhole"
    intrinsic_dim = 4
    forward_sign = +1

    def _project(self, intr, p_cam):
        fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        iz = 1.0 / z
        return torch.stack([fx * x * iz + cx, fy * y * iz + cy], dim=-1)

    def jacobians(self, intr, p_cam):
        ps = self._safe_pcam(p_cam)
        fx, fy = intr[..., 0], intr[..., 1]
        x, y, z = ps[..., 0], ps[..., 1], ps[..., 2]
        iz = 1.0 / z
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        J_point = torch.stack(
            [
                torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
                torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
            ],
            dim=-2,
        )
        J_intr = torch.stack(
            [
                torch.stack([x * iz, zero, one, zero], dim=-1),
                torch.stack([zero, y * iz, zero, one], dim=-1),
            ],
            dim=-2,
        )
        return J_point, J_intr

    def unproject(self, intr, uv):
        fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
        xn = (uv[..., 0] - cx) / fx
        yn = (uv[..., 1] - cy) / fy
        return unit(torch.stack([xn, yn, torch.ones_like(xn)], dim=-1))

    def validate_params(self, intr) -> None:
        intr = host_array(intr)
        if intr.shape[-1] != 4:
            raise ValueError(f"pinhole expects 4 intrinsics [fx,fy,cx,cy], got {intr.shape}")
        if np.any(intr[..., :2] <= 0) or not np.all(np.isfinite(intr)):
            raise ValueError("pinhole focal lengths must be positive and finite")
