"""Camera model protocol (counterpart of ``apex_tpu/cameras/base.py``).

A camera model is stateless; its methods are plain functions of intrinsics
``intr [..., K]`` and camera-frame points ``p_cam [..., 3]``. Validity
(cheirality) is returned as a mask; callers zero invalid rows.
"""

from __future__ import annotations

import torch

MIN_DEPTH = 1e-6


class CameraModel:
    name: str = "camera"
    intrinsic_dim: int = 0
    # +1: camera looks down +Z; -1: looks down -Z (BAL/Bundler)
    forward_sign: int = +1

    def _project(self, intr, p_cam):
        raise NotImplementedError

    def jacobians(self, intr, p_cam):
        """(J_point (..., 2, 3), J_intr (..., 2, K)) in closed form."""
        raise NotImplementedError

    def valid_mask(self, intr, p_cam):
        z = p_cam[..., 2]
        if self.forward_sign > 0:
            return z > MIN_DEPTH
        return z < -MIN_DEPTH

    def _safe_pcam(self, p_cam):
        """Clamp |z| away from 0 so the masked-out rows stay finite."""
        z = p_cam[..., 2]
        if self.forward_sign > 0:
            zs = torch.clamp_min(z, MIN_DEPTH)
        else:
            zs = torch.clamp_max(z, -MIN_DEPTH)
        return torch.cat([p_cam[..., :2], zs[..., None]], dim=-1)

    def project(self, intr, p_cam):
        """(uv (..., 2), valid (...,) bool). Invalid points give finite
        garbage uv that callers must mask."""
        valid = self.valid_mask(intr, p_cam)
        return self._project(intr, self._safe_pcam(p_cam)), valid
