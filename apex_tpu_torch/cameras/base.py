"""Camera model protocol (counterpart of ``apex_tpu/cameras/base.py``).

A camera model is stateless; its methods are plain functions of intrinsics
``intr [..., K]`` and camera-frame points ``p_cam [..., 3]``. Validity
(cheirality and the model's own domain) is returned as a mask; callers zero
invalid rows. Subclasses implement ``_project`` (finite wherever the mask
holds, with every unselected branch guarded) and may override
``valid_mask``; the Jacobians default to exact forward-mode autodiff of
``_project`` (``torch.func.jacfwd`` under ``torch.func.vmap``) and may be
overridden with closed forms.
"""

from __future__ import annotations

import numpy as np
import torch

MIN_DEPTH = 1e-6


def host_array(intr) -> np.ndarray:
    """Intrinsics as a host array for ``validate_params``."""
    if torch.is_tensor(intr):
        return intr.detach().cpu().numpy()
    return np.asarray(intr)


def unit(ray):
    """Rays (..., 3) scaled to unit norm."""
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


class CameraModel:
    name: str = "camera"
    intrinsic_dim: int = 0
    # +1: camera looks down +Z; -1: looks down -Z (BAL/Bundler)
    forward_sign: int = +1

    def _project(self, intr, p_cam):
        """(..., K), (..., 3) -> (..., 2); may assume |z| > MIN_DEPTH."""
        raise NotImplementedError

    def valid_mask(self, intr, p_cam):
        """True where the projection is well defined (cheirality etc.)."""
        z = p_cam[..., 2]
        if self.forward_sign > 0:
            return z > MIN_DEPTH
        return z < -MIN_DEPTH

    def unproject(self, intr, uv):
        """Pixel -> unit-norm ray in the camera frame (..., 3)."""
        raise NotImplementedError

    def validate_params(self, intr) -> None:
        """Host-side check of the intrinsics; raises ValueError."""

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

    def jacobians(self, intr, p_cam):
        """(J_point (..., 2, 3), J_intr (..., 2, K)): exact forward-mode
        autodiff of ``_project`` at the clamped point."""
        ps = self._safe_pcam(p_cam)
        shape = ps.shape[:-1]
        K = self.intrinsic_dim
        flat_i = intr.expand(shape + (K,)).reshape(-1, K)
        flat_p = ps.reshape(-1, 3)
        if flat_p.shape[0] == 0:
            return (ps.new_zeros(shape + (2, 3)), ps.new_zeros(shape + (2, K)))

        # each row keeps a batch dimension of 1: under forward-mode autodiff
        # a python number times a 0-dim tensor gets a float64 tangent, which
        # an f32 solve cannot take
        def single(i, p):
            Jp = torch.func.jacfwd(lambda pp: self._project(i[None], pp[None])[0])(p)
            Ji = torch.func.jacfwd(lambda ii: self._project(ii[None], p[None])[0])(i)
            return Jp, Ji

        Jp, Ji = torch.func.vmap(single)(flat_i, flat_p)
        return Jp.reshape(shape + (2, 3)), Ji.reshape(shape + (2, K))

    def project_batch(self, intr, p_cam, invalid_value=1e6):
        """Projections with the (1e6, 1e6) sentinel where invalid."""
        uv, valid = self.project(intr, p_cam)
        return torch.where(valid[..., None], uv, torch.full_like(uv, invalid_value))

