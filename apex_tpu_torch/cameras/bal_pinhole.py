"""BAL (Snavely/Bundler) pinhole camera (counterpart of
``apex_tpu/cameras/bal_pinhole.py``): intrinsics [f, k1, k2], camera looks
down -Z, no principal point:

    x_n = x / (-z);  y_n = y / (-z);  r2 = x_n^2 + y_n^2
    d = 1 + k1 r2 + k2 r2^2;          uv = f d (x_n, y_n)
"""

from __future__ import annotations

import numpy as np
import torch

from .base import CameraModel, host_array, unit


class BALPinholeCamera(CameraModel):
    name = "bal_pinhole"
    intrinsic_dim = 3
    forward_sign = -1

    def _project(self, intr, p_cam):
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        iz = -1.0 / z
        xn = x * iz
        yn = y * iz
        r2 = xn * xn + yn * yn
        d = 1.0 + r2 * (k1 + k2 * r2)
        return (f * d)[..., None] * torch.stack([xn, yn], dim=-1)

    def jacobians(self, intr, p_cam):
        ps = self._safe_pcam(p_cam)
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        x, y, z = ps[..., 0], ps[..., 1], ps[..., 2]
        iz = -1.0 / z
        xn = x * iz
        yn = y * iz
        r2 = xn * xn + yn * yn
        d = 1.0 + r2 * (k1 + k2 * r2)
        dd_dr2 = k1 + 2.0 * k2 * r2

        # d(uv)/d(xn, yn)
        a = 2.0 * dd_dr2
        J_uxn = f * (d + a * xn * xn)
        J_uyn = f * (a * xn * yn)
        J_vxn = J_uyn
        J_vyn = f * (d + a * yn * yn)

        # d(xn, yn)/d(p_cam): dxn/dx = -1/z = iz, dxn/dz = x/z^2
        z2 = z * z
        zero = torch.zeros_like(iz)
        dxn = torch.stack([iz, zero, x / z2], dim=-1)
        dyn = torch.stack([zero, iz, y / z2], dim=-1)

        Ju = J_uxn[..., None] * dxn + J_uyn[..., None] * dyn
        Jv = J_vxn[..., None] * dxn + J_vyn[..., None] * dyn
        J_point = torch.stack([Ju, Jv], dim=-2)  # (..., 2, 3)

        # d(uv)/d(f, k1, k2)
        J_intr = torch.stack(
            [
                torch.stack([d * xn, f * xn * r2, f * xn * r2 * r2], dim=-1),
                torch.stack([d * yn, f * yn * r2, f * yn * r2 * r2], dim=-1),
            ],
            dim=-2,
        )  # (..., 2, 3)
        return J_point, J_intr

    def unproject(self, intr, uv):
        """The undistorted inverse: 8 fixed-point steps on (k1, k2)."""
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        xd = uv[..., 0] / f
        yd = uv[..., 1] / f
        xn, yn = xd, yd
        for _ in range(8):
            r2 = xn * xn + yn * yn
            d = 1.0 + r2 * (k1 + k2 * r2)
            xn = xd / d
            yn = yd / d
        return unit(torch.stack([xn, yn, -torch.ones_like(xn)], dim=-1))

    def validate_params(self, intr) -> None:
        intr = host_array(intr)
        if intr.shape[-1] != 3:
            raise ValueError(f"BAL pinhole expects 3 intrinsics [f,k1,k2], got {intr.shape}")
        if np.any(intr[..., 0] <= 0) or not np.all(np.isfinite(intr)):
            raise ValueError("BAL pinhole focal length must be positive and finite")
