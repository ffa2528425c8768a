"""Extended camera models (counterpart of ``apex_tpu/cameras/extended.py``):
RadTan, Kannala-Brandt, FOV, UCM, EUCM, Double Sphere and FTheta.

The projections are the JAX package's, statement by statement, with every
NaN guard of an unselected ``where`` branch kept; the Jacobians come from
the exact autodiff default of ``CameraModel.jacobians``. ``max`` / ``min``
/ clip inside a projection are ``torch.maximum`` / ``torch.minimum``
against a full tensor, whose derivative splits 0.5 / 0.5 at a tie as
``jnp.maximum`` / ``jnp.clip`` do (``torch.clamp`` passes it whole). The
``unproject`` loops run the JAX package's fixed iteration counts.
"""

from __future__ import annotations

import numpy as np
import torch

from . import register
from .base import CameraModel, host_array, unit

_GEOM = 1e-9  # the reference's GEOMETRIC_PRECISION analogue


def _finite_pos(intr, n, focals=2):
    intr = host_array(intr)
    if intr.shape[-1] != n:
        raise ValueError(f"expected {n} intrinsics, got {intr.shape}")
    if not np.all(np.isfinite(intr)):
        raise ValueError("intrinsics must be finite")
    if focals and np.any(intr[..., :focals] <= 0):
        raise ValueError("focal lengths must be positive")


def _max(x, c):
    """``jnp.maximum(x, c)`` for a number ``c``."""
    return torch.maximum(x, torch.full_like(x, c))


def _min(x, c):
    return torch.minimum(x, torch.full_like(x, c))


def _nonzero(den):
    """``where(|den| < _GEOM, _GEOM, den)``."""
    return torch.where(torch.abs(den) < _GEOM, _GEOM, den)


class RadTanCamera(CameraModel):
    """Brown-Conrady / OpenCV: [fx, fy, cx, cy, k1, k2, p1, p2, k3]."""

    name = "rad_tan"
    intrinsic_dim = 9

    def _project(self, intr, p_cam):
        fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
        k1, k2, p1, p2, k3 = (intr[..., 4], intr[..., 5], intr[..., 6],
                              intr[..., 7], intr[..., 8])
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        iz = 1.0 / z
        xp, yp = x * iz, y * iz
        r2 = xp * xp + yp * yp
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy = xp * yp
        dx = 2.0 * p1 * xy + p2 * (r2 + 2.0 * xp * xp)
        dy = p1 * (r2 + 2.0 * yp * yp) + 2.0 * p2 * xy
        return torch.stack([fx * (radial * xp + dx) + cx, fy * (radial * yp + dy) + cy], dim=-1)

    def unproject(self, intr, uv, iters: int = 20):
        fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
        k1, k2, p1, p2, k3 = (intr[..., 4], intr[..., 5], intr[..., 6],
                              intr[..., 7], intr[..., 8])
        xd = (uv[..., 0] - cx) / fx
        yd = (uv[..., 1] - cy) / fy
        x, y = xd, yd
        for _ in range(iters):  # fixed-point undistortion
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        return unit(torch.stack([x, y, torch.ones_like(x)], dim=-1))

    def validate_params(self, intr):
        _finite_pos(intr, 9)


class KannalaBrandtCamera(CameraModel):
    """Fisheye: [fx, fy, cx, cy, k1, k2, k3, k4]; d(theta) polynomial."""

    name = "kannala_brandt"
    intrinsic_dim = 8

    def _project(self, intr, p_cam):
        fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
        k1, k2, k3, k4 = intr[..., 4], intr[..., 5], intr[..., 6], intr[..., 7]
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        r2 = x * x + y * y
        near_axis = r2 < _GEOM * _GEOM
        r = torch.sqrt(torch.where(near_axis, torch.ones_like(r2), r2))
        theta = torch.atan2(r, z)
        t2 = theta * theta
        theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = torch.where(near_axis, 1.0 / z, theta_d / r)
        return torch.stack([fx * x * scale + cx, fy * y * scale + cy], dim=-1)

    def unproject(self, intr, uv, iters: int = 30):
        fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
        k1, k2, k3, k4 = intr[..., 4], intr[..., 5], intr[..., 6], intr[..., 7]
        mx = (uv[..., 0] - cx) / fx
        my = (uv[..., 1] - cy) / fy
        rd = torch.sqrt(mx * mx + my * my)
        theta = rd
        for _ in range(iters):  # Newton on theta_d(theta) = rd
            t2 = theta * theta
            f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - rd
            fp = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
            theta = theta - f / fp
        small = rd < _GEOM
        srd = torch.where(small, torch.ones_like(rd), rd)
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        return unit(torch.stack(
            [
                torch.where(small, mx, sin_t * mx / srd),
                torch.where(small, my, sin_t * my / srd),
                torch.where(small, torch.ones_like(cos_t), cos_t),
            ],
            dim=-1,
        ))

    def validate_params(self, intr):
        _finite_pos(intr, 8)


class FovCamera(CameraModel):
    """FOV / atan model: [fx, fy, cx, cy, w]."""

    name = "fov"
    intrinsic_dim = 5

    def valid_mask(self, intr, p_cam):
        return p_cam[..., 2] > 1.4901161193847656e-08  # sqrt(f64 eps)

    def _project(self, intr, p_cam):
        fx, fy, cx, cy, w = (intr[..., 0], intr[..., 1], intr[..., 2],
                             intr[..., 3], intr[..., 4])
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        r2 = x * x + y * y
        near = r2 < _GEOM * _GEOM
        r = torch.sqrt(torch.where(near, torch.ones_like(r2), r2))
        two_tan = 2.0 * torch.tan(w / 2.0)
        rd = torch.where(near, two_tan / w / z, torch.atan(two_tan * r / z) / (r * w))
        return torch.stack([fx * x * rd + cx, fy * y * rd + cy], dim=-1)

    def unproject(self, intr, uv):
        fx, fy, cx, cy, w = (intr[..., 0], intr[..., 1], intr[..., 2],
                             intr[..., 3], intr[..., 4])
        mx = (uv[..., 0] - cx) / fx
        my = (uv[..., 1] - cy) / fy
        rd2 = mx * mx + my * my
        near = rd2 < _GEOM * _GEOM
        rd = torch.sqrt(torch.where(near, torch.ones_like(rd2), rd2))
        two_tan = 2.0 * torch.tan(w / 2.0)
        ru = torch.tan(rd * w) / two_tan
        s = torch.where(near, torch.ones_like(rd), ru / rd)
        return unit(torch.stack([mx * s, my * s, torch.ones_like(mx)], dim=-1))

    def validate_params(self, intr):
        _finite_pos(intr, 5)
        w = host_array(intr)[..., 4]
        if np.any(w <= 0) or np.any(w >= np.pi):
            raise ValueError("FOV parameter w must be in (0, pi)")


class UcmCamera(CameraModel):
    """Unified camera model: [fx, fy, cx, cy, alpha]."""

    name = "ucm"
    intrinsic_dim = 5

    def valid_mask(self, intr, p_cam):
        alpha = intr[..., 4]
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        d = torch.sqrt(x * x + y * y + z * z)
        w = torch.where(alpha <= 0.5, alpha / (1.0 - alpha), (1.0 - alpha) / alpha)
        denom = alpha * d + (1.0 - alpha) * z
        return (z > -w * d) & (denom > _GEOM)

    def _project(self, intr, p_cam):
        fx, fy, cx, cy, alpha = (intr[..., 0], intr[..., 1], intr[..., 2],
                                 intr[..., 3], intr[..., 4])
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        d = torch.sqrt(x * x + y * y + z * z)
        denom = _nonzero(alpha * d + (1.0 - alpha) * z)
        return torch.stack([fx * x / denom + cx, fy * y / denom + cy], dim=-1)

    def unproject(self, intr, uv):
        # UCM is EUCM with beta = 1 (the Double Sphere paper, eq. 6-10)
        fx, fy, cx, cy, alpha = (intr[..., 0], intr[..., 1], intr[..., 2],
                                 intr[..., 3], intr[..., 4])
        mx = (uv[..., 0] - cx) / fx
        my = (uv[..., 1] - cy) / fy
        r2 = mx * mx + my * my
        gamma = 1.0 - alpha
        num = 1.0 - r2 * alpha * alpha
        den = alpha * torch.sqrt(_max(1.0 - (alpha - gamma) * r2, 0.0)) + gamma
        mz = num / _nonzero(den)
        return unit(torch.stack([mx, my, mz], dim=-1))

    def validate_params(self, intr):
        _finite_pos(intr, 5)
        a = host_array(intr)[..., 4]
        if np.any(a < 0) or np.any(a >= 1):
            raise ValueError("UCM alpha must be in [0, 1)")


class EucmCamera(CameraModel):
    """Extended UCM: [fx, fy, cx, cy, alpha, beta]."""

    name = "eucm"
    intrinsic_dim = 6

    def valid_mask(self, intr, p_cam):
        alpha, beta = intr[..., 4], intr[..., 5]
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        d = torch.sqrt(beta * (x * x + y * y) + z * z)
        denom = alpha * d + (1.0 - alpha) * z
        w = torch.where(alpha <= 0.5, alpha / (1.0 - alpha), (1.0 - alpha) / alpha)
        return (z > -w * d) & (denom > _GEOM)

    def _project(self, intr, p_cam):
        fx, fy, cx, cy, alpha, beta = (intr[..., 0], intr[..., 1], intr[..., 2],
                                       intr[..., 3], intr[..., 4], intr[..., 5])
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        d = torch.sqrt(beta * (x * x + y * y) + z * z)
        denom = _nonzero(alpha * d + (1.0 - alpha) * z)
        return torch.stack([fx * x / denom + cx, fy * y / denom + cy], dim=-1)

    def unproject(self, intr, uv):
        fx, fy, cx, cy, alpha, beta = (intr[..., 0], intr[..., 1], intr[..., 2],
                                       intr[..., 3], intr[..., 4], intr[..., 5])
        mx = (uv[..., 0] - cx) / fx
        my = (uv[..., 1] - cy) / fy
        r2 = mx * mx + my * my
        gamma = 1.0 - alpha
        num = 1.0 - r2 * alpha * alpha * beta
        den = alpha * torch.sqrt(_max(1.0 - (alpha - gamma) * beta * r2, 0.0)) + gamma
        mz = num / _nonzero(den)
        return unit(torch.stack([mx, my, mz], dim=-1))

    def validate_params(self, intr):
        _finite_pos(intr, 6)
        a, b = host_array(intr)[..., 4], host_array(intr)[..., 5]
        if np.any(a < 0) or np.any(a >= 1) or np.any(b <= 0):
            raise ValueError("EUCM requires alpha in [0,1), beta > 0")


class DoubleSphereCamera(CameraModel):
    """Double sphere: [fx, fy, cx, cy, xi, alpha]."""

    name = "double_sphere"
    intrinsic_dim = 6

    def valid_mask(self, intr, p_cam):
        xi, alpha = intr[..., 4], intr[..., 5]
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        d1 = torch.sqrt(x * x + y * y + z * z)
        w1 = torch.where(alpha > 0.5, (1.0 - alpha) / alpha, alpha / (1.0 - alpha))
        w2 = (w1 + xi) / torch.sqrt(2.0 * w1 * xi + xi * xi + 1.0)
        xi_d1_z = xi * d1 + z
        d2 = torch.sqrt(x * x + y * y + xi_d1_z * xi_d1_z)
        denom = alpha * d2 + (1.0 - alpha) * xi_d1_z
        return (z > -w2 * d1) & (denom > _GEOM)

    def _project(self, intr, p_cam):
        fx, fy, cx, cy, xi, alpha = (intr[..., 0], intr[..., 1], intr[..., 2],
                                     intr[..., 3], intr[..., 4], intr[..., 5])
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        r2 = x * x + y * y
        d1 = torch.sqrt(r2 + z * z)
        xi_d1_z = xi * d1 + z
        d2 = torch.sqrt(r2 + xi_d1_z * xi_d1_z)
        denom = _nonzero(alpha * d2 + (1.0 - alpha) * xi_d1_z)
        return torch.stack([fx * x / denom + cx, fy * y / denom + cy], dim=-1)

    def unproject(self, intr, uv):
        fx, fy, cx, cy, xi, alpha = (intr[..., 0], intr[..., 1], intr[..., 2],
                                     intr[..., 3], intr[..., 4], intr[..., 5])
        mx = (uv[..., 0] - cx) / fx
        my = (uv[..., 1] - cy) / fy
        r2 = mx * mx + my * my
        mz = (1.0 - alpha * alpha * r2) / (
            alpha * torch.sqrt(_max(1.0 - (2.0 * alpha - 1.0) * r2, 0.0)) + 1.0 - alpha)
        mz2 = mz * mz
        k = (mz * xi + torch.sqrt(_max(mz2 + (1.0 - xi * xi) * r2, 0.0))) / (mz2 + r2)
        return unit(torch.stack([k * mx, k * my, k * mz - xi], dim=-1))

    def validate_params(self, intr):
        _finite_pos(intr, 6)
        a = host_array(intr)[..., 5]
        if np.any(a <= 0) or np.any(a >= 1):
            raise ValueError("double sphere alpha must be in (0, 1)")


class FThetaCamera(CameraModel):
    """NVIDIA f-theta fisheye: [cx, cy, k1, k2, k3, k4], no focal; the
    polynomial f(theta) = k1 t + k2 t^2 + k3 t^3 + k4 t^4 maps the angle to
    the pixel radius."""

    name = "ftheta"
    intrinsic_dim = 6

    def _project(self, intr, p_cam):
        cx, cy = intr[..., 0], intr[..., 1]
        k1, k2, k3, k4 = intr[..., 2], intr[..., 3], intr[..., 4], intr[..., 5]
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        r_p2 = x * x + y * y
        d = torch.sqrt(r_p2 + z * z)
        theta = torch.acos(_min(_max(z / _max(d, _GEOM), -1.0), 1.0))
        f_theta = theta * (k1 + theta * (k2 + theta * (k3 + theta * k4)))
        near = r_p2 < _GEOM * _GEOM
        r_p = torch.sqrt(torch.where(near, torch.ones_like(r_p2), r_p2))
        u = torch.where(near, cx, cx + f_theta * x / r_p)
        v = torch.where(near, cy, cy + f_theta * y / r_p)
        return torch.stack([u, v], dim=-1)

    def unproject(self, intr, uv, iters: int = 50):
        cx, cy = intr[..., 0], intr[..., 1]
        k1, k2, k3, k4 = intr[..., 2], intr[..., 3], intr[..., 4], intr[..., 5]
        dx = uv[..., 0] - cx
        dy = uv[..., 1] - cy
        rd2 = dx * dx + dy * dy
        near = rd2 < _GEOM * _GEOM
        rd = torch.sqrt(torch.where(near, torch.ones_like(rd2), rd2))
        theta = rd / _max(k1, _GEOM)
        for _ in range(iters):  # Newton: f(theta) = rd
            f = theta * (k1 + theta * (k2 + theta * (k3 + theta * k4))) - rd
            fp = k1 + theta * (2 * k2 + theta * (3 * k3 + theta * 4 * k4))
            theta = theta - f / _nonzero(fp)
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        return unit(torch.stack(
            [
                torch.where(near, torch.zeros_like(dx), sin_t * dx / rd),
                torch.where(near, torch.zeros_like(dy), sin_t * dy / rd),
                torch.where(near, torch.ones_like(cos_t), cos_t),
            ],
            dim=-1,
        ))

    def validate_params(self, intr):
        _finite_pos(intr, 6, focals=0)
        k1 = host_array(intr)[..., 2]
        if np.any(k1 <= 0):
            raise ValueError("ftheta k1 must be positive")


register(RadTanCamera())
register(KannalaBrandtCamera())
register(FovCamera())
register(UcmCamera())
register(EucmCamera())
register(DoubleSphereCamera())
register(FThetaCamera())
