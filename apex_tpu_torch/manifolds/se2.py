"""SE(2) planar rigid transforms, storage ``[x, y, theta]``, tangent
``[rho_x, rho_y, theta]`` (counterpart of ``apex_tpu/manifolds/se2.py``).
Exp goes through the closed-form V(theta); the adjoint is
[[R, -S t], [0, 1]] with S = [[0, -1], [1, 0]]."""

from __future__ import annotations

import torch

from .base import LieGroup
from .utils import rand_uniform, randn, small_angle_threshold, wrap_angle

DOF = 3
STORAGE_DIM = 3


def _mat3(rows):
    """(..., 3, 3) from three rows of three (...,) tensors."""
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def _sincosc(theta):
    """A = sin(t)/t and B = (1 - cos(t))/t, Taylor-switched at 0."""
    t2 = theta * theta
    small = t2 < small_angle_threshold(theta.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, theta / 2.0 - t2 * theta / 24.0, (1.0 - torch.cos(safe)) / safe)
    return A, B


def identity(dtype=torch.float64, device=None):
    return torch.zeros(3, dtype=dtype, device=device)


def inverse(x):
    """(-R^T t, -theta)."""
    theta = x[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    tx, ty = x[..., 0], x[..., 1]
    return torch.stack([-(c * tx + s * ty), -(-s * tx + c * ty), -theta], dim=-1)


def compose(a, b):
    theta = a[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    bx, by = b[..., 0], b[..., 1]
    return torch.stack([a[..., 0] + c * bx - s * by, a[..., 1] + s * bx + c * by,
                        wrap_angle(theta + b[..., 2])], dim=-1)


def exp(tau):
    """Exp([rho, theta]) = (V(theta) rho, theta), V = [[A, -B], [B, A]]."""
    rx, ry, theta = tau[..., 0], tau[..., 1], tau[..., 2]
    A, B = _sincosc(theta)
    return torch.stack([A * rx - B * ry, B * rx + A * ry, wrap_angle(theta)], dim=-1)


def log(x):
    """Log: rho = V(theta)^{-1} t."""
    theta = wrap_angle(x[..., 2])
    A, B = _sincosc(theta)
    den = A * A + B * B
    tx, ty = x[..., 0], x[..., 1]
    return torch.stack([(A * tx + B * ty) / den, (-B * tx + A * ty) / den, theta], dim=-1)


def adjoint(x):
    """Ad = [[R, -S t], [0, 1]]; -S t = [ty, -tx]."""
    theta = x[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return _mat3([[c, -s, x[..., 1]], [s, c, -x[..., 0]], [zero, zero, one]])


def act(x, v):
    """Transform 2-vector(s) v (..., 2)."""
    theta = x[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    vx, vy = v[..., 0], v[..., 1]
    return torch.stack([x[..., 0] + c * vx - s * vy, x[..., 1] + s * vx + c * vy], dim=-1)


def normalize(x):
    """Wrap the angle; a new tensor, the input is left as it is."""
    return torch.cat([x[..., :2], wrap_angle(x[..., 2:])], dim=-1)


def _jac_third_col(rho_x, rho_y, theta, sign):
    """Third column of Jr (sign=+1) / Jl (sign=-1):
    [(theta x - y + y cos - x sin)/theta^2, (x + theta y - x cos - y sin)/theta^2],
    Taylor-switched at 0."""
    t2 = theta * theta
    small = t2 < small_angle_threshold(theta.dtype)
    safe2 = torch.where(small, torch.ones_like(t2), t2)
    c, s = torch.cos(theta), torch.sin(theta)
    x = rho_x
    y = sign * rho_y  # Jl mirrors the y-coupling
    a_exact = (theta * x - y + y * c - x * s) / safe2
    b_exact = (x + theta * y - x * c - y * s) / safe2
    a = torch.where(small, -y / 2.0 + x * theta / 6.0, a_exact)
    b = torch.where(small, x / 2.0 + y * theta / 6.0, b_exact)
    return a, sign * b


def rjac(tau):
    """Closed-form right Jacobian (manif's se2 convention)."""
    rx, ry, theta = tau[..., 0], tau[..., 1], tau[..., 2]
    A, B = _sincosc(theta)
    a, b = _jac_third_col(rx, ry, theta, +1.0)
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    return _mat3([[A, B, a], [-B, A, b], [zero, zero, one]])


def ljac(tau):
    """Jl(tau) = Jr(-tau)."""
    return rjac(-tau)


def _inv3(J):
    """Exact 3x3 inverse by the adjugate, elementwise."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    adj = _mat3([[e * i - f * h, c * h - b * i, b * f - c * e],
                 [f * g - d * i, a * i - c * g, c * d - a * f],
                 [d * h - e * g, b * g - a * h, a * e - b * d]])
    return adj * (1.0 / det)[..., None, None]


def rjac_inv(tau):
    return _inv3(rjac(tau))


def ljac_inv(tau):
    return _inv3(ljac(tau))


def hat(tau):
    rx, ry, theta = tau[..., 0], tau[..., 1], tau[..., 2]
    z = torch.zeros_like(theta)
    return _mat3([[z, -theta, rx], [theta, z, ry], [z, z, z]])


def random(generator, batch=(), dtype=torch.float64, device=None):
    batch = tuple(batch)
    return torch.cat([randn(generator, batch + (2,), dtype, device),
                      rand_uniform(generator, batch + (1,), -torch.pi, torch.pi, dtype, device)],
                     dim=-1)


def is_valid(x, tol=1e-6):
    return torch.all(torch.isfinite(x), dim=-1)


def interpolate(a, b, alpha):
    return compose(a, exp(alpha * log(compose(inverse(a), b))))


SE2 = LieGroup(
    name="SE2",
    dof=DOF,
    storage_dim=STORAGE_DIM,
    identity=identity,
    inverse=inverse,
    compose=compose,
    exp=exp,
    log=log,
    normalize=normalize,
    act=act,
    adjoint=adjoint,
    rjac=rjac,
    ljac=ljac,
    rjac_inv=rjac_inv,
    ljac_inv=ljac_inv,
    hat=hat,
    random=random,
    is_valid=is_valid,
    interpolate=interpolate,
)
