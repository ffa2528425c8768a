"""SO(2) planar rotations, storage ``[theta]`` (counterpart of
``apex_tpu/manifolds/so2.py``). The angle is stored directly and wrapped to
(-pi, pi] on composition, which keeps log exact; every tangent Jacobian and
the adjoint are 1x1 ones."""

from __future__ import annotations

import torch

from .base import LieGroup
from .utils import rand_uniform, wrap_angle

DOF = 1
STORAGE_DIM = 1


def identity(dtype=torch.float64, device=None):
    return torch.zeros(1, dtype=dtype, device=device)


def inverse(x):
    return -x


def compose(a, b):
    return wrap_angle(a + b)


def _ones(x):
    return torch.ones(x.shape[:-1] + (1, 1), dtype=x.dtype, device=x.device)


def act(x, v):
    """Rotate 2-vector(s) v (..., 2)."""
    c, s = torch.cos(x[..., 0]), torch.sin(x[..., 0])
    vx, vy = v[..., 0], v[..., 1]
    return torch.stack([c * vx - s * vy, s * vx + c * vy], dim=-1)


def hat(theta):
    t = theta[..., 0]
    z = torch.zeros_like(t)
    return torch.stack([torch.stack([z, -t], dim=-1), torch.stack([t, z], dim=-1)], dim=-2)


def random(generator, batch=(), dtype=torch.float64, device=None):
    return rand_uniform(generator, tuple(batch) + (1,), -torch.pi, torch.pi, dtype, device)


def is_valid(x, tol=1e-6):
    return torch.all(torch.isfinite(x), dim=-1)


def interpolate(a, b, alpha):
    return compose(a, wrap_angle(alpha * wrap_angle(compose(inverse(a), b))))


SO2 = LieGroup(
    name="SO2",
    dof=DOF,
    storage_dim=STORAGE_DIM,
    identity=identity,
    inverse=inverse,
    compose=compose,
    exp=wrap_angle,
    log=wrap_angle,
    normalize=wrap_angle,
    act=act,
    adjoint=_ones,
    rjac=_ones,
    ljac=_ones,
    rjac_inv=_ones,
    ljac_inv=_ones,
    hat=hat,
    random=random,
    is_valid=is_valid,
    interpolate=interpolate,
)
