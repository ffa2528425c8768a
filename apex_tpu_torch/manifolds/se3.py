"""SE(3) rigid transforms, storage ``[tx, ty, tz, qw, qx, qy, qz]``, tangent
``[rho(3), theta(3)]`` (counterpart of ``apex_tpu/manifolds/se3.py``)."""

from __future__ import annotations

import torch

from . import so3
from .base import LieGroup
from .utils import quat_conj, quat_mul, quat_rotate

DOF = 6
STORAGE_DIM = 7


def _t(x):
    return x[..., :3]


def _q(x):
    return x[..., 3:]


def _pack(t, q):
    return torch.cat([t, q], dim=-1)


def identity(dtype=torch.float64, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def inverse(x):
    qi = quat_conj(_q(x))
    return _pack(-quat_rotate(qi, _t(x)), qi)


def compose(a, b):
    return _pack(_t(a) + quat_rotate(_q(a), _t(b)), quat_mul(_q(a), _q(b)))


def exp(tau):
    """Exp([rho, theta]) = (V(theta) rho, Exp_SO3(theta)), V = Jl_SO3."""
    rho, theta = tau[..., :3], tau[..., 3:]
    t = (so3.ljac(theta) @ rho[..., None])[..., 0]
    return _pack(t, so3.exp(theta))


def log(x):
    """Log(x) = [V^{-1}(theta) t, theta]."""
    theta = so3.log(_q(x))
    rho = (so3.ljac_inv(theta) @ _t(x)[..., None])[..., 0]
    return torch.cat([rho, theta], dim=-1)


def act(x, v):
    return quat_rotate(_q(x), v) + _t(x)


def normalize(x):
    return _pack(_t(x), so3.normalize(_q(x)))


SE3 = LieGroup(
    name="SE3",
    dof=DOF,
    storage_dim=STORAGE_DIM,
    identity=identity,
    inverse=inverse,
    compose=compose,
    exp=exp,
    log=log,
    normalize=normalize,
    act=act,
)
