"""SE(3) rigid transforms, storage ``[tx, ty, tz, qw, qx, qy, qz]``, tangent
``[rho(3), theta(3)]`` (counterpart of ``apex_tpu/manifolds/se3.py``)."""

from __future__ import annotations

import torch

from . import so3
from .base import LieGroup
from .utils import (
    q_coeff_1,
    q_coeff_2,
    q_coeff_3,
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_mat,
    skew,
)

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


def adjoint(x):
    """Ad = [[R, [t]x R], [0, R]] for tangent [rho, theta]."""
    R = quat_to_mat(_q(x))
    top = torch.cat([R, skew(_t(x)) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _Q_left(rho, theta):
    """Barfoot's Q: the (rho, theta) off-diagonal block of Jl_SE3."""
    theta2 = torch.sum(theta * theta, dim=-1)[..., None, None]
    P = skew(rho)
    T = skew(theta)
    TP = T @ P
    PT = P @ T
    TPT = TP @ T
    TTP = T @ TP
    PTT = PT @ T
    TPTT = TPT @ T
    TTPT = TTP @ T
    c1 = q_coeff_1(theta2)  # (t - sin t)/t^3
    c2 = q_coeff_2(theta2)  # (t^2/2 + cos t - 1)/t^4
    c3 = q_coeff_3(theta2)  # (t - sin t - t^3/6)/t^5
    return (
        0.5 * P
        + c1 * (TP + PT + TPT)
        + c2 * (TTP + PTT - 3.0 * TPT)
        + 0.5 * (c2 + 3.0 * c3) * (TPTT + TTPT)
    )


def _upper_block(a, b):
    """[[a, b], [0, a]] from (..., 3, 3) blocks."""
    top = torch.cat([a, b], dim=-1)
    bot = torch.cat([torch.zeros_like(a), a], dim=-1)
    return torch.cat([top, bot], dim=-2)


def ljac(tau):
    """Jl_SE3 = [[Jl(theta), Q(rho, theta)], [0, Jl(theta)]]."""
    rho, theta = tau[..., :3], tau[..., 3:]
    return _upper_block(so3.ljac(theta), _Q_left(rho, theta))


def rjac(tau):
    """Jr(tau) = Jl(-tau)."""
    return ljac(-tau)


def ljac_inv(tau):
    """Jl^{-1} = [[Jl^{-1}, -Jl^{-1} Q Jl^{-1}], [0, Jl^{-1}]]."""
    rho, theta = tau[..., :3], tau[..., 3:]
    Jli = so3.ljac_inv(theta)
    return _upper_block(Jli, -((Jli @ _Q_left(rho, theta)) @ Jli))


def rjac_inv(tau):
    return ljac_inv(-tau)


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
    adjoint=adjoint,
    rjac=rjac,
    ljac=ljac,
    rjac_inv=rjac_inv,
    ljac_inv=ljac_inv,
)
