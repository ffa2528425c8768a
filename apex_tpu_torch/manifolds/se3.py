"""SE(3) rigid transforms, storage ``[tx, ty, tz, qw, qx, qy, qz]``, tangent
``[rho(3), theta(3)]`` (counterpart of ``apex_tpu/manifolds/se3.py``)."""

from __future__ import annotations

import torch

from . import so3
from .base import LieGroup
from .utils import (
    mat_to_quat,
    q_coeff_1,
    q_coeff_2,
    q_coeff_3,
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_mat,
    randn,
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


def act_j(x, v):
    """p' = R v + t; J_x = [R | -R [v]x] (right perturbation, [rho, theta]),
    J_v = R."""
    R = quat_to_mat(_q(x))
    p = (R @ v[..., None])[..., 0] + _t(x)
    return p, torch.cat([R, -(R @ skew(v))], dim=-1), R


def normalize(x):
    return _pack(_t(x), so3.normalize(_q(x)))


def hat(tau):
    """4x4 se(3) matrix [[theta^, rho], [0, 0]]."""
    rho, theta = tau[..., :3], tau[..., 3:]
    top = torch.cat([skew(theta), rho[..., None]], dim=-1)
    bot = torch.zeros(top.shape[:-2] + (1, 4), dtype=tau.dtype, device=tau.device)
    return torch.cat([top, bot], dim=-2)


def random(generator, batch=(), dtype=torch.float64, device=None):
    batch = tuple(batch)
    return _pack(randn(generator, batch + (3,), dtype, device),
                 so3.random(generator, batch, dtype, device))


def is_valid(x, tol=1e-6):
    return so3.is_valid(_q(x), tol) & torch.all(torch.isfinite(_t(x)), dim=-1)


def interpolate(a, b, alpha):
    d = log(compose(inverse(a), b))
    return compose(a, exp(alpha * d))


def from_matrix(T):
    return _pack(T[..., :3, 3], mat_to_quat(T[..., :3, :3]))


def to_matrix(x):
    R = quat_to_mat(_q(x))
    top = torch.cat([R, _t(x)[..., None]], dim=-1)
    bot = torch.zeros(top.shape[:-2] + (1, 4), dtype=x.dtype, device=x.device)
    bot[..., 0, 3] = 1.0
    return torch.cat([top, bot], dim=-2)


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
    hat=hat,
    random=random,
    is_valid=is_valid,
    interpolate=interpolate,
)
