"""Sim(3), similarity transforms (sR, t) (counterpart of
``apex_tpu/manifolds/sim3.py``).

Storage ``[tx, ty, tz, qw, qx, qy, qz, s]`` (8), tangent ``[rho(3),
theta(3), sigma]`` (7). Exp uses the scale-aware V(theta, sigma), log its
inverse; act is s R x + t; the adjoint is the exact
[[sR, [t]x R, -t], [0, R, 0], [0, 0, 1]]. The tangent Jacobians come from
exact autodiff of this exp / log (``with_autodiff_jacobians``).
"""

from __future__ import annotations

import torch

from . import so3
from .base import LieGroup, with_autodiff_jacobians
from .utils import (
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_mat,
    randn,
    skew,
    small_angle_threshold,
)

DOF = 7
STORAGE_DIM = 8


def _t(x):
    return x[..., 0:3]


def _q(x):
    return x[..., 3:7]


def _s(x):
    return x[..., 7]


def _pack(t, q, s):
    return torch.cat([t, q, s[..., None]], dim=-1)


def identity(dtype=torch.float64, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def inverse(x):
    qi = quat_conj(_q(x))
    si = 1.0 / _s(x)
    return _pack(-si[..., None] * quat_rotate(qi, _t(x)), qi, si)


def compose(a, b):
    # (s1 R1, t1) (s2 R2, t2) = (s1 s2 R1 R2, s1 R1 t2 + t1)
    return _pack(
        _s(a)[..., None] * quat_rotate(_q(a), _t(b)) + _t(a),
        quat_mul(_q(a), _q(b)),
        _s(a) * _s(b),
    )


def _v_matrix(theta, sigma):
    """The scale-aware V(theta, sigma), NaN-safe in all four regimes
    through nested ``where``."""
    eps = small_angle_threshold(theta.dtype)
    t2 = torch.sum(theta * theta, dim=-1)
    th = skew(theta)
    th2 = torch.einsum("...ij,...jk->...ik", th, th)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)

    small_t = t2 < eps
    small_s = torch.abs(sigma) < eps
    tn = torch.sqrt(torch.where(small_t, torch.ones_like(t2), t2))
    sin_t, cos_t = torch.sin(tn), torch.cos(tn)
    safe_sigma = torch.where(small_s, torch.ones_like(sigma), sigma)
    e_sig = torch.exp(sigma)

    # both small: I (with the first-order sigma term, for smoothness)
    V_both = eye * (1.0 + sigma / 2.0)[..., None, None]

    # pure scale: (e^sigma - 1)/sigma I
    a_scale = torch.where(small_s, 1.0 + sigma / 2.0, (e_sig - 1.0) / safe_sigma)
    V_scale = a_scale[..., None, None] * eye

    # pure rotation: the SO(3) left Jacobian
    b_rot = torch.where(small_t, 0.5 - t2 / 24.0, (1.0 - cos_t) / torch.where(small_t, 1.0, t2))
    c_rot = torch.where(small_t, 1.0 / 6.0 - t2 / 120.0,
                        (tn - sin_t) / torch.where(small_t, 1.0, tn * t2))
    V_rot = eye + b_rot[..., None, None] * th + c_rot[..., None, None] * th2

    # the general case
    alpha2 = sigma * sigma + t2
    safe_a2 = torch.where(alpha2 < 1e-300, torch.ones_like(alpha2), alpha2)
    a_g = (e_sig - 1.0) / safe_sigma
    b_g = (e_sig * (sigma * sin_t - tn * cos_t) + tn) / (torch.where(small_t, 1.0, tn) * safe_a2)
    cos_int = (e_sig * (sigma * cos_t + tn * sin_t) - sigma) / safe_a2
    c_g = (a_g - cos_int) / torch.where(small_t, 1.0, t2)
    V_gen = a_g[..., None, None] * eye + b_g[..., None, None] * th + c_g[..., None, None] * th2

    return torch.where(
        (small_t & small_s)[..., None, None],
        V_both,
        torch.where(
            small_t[..., None, None],
            V_scale,
            torch.where(small_s[..., None, None], V_rot, V_gen),
        ),
    )


def exp(tau):
    rho, theta, sigma = tau[..., 0:3], tau[..., 3:6], tau[..., 6]
    V = _v_matrix(theta, sigma)
    return _pack(torch.einsum("...ij,...j->...i", V, rho), so3.exp(theta), torch.exp(sigma))


def log(x):
    theta = so3.log(_q(x))
    sigma = torch.log(_s(x))
    # inv_ex: no status read, so a CUDA graph can capture it
    Vinv = torch.linalg.inv_ex(_v_matrix(theta, sigma))[0]
    rho = torch.einsum("...ij,...j->...i", Vinv, _t(x))
    return torch.cat([rho, theta, sigma[..., None]], dim=-1)


def adjoint(x):
    """The exact Sim(3) adjoint for the tangent [rho, theta, sigma]:
    [[sR, [t]x R, -t], [0, R, 0], [0, 0, 1]] (Strasdat's convention)."""
    R = quat_to_mat(_q(x))
    sR = _s(x)[..., None, None] * R
    tR = torch.einsum("...ij,...jk->...ik", skew(_t(x)), R)
    Z3 = torch.zeros_like(R)
    mt = -_t(x)[..., None]
    z31 = torch.zeros(R.shape[:-2] + (3, 1), dtype=x.dtype, device=x.device)
    one = torch.ones(R.shape[:-2] + (1, 1), dtype=x.dtype, device=x.device)
    z13 = torch.zeros(R.shape[:-2] + (1, 3), dtype=x.dtype, device=x.device)
    top = torch.cat([sR, tR, mt], dim=-1)
    mid = torch.cat([Z3, R, z31], dim=-1)
    bot = torch.cat([z13, z13, one], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def act(x, p):
    return _s(x)[..., None] * quat_rotate(_q(x), p) + _t(x)


def normalize(x):
    return _pack(_t(x), so3.normalize(_q(x)), torch.abs(_s(x)))


def hat(tau):
    rho, theta, sigma = tau[..., 0:3], tau[..., 3:6], tau[..., 6]
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device)
    top = torch.cat([skew(theta) + sigma[..., None, None] * eye, rho[..., None]], dim=-1)
    bot = torch.zeros(top.shape[:-2] + (1, 4), dtype=tau.dtype, device=tau.device)
    return torch.cat([top, bot], dim=-2)


def random(generator, batch=(), dtype=torch.float64, device=None):
    batch = tuple(batch)
    t = randn(generator, batch + (3,), dtype, device)
    q = so3.random(generator, batch, dtype, device)
    s = torch.exp(0.5 * randn(generator, batch + (1,), dtype, device))
    return torch.cat([t, q, s], dim=-1)


def is_valid(x, tol=1e-6):
    return so3.is_valid(_q(x), tol) & (_s(x) > 0) & torch.all(torch.isfinite(x), dim=-1)


def interpolate(a, b, alpha):
    return compose(a, exp(alpha * log(compose(inverse(a), b))))


Sim3 = with_autodiff_jacobians(
    LieGroup(
        name="Sim3",
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
        hat=hat,
        random=random,
        is_valid=is_valid,
        interpolate=interpolate,
    )
)

from . import register as _register  # noqa: E402

_register(Sim3)
