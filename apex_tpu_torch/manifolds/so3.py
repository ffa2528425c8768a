"""SO(3) as w-first unit quaternions (counterpart of
``apex_tpu/manifolds/so3.py``)."""

from __future__ import annotations

import torch

from .base import LieGroup
from .utils import (
    cosc_b,
    jlinv_d,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    sinc3_c,
    small_angle_threshold,
    skew,
)

DOF = 3
STORAGE_DIM = 4


def identity(dtype=torch.float64, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def inverse(q):
    return quat_conj(q)


def compose(q1, q2):
    return quat_mul(q1, q2)


def exp(theta):
    """(..., 3) axis-angle -> unit quaternion (..., 4)."""
    theta2 = torch.sum(theta * theta, dim=-1)
    small = theta2 < small_angle_threshold(theta.dtype)
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * safe
    # sin(t/2)/t, with Taylor 1/2 - t^2/48 for small t
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / safe)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w[..., None], k[..., None] * theta], dim=-1)


def log(q):
    """Unit quaternion -> axis-angle (..., 3), principal (|theta| <= pi)."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = q[..., 0]
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1)
    # |v| = sin(t/2) ~ t/2, so vn2 ~ t^2/4
    small = vn2 < small_angle_threshold(q.dtype) * 0.25
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    k_exact = 2.0 * torch.atan2(vn, w) / vn
    # small: theta = 2 v / w * (1 - |v|^2/(3 w^2))
    safe_w = torch.where(torch.abs(w) < 1e-30, torch.ones_like(w), w)
    k_taylor = (2.0 / safe_w) * (1.0 - vn2 / (3.0 * safe_w * safe_w))
    k = torch.where(small, k_taylor, k_exact)
    return k[..., None] * v


def act(q, v):
    return quat_rotate(q, v)


def _skew_terms(theta):
    theta2 = torch.sum(theta * theta, dim=-1)[..., None, None]
    S = skew(theta)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return theta2, S, S @ S, eye


def ljac(theta):
    """Left Jacobian: I + B(t)[t]x + C(t)[t]x^2."""
    theta2, S, S2, eye = _skew_terms(theta)
    return eye + cosc_b(theta2) * S + sinc3_c(theta2) * S2


def ljac_inv(theta):
    """Jl^{-1} = I - 1/2 [t]x + D(t) [t]x^2."""
    theta2, S, S2, eye = _skew_terms(theta)
    return eye - 0.5 * S + jlinv_d(theta2) * S2


def normalize(q):
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


SO3 = LieGroup(
    name="SO3",
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
