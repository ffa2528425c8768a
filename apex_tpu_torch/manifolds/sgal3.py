"""SGal(3), the Galilean group (R, t, v, time) of inertial navigation
(counterpart of ``apex_tpu/manifolds/sgal3.py``).

Storage ``[tx, ty, tz, qw, qx, qy, qz, vx, vy, vz, s]`` (11), tangent
``[rho(3), nu(3), theta(3), s]`` (10), and the group law

    g1 ∘ g2 = (R1 R2, R1 (t2 + s1 v2) + t1, R1 v2 + v1, s1 + s2)
    g⁻¹     = (Rᵀ, -Rᵀ (t - s v), -Rᵀ v, -s)
    exp     = (Exp(theta), Jl(theta) rho, Jl(theta) nu, s)
    act(p)  = R p + t + s v

The adjoint and the tangent Jacobians are exact autodiff of this exp / log
/ compose.
"""

from __future__ import annotations

import torch

from . import so3
from .base import LieGroup, vmap_rows, with_autodiff_jacobians
from .utils import quat_conj, quat_mul, quat_rotate, randn, skew

DOF = 10
STORAGE_DIM = 11


def _t(x):
    return x[..., 0:3]


def _q(x):
    return x[..., 3:7]


def _v(x):
    return x[..., 7:10]


def _s(x):
    return x[..., 10]


def _pack(t, q, v, s):
    return torch.cat([t, q, v, s[..., None]], dim=-1)


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def identity(dtype=torch.float64, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                        dtype=dtype, device=device)


def inverse(x):
    qi = quat_conj(_q(x))
    ti = -quat_rotate(qi, _t(x) - _s(x)[..., None] * _v(x))
    vi = -quat_rotate(qi, _v(x))
    return _pack(ti, qi, vi, -_s(x))


def compose(a, b):
    t = quat_rotate(_q(a), _t(b) + _s(a)[..., None] * _v(b)) + _t(a)
    v = quat_rotate(_q(a), _v(b)) + _v(a)
    return _pack(t, quat_mul(_q(a), _q(b)), v, _s(a) + _s(b))


def exp(tau):
    rho, nu, theta, s = tau[..., 0:3], tau[..., 3:6], tau[..., 6:9], tau[..., 9]
    V = so3.ljac(theta)
    return _pack(_mv(V, rho), so3.exp(theta), _mv(V, nu), s)


def log(x):
    theta = so3.log(_q(x))
    Vinv = so3.ljac_inv(theta)
    return torch.cat([_mv(Vinv, _t(x)), _mv(Vinv, _v(x)), theta, _s(x)[..., None]], dim=-1)


def _adjoint_autodiff(x):
    """Ad(x) = d/dd Log(x ∘ Exp(d) ∘ x⁻¹) at d = 0 (each row with a batch
    dimension of 1, as ``base._jac_over_batch``)."""
    def single(xx):
        xx = xx[None]

        def f(d):
            return log(compose(compose(xx, exp(d)), inverse(xx)))[0]

        zero = torch.zeros(1, DOF, dtype=xx.dtype, device=xx.device)
        return torch.func.jacfwd(f)(zero)[:, 0]

    return vmap_rows(single, x, out_shape=(DOF, DOF))


def act(x, p):
    return quat_rotate(_q(x), p) + _t(x) + _s(x)[..., None] * _v(x)


def normalize(x):
    return _pack(_t(x), so3.normalize(_q(x)), _v(x), _s(x))


def hat(tau):
    """5x5 sgal(3) matrix [[theta^, nu, rho], [0, 0, s], [0, 0, 0]]."""
    rho, nu, theta, s = tau[..., 0:3], tau[..., 3:6], tau[..., 6:9], tau[..., 9]
    top = torch.cat([skew(theta), nu[..., None], rho[..., None]], dim=-1)
    z = torch.zeros_like(s)
    row4 = torch.stack([z, z, z, s, z], dim=-1)[..., None, :]
    row5 = torch.zeros(top.shape[:-2] + (1, 5), dtype=tau.dtype, device=tau.device)
    return torch.cat([top, row4, row5], dim=-2)


def random(generator, batch=(), dtype=torch.float64, device=None):
    batch = tuple(batch)
    return _pack(randn(generator, batch + (3,), dtype, device),
                 so3.random(generator, batch, dtype, device),
                 randn(generator, batch + (3,), dtype, device),
                 randn(generator, batch, dtype, device))


def is_valid(x, tol=1e-6):
    return so3.is_valid(_q(x), tol) & torch.all(torch.isfinite(x), dim=-1)


def interpolate(a, b, alpha):
    return compose(a, exp(alpha * log(compose(inverse(a), b))))


SGal3 = with_autodiff_jacobians(
    LieGroup(
        name="SGal3",
        dof=DOF,
        storage_dim=STORAGE_DIM,
        identity=identity,
        inverse=inverse,
        compose=compose,
        exp=exp,
        log=log,
        normalize=normalize,
        act=act,
        adjoint=_adjoint_autodiff,
        hat=hat,
        random=random,
        is_valid=is_valid,
        interpolate=interpolate,
    )
)

from . import register as _register  # noqa: E402

_register(SGal3)
