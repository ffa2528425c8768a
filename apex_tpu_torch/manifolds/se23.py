"""SE_2(3), the extended pose (R, t, v) of IMU / VIO states (counterpart
of ``apex_tpu/manifolds/se23.py``).

Storage ``[tx, ty, tz, qw, qx, qy, qz, vx, vy, vz]`` (10), tangent
``[rho(3), theta(3), nu(3)]`` (9). Log is V⁻¹ t and V⁻¹ v; the adjoint is
[[R, [t]x R, 0], [0, R, 0], [0, [v]x R, R]]; the tangent Jacobians are in
closed form, block-triangular in 3x3 blocks.
"""

from __future__ import annotations

import torch

from . import so3
from .base import LieGroup
from .se3 import _Q_left
from .utils import quat_conj, quat_mul, quat_rotate, quat_to_mat, randn, skew

DOF = 9
STORAGE_DIM = 10


def _t(x):
    return x[..., 0:3]


def _q(x):
    return x[..., 3:7]


def _v(x):
    return x[..., 7:10]


def _pack(t, q, v):
    return torch.cat([t, q, v], dim=-1)


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _mm(A, B):
    return torch.einsum("...ij,...jk->...ik", A, B)


def identity(dtype=torch.float64, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                        dtype=dtype, device=device)


def inverse(x):
    qi = quat_conj(_q(x))
    return _pack(-quat_rotate(qi, _t(x)), qi, -quat_rotate(qi, _v(x)))


def compose(a, b):
    return _pack(
        _t(a) + quat_rotate(_q(a), _t(b)),
        quat_mul(_q(a), _q(b)),
        _v(a) + quat_rotate(_q(a), _v(b)),
    )


def exp(tau):
    rho, theta, nu = tau[..., 0:3], tau[..., 3:6], tau[..., 6:9]
    V = so3.ljac(theta)
    return _pack(_mv(V, rho), so3.exp(theta), _mv(V, nu))


def log(x):
    theta = so3.log(_q(x))
    Vinv = so3.ljac_inv(theta)
    return torch.cat([_mv(Vinv, _t(x)), theta, _mv(Vinv, _v(x))], dim=-1)


def _blocks3(rows):
    """(..., 9, 9) from a 3x3 grid of (..., 3, 3) blocks."""
    return torch.cat([torch.cat(row, dim=-1) for row in rows], dim=-2)


def adjoint(x):
    R = quat_to_mat(_q(x))
    Z = torch.zeros_like(R)
    return _blocks3([[R, _mm(skew(_t(x)), R), Z],
                     [Z, R, Z],
                     [Z, _mm(skew(_v(x)), R), R]])


def act(x, p):
    return quat_rotate(_q(x), p) + _t(x)


def _jac_blocks(tau, left: bool):
    rho, theta, nu = tau[..., 0:3], tau[..., 3:6], tau[..., 6:9]
    if left:
        J = so3.ljac(theta)
        Qr = _Q_left(rho, theta)
        Qn = _Q_left(nu, theta)
    else:
        J = so3.ljac(-theta)
        Qr = _Q_left(-rho, -theta)
        Qn = _Q_left(-nu, -theta)
    Z = torch.zeros_like(J)
    return _blocks3([[J, Qr, Z], [Z, J, Z], [Z, Qn, J]])


def ljac(tau):
    return _jac_blocks(tau, left=True)


def rjac(tau):
    return _jac_blocks(tau, left=False)


def _inv_blocks(J):
    """The inverse of the 9x9 block-triangular Jacobian from its 3x3
    blocks (``inv_ex``: no status read, so a CUDA graph can capture it)."""
    A = J[..., 0:3, 3:6]  # the Q_rho block beside the diagonal block D
    D = J[..., 0:3, 0:3]
    C = J[..., 6:9, 3:6]  # Q_nu
    Di = torch.linalg.inv_ex(D)[0]
    Z = torch.zeros_like(D)
    return _blocks3([[Di, -_mm(_mm(Di, A), Di), Z],
                     [Z, Di, Z],
                     [Z, -_mm(_mm(Di, C), Di), Di]])


def ljac_inv(tau):
    return _inv_blocks(ljac(tau))


def rjac_inv(tau):
    return _inv_blocks(rjac(tau))


def normalize(x):
    return _pack(_t(x), so3.normalize(_q(x)), _v(x))


def hat(tau):
    """5x5 Lie algebra element [[theta^, rho, nu], [0, 0, 0], [0, 0, 0]]."""
    rho, theta, nu = tau[..., 0:3], tau[..., 3:6], tau[..., 6:9]
    top = torch.cat([skew(theta), rho[..., None], nu[..., None]], dim=-1)
    bot = torch.zeros(top.shape[:-2] + (2, 5), dtype=tau.dtype, device=tau.device)
    return torch.cat([top, bot], dim=-2)


def random(generator, batch=(), dtype=torch.float64, device=None):
    batch = tuple(batch)
    return _pack(randn(generator, batch + (3,), dtype, device),
                 so3.random(generator, batch, dtype, device),
                 randn(generator, batch + (3,), dtype, device))


def is_valid(x, tol=1e-6):
    return so3.is_valid(_q(x), tol) & torch.all(torch.isfinite(x), dim=-1)


def interpolate(a, b, alpha):
    return compose(a, exp(alpha * log(compose(inverse(a), b))))


SE23 = LieGroup(
    name="SE23",
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

from . import register as _register  # noqa: E402

_register(SE23)
