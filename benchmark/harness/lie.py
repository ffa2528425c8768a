"""SO(3) and SE(3) in plain PyTorch, for the benchmark's generators and its
reference solver. Storage and conventions are those the solver's users see:

- a rotation is a unit quaternion ``[w, x, y, z]`` with ``w >= 0`` after
  normalization; a pose is ``[tx, ty, tz, qw, qx, qy, qz]``;
- a tangent vector is ``[rho, theta]`` (translation part first);
- ``exp([rho, theta]) = (V(theta) rho, Exp(theta))`` with V the left
  Jacobian of SO(3), and ``plus(x, tau) = x * exp(tau)`` (right plus).

Small angles switch to Taylor series below ``theta^2 < 1e-10`` (f64) or
``1e-6`` (f32). Every function is batched over leading dimensions and
differentiable, so the reference takes Jacobians by ``torch.func``.
"""

from __future__ import annotations

import torch


def _small(dtype) -> float:
    return 1e-6 if dtype == torch.float32 else 1e-10


def skew(v):
    """(..., 3) -> (..., 3, 3) with skew(v) @ w = v x w."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_rotate(q, v):
    """R(q) v, as v + 2 w (u x v) + 2 u x (u x v) with u the vector part."""
    u, w = q[..., 1:], q[..., :1]
    u, v = torch.broadcast_tensors(u, v)
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    one = torch.ones_like(w)
    return torch.stack([
        torch.stack([one - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), one - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), one - 2 * (x * x + y * y)], -1),
    ], -2)


def quat_normalize(q):
    """Unit norm, sign chosen so that w >= 0."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def mat_to_quat(R):
    """Rotation matrix -> unit quaternion with w >= 0: of the four
    Shepperd candidates the one with the largest pivot among (trace, R00,
    R11, R22), the first on ties."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    piv = torch.stack([tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1)

    def half_root(x):
        return torch.sqrt(torch.clamp_min(x, 1e-30)) / 2.0

    a = half_root(1.0 + tr)
    b = half_root(1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2])
    c = half_root(1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2])
    d = half_root(1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2])
    s21, s02, s10 = m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]
    p01, p02, p12 = m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0], m[..., 1, 2] + m[..., 2, 1]
    cands = torch.stack([
        torch.stack([a, s21 / (4 * a), s02 / (4 * a), s10 / (4 * a)], -1),
        torch.stack([s21 / (4 * b), b, p01 / (4 * b), p02 / (4 * b)], -1),
        torch.stack([s02 / (4 * c), p01 / (4 * c), c, p12 / (4 * c)], -1),
        torch.stack([s10 / (4 * d), p02 / (4 * d), p12 / (4 * d), d], -1),
    ], -2)
    idx = torch.argmax(piv, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    return quat_normalize(q)


def so3_exp(theta):
    t2 = torch.sum(theta * theta, -1)
    small = t2 < _small(theta.dtype)
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    k = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * t) / t)
    w = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * t))
    return torch.cat([w[..., None], k[..., None] * theta], -1)


def so3_log(q):
    q = torch.where(q[..., :1] < 0, -q, q)
    w, v = q[..., 0], q[..., 1:]
    n2 = torch.sum(v * v, -1)
    small = n2 < 0.25 * _small(q.dtype)
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    w_safe = torch.where(torch.abs(w) < 1e-30, torch.ones_like(w), w)
    k = torch.where(small, (2.0 / w_safe) * (1.0 - n2 / (3.0 * w_safe * w_safe)),
                    2.0 * torch.atan2(n, w) / n)
    return k[..., None] * v


def _coeffs(theta):
    """(theta^2, B = (1 - cos t)/t^2, C = (t - sin t)/t^3, D) with D the
    [theta]x^2 coefficient of the inverse left Jacobian."""
    t2 = torch.sum(theta * theta, -1)
    small = t2 < _small(theta.dtype)
    s2 = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(s2)
    B = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - torch.cos(t)) / s2)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0, (t - torch.sin(t)) / (s2 * t))
    D = torch.where(small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                    (1.0 - t * torch.sin(t) / (2.0 * (1.0 - torch.cos(t)))) / s2)
    return t2, B, C, D


def so3_ljac(theta):
    _, B, C, _ = _coeffs(theta)
    S = skew(theta)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye + B[..., None, None] * S + C[..., None, None] * (S @ S)


def so3_ljac_inv(theta):
    _, _, _, D = _coeffs(theta)
    S = skew(theta)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye - 0.5 * S + D[..., None, None] * (S @ S)


def se3_compose(a, b):
    return torch.cat([a[..., :3] + quat_rotate(a[..., 3:], b[..., :3]),
                      quat_mul(a[..., 3:], b[..., 3:])], -1)


def se3_inverse(x):
    qi = quat_conj(x[..., 3:])
    return torch.cat([-quat_rotate(qi, x[..., :3]), qi], -1)


def se3_between(a, b):
    """a^-1 * b."""
    return se3_compose(se3_inverse(a), b)


def se3_exp(tau):
    rho, theta = tau[..., :3], tau[..., 3:]
    return torch.cat([(so3_ljac(theta) @ rho[..., None])[..., 0], so3_exp(theta)], -1)


def se3_log(x):
    theta = so3_log(x[..., 3:])
    return torch.cat([(so3_ljac_inv(theta) @ x[..., :3, None])[..., 0], theta], -1)


def se3_plus(x, tau):
    """x * exp(tau), the quaternion renormalized with w >= 0."""
    y = se3_compose(x, se3_exp(tau))
    return torch.cat([y[..., :3], quat_normalize(y[..., 3:])], -1)
