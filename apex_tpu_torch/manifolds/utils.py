"""Shared numerical helpers for the Lie groups (counterpart of
``apex_tpu/manifolds/utils.py``).

Every function broadcasts over leading batch dimensions. Small-angle branches
are selected with ``torch.where`` over "safe" denominators, so neither branch
produces a NaN. Quaternions are w-first Hamilton ``[w, x, y, z]``.
"""

from __future__ import annotations

import torch

# theta^2 switch between exact formulas and Taylor expansions (the
# reference's 1e-10, an angle of ~1e-5 rad), loosened in f32 where 1e-10 is
# below the usable precision of the exact branch.
SMALL_ANGLE_THRESHOLD = 1e-10
SMALL_ANGLE_THRESHOLD_F32 = 1e-6


def small_angle_threshold(dtype) -> float:
    return SMALL_ANGLE_THRESHOLD_F32 if dtype == torch.float32 else SMALL_ANGLE_THRESHOLD


def skew(v):
    """Hat operator for R^3: (..., 3) -> (..., 3, 3) with skew(v) @ w = v x w."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_mul(q1, q2):
    """Hamilton product (..., 4) x (..., 4) -> (..., 4)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_mat(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    one = torch.ones_like(w)
    return torch.stack(
        [
            torch.stack([one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def quat_rotate(q, v):
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def mat_to_quat(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.

    Shepperd-style: four candidate constructions, the one with the largest
    pivot is taken (first on ties, as ``jnp.argmax``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp_min(x, 1e-30)) / 2.0

    qw_a = root(1.0 + tr)
    q_a = torch.stack(
        [qw_a, (m21 - m12) / (4 * qw_a), (m02 - m20) / (4 * qw_a), (m10 - m01) / (4 * qw_a)],
        dim=-1,
    )
    qx_b = root(1.0 + m00 - m11 - m22)
    q_b = torch.stack(
        [(m21 - m12) / (4 * qx_b), qx_b, (m01 + m10) / (4 * qx_b), (m02 + m20) / (4 * qx_b)],
        dim=-1,
    )
    qy_c = root(1.0 - m00 + m11 - m22)
    q_c = torch.stack(
        [(m02 - m20) / (4 * qy_c), (m01 + m10) / (4 * qy_c), qy_c, (m12 + m21) / (4 * qy_c)],
        dim=-1,
    )
    qz_d = root(1.0 - m00 - m11 + m22)
    q_d = torch.stack(
        [(m10 - m01) / (4 * qz_d), (m02 + m20) / (4 * qz_d), (m12 + m21) / (4 * qz_d), qz_d],
        dim=-1,
    )

    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    qs = torch.stack([q_a, q_b, q_c, q_d], dim=-2)  # (..., 4, 4)
    gather_idx = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(qs, -2, gather_idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# Small-angle coefficient functions of theta2 = theta^2 (Taylor-switched).
# ---------------------------------------------------------------------------


def _switch(theta2, exact_fn, taylor):
    small = theta2 < small_angle_threshold(theta2.dtype)
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    return torch.where(small, taylor, exact_fn(safe_t2))


def cosc_b(theta2):
    """B(theta) = (1 - cos(theta)) / theta^2."""
    taylor = 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0
    return _switch(theta2, lambda t2: (1.0 - torch.cos(torch.sqrt(t2))) / t2, taylor)


def sinc3_c(theta2):
    """C(theta) = (theta - sin(theta)) / theta^3."""
    taylor = 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0

    def exact(t2):
        t = torch.sqrt(t2)
        return (t - torch.sin(t)) / (t2 * t)

    return _switch(theta2, exact, taylor)


def jlinv_d(theta2):
    """D(theta) = 1/theta^2 - (1 + cos(theta)) / (2 theta sin(theta)), the
    skew^2 coefficient of the inverse left/right Jacobian of SO(3)."""
    taylor = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0

    def exact(t2):
        t = torch.sqrt(t2)
        return 1.0 / t2 - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t))

    return _switch(theta2, exact, taylor)
