"""Small linear-algebra utilities (counterpart of ``apex_tpu/linalg/utils.py``)."""

from __future__ import annotations

import torch


def bmv(A, x):
    """Batched matrix-vector product [B, m, n] x [B, n] -> [B, m]."""
    return (A @ x[..., None])[..., 0]


def spd_clamped_inv(blocks, rel_floor=None):
    """Batched symmetric inverse with the eigenvalues clamped to a positive
    floor, so the result is SPD. The entity-merged Schur-Jacobi blocks can
    be indefinite, and PCG does not tolerate an indefinite preconditioner.
    The floors are the JAX package's (1e-6 relative in f32, 1e-12 in f64)."""
    if blocks.numel() == 0:
        return blocks
    if rel_floor is None:
        rel_floor = 1e-6 if blocks.dtype == torch.float32 else 1e-12
    w, V = torch.linalg.eigh(blocks)
    floor = torch.clamp_min(torch.amax(torch.abs(w), dim=-1, keepdim=True), 1.0)
    w = torch.maximum(w, rel_floor * floor)
    return (V / w[..., None, :]) @ V.transpose(-1, -2)
