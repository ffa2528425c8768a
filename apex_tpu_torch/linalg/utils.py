"""Small linear-algebra utilities (counterpart of ``apex_tpu/linalg/utils.py``)."""

from __future__ import annotations

import numpy as np
import torch


def sparse_to_dense(rows, cols, vals, shape):
    """COO triplets -> dense matrix (duplicates accumulate), on the device
    and in the dtype of ``vals``."""
    vals = torch.as_tensor(vals)
    M = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    rows = torch.as_tensor(rows, device=vals.device).long()
    cols = torch.as_tensor(cols, device=vals.device).long()
    return M.index_put_((rows, cols), vals, accumulate=True)


def dense_to_sparse(M, threshold: float = 0.0):
    """Dense matrix -> COO triplets, dropping |v| <= threshold. Host-side
    (numpy, int32 indices): sparsity patterns are static metadata."""
    M = M.detach().cpu().numpy() if isinstance(M, torch.Tensor) else np.asarray(M)
    rows, cols = np.nonzero(np.abs(M) > threshold)
    return rows.astype(np.int32), cols.astype(np.int32), M[rows, cols]


def block_diag_matvec(blocks, bases, x):
    """y = blockdiag(blocks) @ x where blocks[i] [d, d] sits at row and
    column bases[i]."""
    d = blocks.shape[-1]
    cols = bases.long()[:, None] + torch.arange(d, device=x.device)
    y = torch.zeros_like(x)
    return y.index_put_((cols,), bmv(blocks, x[cols]), accumulate=True)


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
