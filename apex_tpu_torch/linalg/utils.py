"""Small linear-algebra utilities (counterpart of ``apex_tpu/linalg/utils.py``)."""

from __future__ import annotations

import numpy as np
import torch

# the batched SPD-clamped inverse: the CUDA kernel for a CUDA tensor, the
# plain eigh form on the CPU
from ..kernels.spd_inverse import spd_clamped_inv  # noqa: F401


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
