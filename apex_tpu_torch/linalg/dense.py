"""Dense linear solvers on the normal equations (counterpart of
``apex_tpu/linalg/dense.py``): LM's default ``dense_cholesky`` and its
``dense_qr``. Both solve the damped system (H + damping I) dx = -g;
``covariance_from_hessian`` inverts H for the covariance blocks.

A Cholesky that fails gives NaN, never an exception (``banded._cholesky``:
``cholesky_ex`` with NaN where ``info != 0``), and the retry ladder
(``graphs.ladder``) tests ``isfinite(dx)``: one read-back per test, or in a
captured jit step a branch between graphs.
"""

from __future__ import annotations

import torch

from ..optim.graphs import ladder
from .banded import BASE_REG, RETRY_STAGES, _cholesky


def _eye(A):
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def _cho_solve(A, b):
    return torch.cholesky_solve(b[:, None], _cholesky(A))[:, 0]


def solve_cholesky(H, g, damping=None):
    """Solve (H + damping I) dx = -g by Cholesky; returns dx."""
    if damping is not None:
        H = H + damping * _eye(H)
    return _cho_solve(H, -g)


def solve_cholesky_with_retry(H, g, damping=None):
    """Cholesky solve; while dx is not finite, solve again with the diagonal
    shifted by BASE_REG·trace(H + damping I)/D, then 100x more per stage,
    RETRY_STAGES times at most."""
    eye = _eye(H)
    Hd = H + damping * eye if damping is not None else H

    def retry(stage, dx, reg):
        reg = BASE_REG * torch.trace(Hd) / H.shape[0] if stage == 0 else reg * 100.0
        return _cho_solve(Hd + reg * eye, -g), reg

    dx = _cho_solve(Hd, -g)
    reg = torch.zeros((), dtype=H.dtype, device=H.device)
    return ladder(lambda dx, reg: ~torch.isfinite(dx).all(), retry, RETRY_STAGES, dx, reg)[0]


def solve_qr(r, J, damping=None):
    """Least-squares step from the QR of the damped stacked Jacobian
    [J; sqrt(damping) I]: min ||J dx + r||^2 + damping ||dx||^2."""
    if damping is not None:
        J = torch.cat([J, damping ** 0.5 * _eye(J)])
        r = torch.cat([r, r.new_zeros(J.shape[1])])
    Q, R = torch.linalg.qr(J)
    return torch.linalg.solve_triangular(R, -(Q.mT @ r)[:, None], upper=True)[:, 0]


def covariance_from_hessian(H):
    """H^{-1} by a Cholesky solve against the identity; NaN where H is not
    positive definite."""
    return torch.cholesky_solve(_eye(H), _cholesky(H))
