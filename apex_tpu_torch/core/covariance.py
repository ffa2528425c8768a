"""Covariance estimation after convergence (counterpart of
``apex_tpu/core/covariance.py``): invert the undamped Gauss-Newton Hessian
H = J^T J at the solution and take each variable's diagonal block, in
tangent space.

The dense H^{-1} is O(D^2) memory, fine for small and medium problems;
``compute_covariances_for`` solves only the selected columns, and on
band-shaped problems never forms the dense H.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..linalg import banded
from ..linalg.banded import _cholesky
from ..linalg.dense import covariance_from_hessian
from .problem import CompiledProblem


def _global_free_mask(cp: CompiledProblem) -> torch.Tensor:
    """[D] 1.0 on free tangent columns, 0.0 on fixed ones."""
    free = torch.ones(cp.total_dof, dtype=cp.dtype, device=cp.device)
    for pool in cp.pools:
        cols = pool.cols[:, None] + torch.arange(pool.manifold.dof, device=cp.device)
        free[cols] = pool.free_mask
    return free


def _regularize_fixed(H, free):
    """Fixed DOF have zeroed Jacobian columns, so H is singular there; pin
    them with a unit diagonal so that the factorization succeeds. Their
    covariance is zeroed afterwards (a fixed variable has no uncertainty)."""
    return H * free[:, None] * free[None, :] + torch.diag(1.0 - free)


def _block_of(cp: CompiledProblem, name: str):
    """(first tangent column, dof) of a variable."""
    pid, row = cp.var_loc[name]
    return int(cp.host_pool_cols[pid][row]), cp.pools[pid].manifold.dof


def compute_covariances(
    cp: CompiledProblem, values, names: Optional[Sequence[str]] = None
) -> Dict[str, np.ndarray]:
    """Every variable's (or each of ``names``') covariance block from the
    dense inverse of H."""
    H, _, _ = cp.assemble_normal(values)
    free = _global_free_mask(cp)
    Sigma = covariance_from_hessian(_regularize_fixed(H, free))
    Sigma = Sigma * free[:, None] * free[None, :]
    out = {}
    for pid, pool in enumerate(cp.pools):
        dof = pool.manifold.dof
        picked = [(i, n) for i, n in enumerate(pool.names) if names is None or n in names]
        if not picked:
            continue
        rows = torch.as_tensor([i for i, _ in picked], device=cp.device)
        cols = pool.cols[rows][:, None] + torch.arange(dof, device=cp.device)
        blocks = Sigma[cols[:, :, None], cols[:, None, :]].cpu().numpy()
        for k, (_, n) in enumerate(picked):
            out[n] = blocks[k]
    return out


def compute_covariances_for(
    cp: CompiledProblem, values, names: Sequence[str]
) -> Dict[str, np.ndarray]:
    """Covariance blocks of the selected variables only: solve H X = E_i
    for their columns, O(D sum dof) instead of O(D^2).

    Band-shaped problems (block bandwidth within the panel budget) above
    4096 DOF never form the dense H: the block-tridiagonal storage is
    assembled once and every unit column is one banded solve, O(D W)
    memory."""
    D = cp.total_dof
    if banded.block_bandwidth(cp) <= banded.MAX_BANDWIDTH and D > 4096:
        return _banded_covariances_for(cp, values, names)
    H, _, _ = cp.assemble_normal(values)
    free = _global_free_mask(cp)
    L = _cholesky(_regularize_fixed(H, free))
    out = {}
    for n in names:
        c, dof = _block_of(cp, n)
        E = torch.zeros(D, dof, dtype=cp.dtype, device=cp.device)
        E[c + torch.arange(dof), torch.arange(dof)] = 1.0
        out[n] = torch.cholesky_solve(E, L)[c:c + dof].cpu().numpy()
    return out


def _banded_covariances_for(
    cp: CompiledProblem, values, names: Sequence[str]
) -> Dict[str, np.ndarray]:
    """Selected covariance blocks through the block-tridiagonal band: fixed
    DOF are pinned in band form (rows and columns zeroed, unit diagonal),
    then each requested unit column is one cyclic-reduction solve (the
    solver takes one right-hand side vector at a time)."""
    asm = banded.BandedNormalAssembler(cp)
    core = banded.make_blocktri_cr_core(cp.total_dof, asm.m, cp.dtype)
    D, m, n_blk, Dp = asm.D, asm.m, asm.n, asm.Dp
    Dg, Cg, _, _ = asm.assemble(values)
    Dg = asm.pad_diag_ones(Dg)
    free = _global_free_mask(cp)
    fb = torch.nn.functional.pad(free, (0, Dp - D), value=1.0).reshape(n_blk, m)
    fb_prev = torch.cat([fb[:1] * 0.0, fb[:-1]])
    Dg = Dg * fb[:, :, None] * fb[:, None, :]
    Dg = Dg + torch.diag_embed(1.0 - fb)
    Cg = Cg * fb[:, :, None] * fb_prev[:, None, :]

    out = {}
    for nme in names:
        c, dof = _block_of(cp, nme)
        cols = []
        for j in range(dof):
            e = torch.zeros(Dp, dtype=cp.dtype, device=cp.device)
            e[c + j] = 1.0
            cols.append(core(Dg, Cg, e.reshape(n_blk, m))[c:c + dof])
        fblk = free[c:c + dof]
        Sigma = torch.stack(cols, dim=1) * fblk[:, None] * fblk[None, :]
        out[nme] = Sigma.cpu().numpy()
    return out
