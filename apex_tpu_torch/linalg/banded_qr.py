"""Banded (block-tridiagonal) QR of pose-graph normal equations
(counterpart of ``apex_tpu/linalg/banded_qr.py``), the rank-robust
alternative to the cyclic-reduction Cholesky tier on the same storage.

With the trajectory ordering H is block-tridiagonal in bandwidth-sized
blocks, and its QR is a sequential sweep of small dense factorizations:

    step i:  [A_i; C_{i+1}]            = Q_i [R_ii; 0]      (complete QR)
             [R_{i,i+1}; A_{i+1}]      = Q_i^T [B_i; D_{i+1}]
             [R_{i,i+2}; B_{i+1}]      = Q_i^T [0;  C_{i+2}^T]
             [c_i;       b_{i+1}']     = Q_i^T [b_i; b_{i+1}]

where A and B carry the working diagonal and superdiagonal block. R has
exactly two block superdiagonals (step i fills column i+2 of row i and
nothing beyond), so the back substitution carries (x_{i+1}, x_{i+2}):

    x_i = R_ii^{-1} (c_i - R_{i,i+1} x_{i+1} - R_{i,i+2} x_{i+2})

Memory is O(n m^2), never the dense [D, D] H. QR solves (H + damping I)
dx = b without squaring the system a second time, so a singular H is fine
whenever damping > 0; at zero damping the escalating-shift ladder of the
Cholesky tiers takes over (``banded.shift_ladder``: in a jit step one
captured sweep, replayed per stage).

The sweep is sequential by nature: a Python loop of n small ``qr`` and
matrix products each way, so at small m the solve is bound by launches.
"""

from __future__ import annotations

import torch

from .banded import BASE_REG, damping_tensor, shift_ladder


def make_blocktri_qr_core(D: int, m: int, dtype):
    """Banded QR on block-tridiagonal storage: returns ``solve_blocks(Dg
    [n,m,m], Cg [n,m,m] (Cg[i] = A[i, i-1], Cg[0] zero), b [n,m], damping)
    -> x [n*m]`` solving (A + damping I) x = b. Same contract and attributes
    as ``banded.make_blocktri_cr_core``; ``linear_solver_type="sparse_qr"``
    uses it when the problem is band-shaped."""
    n = -(-D // m)

    def qr_once(Dgs, Cg, bv):
        if n == 1:
            q, r = torch.linalg.qr(Dgs[0], mode="complete")
            y = q.mT @ bv[0][:, None]
            return torch.linalg.solve_triangular(r, y, upper=True)[:, 0]

        eye = torch.eye(m, dtype=dtype, device=Dgs.device)
        zm = torch.zeros(m, m, dtype=dtype, device=Dgs.device)
        zv = torch.zeros(m, dtype=dtype, device=Dgs.device)
        CgT = Cg.mT
        # forward sweep; past the end the window is padded with [eye | 0]
        A, B, bi = Dgs[0], CgT[1], bv[0]
        Rii, R1, R2, c = [], [], [], []
        for i in range(n):
            last = i + 1 >= n
            c1 = zm if last else Cg[i + 1]           # H[i+1, i]
            dn = eye if last else Dgs[i + 1]         # H[i+1, i+1]
            c2t = CgT[i + 2] if i + 2 < n else zm    # H[i+1, i+2]
            bnx = zv if last else bv[i + 1]
            q, r = torch.linalg.qr(torch.cat([A, c1]), mode="complete")  # q [2m, 2m]
            # one product for the two block columns and the right-hand side
            w = q.mT @ torch.cat([torch.cat([B, zm, bi[:, None]], dim=1),
                                  torch.cat([dn, c2t, bnx[:, None]], dim=1)])
            Rii.append(r[:m])
            R1.append(w[:m, :m])
            R2.append(w[:m, m:2 * m])
            c.append(w[:m, 2 * m])
            A, B, bi = w[m:, :m], w[m:, m:2 * m], w[m:, 2 * m]

        x1 = x2 = zv
        xs = [None] * n
        for i in range(n - 1, -1, -1):
            rhs = c[i] - R1[i] @ x1 - R2[i] @ x2
            xi = torch.linalg.solve_triangular(Rii[i], rhs[:, None], upper=True)[:, 0]
            xs[i] = xi
            x1, x2 = xi, x1
        return torch.cat(xs)

    def solve_blocks(Dg0, Cg, bp, damping=None):
        damp = damping_tensor(damping, dtype, Dg0.device)
        eye = torch.eye(m, dtype=dtype, device=Dg0.device)
        trace_d = torch.diagonal(Dg0, dim1=-2, dim2=-1).sum() / D + damp
        dx = qr_once(Dg0 + damp * eye, Cg, bp)
        return shift_ladder(lambda reg: qr_once(Dg0 + (damp + reg) * eye, Cg, bp), dx,
                            BASE_REG * trace_d)[0]

    solve_blocks.block = m
    solve_blocks.n_blocks = n
    return solve_blocks
