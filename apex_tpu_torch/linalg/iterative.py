"""Matrix-free block-preconditioned CG on the Gauss-Newton normal equations
(counterpart of ``apex_tpu/linalg/iterative.py``).

H is never formed: per LM iteration the factor groups are linearized once,
their Jacobian blocks [K, d, dof_s] kept batched, and every CG iteration
computes

    H x = sum_k  P_k^T J_k^T (J_k P_k x)   (+ damping x)

as gathers, batched small products and ``index_add_`` sums: O(K) memory
instead of O(D^2). The preconditioner is the per-variable block diagonal of
H + damping I, inverted through ``spd_clamped_inv`` (outside the captured
graphs in jit mode: ``graphs.uncaptured``).

Select with ``linear_solver_type="pcg"`` on any optimizer config.
"""

from __future__ import annotations

import torch

from ..core.problem import CompiledProblem
from ..optim import graphs
from .utils import bmv as _bmv
from .utils import spd_clamped_inv


class IterativeNormalSolver:
    """The matrix-free normal-equation solve over a CompiledProblem."""

    def __init__(self, cp: CompiledProblem, max_iterations: int = 500,
                 tolerance: float = 1e-10, sync_free: bool = False):
        self.cp = cp
        self.sync_free = sync_free
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        # [K, dof_s] global tangent columns per group and slot
        self._cols = [[cp._slot_cols(grp, s) for s in range(len(grp.manifolds))]
                      for grp in cp.groups]
        # [N, dof] columns per pool, for the block preconditioner
        self._pool_cols = [
            pool.cols[:, None] + torch.arange(pool.manifold.dof, device=cp.device)
            for pool in cp.pools]

    def _linearize_all(self, values):
        """One linearization pass: per group the Jacobian blocks, with the
        gradient and the cost."""
        cp = self.cp
        g = torch.zeros(cp.total_dof, dtype=cp.dtype, device=cp.device)
        cost = torch.zeros((), dtype=cp.dtype, device=cp.device)
        blocks = []
        for grp, cols in zip(cp.groups, self._cols):
            r, jacs = cp.group_linearize(values, grp, True)
            cost = cost + 0.5 * torch.sum(r * r)
            for Js, c in zip(jacs, cols):
                g.index_add_(0, c.reshape(-1), _bmv(Js.mT, r).reshape(-1))
            blocks.append((grp, jacs, cols))
        return blocks, g, cost

    def _hx(self, blocks, x, damping):
        """H x + damping x from the factor-level products."""
        y = damping * x
        for _, jacs, cols in blocks:
            v = sum(_bmv(Js, x[c]) for Js, c in zip(jacs, cols))  # [K, d]
            for Js, c in zip(jacs, cols):
                y.index_add_(0, c.reshape(-1), _bmv(Js.mT, v).reshape(-1))
        return y

    def _block_diag_inv(self, blocks, damping):
        """Per-variable diagonal blocks of H + damping I, inverted."""
        cp = self.cp
        acc = []
        for pool in cp.pools:
            d = pool.manifold.dof
            eye = torch.eye(d, dtype=cp.dtype, device=cp.device)
            acc.append((damping * eye).expand(len(pool.names), d, d).contiguous())
        for grp, jacs, _ in blocks:
            for s, Js in enumerate(jacs):
                acc[grp.pool_ids[s]].index_add_(0, grp.indices[s], Js.mT @ Js)
        # eigh reads its error flag back: not capturable
        return [graphs.uncaptured(spd_clamped_inv, a) for a in acc]

    def _apply_prec(self, inv_blocks, x):
        y = torch.zeros_like(x)
        for cols, inv in zip(self._pool_cols, inv_blocks):
            y[cols] = _bmv(inv, x[cols])
        return y

    def solve(self, values, damping):
        """One damped solve: (dx, g, cost). Plain PCG from zero.

        The recurrence's inner products stay in the working dtype, as the
        JAX module's do (its Schur PCG accumulates them in f64; this solver
        does not), and its scalars stay on the device. Python mode reads
        one flag back per iteration, the convergence test. With
        ``sync_free`` (jit mode) the loop is ``graphs.while_update`` over
        chunks of ``graphs.PCG_CHUNK`` iterations, each masked by the
        device test (a finished PCG stays finished), and reads one flag per
        chunk: one captured chunk replayed on a card."""
        blocks, g, cost = self._linearize_all(values)
        inv_blocks = self._block_diag_inv(blocks, damping)
        b = -g
        tol2 = self.tolerance ** 2 * torch.dot(b, b)

        def iterate(x, r, p, rz, it):
            Sp = self._hx(blocks, p, damping)
            denom = torch.dot(p, Sp)
            alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
            x = x + alpha * p
            r = r - alpha * Sp
            z = self._apply_prec(inv_blocks, r)
            rz_new = torch.dot(r, z)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            return x, r, p * beta + z, rz_new, it + 1

        def more(x, r, p, rz, it):
            return (torch.dot(r, r) > tol2) & (it < self.max_iterations)

        z = self._apply_prec(inv_blocks, b)
        x, r, p, rz = torch.zeros_like(b), b, z, torch.dot(b, z)
        if not self.sync_free:
            state = (x, r, p, rz, 0)
            while bool(more(*state)):
                state = iterate(*state)
            return state[0], g, cost

        def chunk(*state):
            for _ in range(graphs.PCG_CHUNK):
                state = graphs.masked_update(more(*state), iterate, *state)
            return state

        it = torch.zeros((), dtype=torch.int64, device=b.device)
        x = graphs.while_update(more, chunk, -(-self.max_iterations // graphs.PCG_CHUNK),
                                x, r, p, rz, it)[0]
        return x, g, cost
