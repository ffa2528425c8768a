"""Banded normal equations of pose graphs, solved by block cyclic
reduction (counterpart of ``apex_tpu/linalg/banded.py``).

With the trajectory ordering every edge of a SLAM pose graph couples
tangent columns fewer than ``W`` apart (odometry: neighbours; loop
closures: ring to ring). In blocks of ``m >= W`` columns the normal matrix
is then block-tridiagonal, and

- ``BandedNormalAssembler`` writes J^T J and J^T r of every edge straight
  into block-tridiagonal storage ``[Dg (n*m*m) | Cg (n*m*m) | g (Dp) | dump]``
  with one host-planned sorted gather and one ``index_add_`` (the dense
  [D, D] matrix never exists);
- ``make_blocktri_cr_core`` solves it by cyclic reduction: each level
  eliminates every odd block at once with one batched Cholesky, one batched
  triangular solve on ``[C_j | C_{j+1}^T | b_j]`` and one Gram product, and
  the last ~1.5k DOF are folded into one dense Cholesky.

A failed Cholesky gives NaN for its batch entry, never an exception: the
5-stage retry ladder tests the solve's ``isfinite``. The refinement gate
and the ladder are ``graphs.cond_update`` / ``graphs.ladder``, the
reference's ``lax.cond`` and ``while_loop``: a host read each in python
mode, IF nodes of a captured jit step on a card. Spans named
``banded.*`` and ``cr.*`` (``utils.profiling.span``) mark the layers for
the tracer and ``torch.profiler``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..optim import graphs
from ..optim.graphs import cond_update, ladder, while_update
from ..utils.profiling import span

# Widest block bandwidth the banded path takes; above it LM's sparse_cholesky
# switches to the general-sparsity tier (linalg/sparse_general.py).
MAX_BANDWIDTH = 1536
# The retry ladder: first shift BASE_REG * mean(diag), then 100x per stage.
BASE_REG = 1e-10
RETRY_STAGES = 5
# One refinement pass when a solve's residual exceeds this share of ||b||.
REFINE_RTOL = {torch.float64: 1e-10, torch.float32: 2e-5}

# CR solves, refinement passes and retry stages run since import (or since a
# caller last set them to 0), counted where they run (``graphs.count``): in
# python mode as the code runs, in a captured jit solve from the device
# counts of the IF and WHILE nodes that ran them; never in the warm-up.
cr_solves = 0
cr_refines = 0
cr_retries = 0


def default_panel(W: int) -> int:
    """Block size for bandwidth W: multiples of 128 from W = 128 on, a tight
    multiple of 8 below (at least 8)."""
    if W >= 128:
        return int(-(-W // 128) * 128)
    return int(max(8, -(-W // 8) * 8))


def block_bandwidth(cp) -> int:
    """Smallest W such that every nonzero H[r, c] of the problem's factor
    blocks has |r - c| < W (tangent columns), from the host copies of the
    column arrays."""
    W = 1
    for g, host_cols in zip(cp.groups, cp.host_group_cols):
        dofs = [m.dof for m in g.manifolds]
        cols = [np.asarray(c, dtype=np.int64) for c in host_cols]
        for a in range(len(dofs)):
            W = max(W, dofs[a])
            for b in range(len(dofs)):
                if a == b or cols[a].size == 0:
                    continue
                # max over factors of (last row of block a) - (first col of b)
                W = max(W, int((cols[a] + dofs[a] - 1 - cols[b]).max()) + 1)
    return W


# The widest matrix that _cholesky hands to one cuSOLVER potrf in a step
# that is captured. A wider potrf (the 20^3 lattice's 20,262-column core)
# calls cuBLAS through a handle of cuSOLVER's own, which allocates memory
# inside a CUDA graph capture, and a conditional node's body can hold no
# allocation; so there a wider matrix is factored by panels of this width.
# chip_smoke.py's capture_census phase checks both on the card.
CHOLESKY_PANEL = 8192


def _cholesky(A):
    """Lower Cholesky factor of the symmetrized A, batched; a batch entry
    that is not positive definite comes back all NaN. A single CUDA matrix
    wider than ``CHOLESKY_PANEL`` in a step being captured (or warmed up for
    it) is factored by panels (``cholesky_panels``); eager calls, python
    mode's, take one potrf at any width. The NaN goes in in place: the
    20^3 lattice's factor alone is 3.3 GB in f64."""
    if (A.dim() == 2 and A.shape[-1] > CHOLESKY_PANEL and A.device.type == "cuda"
            and graphs.recording()):
        return cholesky_panels((A + A.mT) / 2)
    L, info = torch.linalg.cholesky_ex((A + A.mT) / 2)
    return L.masked_fill_((info != 0)[..., None, None], torch.nan)


def cholesky_panels(S, panel=CHOLESKY_PANEL):
    """The lower Cholesky factor of the symmetric matrix S, overwritten in
    place, by panels of ``panel`` columns, right-looking: each panel's
    diagonal block by ``cholesky_ex``, the panel below it by a triangular
    solve, the trailing matrix updated by one matrix product, every call
    through PyTorch's own cuBLAS handle; all NaN where S is not positive
    definite."""
    n = S.shape[-1]
    bad = torch.zeros((), dtype=torch.bool, device=S.device)
    for j in range(0, n, panel):
        e = min(j + panel, n)
        Ljj, info = torch.linalg.cholesky_ex(S[j:e, j:e])
        bad = bad | (info != 0)
        S[j:e, j:e] = Ljj
        if e < n:
            L21 = torch.linalg.solve_triangular(Ljj.mT, S[e:, j:e], upper=True, left=False)
            S[e:, j:e] = L21
            S[e:, e:].addmm_(L21, L21.mT, alpha=-1.0)
    return S.tril_().masked_fill_(bad, torch.nan)


def cho_solve(L, B):
    """(L L^T)^{-1} B from the lower factor L: what ``torch.cholesky_solve``
    computes, as two triangular solves. On the card those go to cuBLAS
    through PyTorch's handle, whose workspace is set; cuSOLVER's ``potrs``
    calls cuBLAS through a handle of its own without one, which allocates
    inside a CUDA graph capture, and a conditional node's body can hold no
    allocation."""
    return torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, B, upper=False), upper=True)


def damping_tensor(damping, dtype, device):
    """The damping as a 0-d tensor of ``dtype``: a device tensor passes (jit
    mode), a number or None (zero) becomes a fill, not a host-to-device
    copy, which capture forbids."""
    if isinstance(damping, torch.Tensor):
        return damping.to(dtype)
    return torch.full((), 0.0 if damping is None else damping, dtype=dtype, device=device)


def shift_ladder(attempt, x, first_shift, stages=RETRY_STAGES):
    """The reference's retry ``while_loop`` (``graphs.while_update``): while
    ``x`` is not finite, ``x = attempt(reg)`` with ``reg = first_shift``,
    then 100x per stage, ``stages`` times at most. -> (x, the stages run as
    a 0-d int64 tensor)."""
    def body(x, reg, stage):
        reg = torch.where(stage == 0, first_shift, reg * 100.0)
        return attempt(reg), reg, stage + 1

    stage = torch.zeros((), dtype=torch.int64, device=x.device)
    x, _, stage = while_update(lambda x, reg, stage: ~torch.isfinite(x).all(), body, stages,
                               x, torch.zeros_like(first_shift), stage)
    return x, stage


def make_blocktri_cr_core(D: int, m: int, dtype, base_blocks: int | None = None,
                          recompute_l0: bool | None = None,
                          retry_rtol: float | None = None):
    """Block cyclic reduction on block-tridiagonal storage: returns
    ``solve_blocks(Dg [n,m,m], Cg [n,m,m] (Cg[i] = A[i, i-1], Cg[0] zero),
    b [n,m], damping) -> x [n*m]`` solving (A + damping I) x = b.

    - ``base_blocks``: stop eliminating at this many block rows and solve
      them as one dense Cholesky (default: a ~1.5k-DOF core).
    - ``recompute_l0``: drop the level-0 factors and recompute them in the
      back substitution (default: when they would take over 128 MB).
    - one refinement pass when the residual exceeds ``REFINE_RTOL``·||b||
      (1e-10 in f64, 2e-5 in f32);
    - the retry ladder: while the step is not finite or its residual exceeds
      ``retry_rtol``·||b|| (1e-8 / 3e-4), solve again with the diagonal
      shifted by BASE_REG·mean(diag), then 100x more, RETRY_STAGES times at
      most.

    Each level reads back nothing; a solve reads back one flag for the
    refinement and one per retry test. ``damping`` is a number or a 0-d
    tensor."""
    n = -(-D // m)
    f64 = dtype == torch.float64
    if base_blocks is None:
        base_blocks = max(2, 1536 // m)
    if recompute_l0 is None:
        recompute_l0 = 3 * (n // 2) * m * m * (8 if f64 else 4) > 128 * 2**20
    refine_rtol = REFINE_RTOL[dtype]
    if retry_rtol is None:
        retry_rtol = 1e-8 if f64 else 3e-4

    def _elim_factors(Dg, Cg, bv):
        """(L, U) of one level's odd-block elimination, U = L^{-1} [C_j |
        C_{j+1}^T | b_j] in one triangular solve."""
        L = _cholesky(Dg[1::2])
        Cn = torch.cat([Cg[2::2], Cg.new_zeros(1, m, m)])
        rhs = torch.cat([Cg[1::2], Cn.mT, bv[1::2, :, None]], dim=2)
        return L, torch.linalg.solve_triangular(L, rhs, upper=False)

    def _odd_pad(Dg, Cg, bv):
        eye = torch.eye(m, dtype=Dg.dtype, device=Dg.device)[None]
        return (torch.cat([Dg, eye]), torch.cat([Cg, Cg.new_zeros(1, m, m)]),
                torch.cat([bv, bv.new_zeros(1, m)]))

    def solve_once(Dg, Cg, bv):
        args0 = (Dg, Cg, bv)
        levels = []
        with span("cr.eliminate"):
            while Dg.shape[0] > base_blocks:
                padded = Dg.shape[0] % 2 == 1
                if padded:
                    Dg, Cg, bv = _odd_pad(Dg, Cg, bv)
                L, U = _elim_factors(Dg, Cg, bv)
                # one Gram product carries X^T X, Y^T Y, Y^T X, X^T b, Y^T b
                G = U.mT @ U
                De = Dg[0::2] - G[:, :m, :m]
                De[1:] -= G[:-1, m:2 * m, m:2 * m]
                Ce = torch.zeros_like(De)
                Ce[1:] = -G[:-1, m:2 * m, :m]
                be = bv[0::2] - G[:, :m, 2 * m]
                be[1:] -= G[:-1, m:2 * m, 2 * m]
                levels.append(("recompute", padded) if not levels and recompute_l0
                              else (L, U))
                Dg, Cg, bv = De, Ce, be
        with span("cr.dense_fold"):
            nb = Dg.shape[0]
            idx = torch.arange(nb, device=Dg.device)
            A4 = Dg.new_zeros(nb, m, nb, m)
            A4[idx, :, idx, :] = Dg
            if nb > 1:
                A4[idx[1:], :, idx[:-1], :] = Cg[1:]
                A4[idx[:-1], :, idx[1:], :] = Cg[1:].mT
            Lc = _cholesky(A4.reshape(nb * m, nb * m))
            xe = cho_solve(Lc, bv.reshape(-1, 1)).reshape(nb, m)
        with span("cr.back_substitute"):
            for entry in reversed(levels):
                if entry[0] == "recompute":
                    d0, c0, b0 = _odd_pad(*args0) if entry[1] else args0
                    L, U = _elim_factors(d0, c0, b0)
                else:
                    L, U = entry
                nb_ = U.shape[0]
                xnext = torch.cat([xe[1:], xe.new_zeros(1, m)])[:nb_]
                # z = beta - X xe - Y xnext in one batched matvec over [X | Y]
                v = torch.cat([xe[:nb_], xnext], dim=1)
                z = U[:, :, 2 * m] - (U[:, :, :2 * m] @ v[..., None])[..., 0]
                xo = torch.linalg.solve_triangular(L.mT, z[..., None], upper=True)[..., 0]
                x = xe.new_empty(2 * nb_, m)
                x[0::2] = xe[:nb_]
                x[1::2] = xo
                xe = x
        return xe.reshape(-1)[:n * m]

    def solve_blocks(Dg0, Cg, bp, damping=None):
        graphs.count(globals(), "cr_solves")
        damp = damping_tensor(damping, dtype, Dg0.device)
        # mean diagonal magnitude for the retry ladder's first shift
        trace_d = torch.diagonal(Dg0, dim1=-2, dim2=-1).sum() / D + damp
        eye = torch.eye(m, dtype=dtype, device=Dg0.device)
        bb = torch.sum(bp * bp)

        def residual2(Dgs, x):
            with span("cr.residual"):
                xb = x.reshape(n, m, 1)
                hx = (Dgs @ xb)[..., 0]
                hx[1:] += (Cg[1:] @ xb[:-1])[..., 0]
                hx[:-1] += (Cg[1:].mT @ xb[1:])[..., 0]
                res = bp - hx
                return res, torch.sum(res * res)

        def attempt(shift):
            """Solve the shift-damped system: (x, squared residual of x in
            that same system)."""
            Dgs = Dg0 + shift * eye
            x = solve_once(Dgs, Cg, bp)
            res, res2 = residual2(Dgs, x)

            def refine(x, res, res2):
                graphs.count(globals(), "cr_refines")
                with span("cr.refine"):
                    x = x + solve_once(Dgs, Cg, res)
                    return (x, *residual2(Dgs, x))

            x, res, res2 = cond_update(res2 > refine_rtol ** 2 * bb, refine, x, res, res2)
            return x, res2

        bad2 = retry_rtol ** 2 * bb

        def retry(stage, x, res2, reg):
            graphs.count(globals(), "cr_retries")
            reg = BASE_REG * trace_d if stage == 0 else reg * 100.0
            with span("cr.retry"):
                return (*attempt(damp + reg), reg)

        x, res2 = attempt(damp)
        reg = torch.zeros((), dtype=dtype, device=Dg0.device)
        return ladder(lambda x, res2, reg: ~torch.isfinite(x).all() | (res2 > bad2),
                      retry, RETRY_STAGES, x, res2, reg)[0]

    levels, nn = 0, n
    while nn > base_blocks:
        nn, levels = -(-nn // 2), levels + 1
    solve_blocks.block = m
    solve_blocks.n_blocks = n
    solve_blocks.levels = levels  # elimination levels before the dense fold
    return solve_blocks


def make_blocktri_cr_solver(D: int, W: int, dtype, base_blocks: int | None = None):
    """Dense-H front end of ``make_blocktri_cr_core``: ``solve(H, g,
    damping)`` takes the block-tridiagonal band of H and returns the
    solution of (H + damping I) dx = -g, in blocks of ``default_panel(W)``.
    A standalone solve leaves the residual retry gate off (retries only on a
    non-finite step): it wants the unbiased answer, not a silently
    regularized one."""
    m = default_panel(W)
    n = -(-D // m)
    pad = n * m - D
    core = make_blocktri_cr_core(D, m, dtype, base_blocks=base_blocks,
                                 retry_rtol=float("inf"))

    def solve(H, g, damping=None):
        Hp = torch.nn.functional.pad(H, (0, pad, 0, pad))
        if pad:
            prows = torch.arange(D, D + pad, device=H.device)
            Hp[prows, prows] = 1.0
        bp = torch.nn.functional.pad(-g, (0, pad)).reshape(n, m)
        H4 = Hp.reshape(n, m, n, m)
        idx = torch.arange(n, device=H.device)
        Dg = H4[idx, :, idx, :]
        Cg = torch.cat([H4.new_zeros(1, m, m), H4[idx[1:], :, idx[:-1], :]])
        return core(Dg, Cg, bp, damping)[:D]

    solve.block = m
    solve.n_blocks = n
    return solve


def band_plan(slot_specs, m, n, g_base, dump):
    """Host-side destination plan for band assembly. ``slot_specs`` is an
    iterable of (dofs, cols) per factor group, where cols[s] is the [K]
    numpy array of global tangent columns for slot s. Returns (perm, ids)
    as int32 numpy arrays: emit values group-by-group (g entries then the
    s x t Hessian blocks, C-order), gather by perm, segment-sum with ids."""
    nmm = n * m * m
    dests = []
    for dofs, cols in slot_specs:
        cols = [np.asarray(c, dtype=np.int64) for c in cols]
        for s_ in range(len(dofs)):
            rows_g = cols[s_][:, None] + np.arange(dofs[s_])
            dests.append((g_base + rows_g).reshape(-1))
            for t_ in range(len(dofs)):
                r_ = (cols[s_][:, None, None] + np.arange(dofs[s_])[None, :, None])
                c_ = (cols[t_][:, None, None] + np.arange(dofs[t_])[None, None, :])
                r_, c_ = np.broadcast_arrays(r_, c_)
                pr, pc = r_ // m, c_ // m
                flat = np.where(
                    pr == pc, pr * m * m + (r_ % m) * m + (c_ % m),
                    np.where(pr == pc + 1,
                             nmm + pr * m * m + (r_ % m) * m + (c_ % m),
                             dump),
                )
                dests.append(flat.reshape(-1))
    all_dest = np.concatenate(dests)
    perm = np.argsort(all_dest, kind="stable")
    return perm.astype(np.int32), all_dest[perm].astype(np.int32)


def band_values(cp, values, groups=None, weights=None):
    """The values ``band_plan`` places, in its emission order (per group:
    per slot s, J_s^T r, then J_s^T J_t for each t), and the total cost.
    ``groups`` replaces ``cp.groups`` (a rank's factor rows); ``weights``,
    one [K] tensor per group, scales each linearized row (0 drops the
    padding rows of a sharded group)."""
    vals = []
    cost = torch.zeros((), dtype=cp.dtype, device=cp.device)
    groups = cp.groups if groups is None else groups
    for gi, g in enumerate(groups):
        r, jacs = cp.group_linearize(values, g, True)
        if weights is not None:
            r = r * weights[gi][:, None]
            jacs = [j * weights[gi][:, None, None] for j in jacs]
        cost = cost + 0.5 * torch.sum(r * r)
        for Js in jacs:
            JsT = Js.mT
            vals.append((JsT @ r[..., None]).reshape(-1))
            for Jt in jacs:
                vals.append((JsT @ Jt).reshape(-1))
    return torch.cat(vals), cost


class BandedNormalAssembler:
    """Assemble the normal equations of a banded problem straight into
    block-tridiagonal storage. One host-planned destination per emitted
    value covers every Hessian block and the gradient in the buffer

        [ Dg (n*m*m) | Cg (n*m*m) | g (Dp) | dump (1) ]

    (upper-panel entries, the transposes of Cg, land in the dump slot). At
    run time: batched linearization, one gather by the plan's permutation,
    one ``index_add_`` with the sorted int64 destinations."""

    def __init__(self, cp, block: int | None = None):
        W = block_bandwidth(cp)
        m = block if block is not None else default_panel(W)
        if W > m:
            raise ValueError(f"block {m} smaller than bandwidth {W}")
        D = cp.total_dof
        n = -(-D // m)
        Dp = n * m
        self.cp, self.m, self.n, self.D, self.Dp, self.W = cp, m, n, D, Dp, W
        nmm = n * m * m
        self.g_base = 2 * nmm
        dump = 2 * nmm + Dp
        self.n_segments = dump + 1
        perm, ids = band_plan(
            [([mf.dof for mf in g.manifolds], cols)
             for g, cols in zip(cp.groups, cp.host_group_cols)],
            m, n, self.g_base, dump)
        self._perm = torch.from_numpy(perm.astype(np.int64)).to(cp.device)
        self._ids = torch.from_numpy(ids.astype(np.int64)).to(cp.device)

    def assemble(self, values):
        """-> (Dg [n,m,m], Cg [n,m,m], g [D], cost), views of one new buffer."""
        cp, m, n = self.cp, self.m, self.n
        with span("banded.linearize"):
            vals, cost = band_values(cp, values)
        with span("banded.assemble"):
            buf = torch.zeros(self.n_segments, dtype=cp.dtype, device=cp.device)
            buf.index_add_(0, self._ids, vals[self._perm])
        nmm = n * m * m
        Dg = buf[:nmm].view(n, m, m)
        Cg = buf[nmm:2 * nmm].view(n, m, m)
        return Dg, Cg, buf[self.g_base:self.g_base + self.D], cost

    def pad_diag_ones(self, Dg):
        """Add 1 to the padding tail of the last diagonal block, in place,
        so that the empty rows factor; returns Dg."""
        pad = self.Dp - self.D
        if pad:
            k = torch.arange(self.D % self.m, self.m, device=Dg.device)
            Dg[self.n - 1, k, k] += 1.0
        return Dg
