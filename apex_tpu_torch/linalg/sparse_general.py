"""General-sparsity block Cholesky by independent-set elimination
(counterpart of ``apex_tpu/linalg/sparse_general.py``).

High-treewidth graphs (the grid3D lattice, city10000) defeat the banded
tier: reverse Cuthill-McKee still leaves a 20x20x20 grid with a bandwidth
of about 2,400 columns. This tier generalizes the banded tier's block
cyclic reduction to any pattern, by multicolour block elimination. Each
level

1. picks a greedy min-degree maximal independent set I of the remaining
   block graph (host-side, symbolic, once per problem);
2. eliminates every v in I with one batched Cholesky [p, d, d], one
   batched triangular solve for W = U L^-T over the stacked neighbour
   couplings U_v = [H[u1,v]; ...; H[uq,v]] ([p, q*d, d]), and one batched
   Gram product W W^T;
3. subtracts the q x q fill blocks from a flat block store with one
   ``index_add_`` into slots allocated symbolically.

Elimination stops when the remaining core is small or dense, and the core
is one dense Cholesky. Back substitution replays the levels in reverse.
Mixed-DOF variables are padded to the largest block DOF with
identity-pinned diagonals; a Cholesky that fails gives NaN and the 5-stage
retry ladder reads ``isfinite(x)``, one read-back per attempt: a host read
in python mode, a WHILE node over one captured elimination in a jit step
(``graphs.while_update``). Spans named ``general.*`` mark the layers for
the tracer and ``torch.profiler``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..optim import graphs
from ..utils.profiling import span
from .banded import BASE_REG, _cholesky, cho_solve, damping_tensor, shift_ladder

# Solves, retry-ladder attempts and dense core factorizations run since
# import (or since a caller last set them to 0), and the columns of those
# factorizations summed (a core's width is ``general_core_cols /
# general_core_factors``), counted where they run (``graphs.count``): in
# python mode as the code runs, in a captured jit solve from the device
# counts of the graphs and WHILE trips that ran them; never in the warm-up.
general_solves = 0
general_retries = 0
general_core_factors = 0
general_core_cols = 0

# ---------------------------------------------------------------------------
# Host-side symbolic analysis
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Level:
    picked: np.ndarray  # [p] block ids eliminated this level
    nbrs: np.ndarray  # [p, q] neighbour block ids, -1 padded
    # compact plan for the q*q fill/update blocks:
    perm: Optional[np.ndarray]  # argsort of flat LOCAL destinations
    idx: np.ndarray  # sorted local destination ids (incl. trash segment)
    # gather slots for U (orientation (u, v)) and diag of picked
    u_slots: np.ndarray  # [p, q] slot ids of H[u, v]; dump for padding
    diag_slots: np.ndarray  # [p]
    upd_slots: Optional[np.ndarray] = None  # [n_u] global slots updated


def _greedy_min_degree_is(adj, alive, deg_cap):
    """Greedy maximal independent set preferring low degree; only vertices
    with degree <= deg_cap are eligible (high-degree vertices wait:
    eliminating them early would densify the graph). Ties fall in the
    set's iteration order, as in the JAX package."""
    order = sorted((v for v in alive if len(adj[v]) <= deg_cap),
                   key=lambda v: len(adj[v]))
    picked, blocked = [], set()
    for v in order:
        if v in blocked:
            continue
        picked.append(v)
        blocked.add(v)
        blocked.update(adj[v])
    return picked


class BlockGraphSymbolic:
    """Host-side elimination plan for a block graph."""

    def __init__(self, nv, edges, deg_cap=24, base_cap=512, max_levels=64,
                 min_picked=32):
        # adjacency sets
        adj = [set() for _ in range(nv)]
        for a, b in edges:
            if a != b:
                adj[a].add(b)
                adj[b].add(a)
        self.nv = nv

        # slot ids for every (i, j) block that ever exists, both
        # orientations (transpose-free gathers for 2x the block memory)
        slot_of = {}

        def slot(i, j):
            key = (i, j)
            s = slot_of.get(key)
            if s is None:
                s = len(slot_of)
                slot_of[key] = s
                slot_of[(j, i)] = s + 1 if i != j else s
                if i != j:
                    return s
            return s

        for i in range(nv):
            slot(i, i)
        for a, b in edges:
            if a != b:
                slot(a, b)
        self.n_orig_slots = len(slot_of)

        alive = set(range(nv))
        self.levels: List[_Level] = []
        for _ in range(max_levels):
            if len(alive) <= base_cap:
                break
            # eliminate only low-degree vertices and stop when none remain:
            # on mesh-like graphs the survivors are the top separators,
            # which the dense core factors faster than fine-grained
            # elimination would (and fill stays ~4x)
            picked = _greedy_min_degree_is(adj, alive, deg_cap)
            # trailing micro-levels of a handful of vertices each: the
            # dense core absorbs them more cheaply than batched ops on p~1
            if not picked or (len(picked) < min_picked
                              and len(alive) <= 2 * base_cap):
                break
            q = max(len(adj[v]) for v in picked)
            p = len(picked)
            nbrs = np.full((p, q), -1, dtype=np.int64)
            for k, v in enumerate(picked):
                ns = sorted(adj[v])
                nbrs[k, :len(ns)] = ns
            # fill edges + slot allocation for all (u, w) destinations
            dests = np.empty((p, q, q), dtype=np.int64)
            u_slots = np.empty((p, q), dtype=np.int64)
            for k, v in enumerate(picked):
                ns = sorted(adj[v])
                for a_i, u in enumerate(ns):
                    u_slots[k, a_i] = slot_of[(u, v)]
                    adj[u].discard(v)
                u_slots[k, len(ns):] = -2  # padding marker
                for a_i, u in enumerate(ns):
                    for b_i, w in enumerate(ns):
                        if u != w and w not in adj[u]:
                            adj[u].add(w)
                            adj[w].add(u)
                            slot(u, w)
                        dests[k, a_i, b_i] = slot_of[(u, w)]
                    dests[k, a_i, len(ns):] = -2
                dests[k, len(ns):, :] = -2
                adj[v].clear()
                alive.discard(v)
            self.levels.append(_Level(
                picked=np.asarray(picked, dtype=np.int64),
                nbrs=nbrs, perm=None, idx=dests,  # finalized below
                u_slots=u_slots,
                diag_slots=np.asarray([slot_of[(v, v)] for v in picked],
                                      dtype=np.int64),
            ))
        self.remaining = sorted(alive)
        self.slot_of = slot_of
        self.n_slots = len(slot_of)
        self.dump = self.n_slots  # one trash slot
        # finalize each level's plan: its unique destination slots, and the
        # flat (p, q, q) positions sorted by destination
        for lv in self.levels:
            d = lv.idx.reshape(-1)  # -2 marks padding
            uniq = np.unique(d[d >= 0])
            local = np.searchsorted(uniq, np.where(d >= 0, d, uniq[0] if uniq.size else 0))
            local = np.where(d >= 0, local, uniq.size)  # padding -> trash seg
            perm = np.argsort(local, kind="stable")
            lv.perm = perm.astype(np.int32)
            lv.idx = local[perm].astype(np.int32)
            lv.upd_slots = uniq.astype(np.int32)
            lv.u_slots = np.where(lv.u_slots == -2, self.dump, lv.u_slots)

    @property
    def n_levels(self):
        return len(self.levels)

    def fill_ratio(self):
        return self.n_slots / max(self.n_orig_slots, 1)


# ---------------------------------------------------------------------------
# Device solver over a CompiledProblem
# ---------------------------------------------------------------------------


class GeneralSparseCholesky:
    """Direct solve of the damped normal equations for any factor-graph
    sparsity: block values assembled straight from the batched
    linearization with one ``index_add_`` each for H and g, then the
    independent-set elimination plan. Every plan tensor is moved to the
    problem's device once, here.

    Applicability: ``suitable(cp)`` (block count within the symbolic
    budget) before the symbolic phase, ``healthy()`` (bounded fill, a
    dense core of at most 24,576 DOF) after it."""

    MAX_BLOCKS = 40_000
    MAX_FILL_RATIO = 40.0
    MAX_CORE_DOF = 24_576

    def __init__(self, cp, deg_cap=24, base_cap=512, min_picked=32):
        self.cp = cp
        nv, dof_arr, col_arr, edges = self._block_graph(cp)
        self.nv = nv
        self.dmax = int(dof_arr.max()) if nv else 1
        self.dof_arr = dof_arr
        self.col_arr = col_arr
        self.sym = BlockGraphSymbolic(nv, edges, deg_cap=deg_cap,
                                      base_cap=base_cap,
                                      min_picked=min_picked)
        self._build_assembly_plan()
        self._build_core_plan()
        dev = cp.device
        # ladder stages run, over every solve, counted on the device
        self._retry_stages = torch.zeros((), dtype=torch.int64, device=dev)

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)

        self._levels_dev = []
        for lv in self.sym.levels:
            n_upd = lv.upd_slots.size
            valid = lv.idx < n_upd  # padding positions sort last
            self._levels_dev.append(dict(
                picked=on_dev(lv.picked),
                nbrs=on_dev(np.where(lv.nbrs < 0, nv, lv.nbrs)),
                u_slots=on_dev(lv.u_slots),
                diag_slots=on_dev(lv.diag_slots),
                # the fill blocks' flat (p, q, q) positions and their slots
                rows=on_dev(lv.perm[valid]),
                dest=on_dev(lv.upd_slots[lv.idx[valid]]),
            ))

    # -- host structure ----------------------------------------------------

    @staticmethod
    def _block_graph(cp):
        """Blocks = variables; ids ordered by tangent column (so the
        layout permutation, name or RCM, is respected)."""
        entries = []  # (col, dof, pid, row)
        for pid, pool in enumerate(cp.pools):
            for row, c in enumerate(cp.host_pool_cols[pid]):
                entries.append((int(c), pool.manifold.dof, pid, row))
        entries.sort()
        nv = len(entries)
        col_arr = np.asarray([e[0] for e in entries], dtype=np.int64)
        dof_arr = np.asarray([e[1] for e in entries], dtype=np.int64)

        col_to_block = {int(c): i for i, c in enumerate(col_arr)}
        edges = set()
        for gi, g in enumerate(cp.groups):
            slot_blocks = [np.asarray([col_to_block[int(c)] for c in cols_s])
                           for cols_s in cp.host_group_cols[gi]]
            for a in range(len(slot_blocks)):
                for b in range(a + 1, len(slot_blocks)):
                    for u, v in zip(slot_blocks[a].tolist(),
                                    slot_blocks[b].tolist()):
                        if u != v:
                            edges.add((min(u, v), max(u, v)))
        return nv, dof_arr, col_arr, sorted(edges)

    @classmethod
    def suitable(cls, cp) -> bool:
        """Cheap pre-check (without running the symbolic phase): block
        count within budget."""
        return sum(len(p.names) for p in cp.pools) <= cls.MAX_BLOCKS

    def healthy(self) -> bool:
        """Post-symbolic check: elimination reached a dense-solvable core
        with bounded fill."""
        return (self.sym.fill_ratio() <= self.MAX_FILL_RATIO
                and len(self.sym.remaining) * self.dmax <= self.MAX_CORE_DOF)

    def _build_assembly_plan(self):
        """Destinations at block granularity, in ``assemble``'s emission
        order (group, s, t): one slot id per J_s^T J_t block and one block
        id per J_s^T r row; the diagonal pin and the padding mask."""
        cp, d = self.cp, self.dmax
        col_to_block = {int(c): i for i, c in enumerate(self.col_arr)}
        slot_of = self.sym.slot_of
        h_dest, g_dest = [], []
        for gi, g in enumerate(cp.groups):
            blocks = [np.asarray([col_to_block[int(c)] for c in cols_s])
                      for cols_s in cp.host_group_cols[gi]]
            for s in range(len(blocks)):
                g_dest.append(blocks[s])
                for t in range(len(blocks)):
                    h_dest.append(np.asarray(
                        [slot_of.get((int(a), int(b)), self.sym.dump)
                         for a, b in zip(blocks[s], blocks[t])], dtype=np.int64))
        empty = np.zeros(0, dtype=np.int64)
        dev = cp.device
        self._h_dest = torch.from_numpy(np.concatenate(h_dest) if h_dest else empty).to(dev)
        self._g_dest = torch.from_numpy(np.concatenate(g_dest) if g_dest else empty).to(dev)
        # diagonal pinning: padded dims of each block diag get +1
        real = np.arange(d)[None, :] < self.dof_arr[:, None]  # [nv, d]
        self._diag_pin = torch.from_numpy((~real).astype(np.float64)).to(
            device=dev, dtype=cp.dtype)
        self._diag_slots_all = torch.from_numpy(np.asarray(
            [self.sym.slot_of[(i, i)] for i in range(self.nv)], dtype=np.int64)).to(dev)
        # blocks are sorted by column and tile [0, D): the real entries of
        # the flat [nv * d] block vector are the tangent vector in order
        if not np.array_equal((self.col_arr[:, None] + np.arange(d))[real],
                              np.arange(cp.total_dof)):
            raise ValueError("variable blocks do not tile the tangent columns")
        self._real = torch.from_numpy(np.flatnonzero(real.reshape(-1))).to(dev)

    def _build_core_plan(self):
        """Dense core: the remaining blocks packed into an [R*dmax, R*dmax]
        matrix, each block placed by (block row, block column, slot)."""
        rem = self.sym.remaining
        base_rank = {v: i for i, v in enumerate(rem)}
        ij = []  # (block row i, block col j, slot)
        for (u, w), s in self.sym.slot_of.items():
            i = base_rank.get(u)
            j = base_rank.get(w)
            if i is not None and j is not None:
                ij.append((i, j, s))
        ij.sort()
        core = np.asarray(ij, dtype=np.int64).reshape(-1, 3)
        dev = self.cp.device
        self._core_i, self._core_j, self._core_slots = (
            torch.from_numpy(np.ascontiguousarray(core[:, k])).to(dev) for k in range(3))
        self._base_ids = torch.from_numpy(np.asarray(rem, dtype=np.int64)).to(dev)
        self.R = len(rem)

    # -- device numerics ---------------------------------------------------

    def assemble(self, values):
        """-> (B [n_slots+1, dmax, dmax], gv [nv, dmax], cost): per group,
        the batched linearization's J_s^T J_t and J_s^T r padded to dmax,
        each summed into place with one ``index_add_``."""
        cp, d = self.cp, self.dmax
        pad = torch.nn.functional.pad
        with span("general.assemble"):
            cost = torch.zeros((), dtype=cp.dtype, device=cp.device)
            h_rows, g_rows = [], []
            for g in cp.groups:
                r, jacs = cp.group_linearize(values, g, True)
                cost = cost + 0.5 * torch.sum(r * r)
                dofs = [m.dof for m in g.manifolds]
                for s, Js in enumerate(jacs):
                    JsT = Js.mT
                    g_rows.append(pad((JsT @ r[..., None])[..., 0], (0, d - dofs[s])))
                    for t, Jt in enumerate(jacs):
                        Hb = pad(JsT @ Jt, (0, d - dofs[t], 0, d - dofs[s]))
                        h_rows.append(Hb.reshape(-1, d * d))
            B = torch.zeros(self.sym.n_slots + 1, d * d, dtype=cp.dtype, device=cp.device)
            B.index_add_(0, self._h_dest, torch.cat(h_rows))
            gv = torch.zeros(self.nv, d, dtype=cp.dtype, device=cp.device)
            gv.index_add_(0, self._g_dest, torch.cat(g_rows))
        return B.view(-1, d, d), gv, cost

    def _solve_once(self, B, bv, shift):
        """One elimination + back-substitution pass on copies of B and bv
        ([nv, d]); ``shift`` is the total diagonal shift (damping + retry
        regularization). Returns x [nv, d]."""
        d, nv = self.dmax, self.nv
        eye = torch.eye(d, dtype=B.dtype, device=B.device)
        B = B.clone()
        # damp + pin diagonal blocks (padded dims get identity)
        diag_add = shift * (1.0 - self._diag_pin) + self._diag_pin
        B.index_add_(0, self._diag_slots_all, diag_add[:, :, None] * eye)
        # keep the dump slot zero so padded gathers read zeros
        B[self.sym.dump].zero_()
        # the last row takes the padded neighbours' updates
        b = torch.cat([bv, bv.new_zeros(1, d)])

        stash = []
        with span("general.eliminate"):
            for lv in self._levels_dev:
                L = _cholesky(B[lv["diag_slots"]])  # [p, d, d]
                U = B[lv["u_slots"]]  # [p, q, d, d] = H[u, v] blocks
                p, q = U.shape[0], U.shape[1]
                # W = U L^-T and beta = L^-1 b_v
                W = torch.linalg.solve_triangular(L.mT, U.reshape(p, q * d, d), upper=True,
                                                  left=False)
                beta = torch.linalg.solve_triangular(L, b[lv["picked"]][..., None], upper=False)
                G = W @ W.mT  # [p, q*d, q*d]
                contrib = G.view(p, q, d, q, d).transpose(2, 3).reshape(-1, d * d)
                B.view(-1, d * d).index_add_(0, lv["dest"], contrib[lv["rows"]], alpha=-1)
                # b_u -= W_u beta
                b.index_add_(0, lv["nbrs"].reshape(-1), (W @ beta).view(-1, d), alpha=-1)
                stash.append((L, W, beta[..., 0]))

        x = B.new_zeros(nv + 1, d)
        if self.R:
            graphs.count(globals(), "general_core_factors")
            graphs.count(globals(), "general_core_cols", self.R * d)
            with span("general.core"):
                R = self.R
                A = B.new_zeros(R, d, R, d)
                A[self._core_i, :, self._core_j, :] = B[self._core_slots]
                Lc = _cholesky(A.view(R * d, R * d))
                xb = cho_solve(Lc, b[self._base_ids].reshape(-1, 1))
                x[self._base_ids] = xb.view(R, d)

        with span("general.back_substitute"):
            for lv, (L, W, beta) in zip(reversed(self._levels_dev), reversed(stash)):
                xn = x[lv["nbrs"]]  # [p, q, d]
                p, q = xn.shape[0], xn.shape[1]
                z = beta - (W.mT @ xn.view(p, q * d, 1))[..., 0]
                x[lv["picked"]] = torch.linalg.solve_triangular(
                    L.mT, z[..., None], upper=True)[..., 0]
        return x[:nv]

    def solve_blocks(self, B, gv, damping=None):
        """Solve (H + damping I) x = -g from assembled blocks with the
        escalating-regularization retry ladder. Returns x [total_dof].

        In f32 the first attempt carries a shift floor of 1e-7 x the mean
        diagonal: at auto damping's late-phase mu (~1e-11 x the largest
        diagonal) the elimination's f32 rounding leaves the gauge-deficient
        separator core indefinite, and every LM iteration would otherwise
        climb the ladder. The ladder (``banded.shift_ladder``, the
        reference's ``while_loop``) starts at 1e-6 (f32) or BASE_REG (f64)
        x the mean diagonal and multiplies by 100 per stage, RETRY_STAGES
        stages at most, one read of ``isfinite(x)`` per attempt; its stages
        are counted on the device. ``damping`` may be a 0-d device tensor
        (jit mode)."""
        graphs.count(globals(), "general_solves")
        dt = B.dtype
        f32 = dt == torch.float32
        damp = damping_tensor(damping, dt, B.device)
        bv = -gv
        diagB = B[self._diag_slots_all]
        trace_d = (torch.diagonal(diagB, dim1=-2, dim2=-1).sum(-1).sum()
                   / max(self.cp.total_dof, 1) + damp)
        floor = trace_d * 1e-7 if f32 else torch.zeros((), dtype=dt, device=B.device)
        x = self._solve_once(B, bv, damp + floor)

        def retry(reg):
            graphs.count(globals(), "general_retries")
            with span("general.retry"):
                return self._solve_once(B, bv, damp + reg)

        x, stages = shift_ladder(retry, x, (1e-6 if f32 else BASE_REG) * trace_d)
        if not graphs.warming_up():
            self._retry_stages += stages
        return x.reshape(-1)[self._real]

    @property
    def retry_stages(self) -> int:
        """Ladder stages run, over every solve (one read of the device
        count)."""
        return int(self._retry_stages)

    def solve(self, values, damping=None):
        """assemble + solve; -> (dx [D], g [D], cost)."""
        B, gv, cost = self.assemble(values)
        dx = self.solve_blocks(B, gv, damping)
        return dx, gv.reshape(-1)[self._real], cost
