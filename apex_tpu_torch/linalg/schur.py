"""Schur-complement solver for bundle adjustment (counterpart of the block
path of ``apex_tpu/linalg/schur.py``).

Landmarks (``pt_*``-named R^3 variables) are eliminated and the reduced
camera system

    S = H_cc - W Hpp^{-1} W^T,      S dxc = -g_c + W Hpp^{-1} g_p
    dxp = Hpp^{-1} (-g_p - W^T dxc)

is solved in one of two ways. ``variant="iterative"`` (implicit): matrix-free
PCG with the Schur-Jacobi block preconditioner; S is never formed.
``variant="sparse"`` (explicit): the dense S is built from the pairs of
observations that share a landmark, enumerated once per problem, and solved
by a Cholesky factorization with the retry ladder; right for reduced
systems of a few thousand camera DOF. The global sparse H is never formed.

Per factor group the linearization gives one merged camera-entity Jacobian
``Jc [K, d, De]`` (every camera slot of a factor lies in one entity), from
which come batched ``H_cc`` entity blocks ``[E, De, De]``, landmark blocks
``Hpp [P, 3, 3]`` and per-observation couplings ``W [K, De, 3]``; every sum
over observations is one ``index_add_``. The landmark blocks are inverted by the CUDA kernel of
``kernels/landmark_blocks.py`` for a CUDA tensor.

LM damping is added to H_cc's diagonal and to the Hpp blocks, the latter
floored by ``pp_shift_floor`` (1e-4 in f32), in both variants.

``index_add_`` on CUDA sums with atomics in no fixed order, so results
differ from the JAX package's sorted segment sums, and from run to run, by
rounding.

Damping and the LM iteration may be device tensors (jit mode). The
explicit variant's retry ladder is ``graphs.ladder``; with ``sync_free``
(jit mode) PCG's continue flag is a ``graphs.cond_update`` per
``graphs.PCG_CHUNK`` iterations, each iteration masked by a done flag that
freezes once set, as the reference's ``while_loop``; the preconditioner's
``eigh`` runs outside captured graphs (``graphs.uncaptured``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..core.problem import CompiledProblem
from ..kernels.landmark_blocks import invert_landmark_blocks
from ..optim import graphs
from .dense import solve_cholesky_with_retry
from .utils import bmv as _bmv
from .utils import spd_clamped_inv


def landmark_inverse(Hpp):
    """Regularized inverse of the landmark blocks: the CUDA kernel for a
    CUDA tensor, f32 or f64 at any size; the plain version on the CPU."""
    return invert_landmark_blocks(Hpp)


def _dot64(a, b):
    """Inner product accumulated in f64 (PCG recurrence scalars are the
    first thing f32 noise corrupts); a 0-d f64 tensor on the device."""
    return torch.dot(a.reshape(-1).to(torch.float64), b.reshape(-1).to(torch.float64))


def enumerate_pairs(lm_of_coupling):
    """For every ordered pair of couplings (A, B), in row-major order, the
    index pairs (ia, ib) of observations of A and of B that see the same
    landmark: the per-landmark outer products of the explicit variant,
    enumerated once over entity blocks. ``lm_of_coupling[i]`` is the host
    array of landmark ids of coupling i; the result is a list of
    ``(ia, ib)`` int64 numpy arrays.

    Both sides are sorted by landmark; a landmark seen na times in A and nb
    times in B contributes the na x nb grid of its two segments."""
    P = max((int(ids.max()) + 1 for ids in lm_of_coupling if ids.size), default=0)
    orders = [np.argsort(ids, kind="stable") for ids in lm_of_coupling]
    counts = [np.bincount(ids, minlength=P) for ids in lm_of_coupling]
    starts = [np.cumsum(c) - c for c in counts]
    pairs = []
    for a in range(len(lm_of_coupling)):
        for b in range(len(lm_of_coupling)):
            na, nb = counts[a], counts[b]
            per_lm = na * nb
            total = int(per_lm.sum())
            # landmark of each pair, and the pair's rank within its landmark
            lm = np.repeat(np.arange(P, dtype=np.int64), per_lm)
            rank = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(per_lm) - per_lm, per_lm)
            nb_lm = nb[lm]  # positive wherever a pair exists
            ia = orders[a][starts[a][lm] + rank // nb_lm]
            ib = orders[b][starts[b][lm] + rank % nb_lm]
            pairs.append((ia.astype(np.int64), ib.astype(np.int64)))
    return pairs


@dataclasses.dataclass
class _GroupPlan:
    """Device index tensors of one factor group."""

    group_idx: int
    cam_slots: tuple  # slots whose variables are kept (camera side)
    lm_slot: Optional[int]  # the eliminated slot, if any
    ent: Optional[torch.Tensor]  # [K] camera-entity id per factor
    cam_cols: List[torch.Tensor]  # per cam slot, [K, ds] columns in Jc
    lm: Optional[torch.Tensor]  # [K] landmark id per factor


class SchurContext:
    """Elimination structure, assembly and the damped solve over a
    CompiledProblem. Landmark variables are those whose name starts with
    ``eliminate_prefix`` and that live on a 3-DOF Euclidean manifold."""

    def __init__(
        self,
        cp: CompiledProblem,
        eliminate_prefix: str = "pt_",
        variant: str = "iterative",
        preconditioner: str = "schur_jacobi",  # none | block_diagonal | schur_jacobi
        pcg_max_iterations: int = 200,
        pcg_tolerance: float = 1e-6,
        pcg_forcing: bool = True,
        pp_shift_floor: Optional[float] = None,
        pcg_q_tolerance: Optional[float] = None,
        sync_free: bool = False,
    ):
        if variant not in ("sparse", "iterative"):
            raise ValueError(f"unknown Schur variant {variant!r}; 'sparse' or 'iterative'")
        if preconditioner not in ("none", "block_diagonal", "schur_jacobi"):
            raise ValueError(f"unknown preconditioner {preconditioner!r}")
        self.cp = cp
        self.variant = variant
        self.sync_free = sync_free
        self.preconditioner = preconditioner
        self.pcg_max_iterations = pcg_max_iterations
        self.pcg_tolerance = pcg_tolerance
        self.pcg_forcing = pcg_forcing
        # Nash-Sofer Q-stagnation termination; None disables it.
        self.pcg_q_tol = pcg_q_tolerance
        f32 = cp.dtype == torch.float32
        # f32 PCG stagnates around 1e-5 relative residual; asking for less
        # burns the whole iteration budget on every LM iteration.
        self.pcg_rtol_floor = max(pcg_tolerance, 3e-5) if f32 else pcg_tolerance
        # Landmark-block shift floor, decoupled from LM damping: when the
        # damping collapses, weakly observed landmarks get huge steps that
        # overwhelm f32. It bounds ||dxp_k|| <= ||g_k|| / floor.
        if pp_shift_floor is None:
            pp_shift_floor = 1e-4 if f32 else 0.0
        self.pp_shift_floor = pp_shift_floor

        dev = cp.device
        D = cp.total_dof
        host_pool_cols = cp.host_pool_cols

        def gcols(gi, slot):
            return cp.host_group_cols[gi][slot]

        # --- classify variables --------------------------------------------
        # a landmark's first global column -> its landmark id (else -1)
        lm_id_arr = np.full(D, -1, dtype=np.int64)
        P = 0
        for pid, pool in enumerate(cp.pools):
            if pool.manifold.dof != 3 or pool.manifold.storage_dim != 3:
                continue
            rows = np.asarray([i for i, n in enumerate(pool.names)
                               if n.startswith(eliminate_prefix)], dtype=np.int64)
            if rows.size == 0:
                continue
            lm_id_arr[host_pool_cols[pid][rows]] = P + np.arange(rows.size)
            P += rows.size
        self.num_landmarks = P
        if P == 0:
            raise ValueError(
                f"Schur solver found no landmark variables (prefix "
                f"{eliminate_prefix!r} on R3 manifolds)")

        # --- camera-side entities --------------------------------------------
        # Union-find over kept variables linked by a factor that binds two
        # kept slots: in BA, pose_i <-> intr_i. H_cc is block diagonal over
        # these entities, laid out entity-major with uniform width De.
        cam_vars = []  # (global_col, dof)
        for pid, pool in enumerate(cp.pools):
            cols = host_pool_cols[pid]
            keep = lm_id_arr[cols] < 0
            cam_vars.extend((int(c), pool.manifold.dof) for c in cols[keep])
        cam_vars.sort()
        parent = {c: c for c, _ in cam_vars}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for gi, g in enumerate(cp.groups):
            cam_slots = [s for s in range(len(g.manifolds))
                         if g.count and lm_id_arr[gcols(gi, s)[0]] < 0]
            for ai in range(len(cam_slots)):
                for bi in range(ai + 1, len(cam_slots)):
                    pairs = np.unique(np.stack(
                        [gcols(gi, cam_slots[ai]), gcols(gi, cam_slots[bi])], axis=1), axis=0)
                    for pa, pb in pairs.tolist():
                        ra, rb = find(int(pa)), find(int(pb))
                        if ra != rb:
                            parent[ra] = rb

        dof_of = dict(cam_vars)
        members = {}
        for c, _ in cam_vars:
            members.setdefault(find(c), []).append(c)
        entities = sorted((sorted(v) for v in members.values()), key=lambda m: m[0])
        De = max((sum(dof_of[c] for c in m) for m in entities), default=0)
        E = len(entities)

        red_of_global = np.full(D, -1, dtype=np.int64)
        real_mask = np.zeros(E * De, dtype=np.float64)
        for e, m in enumerate(entities):
            off = 0
            for c in m:
                d = dof_of[c]
                red_of_global[c: c + d] = e * De + off + np.arange(d)
                real_mask[e * De + off: e * De + off + d] = 1.0
                off += d
        self.num_entities = E
        self.entity_dof = De
        self.Dc = E * De
        self.red_of_global = red_of_global
        # padded entity dims get 1.0 on the diagonal: non-singular blocks
        # with a zero right-hand side there
        self._pad_diag = torch.as_tensor((1.0 - real_mask).reshape(E, De),
                                         dtype=cp.dtype, device=dev)
        self.pcg_iter_cap = int(min(pcg_max_iterations, max(self.Dc, 1)))

        # --- per-group plans -------------------------------------------------
        def long(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        self.plans: List[_GroupPlan] = []
        for gi, g in enumerate(cp.groups):
            cam_slots, lm_slots = [], []
            for s in range(len(g.manifolds)):
                is_lm = lm_id_arr[gcols(gi, s)] >= 0
                if is_lm.all():
                    lm_slots.append(s)
                elif (~is_lm).all():
                    cam_slots.append(s)
                else:
                    raise ValueError(
                        "factor group slot mixes eliminated and kept variables; "
                        "name landmarks uniformly (pt_*)")
            if len(lm_slots) > 1:
                raise ValueError("factors binding >1 landmark are not Schur-eliminable")
            ent, cam_cols = None, []
            for s in cam_slots:
                base = red_of_global[gcols(gi, s)]
                ent_s = base // De
                if ent is None:
                    ent = ent_s
                elif not (ent_s == ent).all():
                    raise AssertionError("camera slots of one factor span entities")
                loc = base - ent_s * De
                cam_cols.append(long(loc[:, None] + np.arange(g.manifolds[s].dof)))
            lm_slot = lm_slots[0] if lm_slots else None
            self.plans.append(_GroupPlan(
                group_idx=gi,
                cam_slots=tuple(cam_slots),
                lm_slot=lm_slot,
                ent=None if ent is None else long(ent),
                cam_cols=cam_cols,
                lm=None if lm_slot is None else long(lm_id_arr[gcols(gi, lm_slot)]),
            ))
        # groups coupling cameras and landmarks, in the order of Ws
        self.couplings = [p for p in self.plans if p.cam_slots and p.lm_slot is not None]

        # --- reduced <-> global layout ----------------------------------------
        kept = np.nonzero(red_of_global >= 0)[0]
        self._kept = long(kept)
        self._kept_red = long(red_of_global[kept])
        starts = np.nonzero(lm_id_arr >= 0)[0]
        self._lm_cols3 = long(starts[:, None] + np.arange(3))
        self._lm_ids_of_cols = long(lm_id_arr[starts])

        # --- pair enumeration of the explicit variant --------------------------
        self._lm_host = [lm_id_arr[gcols(p.group_idx, p.lm_slot)] for p in self.couplings]
        self.pair_indices = None
        if variant == "sparse":
            self._enumerate_pairs()

    def _enumerate_pairs(self):
        dev = self.cp.device
        self.pair_indices = [
            (torch.as_tensor(ia, device=dev), torch.as_tensor(ib, device=dev))
            for ia, ib in enumerate_pairs(self._lm_host)]

    def with_variant(self, variant: str) -> "SchurContext":
        """This context's structure under another variant, without a second
        structure analysis (``schur_auto`` reads ``Dc`` first)."""
        if variant not in ("sparse", "iterative"):
            raise ValueError(f"unknown Schur variant {variant!r}; 'sparse' or 'iterative'")
        other = copy.copy(self)
        other.variant = variant
        if variant == "sparse" and other.pair_indices is None:
            other._enumerate_pairs()
        return other

    # ------------------------------------------------------------------

    def _pp_shift(self, damping):
        """LM damping floored by the landmark regularization floor (a number
        or a 0-d tensor, as ``damping``)."""
        if self.pp_shift_floor > 0.0:
            if isinstance(damping, torch.Tensor):
                return torch.clamp_min(damping, self.pp_shift_floor)
            return max(damping, self.pp_shift_floor)
        return damping

    def assemble(self, values, damping=None):
        """Linearize every group; return (Hcc [E, De, De], gc [Dc],
        Hpp [P, 3, 3], gp [P, 3], Ws, cost). ``Ws[i]`` is the [K, De, 3]
        coupling of ``couplings[i]``."""
        cp = self.cp
        dt, dev = cp.dtype, cp.device
        E, De, P = self.num_entities, self.entity_dof, self.num_landmarks
        Hcc = torch.zeros((E, De, De), dtype=dt, device=dev)
        gc = torch.zeros((E, De), dtype=dt, device=dev)
        Hpp = torch.zeros((P, 3, 3), dtype=dt, device=dev)
        gp = torch.zeros((P, 3), dtype=dt, device=dev)
        cost = torch.zeros((), dtype=dt, device=dev)
        Ws = []
        for plan in self.plans:
            g = cp.groups[plan.group_idx]
            r, jacs = cp.group_linearize(values, g, True)
            cost = cost + 0.5 * torch.sum(r * r)
            if plan.cam_slots:
                Jc = torch.zeros((g.count, g.residual_dim, De), dtype=dt, device=dev)
                for s, cols in zip(plan.cam_slots, plan.cam_cols):
                    Jc.scatter_(2, cols[:, None, :].expand(-1, g.residual_dim, -1), jacs[s])
                JcT = Jc.transpose(1, 2)
                Hcc.index_add_(0, plan.ent, JcT @ Jc)
                gc.index_add_(0, plan.ent, _bmv(JcT, r))
            if plan.lm_slot is not None:
                Jl = jacs[plan.lm_slot]
                JlT = Jl.transpose(1, 2)
                Hpp.index_add_(0, plan.lm, JlT @ Jl)
                gp.index_add_(0, plan.lm, _bmv(JlT, r))
                if plan.cam_slots:
                    Ws.append(JcT @ Jl)

        eye = torch.eye(De, dtype=dt, device=dev)
        Hcc = Hcc + self._pad_diag[:, :, None] * eye
        if damping is not None:
            Hcc = Hcc + damping * eye
            Hpp = Hpp + self._pp_shift(damping) * torch.eye(3, dtype=dt, device=dev)
        return Hcc, gc.reshape(-1), Hpp, gp, Ws, cost

    def _hcc_matvec(self, Hcc, x):
        return _bmv(Hcc, x.reshape(self.num_entities, self.entity_dof)).reshape(-1)

    def _wt_x(self, Ws, xc):
        """t_p = sum_k W_k^T xc[entity of k]: one gather and one index_add_
        per coupling group."""
        xe = xc.reshape(self.num_entities, self.entity_dof)
        t = torch.zeros((self.num_landmarks, 3), dtype=xc.dtype, device=xc.device)
        for plan, W in zip(self.couplings, Ws):
            t.index_add_(0, plan.lm, _bmv(W.transpose(1, 2), xe[plan.ent]))
        return t

    def _w_u(self, Ws, u):
        """y = sum_k W_k u[landmark of k], landing on entity blocks."""
        y = torch.zeros((self.num_entities, self.entity_dof), dtype=u.dtype, device=u.device)
        for plan, W in zip(self.couplings, Ws):
            y.index_add_(0, plan.ent, _bmv(W, u[plan.lm]))
        return y.reshape(-1)

    def _entity_prec_inv(self, Hcc, Hpp_inv, Ws, schur_jacobi: bool):
        """Entity-block preconditioner of S, inverted. With Schur-Jacobi each
        block is the full De x De entity diagonal block of S, pose<->
        intrinsics cross terms through the landmark included."""
        acc = Hcc
        if schur_jacobi:
            acc = Hcc.clone()
            for plan, W in zip(self.couplings, Ws):
                Y = W @ Hpp_inv[plan.lm]  # [K, De, 3]
                acc.index_add_(0, plan.ent, -(Y @ W.transpose(1, 2)))
        # eigh reads its error flag back: not capturable
        return graphs.uncaptured(spd_clamped_inv, acc)

    def _pcg(self, apply_S, apply_M, b, rtol=None, max_iter=None, x0=None):
        """Block-preconditioned conjugate gradients with f64 recurrence
        scalars. The loop runs on the host and reads one flag per iteration;
        with ``sync_free`` it reads one per ``graphs.PCG_CHUNK`` iterations.

        ``x0`` warm-starts from the previous LM iteration's camera step. It
        is guarded: if ||S x0 - b|| is not below ||b|| (a damping jump, a
        rejected step), PCG starts from zero instead. The warm start's first
        pass counts as iteration 0."""
        if rtol is None:
            rtol = self.pcg_rtol_floor
        if max_iter is None:
            max_iter = self.pcg_iter_cap
        q_tol = self.pcg_q_tol
        dot = _dot64
        bb = dot(b, b)
        tol2 = rtol * rtol * bb

        def q_of(x, r):
            # Q(x) = 0.5 x'Sx - b'x = -0.5 (x'b + x'r)  since r = b - Sx
            return -0.5 * (dot(x, b) + dot(x, r))

        if x0 is not None:
            r_w = b - apply_S(x0)
            better = dot(r_w, r_w) < bb
            x = torch.where(better, x0, torch.zeros_like(x0))
            r = torch.where(better, r_w, b)
        else:
            x, r = torch.zeros_like(b), b.clone()
        z = apply_M(r)
        p = z.clone()
        rz = dot(r, z)
        Q0 = Qn = Qp = q_of(x, r) if q_tol is not None else None

        def go(k, r, Qp, Qn):
            """Whether iteration k (counted from this call's start) runs."""
            more = dot(r, r) > tol2
            if q_tol is not None and k >= 2:
                # Nash-Sofer: stop once n (Q_n - Q_{n-1}) / (Q_n - Q_0) < q_tol,
                # progress measured from this call's own starting model value
                dq = Qn - Q0
                zeta = float(k) * (Qn - Qp) / torch.where(dq == 0, -torch.ones_like(dq), dq)
                more = more & (zeta >= q_tol)
            return more

        def iterate(x, r, p, rz, Qp, Qn):
            Sp = apply_S(p)
            denom = dot(p, Sp)
            alpha = (rz / torch.where(denom == 0, torch.ones_like(denom), denom)).to(b.dtype)
            x = x + alpha * p
            r = r - alpha * Sp
            z = apply_M(r)
            rz_new = dot(r, z)
            beta = (rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)).to(b.dtype)
            p = z + beta * p
            if q_tol is not None:
                Qp, Qn = Qn, q_of(x, r)
            return x, r, p, rz_new, Qp, Qn

        if not self.sync_free:
            for k in range(max_iter):
                if not bool(go(k, r, Qp, Qn)):
                    break
                x, r, p, rz, Qp, Qn = iterate(x, r, p, rz, Qp, Qn)
            return x

        if q_tol is not None:
            Qn, Qp = Qn.clone(), Qp.clone()
        else:
            # unused slots of the loop state
            Qn, Qp = torch.zeros_like(rz), torch.zeros_like(rz)
        running = torch.ones((), dtype=torch.bool, device=b.device)

        def chunk(k0, k1):
            def body(x, r, p, rz, Qp, Qn, running):
                for k in range(k0, k1):
                    running = running & go(k, r, Qp, Qn)
                    x, r, p, rz, Qp, Qn = graphs.masked_update(
                        running, iterate, x, r, p, rz, Qp, Qn)
                return x, r, p, rz, Qp, Qn, running
            return body

        for k0 in range(0, max_iter, graphs.PCG_CHUNK):
            k1 = min(k0 + graphs.PCG_CHUNK, max_iter)
            # the chunk's first test: a finished PCG stays finished
            running = running & go(k0, r, Qp, Qn)
            x, r, p, rz, Qp, Qn, running = graphs.cond_update(
                running, chunk(k0, k1), x, r, p, rz, Qp, Qn, running)
        return x

    def _x0_reduced(self, dx_prev):
        """Previous global step -> reduced camera vector (None passes)."""
        if dx_prev is None:
            return None
        x0 = torch.zeros(self.Dc, dtype=dx_prev.dtype, device=dx_prev.device)
        x0[self._kept_red] = dx_prev[self._kept]
        return x0

    def pcg_rtol(self, iteration):
        """The forcing sequence: loose PCG solves while LM is far from the
        optimum, tightening geometrically to the floor. On a device
        iteration counter the same f64 values as a 0-d tensor (0.1 * 2^-it
        is exact in f64)."""
        if not self.pcg_forcing or iteration is None:
            return self.pcg_rtol_floor
        if isinstance(iteration, torch.Tensor):
            scaled = torch.ldexp(torch.full((), 0.1, dtype=torch.float64,
                                            device=iteration.device), -iteration)
            return torch.clamp(scaled, self.pcg_rtol_floor, 0.1)
        if iteration < 0:
            return self.pcg_rtol_floor
        return min(max(0.1 * 2.0 ** (-iteration), self.pcg_rtol_floor), 0.1)

    def solve(self, values, damping, iteration=None, dx_prev=None):
        """One damped Schur solve: (dx [D], g [D], cost, predicted). ``dx_prev``
        (the previous LM step) warm-starts PCG.

        ``predicted`` is the exact Gauss-Newton model reduction
        -g.dx - 0.5 dx^T H dx of the actual, possibly inexact, step: with a
        truncated PCG the shortcut 0.5 dx^T (lambda dx - g) under-predicts
        and collapses the Nielsen damping."""
        dt = self.cp.dtype
        with record_function("schur.assemble"):
            Hcc, gc, Hpp, gp, Ws, cost = self.assemble(values, damping)
            Hpp_inv = landmark_inverse(Hpp)
            b = -gc + self._w_u(Ws, _bmv(Hpp_inv, gp))

        if self.variant == "sparse":
            with record_function("schur.pair_products"):
                S = self._schur_dense(Hcc, Hpp_inv, Ws)
            with record_function("schur.dense_solve"):
                # solve_cholesky_with_retry solves (H + shift I) x = -g
                dxc = solve_cholesky_with_retry(S, -b)
        else:
            dxc = self._solve_reduced_pcg(Hcc, Hpp_inv, Ws, b, iteration, dx_prev)

        with record_function("schur.back_substitute"):
            return self._back_substitute(Hcc, gc, Hpp, gp, Ws, Hpp_inv, dxc, damping, cost)

    def _solve_reduced_pcg(self, Hcc, Hpp_inv, Ws, b, iteration, dx_prev):
        """The implicit variant's reduced solve: matrix-free S, PCG."""
        def apply_S(x):
            u = _bmv(Hpp_inv, self._wt_x(Ws, x))
            return self._hcc_matvec(Hcc, x) - self._w_u(Ws, u)

        if self.preconditioner == "none":
            def apply_M(x):
                return x
        else:
            inv_blocks = self._entity_prec_inv(
                Hcc, Hpp_inv, Ws, schur_jacobi=self.preconditioner == "schur_jacobi")

            def apply_M(x):
                return self._hcc_matvec(inv_blocks, x)

        return self._pcg(apply_S, apply_M, b, rtol=self.pcg_rtol(iteration),
                         x0=self._x0_reduced(dx_prev))

    # Pairs processed per scatter step in the explicit variant. Dense
    # visibility makes the pair count quadratic in cameras per landmark;
    # fixed-size chunks bound the peak at about PAIR_CHUNK * De^2 elements
    # (170 MB in f64 at De = 9) whatever the pair count.
    PAIR_CHUNK = 1 << 18

    def _hcc_dense(self, Hcc):
        """The dense [Dc, Dc] block-diagonal H_cc from its entity blocks,
        padded diagonal ones included."""
        E, De = self.num_entities, self.entity_dof
        dense = torch.zeros((self.Dc, self.Dc), dtype=Hcc.dtype, device=Hcc.device)
        e = torch.arange(E, device=Hcc.device)
        dense.view(E, De, E, De)[e, :, e, :] = Hcc
        return dense

    def _scatter_pair_products(self, S, Y, W, ent_a, ent_b, ia, ib):
        """S -= Y[ia] @ W[ib]^T at entity block (ent_a[ia], ent_b[ib]), one
        flat ``index_add_`` into S's storage per chunk of pairs."""
        De, Dc = self.entity_dof, self.Dc
        ar = torch.arange(De, device=S.device)
        cell = ar[:, None] * Dc + ar[None, :]  # offsets within a block
        flat = S.view(-1)
        for lo in range(0, ia.shape[0], self.PAIR_CHUNK):
            idx_a = ia[lo: lo + self.PAIR_CHUNK]
            idx_b = ib[lo: lo + self.PAIR_CHUNK]
            contrib = Y[idx_a] @ W[idx_b].mT  # [chunk, De, De]
            base = ent_a[idx_a] * (De * Dc) + ent_b[idx_b] * De
            flat.index_add_(0, (base[:, None, None] + cell).reshape(-1),
                            contrib.reshape(-1), alpha=-1.0)
        return S

    def _schur_dense(self, Hcc, Hpp_inv, Ws):
        """The explicit reduced camera matrix S = blockdiag(Hcc) - sum over
        pairs of Y[ia] W[ib]^T with Y = W Hpp^-1."""
        S = self._hcc_dense(Hcc)
        Ys = [W @ Hpp_inv[plan.lm] for plan, W in zip(self.couplings, Ws)]
        pi = 0
        for a, pa in enumerate(self.couplings):
            for bidx, pb in enumerate(self.couplings):
                ia, ib = self.pair_indices[pi]
                pi += 1
                if ia.shape[0]:
                    self._scatter_pair_products(S, Ys[a], Ws[bidx], pa.ent, pb.ent, ia, ib)
        return S

    def _back_substitute(self, Hcc, gc, Hpp, gp, Ws, Hpp_inv, dxc, damping, cost):
        """Landmark step, exact model reduction and the global layout, shared
        by both variants."""
        dt = self.cp.dtype
        # back-substitution: dxp = Hpp^-1 (-gp - W^T dxc)
        dxp = _bmv(Hpp_inv, -gp - self._wt_x(Ws, dxc))

        # exact model reduction: q = dx^T H dx from the damped blocks minus
        # the diagonal shifts
        dot = _dot64
        q_damped = (dot(dxc, self._hcc_matvec(Hcc, dxc))
                    + 2.0 * dot(dxc, self._w_u(Ws, dxp))
                    + dot(dxp, _bmv(Hpp, dxp)))
        q = (q_damped - damping * dot(dxc, dxc)
             - self._pp_shift(damping) * dot(dxp, dxp))
        predicted = (-(dot(gc, dxc) + dot(gp, dxp)) - 0.5 * q).to(dt)

        dx, g_full = self._scatter_global(dxc, gc, dxp, gp)
        return dx, g_full, cost, predicted

    def _scatter_global(self, dxc, gc, dxp, gp):
        """Place the reduced camera step and gradient and the landmark step
        and gradient back into the global tangent layout."""
        D = self.cp.total_dof
        dx = torch.zeros(D, dtype=dxc.dtype, device=dxc.device)
        g = torch.zeros(D, dtype=gc.dtype, device=gc.device)
        dx[self._kept] = dxc[self._kept_red]
        g[self._kept] = gc[self._kept_red]
        dx[self._lm_cols3] = dxp[self._lm_ids_of_cols]
        g[self._lm_cols3] = gp[self._lm_ids_of_cols]
        return dx, g
