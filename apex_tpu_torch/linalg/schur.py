"""Implicit Schur-complement solver for bundle adjustment (counterpart of the
block path of ``apex_tpu/linalg/schur.py``, ``variant="iterative"``).

Landmarks (``pt_*``-named R^3 variables) are eliminated and the reduced
camera system

    S = H_cc - W Hpp^{-1} W^T,      S dxc = -g_c + W Hpp^{-1} g_p
    dxp = Hpp^{-1} (-g_p - W^T dxc)

is solved matrix-free by PCG with the Schur-Jacobi block preconditioner.
The global sparse H is never formed. Per factor group the linearization
gives one merged camera-entity Jacobian ``Jc [K, d, De]`` (every camera slot
of a factor lies in one entity), from which come batched ``H_cc`` entity
blocks ``[E, De, De]``, landmark blocks ``Hpp [P, 3, 3]`` and per-observation
couplings ``W [K, De, 3]``; every sum over observations is one
``index_add_``. The landmark blocks are inverted by the CUDA kernel of
``kernels/landmark_blocks.py`` for a CUDA tensor.

LM damping is added to H_cc's diagonal and to the Hpp blocks, the latter
floored by ``pp_shift_floor`` (1e-4 in f32). The explicit variant (dense S,
Cholesky) is ROADMAP A.3.

``index_add_`` on CUDA sums with atomics in no fixed order, so results
differ from the JAX package's sorted segment sums, and from run to run, by
rounding.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.problem import CompiledProblem
from ..kernels.landmark_blocks import invert_landmark_blocks
from .utils import spd_clamped_inv


def landmark_inverse(Hpp):
    """Regularized inverse of the landmark blocks: the CUDA kernel for a
    CUDA tensor, f32 or f64 at any size; the plain version on the CPU."""
    return invert_landmark_blocks(Hpp)


def _dot64(a, b):
    """Inner product accumulated in f64 (PCG recurrence scalars are the
    first thing f32 noise corrupts); a 0-d f64 tensor on the device."""
    return torch.dot(a.reshape(-1).to(torch.float64), b.reshape(-1).to(torch.float64))


def _bmv(A, x):
    """Batched matrix-vector product [B, m, n] x [B, n] -> [B, m]."""
    return (A @ x[..., None])[..., 0]


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
    ):
        if variant != "iterative":
            raise NotImplementedError(
                f"Schur variant {variant!r} is not ported yet (ROADMAP A.3: "
                "explicit Schur); the port has 'iterative'")
        if preconditioner not in ("none", "block_diagonal", "schur_jacobi"):
            raise ValueError(f"unknown preconditioner {preconditioner!r}")
        self.cp = cp
        self.variant = variant
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

    # ------------------------------------------------------------------

    def _pp_shift(self, damping):
        """LM damping floored by the landmark regularization floor."""
        if self.pp_shift_floor > 0.0:
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
        return spd_clamped_inv(acc)

    def _pcg(self, apply_S, apply_M, b, rtol=None, max_iter=None, x0=None):
        """Block-preconditioned conjugate gradients with f64 recurrence
        scalars. The loop runs on the host and reads one flag per iteration.

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
            it_off = 1
        else:
            x, r, it_off = torch.zeros_like(b), b, 0
        z = apply_M(r)
        p = z
        rz = dot(r, z)
        if q_tol is not None:
            Q0 = Qn = Qp = q_of(x, r)

        it = it_off
        while it < max_iter + it_off:
            go = dot(r, r) > tol2
            if q_tol is not None and it - it_off >= 2:
                # Nash-Sofer: stop once n (Q_n - Q_{n-1}) / (Q_n - Q_0) < q_tol,
                # progress measured from this call's own starting model value
                n = float(it - it_off)
                dq = Qn - Q0
                zeta = n * (Qn - Qp) / torch.where(dq == 0, -torch.ones_like(dq), dq)
                go = go & (zeta >= q_tol)
            if not bool(go):
                break
            Sp = apply_S(p)
            denom = dot(p, Sp)
            alpha = (rz / torch.where(denom == 0, torch.ones_like(denom), denom)).to(b.dtype)
            x = x + alpha * p
            r = r - alpha * Sp
            z = apply_M(r)
            rz_new = dot(r, z)
            beta = (rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)).to(b.dtype)
            p = z + beta * p
            rz = rz_new
            if q_tol is not None:
                Qp, Qn = Qn, q_of(x, r)
            it += 1
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
        optimum, tightening geometrically to the floor."""
        if not self.pcg_forcing or iteration is None or iteration < 0:
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
        Hcc, gc, Hpp, gp, Ws, cost = self.assemble(values, damping)
        Hpp_inv = landmark_inverse(Hpp)

        b = -gc + self._w_u(Ws, _bmv(Hpp_inv, gp))

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

        dxc = self._pcg(apply_S, apply_M, b, rtol=self.pcg_rtol(iteration),
                        x0=self._x0_reduced(dx_prev))

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
