"""Landmark-partitioned multi-device bundle adjustment (counterpart of
``apex_tpu/parallel/schur_planes_sharded.py``) on the port's block layout
(``linalg/schur.py::SchurContext``).

In a uniform layout (``build_ba_problem``'s default, bucketed) every
coupling group's observations come in equal runs of ``cap`` per landmark
over a consecutive landmark range. Each group's range ``[lo, lo + n)`` is
split into ``size`` sub-ranges of ``n_loc = ceil(n / size)`` landmarks
(padded with weight-0 copies of row 0), and rank c owns sub-range c of
every group together with its ``n_loc * cap`` observation rows:

- the landmark blocks Hpp, their inverse (the CUDA kernel, one launch per
  LM iteration on the rank's ``[sum n_loc, 3, 3]``) and the landmark step
  stay on the rank: an observation's landmark lives on its rank;
- only camera-side sums cross ranks: H_cc, g_c, the cost, ``W u`` once per
  PCG iteration, the Schur-Jacobi blocks and three landmark-side dot
  products of the model reduction, each one ``all_reduce``;
- the PCG on the reduced camera system runs replicated, and the landmark
  partition is gathered once at the end by an ``all_reduce`` of a zeroed
  global buffer into which each rank adds its slices.

``ShardedSchurContext`` overrides three methods of ``SchurContext``:
``_group`` (the rank's rows), ``_allreduce`` and the final landmark
gather. So one rank and several solve the same pipeline, forcing
sequence, warm start and ``pp_shift_floor`` included.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.problem import CompiledProblem
from ..linalg.schur import SchurContext
from .mesh import ProcessMesh
from .sharding import nielsen_accept, rank_rows_of, row_weights, take_rows


@dataclasses.dataclass(frozen=True)
class _GroupMeta:
    """Static partition of one factor group."""

    gi: int
    cap: int  # observations per landmark; 0 for camera-only groups
    lo: int  # first landmark id of the group's range
    n: int  # landmarks in the range
    n_loc: int  # landmarks per rank (padded)
    k_loc: int  # observation rows per rank


def uniform_groups(ctx) -> Optional[List[tuple]]:
    """(gi, cap, lo, n) per factor group if ``ctx``'s problem has the
    uniform layout, else None. Host arrays only:

    - every camera slot sits at one entity-local offset in all its rows;
    - each coupling group's landmark ids are runs of one length ``cap``
      over a consecutive range, disjoint from the other groups' ranges;
    - there is no landmark-only group (a landmark prior)."""
    cp, De = ctx.cp, ctx.entity_dof
    if not ctx.couplings:
        return None
    lm_host = {p.group_idx: lm for p, lm in zip(ctx.couplings, ctx._lm_host)}
    out, ranges = [], []
    for plan in ctx.plans:
        gi = plan.group_idx
        if plan.lm_slot is not None and not plan.cam_slots:
            return None
        for s in plan.cam_slots:
            loc = ctx.red_of_global[cp.host_group_cols[gi][s]] % De
            if loc.size and not (loc == loc[0]).all():
                return None
        if plan.lm_slot is None:
            out.append((gi, 0, 0, 0))
            continue
        lm = lm_host[gi]
        K = lm.shape[0]
        runs = np.nonzero(np.diff(lm))[0]
        cap = int(runs[0] + 1) if runs.size else K
        if cap == 0 or K % cap:
            return None
        lm_u = lm[::cap]
        if not (lm.reshape(-1, cap) == lm_u[:, None]).all():
            return None
        if lm_u.size > 1 and not (np.diff(lm_u) == 1).all():
            return None
        lo, n = int(lm_u[0]), int(lm_u.size)
        ranges.append((lo, lo + n))
        out.append((gi, cap, lo, n))
    ranges.sort()
    if any(b0 < a1 for (_, a1), (b0, _) in zip(ranges, ranges[1:])):
        return None
    return out


def is_uniform_layout(ctx) -> bool:
    """Whether ``make_sharded_schur_step`` partitions the landmarks of
    ``ctx``'s problem (``uniform_groups``)."""
    return uniform_groups(ctx) is not None


def partition_metas(ctx, size: int) -> List[_GroupMeta]:
    """The partition of every factor group over ``size`` ranks."""
    metas = []
    for gi, cap, lo, n in uniform_groups(ctx):
        if cap:
            n_loc = -(-n // size)
            k_loc = n_loc * cap
        else:
            n_loc, k_loc = 0, -(-ctx.cp.groups[gi].count // size)
        metas.append(_GroupMeta(gi=gi, cap=cap, lo=lo, n=n, n_loc=n_loc, k_loc=k_loc))
    return metas


class ShardedSchurContext(SchurContext):
    """A rank's view of a ``SchurContext``: its rows of every factor group
    (``_group``), ``_allreduce`` over the mesh and, where the landmarks are
    partitioned, the final landmark gather (``_scatter_global``). A rank
    assembles its rows by the generic path and sums over its couplings by
    the plain one: the assembly kernels' plans and the row orders are of
    whole groups (``make_sharded_schur_step`` builds ``ctx`` without them,
    ``whole_groups=False``).

    ``rows[i]`` is ``rank_rows_of``'s pair for plan i. ``lms[i]`` is the
    rank-local landmark id of each of those rows (a tensor), or None to
    keep the global ids (the observation-sharded block path, whose
    landmark state is replicated). ``lm_slices`` lists (lo, llo, n_loc)
    per partitioned group: global range start, rank-local start, count."""

    def __init__(self, ctx: SchurContext, mesh: ProcessMesh, rows, lms, lm_slices=None):
        self.__dict__.update(ctx.__dict__)
        cp = ctx.cp
        self.mesh = mesh
        self._groups_local = {}
        plans = []
        for plan, (take_host, sl), lm in zip(ctx.plans, rows, lms):
            g = cp.groups[plan.group_idx]
            take = torch.as_tensor(take_host, device=cp.device)
            weight = row_weights(g, mesh.size * (sl.stop - sl.start), cp.dtype, cp.device)[sl]
            self._groups_local[plan.group_idx] = take_rows(g, take, weight)
            plans.append(dataclasses.replace(
                plan,
                ent=None if plan.ent is None else plan.ent[take],
                cam_cols=[cc[take] for cc in plan.cam_cols],
                lm=None if plan.lm is None else (plan.lm[take] if lm is None else lm),
                orders=None, kernel=None))
        self.plans = plans
        self.couplings = [p for p in plans if p.cam_slots and p.lm_slot is not None]
        self._lm_slices = lm_slices
        self.num_landmarks_global = ctx.num_landmarks
        if lm_slices is not None:
            self.num_landmarks = sum(n_loc for _, _, n_loc in lm_slices)

    def _group(self, gi):
        return self._groups_local[gi]

    def _allreduce(self, *tensors):
        out = self.mesh.all_reduce_many(*tensors)
        return out if len(out) > 1 else out[0]

    def _scatter_global(self, dxc, gc, dxp, gp):
        """With partitioned landmarks, gather them first: every rank adds
        its slices (the padded landmarks' entries are exactly zero) into a
        zeroed global buffer and one ``all_reduce`` merges them; then the
        global layout is written as on one device."""
        if self._lm_slices is None:
            return super()._scatter_global(dxc, gc, dxp, gp)
        size, rank = self.mesh.size, self.mesh.rank
        Pg = self.num_landmarks_global
        Pbuf = max([Pg] + [lo + n_loc * size for lo, _, n_loc in self._lm_slices])
        buf = torch.zeros((Pbuf, 6), dtype=dxp.dtype, device=dxp.device)
        for lo, llo, n_loc in self._lm_slices:
            idx = lo + rank * n_loc + torch.arange(n_loc, device=dxp.device)
            buf.index_add_(0, idx, torch.cat([dxp[llo:llo + n_loc], gp[llo:llo + n_loc]], dim=1))
        self.mesh.all_reduce(buf)
        return super()._scatter_global(dxc, gc, buf[:Pg, :3], buf[:Pg, 3:])


def partitioned_context(ctx: SchurContext, mesh: ProcessMesh,
                        metas: List[_GroupMeta]) -> ShardedSchurContext:
    """This rank's part of the landmark partition: its landmarks of every
    group, numbered rank-locally group after group, and their rows."""
    dev = ctx.cp.device
    rows, lms, slices = [], [], []
    llo = 0
    for meta in metas:
        rows.append(rank_rows_of(ctx.cp.groups[meta.gi].count, meta.k_loc,
                                 mesh.rank, mesh.size))
        if meta.cap:
            lms.append(llo + torch.arange(meta.k_loc, device=dev) // meta.cap)
            slices.append((meta.lo, llo, meta.n_loc))
            llo += meta.n_loc
        else:
            lms.append(None)
    return ShardedSchurContext(ctx, mesh, rows, lms, slices)


def make_partitioned_schur_step(cp: CompiledProblem, ctx: SchurContext, mesh: ProcessMesh,
                                damping_min: float = 1e-12, damping_max: float = 1e12):
    """The landmark-partitioned LM step from a ``SchurContext`` (variant
    ``iterative``) whose problem has the uniform layout. Returns (step,
    shard_args): ``step(values, damping, nu, cost, iteration=-1,
    dx_prev=None) -> (values, damping, nu, cost)`` sets ``step.last_dx``;
    ``step.solve(values, damping, iteration=-1, dx_prev=None) -> (dx, g,
    cost, predicted)`` is ``SchurContext.solve`` over the mesh;
    ``step.metas`` the partition; ``shard_args`` this rank's factor rows."""
    metas = partition_metas(ctx, mesh.size)
    sh = partitioned_context(ctx, mesh, metas)

    def solve(values, damping, iteration=-1, dx_prev=None):
        """(dx, g, cost, predicted) of one damped solve."""
        return sh.solve(values, damping, iteration=iteration, dx_prev=dx_prev)

    def step(values, damping, nu, current_cost, iteration=-1, dx_prev=None):
        """One LM iteration. ``iteration`` (>= 0) drives the PCG forcing
        sequence (-1: the fixed tolerance); ``dx_prev`` (``step.last_dx``)
        warm-starts the PCG."""
        dx, _, cost, predicted = sh.solve(values, damping, iteration=iteration,
                                          dx_prev=dx_prev)
        step.last_dx = dx
        return nielsen_accept(cp, values, damping, nu, cost, dx, predicted,
                              damping_min, damping_max)

    step.solve = solve
    step.metas = metas
    step.context = sh
    step.last_dx = None
    return step, tuple(sh._groups_local[m.gi] for m in metas)
