"""Multi-device bundle adjustment: the routing of ``make_sharded_schur_step``
and the observation-sharded block path (counterpart of
``apex_tpu/parallel/schur_sharded.py``).

A problem with the uniform layout (``build_ba_problem``'s default) takes the
landmark partition of ``schur_partitioned.py``. Any other layout takes the
block path below, with the reference's own semantics:

- the observations (factor rows) are sharded over the ranks; camera and
  landmark state are replicated;
- each rank linearizes its rows into partial H_cc, g_c, Hpp, g_p and cost,
  and ``all_reduce`` sums them;
- PCG on the reduced camera system runs replicated at the context's
  tolerance, from zero, with ``W^T x`` and ``W u`` each summed over the
  ranks: two collectives per PCG iteration;
- Hpp is damped by ``damping`` alone (no ``pp_shift_floor``), and the
  Schur-Jacobi preconditioner has one block per camera-side variable;
- every rank inverts the replicated ``[P, 3, 3]`` landmark blocks (the
  CUDA kernel on a card) and back-substitutes the landmark step;
- ``predicted = 0.5 dx . (damping dx - g)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.problem import CompiledProblem
from ..kernels import spd_inverse
from ..linalg.schur import SchurContext, landmark_inverse
from ..linalg.utils import bmv as _bmv
from .mesh import ProcessMesh
from .schur_partitioned import (ShardedSchurContext, is_uniform_layout,
                                make_partitioned_schur_step)
from .sharding import nielsen_accept, rank_rows_of


def _camera_variable_blocks(ctx: SchurContext):
    """Per pool with camera-side variables: (entity [Nv], entity-local
    columns [Nv, d], reduced columns [Nv, d]) of each variable."""
    out = []
    De, dev = ctx.entity_dof, ctx.cp.device
    for pid, pool in enumerate(ctx.cp.pools):
        red = ctx.red_of_global[ctx.cp.host_pool_cols[pid]]
        base = red[red >= 0]
        if base.size == 0:
            continue
        d = np.arange(pool.manifold.dof)
        out.append(tuple(torch.as_tensor(a, device=dev) for a in (
            base // De, (base % De)[:, None] + d, base[:, None] + d)))
    return out


def make_block_schur_step(cp: CompiledProblem, ctx: SchurContext, mesh: ProcessMesh,
                          damping_min: float = 1e-12, damping_max: float = 1e12):
    """The observation-sharded LM step: (step, shard_args), ``step(values,
    damping, nu, cost) -> (values, damping, nu, cost)``."""
    rows = []
    for plan in ctx.plans:
        count = cp.groups[plan.group_idx].count
        rows.append(rank_rows_of(count, -(-count // mesh.size), mesh.rank, mesh.size))
    sh = ShardedSchurContext(ctx, mesh, rows, [None] * len(rows))
    dt, dev = cp.dtype, cp.device
    eye_c = torch.eye(ctx.entity_dof, dtype=dt, device=dev)
    eye_p = torch.eye(3, dtype=dt, device=dev)
    var_blocks = _camera_variable_blocks(ctx)

    def solve(values, damping):
        Hcc, gc, Hpp, gp, Ws, cost = sh.assemble(values)
        Hpp, gp = sh._allreduce(Hpp, gp)
        Hcc = Hcc + damping * eye_c
        Hpp_inv = landmark_inverse(Hpp + damping * eye_p)

        def wt_x(x):
            return sh._allreduce(sh._wt_x(Ws, x))

        def apply_S(x):
            return sh._hcc_matvec(Hcc, x) - sh._w_u(Ws, _bmv(Hpp_inv, wt_x(x)))

        if ctx.preconditioner == "none":
            def apply_M(x):
                return x
        else:
            acc = (sh._schur_diagonal(Hcc, Hpp_inv, Ws)
                   if ctx.preconditioner == "schur_jacobi" else Hcc)
            inv = [(cols, spd_inverse.spd_clamped_inv(acc[ent[:, None, None], loc[:, :, None],
                                              loc[:, None, :]]))
                   for ent, loc, cols in var_blocks]

            def apply_M(x):
                y = torch.zeros_like(x)
                for cols, blocks in inv:
                    y[cols] = _bmv(blocks, x[cols])
                return y

        b = -gc + sh._w_u(Ws, _bmv(Hpp_inv, gp))
        dxc = sh._pcg(apply_S, apply_M, b)
        dxp = _bmv(Hpp_inv, -gp - wt_x(dxc))
        dx, g_full = sh._scatter_global(dxc, gc, dxp, gp)
        return dx, g_full, cost

    def step(values, damping, nu, current_cost):
        dx, g_full, cost = solve(values, damping)
        predicted = 0.5 * torch.dot(dx, damping * dx - g_full)
        return nielsen_accept(cp, values, damping, nu, cost, dx, predicted,
                              damping_min, damping_max)

    return step, tuple(sh._groups_local[p.group_idx] for p in ctx.plans)


def make_sharded_schur_step(
    cp: CompiledProblem,
    mesh: ProcessMesh,
    eliminate_prefix: str = "pt_",
    preconditioner: str = "schur_jacobi",
    pcg_max_iterations: int = 200,
    pcg_tolerance: float = 1e-6,
    damping_min: float = 1e-12,
    damping_max: float = 1e12,
    pcg_q_tolerance: float | None = None,
):
    """The sharded LM iteration with the implicit Schur solve: (step,
    shard_args). The uniform layout takes the landmark partition (``step``
    has ``solve``, ``metas`` and ``last_dx``); any other layout the
    observation-sharded block path."""
    ctx = SchurContext(
        cp, eliminate_prefix=eliminate_prefix, variant="iterative",
        preconditioner=preconditioner, pcg_max_iterations=pcg_max_iterations,
        pcg_tolerance=pcg_tolerance, pcg_q_tolerance=pcg_q_tolerance, whole_groups=False)
    make = make_partitioned_schur_step if is_uniform_layout(ctx) else make_block_schur_step
    return make(cp, ctx, mesh, damping_min=damping_min, damping_max=damping_max)
