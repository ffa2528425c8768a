"""Problem IR: structure-of-arrays factor graph (counterpart of
``apex_tpu/core/problem.py``).

- variable pools: one tensor per manifold (``[N, S]``), per-DOF free masks
  and storage-space bounds;
- factor groups: single residual blocks grouped by (factor signature, loss
  kind), then each bulk-added batch, with stacked measurement data, loss
  parameters, optional per-row weights and int64 index/column tensors.
  Linearization is one batched kernel per group with the corrector applied
  after it.

``Problem`` is the mutable host-side builder. ``CompiledProblem`` holds the
tensors on one device in one dtype; the state threaded through the
optimizer is a tuple of pool tensors. The tangent column layout is the
JAX package's: numeric-aware name order, or reverse Cuthill-McKee under
``ordering="rcm"``/``"auto"``, so both packages give the same columns.
"""

from __future__ import annotations

import dataclasses
import os
import re as _re
from collections.abc import MutableMapping
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..factors.base import Factor
from ..manifolds import get as get_manifold
from ..utils import profiling
from ..utils.profiling import annotate
from .corrector import correct
from .losses import Loss


_DIGIT_RUNS = _re.compile(r"(\d+)")

# row views that ``VariableMap`` made for a caller who read a name
result_views = 0
profiling.watch(globals(), "result_views")


def _natural_key(name: str):
    """Sort key splitting digit runs into ints: x2 < x10, cam_9 < cam_10."""
    return [int(part) if part.isdigit() else part for part in _DIGIT_RUNS.split(name)]


@dataclasses.dataclass
class VarPool:
    manifold: object
    names: List[str]
    values0: torch.Tensor  # [N, S]
    free_mask: torch.Tensor  # [N, dof], 1.0 = free, 0.0 = fixed
    lower: torch.Tensor  # [N, S]
    upper: torch.Tensor  # [N, S]
    cols: torch.Tensor  # [N] int64 global tangent column offsets


@dataclasses.dataclass
class FactorGroup:
    factor_cls: type
    # (manifolds, data, params, compute_jac) -> (r [K, d], [J [K, d, dof_s]])
    kernel: object
    manifolds: Tuple
    data: Dict[str, torch.Tensor]  # each [K, ...]
    loss_kind: str
    loss_params: torch.Tensor  # [K, P]
    pool_ids: Tuple[int, ...]  # per slot
    indices: Tuple[torch.Tensor, ...]  # per slot, [K] int64 rows into pool
    cols: Tuple[torch.Tensor, ...]  # per slot, [K] int64 global col offsets
    # Per slot: None if every bound variable is fully free, else [K, dof].
    # Fixed DOF zero both the step and the Jacobian columns, so the gradient
    # and the predicted reduction agree with the step actually applied.
    free_masks: Tuple[Optional[torch.Tensor], ...] = ()
    # Optional [K] residual scale. Weight-0 rows are exact no-ops (zero
    # residual, zero Jacobian): the bucketed BA layout pads with them.
    weights: Optional[torch.Tensor] = None
    residual_dim: int = 0
    row_offset: int = 0
    count: int = 0
    # the factor the group was compiled from (its template, or its first
    # single block): what a kernel that takes the group reads its kind from
    factor: Optional[Factor] = None


class VariableMap(MutableMapping):
    """{name: host storage vector} over one read-only host copy per pool
    (``hosts``) and a compiled problem's name index (``loc``: name -> (pool,
    row), in pool order, each pool's names in row order). ``m[name]`` is
    the row of its pool's copy, a read-only view made when it is read
    (``result_views`` counts them). The first name assigned or deleted
    gives the mapping an index of its own (an assigned name maps to None,
    its value kept in ``_own``), so a change never reaches the copies,
    another mapping or the compiled problem, and the order is a dict's.
    Holds nothing of the device."""

    __slots__ = ("_hosts", "_loc", "_own", "_shared")

    def __init__(self, hosts, loc):
        for host in hosts:
            host.setflags(write=False)
        self._hosts = tuple(hosts)
        self._loc = loc
        self._own = {}
        self._shared = True

    def __getitem__(self, name):
        global result_views
        where = self._loc[name]
        if where is None:
            return self._own[name]
        result_views += 1
        return self._hosts[where[0]][where[1]]

    def __contains__(self, name):
        return name in self._loc

    def __iter__(self):
        return iter(self._loc)

    def __len__(self):
        return len(self._loc)

    def _index(self):
        if self._shared:
            self._loc, self._shared = dict(self._loc), False
        return self._loc

    def __setitem__(self, name, value):
        self._index()[name] = None
        self._own[name] = value

    def __delitem__(self, name):
        del self._index()[name]
        self._own.pop(name, None)

    def __reduce__(self):
        return type(self), (self._hosts, self._loc), self._own

    def __setstate__(self, own):
        self._own = own


class Problem:
    """Mutable factor-graph builder. Factors are added one block at a time
    (``add_residual_block``: pose graphs) or in bulk
    (``add_residual_block_batch``: bundle adjustment)."""

    def __init__(self):
        self._manifold_of: Dict[str, str] = {}
        self._values: Dict[str, np.ndarray] = {}
        # (keys, factor, loss); None once removed
        self._blocks: List[Optional[Tuple[Tuple[str, ...], Factor, Optional[Loss]]]] = []
        # (slot_keys, template, data, loss, loss_params, weights, count)
        self._bulk: List[tuple] = []
        self._fixed: Dict[str, Optional[List[int]]] = {}
        self._bounds: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    # -- construction ------------------------------------------------------

    def add_variable(self, name: str, manifold, value=None):
        mname = manifold if isinstance(manifold, str) else manifold.name
        G = get_manifold(mname)
        if name in self._manifold_of and self._manifold_of[name] != mname:
            raise ValueError(
                f"variable {name!r} redeclared with manifold {mname}, was "
                f"{self._manifold_of[name]}")
        self._manifold_of[name] = mname
        if value is not None:
            value = np.asarray(value, dtype=np.float64)
            if value.shape != (G.storage_dim,):
                raise ValueError(
                    f"variable {name!r} ({mname}) expects shape "
                    f"({G.storage_dim},), got {value.shape}")
            self._values[name] = value
        return name

    def add_residual_block(self, keys: Sequence[str], factor: Factor,
                           loss: Optional[Loss] = None) -> int:
        """Add one factor on ``keys`` (declared here if new); returns its
        block id."""
        keys = tuple(keys)
        manifolds = factor.var_manifolds()
        if len(keys) != len(manifolds):
            raise ValueError(
                f"{type(factor).__name__} binds {len(manifolds)} variables, "
                f"got {len(keys)} keys")
        for k, m in zip(keys, manifolds):
            self.add_variable(k, m)
        self._blocks.append((keys, factor, loss))
        return len(self._blocks) - 1

    def remove_residual_block(self, block_id: int):
        self._blocks[block_id] = None

    def add_variables_batch(self, names: Sequence[str], manifold, values: np.ndarray):
        mname = manifold if isinstance(manifold, str) else manifold.name
        G = get_manifold(mname)
        values = np.asarray(values, dtype=np.float64)
        if values.shape != (len(names), G.storage_dim):
            raise ValueError(
                f"expected values of shape ({len(names)}, {G.storage_dim}), "
                f"got {values.shape}")
        for i, n in enumerate(names):
            self._manifold_of[n] = mname
            self._values[n] = values[i]

    def add_residual_block_batch(
        self,
        slot_keys: Sequence,
        template: Factor,
        data: Dict[str, np.ndarray],
        loss: Optional[Loss] = None,
        loss_params: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
    ):
        """Add K factors sharing ``template``'s signature and kernel, with
        per-factor ``data`` arrays [K, ...]. ``slot_keys[s]`` is either the
        list of K variable names bound to slot s, or ``(base_names, idx)``
        with ``idx`` indexing into ``base_names``. Variables must exist."""
        manifolds = template.var_manifolds()
        if len(slot_keys) != len(manifolds):
            raise ValueError(
                f"{type(template).__name__} binds {len(manifolds)} slots, got "
                f"{len(slot_keys)}")
        norm_slots = []
        counts = {v.shape[0] for v in data.values()}
        for s, m in enumerate(manifolds):
            sk = slot_keys[s]
            if isinstance(sk, tuple) and len(sk) == 2 and not isinstance(sk[0], str):
                base_names, idx = sk
                idx = np.asarray(idx, dtype=np.int64)
                if idx.min() < 0 or idx.max() >= len(base_names):
                    raise IndexError(f"slot {s}: index out of range")
                names, kind = tuple(base_names), "indexed"
                counts.add(idx.shape[0])
            else:
                names, kind, idx = tuple(sk), "named", None
                counts.add(len(names))
            for k in names:
                if k not in self._manifold_of:
                    raise KeyError(f"unknown variable {k!r} (add variables first)")
                if self._manifold_of[k] != m:
                    raise ValueError(
                        f"slot {s} expects {m}, variable {k!r} is "
                        f"{self._manifold_of[k]}")
            norm_slots.append((kind, names, idx))
        if len(counts) != 1:
            raise ValueError(f"inconsistent batch sizes: {counts}")
        count = counts.pop()
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float64).reshape(count)
        self._bulk.append((tuple(norm_slots), template, dict(data),
                           loss, loss_params, weights, count))

    def fix_variable(self, name: str, indices: Optional[Sequence[int]] = None):
        if name not in self._manifold_of:
            raise KeyError(f"unknown variable {name!r}")
        if indices is None:
            self._fixed[name] = None  # all DOF
        else:
            prev = self._fixed.get(name, [])
            if prev is None:
                return
            self._fixed[name] = sorted(set(list(prev) + list(indices)))

    def set_variable_bounds(self, name: str, lower, upper):
        if name not in self._manifold_of:
            raise KeyError(f"unknown variable {name!r}")
        self._bounds[name] = (np.asarray(lower, dtype=np.float64),
                              np.asarray(upper, dtype=np.float64))

    @property
    def num_residual_blocks(self) -> int:
        return (sum(1 for b in self._blocks if b is not None)
                + sum(b[-1] for b in self._bulk))

    @property
    def variable_names(self) -> List[str]:
        return sorted(self._manifold_of, key=_natural_key)

    # -- compilation -------------------------------------------------------

    def _block_batches(self) -> List[tuple]:
        """The single residual blocks as bulk batches, one per (factor
        signature, loss kind) in first-seen order, with per-block data and
        loss parameters stacked. They come before the bulk batches: the
        JAX package's group order."""
        grouped: Dict[tuple, list] = {}
        for blk in self._blocks:
            if blk is not None:
                _, factor, loss = blk
                sig = (factor.signature(), loss.kind if loss is not None else "l2")
                grouped.setdefault(sig, []).append(blk)
        out = []
        for blocks in grouped.values():
            keys0, f0, loss0 = blocks[0]
            slot_keys = tuple(("named", tuple(b[0][s] for b in blocks), None)
                              for s in range(len(keys0)))
            data = {k: np.stack([np.asarray(b[1].data()[k]) for b in blocks])
                    for k in sorted(f0.data())}
            params = np.stack([np.asarray(b[2].params if b[2] is not None else (),
                                          dtype=np.float64) for b in blocks])
            out.append((slot_keys, f0, data, loss0, params, None, len(blocks)))
        return out

    def _edge_arrays(self, id_of):
        """Variable-pair edges (with duplicates) as int64 arrays: the
        connectivity graph for fill-reducing ordering."""
        out_r = [np.zeros(0, dtype=np.int64)]
        out_c = [np.zeros(0, dtype=np.int64)]
        for slot_keys, *_ in self._block_batches() + self._bulk:
            slot_ids = []
            for kind, names_s, base_idx in slot_keys:
                base = np.asarray([id_of[k] for k in names_s], dtype=np.int64)
                slot_ids.append(base[base_idx] if kind == "indexed" else base)
            for a in range(len(slot_ids)):
                for b in range(a + 1, len(slot_ids)):
                    out_r.append(slot_ids[a])
                    out_c.append(slot_ids[b])
        return np.concatenate(out_r), np.concatenate(out_c)

    @staticmethod
    def _layout_bandwidth(order, dof_arr, er, ec):
        """Tangent-column block bandwidth of the coupling pattern under a
        variable ordering (``order``: permutation of variable ids)."""
        n = len(order)
        cols = np.zeros(n, dtype=np.int64)
        cols[order] = np.concatenate([[0], np.cumsum(dof_arr[order])[:-1]])
        if er.size == 0:
            return int(dof_arr.max(initial=1))
        lo = np.minimum(cols[er], cols[ec])
        hi = np.maximum(cols[er] + dof_arr[er], cols[ec] + dof_arr[ec])
        return int(max((hi - lo).max(), dof_arr.max()))

    # Auto-ordering guards, the JAX package's: RCM only where the name-order
    # band is wide and the host-side graph build stays cheap.
    _RCM_AUTO_BANDWIDTH = 768
    _RCM_MAX_VARS = 200_000
    _RCM_MAX_EDGES = 4_000_000

    def _ordered_names(self, names_sorted, ordering: str):
        """``name`` keeps the numeric-aware name sort; ``rcm`` applies
        reverse Cuthill-McKee over the variable connectivity graph; ``auto``
        applies RCM only when the name-order bandwidth exceeds the panel
        threshold and RCM narrows it."""
        if ordering == "name" or len(names_sorted) < 3:
            return names_sorted
        if ordering not in ("rcm", "auto"):
            raise ValueError(f"unknown ordering {ordering!r}")
        id_of = {n: i for i, n in enumerate(names_sorted)}
        nv = len(names_sorted)
        if ordering == "auto" and nv > self._RCM_MAX_VARS:
            return names_sorted
        dof_arr = np.asarray(
            [get_manifold(self._manifold_of[n]).dof for n in names_sorted],
            dtype=np.int64)
        er, ec = self._edge_arrays(id_of)
        if ordering == "auto" and er.size > self._RCM_MAX_EDGES:
            return names_sorted
        Wn = self._layout_bandwidth(np.arange(nv), dof_arr, er, ec)
        if ordering == "auto" and Wn <= self._RCM_AUTO_BANDWIDTH:
            return names_sorted
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        ones = np.ones(er.size, dtype=np.int8)
        A = sp.coo_matrix(
            (np.concatenate([ones, ones]),
             (np.concatenate([er, ec]), np.concatenate([ec, er]))),
            shape=(nv, nv)).tocsr()
        perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                          dtype=np.int64)
        Wr = self._layout_bandwidth(perm, dof_arr, er, ec)
        if ordering == "auto" and Wr >= Wn:
            return names_sorted
        return [names_sorted[i] for i in perm]

    @annotate("problem.compile")
    def compile(self, initial_values: Optional[Dict[str, np.ndarray]] = None,
                dtype=None, device="cuda", ordering: str = "auto") -> "CompiledProblem":
        """Freeze the graph into tensors of ``dtype`` (default
        ``config.default_dtype()``: f64, f32 under ``APEX_TPU_NO_X64=1``) on
        ``device`` (default ``"cuda"``, the card; ``"cpu"`` runs the plain
        PyTorch path). Asking for the card where there is none raises."""
        dtype = resolve_dtype(dtype)
        device = resolve_device(device)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32

        def to_dev(arr, float_data=True):
            arr = np.asarray(arr)
            arr = arr.astype(np_dtype) if float_data else arr.astype(np.int64)
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

        values = dict(self._values)
        for k, v in (initial_values or {}).items():
            if k not in self._manifold_of:
                raise KeyError(f"initial value for unknown variable {k!r}")
            values[k] = np.asarray(v, dtype=np.float64)
        missing = [n for n in self._manifold_of if n not in values]
        if missing:
            raise ValueError(f"no initial value for variables: {missing[:5]}...")

        names_sorted = sorted(self._manifold_of, key=_natural_key)
        names_layout = self._ordered_names(names_sorted, ordering)
        dof_of = {m: get_manifold(m).dof for m in set(self._manifold_of.values())}
        dofs = np.fromiter((dof_of[self._manifold_of[n]] for n in names_layout),
                           dtype=np.int64, count=len(names_layout))
        offsets = np.cumsum(dofs) - dofs
        col_of: Dict[str, int] = dict(zip(names_layout, offsets.tolist()))
        total_dof = int(dofs.sum())

        # Pools per manifold name, rows in sorted-name order.
        pool_id_of_manifold: Dict[str, int] = {}
        pool_names: List[List[str]] = []
        for n in names_sorted:
            m = self._manifold_of[n]
            if m not in pool_id_of_manifold:
                pool_id_of_manifold[m] = len(pool_names)
                pool_names.append([])
            pool_names[pool_id_of_manifold[m]].append(n)

        var_loc: Dict[str, Tuple[int, int]] = {}
        pools: List[VarPool] = []
        host_free: Dict[int, np.ndarray] = {}
        host_pool_cols: Dict[int, np.ndarray] = {}
        for m, pid in sorted(pool_id_of_manifold.items(), key=lambda kv: kv[1]):
            G = get_manifold(m)
            names = pool_names[pid]
            vals = np.stack([values[n] for n in names])
            free = np.ones((len(names), G.dof))
            lb = np.full((len(names), G.storage_dim), -np.inf)
            ub = np.full((len(names), G.storage_dim), np.inf)
            cols = np.array([col_of[n] for n in names], dtype=np.int64)
            row_of = dict(zip(names, range(len(names))))
            var_loc.update((n, (pid, i)) for n, i in row_of.items())
            for n, idx in self._fixed.items():
                i = row_of.get(n)
                if i is None:
                    continue
                if idx is None:
                    free[i, :] = 0.0
                else:
                    free[i, [j for j in idx if j < G.dof]] = 0.0
            for n, (blo, bhi) in self._bounds.items():
                i = row_of.get(n)
                if i is not None:
                    lb[i, : len(blo)] = blo
                    ub[i, : len(bhi)] = bhi
            host_free[pid] = free
            host_pool_cols[pid] = cols.astype(np.int32)
            pools.append(VarPool(
                manifold=G, names=names, values0=to_dev(vals),
                free_mask=to_dev(free), lower=to_dev(lb), upper=to_dev(ub),
                cols=to_dev(cols, float_data=False)))

        groups: List[FactorGroup] = []
        all_host_cols: List[List[np.ndarray]] = []
        row_offset = 0
        # (locations, columns) of each indexed slot's base names, once per
        # distinct name list: the bucketed BA layout's groups share theirs
        base_of: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}
        for (slot_keys, template, bdata, loss, loss_params, wts,
             count) in self._block_batches() + self._bulk:
            manifolds = tuple(get_manifold(m) for m in template.var_manifolds())
            d = template.residual_dim()
            lkind = loss.kind if loss is not None else "l2"
            nparams = loss.num_params if loss is not None else 0
            if loss_params is None:
                lp = np.tile(np.asarray(loss.params if loss is not None else (),
                                        dtype=np.float64), (count, 1))
            else:
                lp = np.asarray(loss_params, dtype=np.float64)
            lp = lp.reshape(count, nparams)

            idx_arrays, col_arrays, pool_ids, mask_arrays, host_cols = [], [], [], [], []
            for kind, names_s, base_idx in slot_keys:
                if kind == "indexed":
                    if names_s not in base_of:
                        base_of[names_s] = (
                            np.asarray([var_loc[k] for k in names_s], dtype=np.int64),
                            np.asarray([col_of[k] for k in names_s], dtype=np.int32))
                    base_locs, base_cols = base_of[names_s]
                    pids = set(base_locs[:, 0].tolist())
                    rows = base_locs[base_idx, 1]
                    cols_s = base_cols[base_idx]
                else:
                    locs = [var_loc[k] for k in names_s]
                    pids = {p for p, _ in locs}
                    rows = np.asarray([r for _, r in locs], dtype=np.int64)
                    cols_s = np.asarray([col_of[k] for k in names_s], dtype=np.int32)
                if len(pids) != 1:
                    raise AssertionError("slot spans multiple pools")
                pid = pids.pop()
                pool_ids.append(pid)
                idx_arrays.append(to_dev(rows, float_data=False))
                col_arrays.append(to_dev(cols_s, float_data=False))
                host_cols.append(cols_s)
                slot_free = host_free[pid][rows]
                mask_arrays.append(None if np.all(slot_free == 1.0) else to_dev(slot_free))

            groups.append(FactorGroup(
                factor_cls=type(template),
                kernel=template.group_kernel(),
                manifolds=manifolds,
                data={k: to_dev(v) for k, v in bdata.items()},
                loss_kind=lkind,
                loss_params=to_dev(lp),
                pool_ids=tuple(pool_ids),
                indices=tuple(idx_arrays),
                cols=tuple(col_arrays),
                free_masks=tuple(mask_arrays),
                weights=None if wts is None else to_dev(wts),
                residual_dim=d,
                row_offset=row_offset,
                count=count,
                factor=template,
            ))
            row_offset += d * count
            all_host_cols.append(host_cols)

        cp = CompiledProblem(pools=pools, groups=groups, var_loc=var_loc,
                             total_dof=total_dof, total_residual_dim=row_offset,
                             dtype=dtype, device=device)
        # Host copies of the index arrays: structure analysis (Schur
        # classification) reads these and never copies back from the card.
        cp.host_group_cols = all_host_cols
        cp.host_pool_cols = host_pool_cols
        return cp


class CompiledProblem:
    """Frozen factor graph on one device. Every method is a plain function
    of ``values`` (a tuple of pool tensors)."""

    def __init__(self, pools, groups, var_loc, total_dof, total_residual_dim,
                 dtype, device):
        self.pools: List[VarPool] = pools
        self.groups: List[FactorGroup] = groups
        self.var_loc: Dict[str, Tuple[int, int]] = var_loc
        self.total_dof = total_dof
        self.total_residual_dim = total_residual_dim
        self.dtype = dtype
        self.device = device
        self.host_group_cols: List[List[np.ndarray]] = []
        self.host_pool_cols: Dict[int, np.ndarray] = {}

    # -- state helpers -----------------------------------------------------

    def initial_values(self) -> Tuple[torch.Tensor, ...]:
        return tuple(p.values0 for p in self.pools)

    @annotate("problem.values_dict")
    def values_dict(self, values) -> VariableMap:
        """{name: host storage vector} as a ``VariableMap``: one read-only
        host copy per pool, each vector a view of its pool's row, as the JAX
        package hands out (a write raises ``ValueError``), in its dict's
        order. The copy is made on the CPU too, so no array aliases a
        solver's pool tensor."""
        return VariableMap([arr.detach().to("cpu", copy=True).numpy() for arr in values],
                           self.var_loc)

    def get_value(self, values, name: str) -> torch.Tensor:
        pid, row = self.var_loc[name]
        return values[pid][row]

    # -- linearization -----------------------------------------------------

    def group_linearize(self, values, group: FactorGroup, compute_jacobian: bool):
        """gather -> factor residual (+J) -> weights, free masks -> corrector."""
        params = [values[pid][idx] for pid, idx in zip(group.pool_ids, group.indices)]
        r, jacs = group.kernel(group.manifolds, group.data, params, compute_jacobian)
        if group.weights is not None:
            r = r * group.weights[:, None]
            if compute_jacobian:
                jacs = [j * group.weights[:, None, None] for j in jacs]
        if compute_jacobian and any(m is not None for m in group.free_masks):
            jacs = [j if m is None else j * m[:, None, :]
                    for j, m in zip(jacs, group.free_masks)]
        if group.loss_kind == "l2":
            return r, jacs
        if not compute_jacobian:
            return correct(group.loss_kind, group.loss_params, r, None)
        r_t, J_t = correct(group.loss_kind, group.loss_params, r,
                           torch.cat(jacs, dim=-1))
        return r_t, list(torch.split(J_t, [G.dof for G in group.manifolds], dim=-1))

    def residual_vector(self, values) -> torch.Tensor:
        """Stacked (corrected) residual vector, group-major."""
        parts = [self.group_linearize(values, g, False)[0].reshape(-1)
                 for g in self.groups]
        if not parts:
            return torch.zeros(0, dtype=self.dtype, device=self.device)
        return torch.cat(parts)

    def cost(self, values) -> torch.Tensor:
        """cost = 0.5 * ||r||^2."""
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for g in self.groups:
            r, _ = self.group_linearize(values, g, False)
            total = total + 0.5 * torch.sum(r * r)
        return total

    def _slot_cols(self, group: FactorGroup, s: int) -> torch.Tensor:
        """[K, dof_s] global tangent columns of slot s."""
        return group.cols[s][:, None] + torch.arange(group.manifolds[s].dof,
                                                     device=self.device)

    def scatter_normal(self, H, gvec, cost, group: FactorGroup, r, jacs):
        """Accumulate one linearized group into the dense (H, g, cost): each
        per-factor block J_s^T J_t and J_s^T r added in place with
        ``index_add_`` into H's and g's storage."""
        cost = cost + 0.5 * torch.sum(r * r)
        D = self.total_dof
        for s, Js in enumerate(jacs):
            rows = self._slot_cols(group, s)
            gvec.index_add_(0, rows.reshape(-1), (Js.mT @ r[..., None]).reshape(-1))
            for t, Jt in enumerate(jacs):
                flat = rows[:, :, None] * D + self._slot_cols(group, t)[:, None, :]
                H.view(-1).index_add_(0, flat.reshape(-1), (Js.mT @ Jt).reshape(-1))
        return H, gvec, cost

    def assemble_normal(self, values):
        """The Gauss-Newton normal equations H = J^T J (dense [D, D]),
        g = J^T r and the cost, without the global J."""
        D = self.total_dof
        H = torch.zeros(D, D, dtype=self.dtype, device=self.device)
        gvec = torch.zeros(D, dtype=self.dtype, device=self.device)
        cost = torch.zeros((), dtype=self.dtype, device=self.device)
        for g in self.groups:
            r, jacs = self.group_linearize(values, g, True)
            H, gvec, cost = self.scatter_normal(H, gvec, cost, g, r, jacs)
        return H, gvec, cost

    def assemble_dense_jacobian(self, values):
        """The stacked residual [R] and dense Jacobian [R, D], for the QR
        solver on small problems. Each group owns the rows
        ``row_offset + arange(count * residual_dim)``."""
        R, D = self.total_residual_dim, self.total_dof
        Jd = torch.zeros(R, D, dtype=self.dtype, device=self.device)
        parts = []
        for g in self.groups:
            r, jacs = self.group_linearize(values, g, True)
            parts.append(r.reshape(-1))
            rows = Jd[g.row_offset:g.row_offset + g.count * g.residual_dim]
            Jg = rows.view(g.count, g.residual_dim, D)
            for s, Js in enumerate(jacs):
                Jg.scatter_add_(2, self._slot_cols(g, s)[:, None, :].expand(Js.shape), Js)
        rv = torch.cat(parts) if parts else Jd.new_zeros(0)
        return rv, Jd

    def normal_diag_max(self, values) -> torch.Tensor:
        """max_i (J^T J)_ii without assembling H (Madsen-Nielsen initial
        damping, ``damping="auto"``)."""
        diag = torch.zeros(self.total_dof, dtype=self.dtype, device=self.device)
        for g in self.groups:
            _, jacs = self.group_linearize(values, g, True)
            for s in range(len(g.manifolds)):
                diag.index_add_(0, self._slot_cols(g, s).reshape(-1),
                                torch.sum(jacs[s] * jacs[s], dim=1).reshape(-1))
        return torch.max(diag)

    # -- state update ------------------------------------------------------

    def apply_step(self, values, dx):
        """Manifold plus per variable, fixed DOF masked out of the step, then
        the bounds clamp."""
        new_values = []
        for p, arr in zip(self.pools, values):
            G = p.manifold
            steps = dx[p.cols[:, None] + torch.arange(G.dof, device=dx.device)]
            new = G.normalize(G.plus(arr, steps * p.free_mask))
            new_values.append(torch.clamp(new, p.lower, p.upper))
        return tuple(new_values)

    def parameter_norm(self, values) -> torch.Tensor:
        """sqrt of the summed squared storage vectors."""
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for arr in values:
            total = total + torch.sum(arr * arr)
        return torch.sqrt(total)

    # -- debugging -----------------------------------------------------------

    def dump_debug(self, directory, values, with_jacobian: bool = False):
        """Write the residuals, the variables (and optionally the dense
        Jacobian) as text files for offline inspection, in the JAX package's
        formats: ``residuals.txt`` and ``jacobian.txt`` by ``np.savetxt``,
        ``variables.txt`` one name and its storage (``%.17e``) per line, in
        name order."""
        os.makedirs(directory, exist_ok=True)
        r = self.residual_vector(values).detach().cpu().numpy()
        np.savetxt(os.path.join(directory, "residuals.txt"), r)
        with open(os.path.join(directory, "variables.txt"), "w") as f:
            for name, v in sorted(self.values_dict(values).items()):
                f.write(f"{name} {' '.join(f'{x:.17e}' for x in v)}\n")
        if with_jacobian:
            _, J = self.assemble_dense_jacobian(values)
            np.savetxt(os.path.join(directory, "jacobian.txt"), J.detach().cpu().numpy())
