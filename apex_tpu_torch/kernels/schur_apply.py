"""The coupling products of the implicit Schur solve: the CUDA kernels
``csrc/schur_apply.cu``, and the two row orders of a coupling group that
they and the assembly kernels (``kernels/schur_assemble.py``) walk.

For one coupling group of ``linalg/schur.py`` (rows k with couplings W_k
[De, 3], entity ``ent(k)``, landmark ``lm(k)``), the kernels add

- ``wt_x``: sum_k W_k^T x[ent(k)] into t [P, 3], or, fused with the
  landmark blocks' inverse, store Hpp^-1[p] t_p for each of the group's
  landmarks p (where no other group has them);
- ``w_u``: sum_k W_k u[lm(k)] into y [E, De];
- ``schur_diagonal``: sum_k W_k Hpp^-1[lm(k)] W_k^T into Z [E, De, De].

Their plain version is ``linalg/schur.py``'s gather, batched product and
``index_add_`` per group, which the CPU, an entity width the kernels are
not built for (``ENTITY_DOFS``) and a sharded context's rank plans run.
The kernels sum each landmark's run of rows, then each entity's rows in
camera-major tiles and the tiles in order: no atomics, the same bits run
to run. The JAX package leaves these sums to XLA; no TPU kernel is
replaced.

``plan_orders`` builds a group's ``RowOrders`` once, on the host
(``SchurContext`` does, for every coupling group of a CUDA problem). Each
wrapper launches the kernels for CUDA tensors, f32 or f64, and counts each
call in ``launches`` (one or two kernels); under CUDA graph capture it
counts in ``captured`` instead, and ``optim/graphs.py`` counts the replayed
calls. The kernels are built with ``nvcc`` into ``build/apex_tpu_torch/``
at first use and bound with ``ctypes`` (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import build as _build

SOURCE = _build.CSRC / "schur_apply.cu"
# rows of one entity per tile of the camera-major order (a CTA each)
TILE_ROWS = 1024
# the entity widths the kernels are built for: pose and intrinsics, pose
ENTITY_DOFS = (9, 6)

launches = 0
captured = 0

_fns: dict = {}
_WT_X, _W_U, _DIAG = 0, 1, 2

_POINTERS = ("W", "lm_perm", "lm_ent", "seg_lm", "seg_off", "cam_perm", "cam_lm", "tile_off",
             "fin_ent", "fin_off", "inp", "Hinv", "out", "part")  # "inp": the source's "in"
_SIZES = ("S", "width", "T", "Eg")


class _Args(ctypes.Structure):
    """``struct SchurApplyArgs`` of the source, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_longlong) for n in _SIZES])


@dataclasses.dataclass
class RowOrders:
    """A coupling group's rows in landmark-major runs and in camera-major
    tiles (int32 tensors on the problem's device)."""

    lm_perm: Optional[torch.Tensor]  # [K] landmark-major order; None: the rows' own
    lm_ent: torch.Tensor  # [K] entity of each row, in landmark-major order
    seg_lm: torch.Tensor  # [S] landmark of each run
    seg_off: torch.Tensor  # [S + 1] run bounds in landmark-major order
    width: int  # lanes per run: a power of two, the longest run's up to 32
    cam_perm: torch.Tensor  # [K] camera-major order
    cam_lm: torch.Tensor  # [K] landmark of each row, in camera-major order
    tile_off: torch.Tensor  # [T + 1] tile bounds in camera-major order
    fin_ent: torch.Tensor  # [Eg] the entities with rows in the group
    fin_off: torch.Tensor  # [Eg + 1] their tiles

    @property
    def rows(self) -> int:
        return self.cam_perm.shape[0]

    @property
    def tiles(self) -> int:
        return self.tile_off.shape[0] - 1


def _ragged_arange(lengths):
    return np.arange(int(lengths.sum())) - np.repeat(np.cumsum(lengths) - lengths, lengths)


def plan_orders(ent, lm, num_entities, device) -> Optional[RowOrders]:
    """The row orders of one coupling group from host arrays: ``ent`` [K]
    each row's camera entity, ``lm`` [K] each row's landmark. None for a
    group of no rows or of 2^31 or more."""
    K = ent.size
    if not 0 < K < 2 ** 31:
        return None
    lm_perm = None
    lm_sorted, ent_sorted = lm, ent
    if np.any(np.diff(lm) < 0):
        lm_perm = np.argsort(lm, kind="stable")
        lm_sorted, ent_sorted = lm[lm_perm], ent[lm_perm]
    starts = np.flatnonzero(np.r_[True, lm_sorted[1:] != lm_sorted[:-1]])
    seg_off = np.r_[starts, K]
    width = min(32, 1 << (int(np.diff(seg_off).max()) - 1).bit_length())

    cam_perm = np.argsort(ent, kind="stable")
    counts = np.bincount(ent, minlength=num_entities)
    present = np.flatnonzero(counts)
    n_tiles = -(-counts[present] // TILE_ROWS)
    first = (np.cumsum(counts) - counts)[present]
    tile_start = np.repeat(first, n_tiles) + TILE_ROWS * _ragged_arange(n_tiles)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    return RowOrders(
        lm_perm=None if lm_perm is None else dev(lm_perm), lm_ent=dev(ent_sorted),
        seg_lm=dev(lm_sorted[starts]), seg_off=dev(seg_off), width=width,
        cam_perm=dev(cam_perm), cam_lm=dev(lm[cam_perm]), tile_off=dev(np.r_[tile_start, K]),
        fin_ent=dev(present), fin_off=dev(np.r_[0, np.cumsum(n_tiles)]))


def build() -> dict:
    """Compile the kernels (once per source and flag set), load them and
    bind their entry points: ``{dtype: C function}``."""
    if _fns:
        return _fns
    lib = _build.shared_library("schur_apply")
    for dtype, name in ((torch.float32, "schur_apply_f32"), (torch.float64, "schur_apply_f64")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns


def _launch(op, orders: RowOrders, W, inp, Hinv, out, part_width):
    """Check the tensors, launch ``op`` over one group's rows and count it."""
    global launches, captured
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    dt, dev = W.dtype, W.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the coupling kernels take float32 or float64, got {dt}")
    De = W.shape[1] if W.dim() == 3 else 0
    if De not in ENTITY_DOFS or tuple(W.shape) != (orders.rows, De, 3) or not W.is_contiguous():
        raise ValueError(f"W {tuple(W.shape)} (contiguous: {W.is_contiguous()}): the kernels "
                         f"take a contiguous [{orders.rows}, De, 3], De in {ENTITY_DOFS}")
    # (name, tensor, its shape after the first dimension)
    checks = {_WT_X: [("x", inp, (De,)), ("out", out, (3,))]
              + ([("Hinv", Hinv, (3, 3))] if Hinv is not None else []),
              _W_U: [("u", inp, (3,)), ("out", out, (De,))],
              _DIAG: [("Hinv", Hinv, (3, 3)), ("out", out, (De, De))]}[op]
    for name, t, tail in checks:
        if t is None:
            raise ValueError(f"{name} missing")
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: the kernels take a contiguous {dt} tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous: {t.is_contiguous()})")
        if tuple(t.shape[1:]) != tail or t.dim() != len(tail) + 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the kernels take [n, "
                             f"{', '.join(map(str, tail))}]")
    part = (torch.empty((orders.tiles, part_width), dtype=dt, device=dev)
            if part_width else None)
    ptr = {"W": W, "lm_perm": orders.lm_perm, "lm_ent": orders.lm_ent, "seg_lm": orders.seg_lm,
           "seg_off": orders.seg_off, "cam_perm": orders.cam_perm, "cam_lm": orders.cam_lm,
           "tile_off": orders.tile_off, "fin_ent": orders.fin_ent, "fin_off": orders.fin_off,
           "inp": inp, "Hinv": Hinv, "out": out, "part": part}
    args = _Args(**{name: None if t is None else t.data_ptr() for name, t in ptr.items()},
                 S=orders.seg_lm.shape[0], width=orders.width, T=orders.tiles,
                 Eg=orders.fin_ent.shape[0])
    fn = (_fns or build())[dt]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = fn(ctypes.byref(args), op, De, index, _build.current_stream(index))
    if err != 0:
        raise RuntimeError(f"schur_apply kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1


def wt_x(orders: RowOrders, W, x, out, Hinv=None):
    """Add the group's sum_k W_k^T x[ent(k)] into ``out`` [P, 3] (``x``
    [E, De]); with ``Hinv`` [P, 3, 3], store Hinv[p] t_p in ``out`` for
    each of the group's landmarks p instead, which no other group may
    have."""
    _launch(_WT_X, orders, W, x, Hinv, out, 0)


def w_u(orders: RowOrders, W, u, out):
    """Add the group's sum_k W_k u[lm(k)] into ``out`` [E, De] (``u``
    [P, 3])."""
    _launch(_W_U, orders, W, u, None, out, W.shape[1])


def schur_diagonal(orders: RowOrders, W, Hinv, out):
    """Add the group's sum_k W_k Hinv[lm(k)] W_k^T into ``out`` [E, De, De]
    (``Hinv`` [P, 3, 3]), both triangles from the upper one."""
    De = W.shape[1]
    _launch(_DIAG, orders, W, None, Hinv, out, De * (De + 1) // 2)
