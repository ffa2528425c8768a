"""Fused BAL projection linearization and implicit-Schur assembly: the CUDA
kernels ``csrc/schur_assemble.cu``.

For one factor group of ``ProjectionFactor`` rows with the ``bal_pinhole``
camera, the kernels go from the pool tensors and the group's indices to the
group's contributions to ``SchurContext.assemble``'s H_cc, g_c, H_pp, g_p
and cost, and return its couplings W ``[K, De, 3]``. They compute what the
generic path computes (``CompiledProblem.group_linearize``, then the
``index_add_`` sums of ``linalg/schur.py``), per row with the same
formulas, and sum in their own order: each landmark's run of rows, then
each camera entity's rows in camera-major order. The generic path is their
plain version: the tests hold them to it. The JAX package leaves this to
XLA; no TPU kernel is replaced.

``plan_group`` builds a group's plan once, on the host (``SchurContext``
does, for the groups of a CUDA problem that ``takes`` accepts) from the
group's row orders (landmark-major runs and camera-major tiles,
``kernels/schur_apply.py``'s ``RowOrders``, which the coupling kernels walk
too): each entity's column offsets. ``assemble_group`` launches the
kernels for CUDA tensors, f32 or f64, and counts each call in
``launches`` (three kernels, one launch here);
under CUDA graph capture it counts in ``captured`` instead, and
``optim/graphs.py`` counts the replayed calls. The kernels are built with
``nvcc`` into ``build/apex_tpu_torch/`` at first use and bound with
``ctypes`` (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..factors.projection import ProjectionFactor
from . import build as _build
from .schur_apply import RowOrders

SOURCE = _build.CSRC / "schur_assemble.cu"
# camera slots of the optimize modes the kernel takes; the landmark is slot 1
_MODES = {("pose", "landmark"): (0,), ("pose", "landmark", "intrinsics"): (0, 2)}

launches = 0
captured = 0

_fns: dict = {}

_POINTERS = ("pose", "pose_idx", "point", "point_idx", "intr", "intr_idx", "obs", "weight",
             "huber", "mask_pose", "mask_point", "mask_intr", "ent", "ent_cols", "lm_perm",
             "seg_lm", "seg_off", "cam_perm", "tile_off", "fin_ent", "fin_off", "W", "rec",
             "part", "Hcc", "gc", "Hpp", "gp", "cost")
_SIZES = ("S", "width", "T", "Eg", "De")


class _Args(ctypes.Structure):
    """``struct Args`` of the source, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_longlong) for n in _SIZES])


@dataclasses.dataclass
class KernelPlan:
    """A group's rows as the kernels walk them (int32 device tensors but
    ``ent``, the Schur plan's own int64 entity ids)."""

    nc: int  # camera columns per row: 9 (pose, intrinsics) or 6 (pose)
    ent: torch.Tensor  # [K] camera entity of each row
    ent_cols: torch.Tensor  # [E, 2] entity-local first column of the pose, the intrinsics
    orders: RowOrders  # the group's landmark-major runs and camera-major tiles

    @property
    def sums(self) -> int:
        """Partial sums per tile: Jc^T Jc's upper triangle, Jc^T r, r.r."""
        return self.nc * (self.nc + 1) // 2 + self.nc + 1


def build() -> dict:
    """Compile the kernels (once per source and flag set), load them and
    bind their entry points: ``{dtype: C function}``."""
    if _fns:
        return _fns
    lib = _build.shared_library("schur_assemble")
    for dtype, name in ((torch.float32, "schur_assemble_f32"),
                        (torch.float64, "schur_assemble_f64")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns


def takes(group, cam_slots, lm_slot) -> bool:
    """Whether the kernels compute this factor group: ``ProjectionFactor``
    with the ``bal_pinhole`` camera, pose and landmark optimized (intrinsics
    optimized or per-row constants), loss ``l2`` or ``huber``, f32 or f64,
    and the Schur plan's camera slots the pose (and intrinsics) slots."""
    f = group.factor
    return (type(f) is ProjectionFactor and f.camera.name == "bal_pinhole"
            and _MODES.get(f.optimize) == tuple(cam_slots) and lm_slot == 1
            and group.loss_kind in ("l2", "huber")
            and group.data["obs"].dtype in (torch.float32, torch.float64))


def plan_group(group, cam_slots, lm_slot, ent, locs, orders: Optional[RowOrders],
               num_entities, ent_t) -> Optional[KernelPlan]:
    """The plan of one coupling group from host arrays: ``ent`` [K] each
    row's camera entity, ``locs`` each camera slot's entity-local column
    per row; ``orders`` the group's row orders (``schur_apply.plan_orders``,
    None: the group has none); ``ent_t`` is ``ent`` on the device. None
    where the kernels do not take the group, or where a camera slot's
    column differs between rows of one entity."""
    if orders is None or not takes(group, cam_slots, lm_slot):
        return None
    ent_cols = np.full((num_entities, 2), -1, dtype=np.int32)
    for j, loc in enumerate(locs):
        ent_cols[ent, j] = loc
        if not np.array_equal(ent_cols[ent, j], loc):
            return None
    return KernelPlan(nc=3 * len(locs) + 3, ent=ent_t,
                      ent_cols=torch.as_tensor(ent_cols, device=ent_t.device), orders=orders)


def _slot_inputs(kp, group, values):
    """(pose, point, intrinsics pool or per-row constants, intrinsics index
    or None, masks of the pose, point, intrinsics) of a group."""
    intr, intr_idx = ((values[group.pool_ids[2]], group.indices[2]) if kp.nc == 9
                      else (group.data["const_intrinsics"], None))
    masks = tuple(group.free_masks) + (None,) * (3 - len(group.free_masks))
    return (values[group.pool_ids[0]], values[group.pool_ids[1]], intr, intr_idx,
            masks[0], masks[1], masks[2] if kp.nc == 9 else None)


def assemble_group(kp: KernelPlan, group, values, Hcc, gc, Hpp, gp, cost):
    """Add one group's H_cc [E, De, De], g_c [E, De], H_pp [P, 3, 3], g_p
    [P, 3] and cost [] contributions in place; return its W [K, De, 3].
    The tensors are CUDA tensors, contiguous, f32 or f64."""
    global launches, captured
    if Hcc.device.type != "cuda":
        raise ValueError(f"unsupported device {Hcc.device}")
    dt, dev = Hcc.dtype, Hcc.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the assembly kernels take float32 or float64, got {dt}")
    pose, point, intr, intr_idx, m_pose, m_point, m_intr = _slot_inputs(kp, group, values)
    K, De = group.count, Hcc.shape[-1]
    huber = group.loss_params if group.loss_kind == "huber" else None
    # {field: (tensor or None, its last dimension, None where any)}
    floats = {"pose": (pose, 7), "point": (point, 3), "intr": (intr, 3),
              "obs": (group.data["obs"], 2), "weight": (group.weights, None),
              "huber": (huber, 1), "mask_pose": (m_pose, 6), "mask_point": (m_point, 3),
              "mask_intr": (m_intr, 3), "Hcc": (Hcc, None), "gc": (gc, None),
              "Hpp": (Hpp, None), "gp": (gp, None), "cost": (cost, None)}
    for name, (t, width) in floats.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: the kernels take a contiguous {dt} tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous: {t.is_contiguous()})")
        if width is not None and t.shape[-1] != width:
            raise ValueError(f"{name}: last dimension {t.shape[-1]}, the kernels take {width}")
    if De < kp.nc or tuple(Hcc.shape[1:]) != (De, De) or tuple(Hpp.shape[1:]) != (3, 3):
        raise ValueError(f"blocks H_cc {tuple(Hcc.shape)}, H_pp {tuple(Hpp.shape)}")
    W = torch.empty((K, De, 3), dtype=dt, device=dev)
    rec = torch.empty((K, 2 * kp.nc + 2), dtype=dt, device=dev)
    o = kp.orders
    part = torch.empty((o.tiles, kp.sums), dtype=dt, device=dev)
    ptr = {"pose_idx": group.indices[0], "point_idx": group.indices[1], "intr_idx": intr_idx,
           "ent": kp.ent, "ent_cols": kp.ent_cols, "lm_perm": o.lm_perm, "seg_lm": o.seg_lm,
           "seg_off": o.seg_off, "cam_perm": o.cam_perm, "tile_off": o.tile_off,
           "fin_ent": o.fin_ent, "fin_off": o.fin_off, "W": W, "rec": rec, "part": part}
    ptr.update((name, t) for name, (t, _) in floats.items())
    args = _Args(**{name: None if t is None else t.data_ptr() for name, t in ptr.items()},
                 S=o.seg_lm.shape[0], width=o.width, T=o.tiles, Eg=o.fin_ent.shape[0], De=De)
    fn = (_fns or build())[dt]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = fn(ctypes.byref(args), kp.nc, index, _build.current_stream(index))
    if err != 0:
        raise RuntimeError(f"schur_assemble kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return W
