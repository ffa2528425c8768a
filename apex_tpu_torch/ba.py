"""Bundle adjustment problem builder (counterpart of ``apex_tpu/ba.py``).

Mirrors the reference CLI's problem construction (bin/bundle_adjustment.rs):
- variables ``pose_NNNN`` (SE3, world-to-camera), ``intr_NNNN`` (R3
  [f, k1, k2]), ``pt_NNNNN`` (R3) (:232-257)
- one ProjectionFactor<BALPinholeCameraStrict> per observation with
  HuberLoss(1.0) (:425-428)
- first camera fixed (all 6 DOF) for gauge (:294-298)
- the 5 optimization modes via --type (:70-83)
- RMSE = sqrt(cost / num_observations) (:364-373)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .cameras import get as get_camera
from .core.losses import HuberLoss, Loss
from .core.problem import Problem
from .factors.projection import OPTIMIZE_MODES, ProjectionFactor
from .io.bal import BalDataset
from .utils.profiling import annotate


@annotate("ba.build_ba_problem")
def build_ba_problem(
    ds: BalDataset,
    mode: str = "self_calibration",
    loss: Optional[Loss] = HuberLoss(1.0),
    fix_first_camera: bool = True,
    max_points: Optional[int] = None,
    camera_model: str = "bal_pinhole",
    layout: str = "bucketed",
) -> Problem:
    """Build an optimization Problem from a BAL dataset.

    ``layout="bucketed"`` (default) renumbers landmarks bucket-major by
    observation count (power-of-two caps) and pads each landmark's
    observation run to its bucket cap with weight-0 duplicates, one factor
    group per bucket (total padded rows <= 2x). ``layout="flat"`` keeps one
    landmark-sorted group (the same math). Both give the JAX package's
    variable names, groups and rows, so the two packages compare row by
    row."""
    if mode not in OPTIMIZE_MODES:
        raise KeyError(f"unknown mode {mode!r}; known: {sorted(OPTIMIZE_MODES)}")
    optimize = OPTIMIZE_MODES[mode]
    camera = get_camera(camera_model)

    cam_idx = ds.cam_indices
    pt_idx = ds.point_indices
    obs = ds.observations
    if max_points is not None and max_points < ds.num_points:
        keep_pts = np.zeros(ds.num_points, dtype=bool)
        keep_pts[:max_points] = True
        keep = keep_pts[pt_idx]
        cam_idx, pt_idx, obs = cam_idx[keep], pt_idx[keep], obs[keep]
        n_pts = max_points
    else:
        n_pts = ds.num_points

    # Canonical observation order: sorted by (landmark, camera), so the
    # landmark-direction sums of the Schur solver read contiguous rows.
    order = np.lexsort((cam_idx, pt_idx))
    cam_idx, pt_idx, obs = cam_idx[order], pt_idx[order], obs[order]

    pt_perm = None
    if layout == "bucketed":
        # Renumber landmarks bucket-major (ascending cap, then old id), so
        # each bucket's landmarks occupy a consecutive id range.
        counts = np.bincount(pt_idx, minlength=n_pts)
        caps = np.maximum(1, 2 ** np.ceil(
            np.log2(np.maximum(counts, 1))).astype(np.int64))
        # zero-observation landmarks sort to the end so each bucket's ids
        # stay consecutive
        sort_key = np.where(counts > 0, caps, np.int64(1) << 62)
        pt_perm = np.lexsort((np.arange(n_pts), sort_key))  # bucket-major
        new_of_old = np.empty(n_pts, dtype=np.int64)
        new_of_old[pt_perm] = np.arange(n_pts)
        pt_idx = new_of_old[pt_idx]
        order = np.lexsort((cam_idx, pt_idx))
        cam_idx, pt_idx, obs = cam_idx[order], pt_idx[order], obs[order]

        # Pad each landmark's observation run to its bucket cap with
        # weight-0 duplicates of its first observation.
        counts_new = np.bincount(pt_idx, minlength=n_pts)
        caps_new = caps[pt_perm]
        caps_new = np.where(counts_new > 0, caps_new, 0)
        starts = np.zeros(n_pts, dtype=np.int64)
        np.cumsum(counts_new[:-1], out=starts[1:])
        seen = counts_new > 0
        reps = np.repeat(starts[seen], caps_new[seen])  # dummy source rows
        offs = _ragged_arange(caps_new[seen])
        take = np.where(
            offs < np.repeat(counts_new[seen], caps_new[seen]),
            reps + offs, reps)
        weights = (offs < np.repeat(counts_new[seen], caps_new[seen])
                   ).astype(np.float64)
        cam_idx, pt_idx, obs = cam_idx[take], pt_idx[take], obs[take]
        bucket_cap = np.repeat(caps_new[seen], caps_new[seen])
    else:
        weights = None
        bucket_cap = None

    problem = Problem()
    pose_names = [f"pose_{i:04d}" for i in range(ds.num_cameras)]
    intr_names = [f"intr_{i:04d}" for i in range(ds.num_cameras)]
    # Landmark ids follow the (possibly renumbered) bucket-major order —
    # variable columns are assigned by name sort, so names must follow the
    # new order too. problem._pt_perm maps new id -> original BAL index.
    pts_vals = ds.points[:n_pts] if pt_perm is None else ds.points[:n_pts][pt_perm]
    pt_names = [f"pt_{j:05d}" for j in range(n_pts)]

    # Only optimized quantities become variables; the rest ride along as
    # per-observation constants (reference OptimizeParams semantics).
    if "pose" in optimize:
        problem.add_variables_batch(pose_names, "SE3", ds.camera_se3())
    if "intrinsics" in optimize:
        problem.add_variables_batch(intr_names, "R3", ds.intrinsics())
    if "landmark" in optimize:
        problem.add_variables_batch(pt_names, "R3", pts_vals)

    template = ProjectionFactor.template(camera, optimize)

    def add_rows(sel):
        ci, pi, ob = cam_idx[sel], pt_idx[sel], obs[sel]
        slot_keys = []
        data = {"obs": np.asarray(ob)}
        for slot in ("pose", "landmark", "intrinsics"):
            names = {"pose": pose_names, "landmark": pt_names,
                     "intrinsics": intr_names}[slot]
            per_obs_idx = {"pose": ci, "landmark": pi, "intrinsics": ci}[slot]
            if slot in optimize:
                # (base_names, idx): no per-observation name lists
                slot_keys.append((names, per_obs_idx))
            else:
                vals = {
                    "pose": ds.camera_se3(),
                    "landmark": pts_vals,
                    "intrinsics": ds.intrinsics(),
                }[slot]
                data[f"const_{slot}"] = vals[per_obs_idx]
        w = None if weights is None else weights[sel]
        problem.add_residual_block_batch(slot_keys, template, data,
                                         loss=loss, weights=w)

    if bucket_cap is None:
        add_rows(np.ones(len(cam_idx), dtype=bool))
    else:
        # one factor group per bucket cap: uniform landmark run length
        for c in np.unique(bucket_cap):
            add_rows(bucket_cap == c)

    if fix_first_camera and "pose" in optimize:
        problem.fix_variable(pose_names[0])
    problem._pt_perm = pt_perm  # new landmark id -> original BAL index
    return problem


def _ragged_arange(lengths: np.ndarray) -> np.ndarray:
    """[0..l0-1, 0..l1-1, ...] for integer lengths (vectorized)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lengths)
    out = np.arange(total, dtype=np.int64)
    resets = np.zeros(total, dtype=np.int64)
    resets[ends[:-1]] = lengths[:-1]
    return out - np.cumsum(resets)


def rmse(cost: float, num_observations: int) -> float:
    """RMSE in pixels = sqrt(cost / N) (bin/bundle_adjustment.rs:364-373)."""
    return float(np.sqrt(cost / num_observations))
