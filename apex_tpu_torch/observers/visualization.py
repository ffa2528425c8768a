"""Visualization observer (counterpart of
``apex_tpu/observers/visualization.py``, the same panels and records).

Cost / gradient-norm / damping / step-norm / step-quality time series,
Hessian heat maps (block-averaged downsampling, white-to-blue colormap),
gradient bar images, SE3 camera frusta, SE2 pose boxes, BA landmark clouds
with initial / optimized colors, displacement statistics, a convergence
banner, and the initial / final graph states.

All image and statistic computation is numpy on the host, and the SDK
calls go through a small sink interface. ``RerunSink`` wraps the optional
``rerun`` package and raises ``ImportError`` where it is absent;
``MemorySink`` records (path, kind, payload) tuples for tests and headless
use.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..manifolds import se3
from .base import OptObserver

logger = logging.getLogger("apex_tpu_torch.observers")


# ---------------------------------------------------------------------------
# Pure-numpy artifact helpers
# ---------------------------------------------------------------------------


def value_to_rgb_heatmap(values: np.ndarray, max_abs: float) -> np.ndarray:
    """White-to-blue heatmap colormap,
    vectorized: |v|/max_abs -> intensity; zero/non-finite -> white."""
    values = np.asarray(values, dtype=np.float64)
    out = np.full(values.shape + (3,), 255, dtype=np.uint8)
    if max_abs <= 0.0:
        return out
    norm = np.clip(np.abs(values) / max_abs, 0.0, 1.0)
    norm = np.where(np.isfinite(values), norm, 0.0)
    on = norm >= 1e-10
    remaining = (255 - (norm * 255.0).astype(np.int32)).astype(np.uint8)
    out[..., 0] = np.where(on, remaining, 255)
    out[..., 1] = np.where(on, remaining, 255)
    # blue channel stays 255
    return out


def downsample_matrix(
    dense: np.ndarray, target_rows: int, target_cols: int, zero_tol: float = 1e-12
) -> np.ndarray:
    """Block-average downsample of a (possibly huge) matrix to
    [target_rows, target_cols], averaging only entries with |v|>tol,
    computed with one vectorized bincount instead of a per-nnz loop."""
    dense = np.asarray(dense, dtype=np.float64)
    m, n = dense.shape
    tr, tc = min(target_rows, m), min(target_cols, n)
    rows, cols = np.nonzero(np.abs(dense) > zero_tol)
    if rows.size == 0:
        return np.zeros((tr, tc))
    vals = dense[rows, cols]
    idx = (rows * tr) // m * tc + (cols * tc) // n
    sums = np.bincount(idx, weights=vals, minlength=tr * tc)
    counts = np.bincount(idx, minlength=tr * tc)
    out = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    return out.reshape(tr, tc)


def hessian_to_image(hessian: np.ndarray, target_size: int) -> np.ndarray:
    """Downsampled Hessian heatmap as uint8 [S, S, 3]."""
    ds = downsample_matrix(hessian, target_size, target_size)
    finite = ds[np.isfinite(ds)]
    max_abs = float(np.max(np.abs(finite))) if finite.size else 0.0
    return value_to_rgb_heatmap(ds, max_abs)


def gradient_to_image(
    gradient: np.ndarray, target_width: int, bar_height: int = 50
) -> np.ndarray:
    """Gradient as a horizontal heat bar, uint8 [bar_height, W, 3]: bucket-average n entries into W bins."""
    g = np.asarray(gradient, dtype=np.float64).ravel()
    n = g.size
    w = min(target_width, max(n, 1))
    starts = (np.arange(w) * n) // w
    ends = (np.arange(1, w + 1) * n) // w
    sums = np.add.reduceat(g, starts)
    widths = np.maximum(ends - starts, 1)
    binned = sums / widths
    max_abs = float(np.max(np.abs(g))) if n else 0.0
    row = value_to_rgb_heatmap(binned, max_abs)  # [w, 3]
    return np.broadcast_to(row, (bar_height, w, 3)).copy()


def displacement_statistics(
    initial: Dict[str, np.ndarray], final: Dict[str, np.ndarray]
) -> Dict[str, float]:
    """avg/min/max Euclidean displacement over names present in both maps."""
    disps = [
        float(np.linalg.norm(np.asarray(final[k], dtype=np.float64) - np.asarray(v, dtype=np.float64)))
        for k, v in initial.items()
        if k in final
    ]
    if not disps:
        return {"count": 0, "avg": 0.0, "min": 0.0, "max": 0.0}
    a = np.asarray(disps)
    return {
        "count": len(disps),
        "avg": float(a.mean()),
        "min": float(a.min()),
        "max": float(a.max()),
    }


def se3_camera_pose(value7: np.ndarray, invert: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(position[3], quaternion xyzw[4]) for logging an SE3 variable as a
    camera transform; ``invert=True`` maps a world-to-camera estimate
    (BA convention) to the camera-in-world frame the viewer expects."""
    v = np.asarray(value7, dtype=np.float64)
    if invert:
        v = se3.inverse(torch.tensor(v)).numpy()  # a copy: ``v`` may be read-only
    pos = v[:3]
    qw, qx, qy, qz = v[3], v[4], v[5], v[6]  # storage is w-first
    return pos, np.array([qx, qy, qz, qw])  # rerun wants xyzw


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------


class MemorySink:
    """Headless sink: records every call as (path, kind, payload). Used by
    tests and as the fallback when the rerun SDK is absent."""

    def __init__(self):
        self.records: List[Tuple[str, str, dict]] = []
        self.current_time: int = 0

    def set_time_sequence(self, timeline: str, value: int):
        self.current_time = int(value)

    def _rec(self, path, kind, **payload):
        payload["iteration"] = self.current_time
        self.records.append((path, kind, payload))

    def log_scalar(self, path, value):
        self._rec(path, "scalar", value=float(value))

    def log_image(self, path, rgb):
        self._rec(path, "image", shape=tuple(np.asarray(rgb).shape))

    def log_points3d(self, path, positions, radii=None, color=None):
        self._rec(path, "points3d", count=len(positions), color=color)

    def log_boxes2d(self, path, centers, half_size, color=None):
        self._rec(path, "boxes2d", count=len(centers), color=color)

    def log_linestrip3d(self, path, points, color=None):
        self._rec(path, "linestrip3d", count=len(points), color=color)

    def log_camera(self, path, position, quat_xyzw, fov, aspect, frustum_scale):
        self._rec(path, "camera", position=tuple(np.asarray(position)))

    def log_text(self, path, text):
        self._rec(path, "text", text=text)

    def flush(self):
        pass

    # test conveniences
    def paths(self) -> List[str]:
        return sorted({p for p, _, _ in self.records})

    def by_kind(self, kind: str):
        return [(p, d) for p, k, d in self.records if k == kind]


class RerunSink:
    """Thin wrapper over the real rerun SDK (an optional dependency)."""

    def __init__(self, app_id: str, spawn: bool, save_path: Optional[str]):
        try:
            import rerun as rr  # type: ignore
        except ImportError as e:  # pragma: no cover - env-dependent
            raise ImportError(
                "RerunObserver with a live sink requires the 'rerun-sdk' "
                "package. Pass sink=MemorySink() for headless capture, or "
                "use HistoryObserver."
            ) from e
        self.rr = rr
        rr.init(app_id, spawn=spawn)
        if save_path:
            rr.save(save_path)

    def set_time_sequence(self, timeline, value):
        rr = self.rr
        if hasattr(rr, "set_time_sequence"):
            rr.set_time_sequence(timeline, value)
        else:  # pragma: no cover - rerun >= 0.20 renamed the API
            rr.set_time(timeline, sequence=value)

    def log_scalar(self, path, value):
        rr = self.rr
        scalar = getattr(rr, "Scalars", None) or rr.Scalar
        rr.log(path, scalar(float(value)))

    def log_image(self, path, rgb):
        self.rr.log(path, self.rr.Image(np.asarray(rgb, dtype=np.uint8)))

    def log_points3d(self, path, positions, radii=None, color=None):
        kw = {}
        if radii is not None:
            kw["radii"] = radii
        if color is not None:
            kw["colors"] = [color]
        self.rr.log(path, self.rr.Points3D(np.asarray(positions, np.float32), **kw))

    def log_boxes2d(self, path, centers, half_size, color=None):
        rr = self.rr
        centers = np.asarray(centers, np.float32)
        kw = {"centers": centers, "half_sizes": np.full_like(centers, half_size)}
        if color is not None:
            kw["colors"] = [color]
        rr.log(path, rr.Boxes2D(**kw))

    def log_linestrip3d(self, path, points, color=None):
        kw = {"colors": [color]} if color is not None else {}
        self.rr.log(path, self.rr.LineStrips3D([np.asarray(points, np.float32)], **kw))

    def log_camera(self, path, position, quat_xyzw, fov, aspect, frustum_scale):
        rr = self.rr
        rr.log(
            path,
            rr.Transform3D(
                translation=np.asarray(position, np.float32),
                rotation=rr.Quaternion(xyzw=np.asarray(quat_xyzw, np.float32)),
            ),
        )
        rr.log(
            path,
            rr.Pinhole.from_fov_and_aspect_ratio(fov, aspect).with_image_plane_distance(
                frustum_scale
            ),
        )

    def log_text(self, path, text):
        self.rr.log(path, self.rr.TextLog(text))

    def flush(self):  # pragma: no cover - passthrough
        if hasattr(self.rr, "flush"):
            self.rr.flush()


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


class VisualizationMode(enum.Enum):
    """Reference VisualizationMode: FULL logs the
    scene every iteration; INITIAL_AND_FINAL logs scalars per-iteration but
    the 3D scene only at iteration 0 and on completion."""

    FULL = "full"
    INITIAL_AND_FINAL = "initial_and_final"


@dataclasses.dataclass
class VisualizationConfig:
    """What the observer logs and how, with the JAX package's preset
    constructors."""

    app_id: str = "apex_tpu"
    spawn: bool = False  # spawn a live viewer
    save_path: Optional[str] = None  # write an .rrd recording
    mode: VisualizationMode = VisualizationMode.FULL

    show_cameras: bool = True
    show_landmarks: bool = True
    show_se2_poses: bool = True
    show_plots: bool = True
    show_matrices: bool = True

    camera_fov: float = 0.8  # radians
    camera_aspect_ratio: float = 1.777
    camera_frustum_scale: float = 0.3
    invert_camera_poses: bool = False  # BA: stored pose is world->cam

    landmark_point_size: float = 0.02
    initial_landmark_color: Tuple[int, int, int] = (64, 128, 255)  # blue
    optimized_landmark_color: Tuple[int, int, int] = (50, 200, 100)  # green
    se2_pose_radius: float = 0.05
    se2_box_half_size: float = 0.05
    initial_se2_color: Tuple[int, int, int] = (255, 128, 64)
    optimized_se2_color: Tuple[int, int, int] = (64, 255, 128)

    hessian_downsample_size: int = 256
    gradient_bar_width: int = 512
    graph_scale: float = 1.0
    max_landmarks_logged: int = 200_000

    @classmethod
    def for_pose_graph(cls) -> "VisualizationConfig":
        return cls(show_landmarks=False, mode=VisualizationMode.FULL)

    @classmethod
    def for_bundle_adjustment(cls) -> "VisualizationConfig":
        return cls(
            show_se2_poses=False,
            invert_camera_poses=True,
            mode=VisualizationMode.INITIAL_AND_FINAL,
        )

    @classmethod
    def cameras_only(cls) -> "VisualizationConfig":
        return cls(show_landmarks=False, show_se2_poses=False)

    @classmethod
    def landmarks_only(cls) -> "VisualizationConfig":
        return cls(show_cameras=False, show_se2_poses=False)


# ---------------------------------------------------------------------------
# Observer
# ---------------------------------------------------------------------------


class RerunObserver(OptObserver):
    """Full-depth visualization observer.

    Logs, per iteration: metric time series, Hessian heatmap + gradient
    bar (when the optimizer exposes matrix data), and the 3D/2D scene
    (mode-dependent). On completion: final graph state, displacement
    statistics, and a convergence banner.
    """

    def __init__(
        self,
        config: Optional[VisualizationConfig] = None,
        sink=None,
    ):
        self.config = config or VisualizationConfig()
        self.sink = sink if sink is not None else RerunSink(
            self.config.app_id, self.config.spawn, self.config.save_path
        )
        self._pending_matrix: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._initial_cameras: Dict[str, np.ndarray] = {}
        self._initial_landmarks: Dict[str, np.ndarray] = {}
        self._logged_initial = False
        self.displacements: Dict[str, Dict[str, float]] = {}

    # -- classification ----------------------------------------------------

    def _split_variables(self, variables: Dict[str, np.ndarray]):
        """SE3 poses are 7-vectors; 3D landmarks are 3-vectors named pt_*;
        SE2 poses are other 3-vectors (the names stand in for the
        variables' manifolds, which the host arrays do not carry)."""
        poses3, poses2, points = {}, {}, {}
        for name, v in variables.items():
            v = np.asarray(v)
            if v.shape == (7,):
                poses3[name] = v
            elif v.shape == (3,) and name.startswith("pt_"):
                points[name] = v
            elif v.shape == (3,):
                poses2[name] = v
        return poses3, poses2, points

    def _camera_world_positions(self, poses3: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {}
        for name, v in poses3.items():
            pos, _ = se3_camera_pose(v, self.config.invert_camera_poses)
            out[name] = pos
        return out

    # -- scene logging -------------------------------------------------------

    def _log_scene(self, variables, iteration, prefix="world", final=False):
        cfg = self.config
        sink = self.sink
        sink.set_time_sequence("iteration", iteration)
        poses3, poses2, points = self._split_variables(variables)

        if cfg.show_cameras and poses3:
            for name, v in poses3.items():
                pos, quat = se3_camera_pose(v, cfg.invert_camera_poses)
                sink.log_camera(
                    f"{prefix}/cameras/{name}",
                    pos * cfg.graph_scale,
                    quat,
                    cfg.camera_fov,
                    cfg.camera_aspect_ratio,
                    cfg.camera_frustum_scale,
                )
        if cfg.show_se2_poses and poses2:
            arr = np.stack(list(poses2.values()))
            color = cfg.optimized_se2_color if final else cfg.initial_se2_color
            sink.log_boxes2d(
                f"{prefix}/se2_poses", arr[:, :2] * cfg.graph_scale,
                cfg.se2_box_half_size, color=color,
            )
            pts = np.concatenate(
                [arr[:, :2] * cfg.graph_scale, np.zeros((arr.shape[0], 1))], axis=1
            )
            sink.log_linestrip3d(f"{prefix}/trajectory", pts)
        if cfg.show_landmarks and points:
            arr = np.stack(list(points.values())[: cfg.max_landmarks_logged])
            color = cfg.optimized_landmark_color if final else cfg.initial_landmark_color
            sink.log_points3d(
                f"{prefix}/landmarks", arr * cfg.graph_scale,
                radii=cfg.landmark_point_size, color=color,
            )

    def _capture_initial(self, variables):
        poses3, _, points = self._split_variables(variables)
        self._initial_cameras = self._camera_world_positions(poses3)
        self._initial_landmarks = {k: np.asarray(v, np.float64) for k, v in points.items()}

    # -- public pre-solve hooks ------------------------------------------------

    def log_initial_graph(self, variables: Dict[str, np.ndarray], scale: float = 1.0):
        """Log the un-optimized graph under initial_graph/."""
        self.config.graph_scale = scale
        self._capture_initial(variables)
        self._log_scene(variables, 0, prefix="initial_graph")
        self._logged_initial = True

    def log_initial_ba_state(self, variables: Dict[str, np.ndarray]):
        """BA variant: same initial dump
        with camera-pose inversion enabled."""
        self.config.invert_camera_poses = True
        self.log_initial_graph(variables)

    def log_convergence(self, status: str):
        """Convergence banner."""
        self.sink.log_text("optimization/status", f"Converged: {status}")

    # -- OptObserver ----------------------------------------------------------

    def set_matrix_data(self, hessian: np.ndarray, gradient: np.ndarray) -> None:
        self._pending_matrix = (np.asarray(hessian), np.asarray(gradient))

    def on_step(self, variables, iteration, cost, gradient_norm, damping,
                step_norm, step_quality):
        cfg = self.config
        sink = self.sink
        sink.set_time_sequence("iteration", iteration)
        if not self._logged_initial:
            self._capture_initial(variables)
            self._log_scene(variables, 0, prefix="initial_graph")
            self._logged_initial = True
        if cfg.show_plots:
            sink.log_scalar("metrics/cost", cost)
            sink.log_scalar("metrics/gradient_norm", gradient_norm)
            sink.log_scalar("metrics/damping", damping)
            sink.log_scalar("metrics/step_norm", step_norm)
            sink.log_scalar("metrics/step_quality", step_quality)
        if cfg.show_matrices and self._pending_matrix is not None:
            H, g = self._pending_matrix
            sink.log_image(
                "optimization/matrices/hessian",
                hessian_to_image(H, cfg.hessian_downsample_size),
            )
            sink.log_image(
                "optimization/matrices/gradient",
                gradient_to_image(g, cfg.gradient_bar_width),
            )
            self._pending_matrix = None
        if cfg.mode is VisualizationMode.FULL:
            self._log_scene(variables, iteration)

    def notify_complete(self, variables, iterations):
        self._log_scene(variables, iterations, prefix="final_graph", final=True)
        poses3, _, points = self._split_variables(variables)
        cam_stats = displacement_statistics(
            self._initial_cameras, self._camera_world_positions(poses3)
        )
        lm_stats = displacement_statistics(
            self._initial_landmarks,
            {k: np.asarray(v, np.float64) for k, v in points.items()},
        )
        self.displacements = {"cameras": cam_stats, "landmarks": lm_stats}
        if cam_stats["count"]:
            logger.info(
                "Camera displacement: avg=%.6f min=%.6f max=%.6f (%d cameras)",
                cam_stats["avg"], cam_stats["min"], cam_stats["max"], cam_stats["count"],
            )
            self.sink.log_scalar("statistics/camera_displacement/avg", cam_stats["avg"])
            self.sink.log_scalar("statistics/camera_displacement/max", cam_stats["max"])
        if lm_stats["count"]:
            logger.info(
                "Landmark displacement: avg=%.6f min=%.6f max=%.6f (%d landmarks)",
                lm_stats["avg"], lm_stats["min"], lm_stats["max"], lm_stats["count"],
            )
            self.sink.log_scalar("statistics/landmark_displacement/avg", lm_stats["avg"])
            self.sink.log_scalar("statistics/landmark_displacement/max", lm_stats["max"])
        self.sink.log_text(
            "optimization/status", f"Optimization complete after {iterations} iterations"
        )
        self.sink.flush()
