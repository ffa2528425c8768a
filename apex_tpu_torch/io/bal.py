"""BAL (Bundle Adjustment in the Large) dataset loader, numpy only
(counterpart of ``apex_tpu/io/bal.py``; its native C++ parser is not
ported).

    <num_cameras> <num_points> <num_observations>
    <camera_index> <point_index> <x> <y>        (num_observations lines)
    <9 camera params per camera, one per line>  (axis-angle R, t, f, k1, k2)
    <3 point coords per point, one per line>

Snavely's convention: world-to-camera rotation and translation, the camera
looks down -Z. Negative or non-finite focal lengths become 500.0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_FOCAL_LENGTH = 500.0


@dataclasses.dataclass
class BalDataset:
    rotations: np.ndarray  # [C, 3] axis-angle (world-to-camera)
    translations: np.ndarray  # [C, 3]
    focals: np.ndarray  # [C]
    k1: np.ndarray  # [C]
    k2: np.ndarray  # [C]
    points: np.ndarray  # [P, 3]
    cam_indices: np.ndarray  # [K] int32
    point_indices: np.ndarray  # [K] int32
    observations: np.ndarray  # [K, 2] pixel coords

    @property
    def num_cameras(self) -> int:
        return self.rotations.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_observations(self) -> int:
        return self.observations.shape[0]

    def camera_se3(self) -> np.ndarray:
        """World-to-camera poses as SE3 storage [C, 7] (t, w-first quat)."""
        theta = self.rotations
        t2 = np.sum(theta * theta, axis=1)
        small = t2 < 1e-10
        safe = np.sqrt(np.where(small, 1.0, t2))
        half = 0.5 * safe
        k = np.where(small, 0.5 - t2 / 48.0, np.sin(half) / safe)
        w = np.where(small, 1.0 - t2 / 8.0, np.cos(half))
        q = np.concatenate([w[:, None], k[:, None] * theta], axis=1)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return np.concatenate([self.translations, q], axis=1)

    def intrinsics(self) -> np.ndarray:
        """[C, 3] (f, k1, k2)."""
        return np.stack([self.focals, self.k1, self.k2], axis=1)


def load_bal(path) -> BalDataset:
    with open(path, "r") as f:
        header = f.readline().split()
        n_cam, n_pt, n_obs = int(header[0]), int(header[1]), int(header[2])
        tokens = np.array(f.read().split(), dtype=np.float64)

    n_obs_vals = 4 * n_obs
    if tokens.size < n_obs_vals:
        raise ValueError(f"BAL: expected {n_obs} observation rows")
    data = tokens[:n_obs_vals].reshape(n_obs, 4)
    rest = tokens[n_obs_vals:]
    expected = 9 * n_cam + 3 * n_pt
    if rest.size != expected:
        raise ValueError(f"BAL: expected {expected} trailing values, got {rest.size}")

    cams = rest[: 9 * n_cam].reshape(n_cam, 9)
    pts = rest[9 * n_cam:].reshape(n_pt, 3)
    focals = cams[:, 6].copy()
    focals[~np.isfinite(focals) | (focals <= 0.0)] = DEFAULT_FOCAL_LENGTH
    return BalDataset(
        rotations=cams[:, 0:3].copy(),
        translations=cams[:, 3:6].copy(),
        focals=focals,
        k1=cams[:, 7].copy(),
        k2=cams[:, 8].copy(),
        points=pts.copy(),
        cam_indices=data[:, 0].astype(np.int32),
        point_indices=data[:, 1].astype(np.int32),
        observations=data[:, 2:4].copy(),
    )


def save_bal(path, ds: BalDataset):
    with open(path, "w") as f:
        f.write(f"{ds.num_cameras} {ds.num_points} {ds.num_observations}\n")
        for c, p, (x, y) in zip(ds.cam_indices, ds.point_indices, ds.observations):
            f.write(f"{c} {p} {x:.12e} {y:.12e}\n")
        for i in range(ds.num_cameras):
            for v in (*ds.rotations[i], *ds.translations[i], ds.focals[i], ds.k1[i], ds.k2[i]):
                f.write(f"{v:.16e}\n")
        for p in ds.points:
            for v in p:
                f.write(f"{v:.16e}\n")
