"""Synthetic bundle-adjustment datasets (counterpart of the BA generators of
``apex_tpu/io/synthetic.py``). Host-side numpy; the rotation conversions run
through the port's own manifold functions in f64 on the CPU, so a seed gives
the same arrays as the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from ..manifolds import so3
from ..manifolds.utils import mat_to_quat, quat_to_mat
from .bal import BalDataset


def _rotations(Rcw: np.ndarray):
    """World-to-camera rotation matrices -> (axis-angle, matrices rebuilt
    from their quaternions), numpy f64."""
    qs = mat_to_quat(torch.from_numpy(Rcw))
    return so3.log(qs).numpy(), quat_to_mat(qs).numpy()


def _ring_cameras(n_cameras, radius, wobble, harmonic):
    ang = 2 * np.pi * np.arange(n_cameras) / n_cameras
    centers = radius * np.stack(
        [np.cos(ang), np.sin(ang), wobble * np.sin(harmonic * ang)], axis=1)
    fwd = -centers / np.linalg.norm(centers, axis=1, keepdims=True)
    up = np.tile(np.array([0.0, 0.0, 1.0]), (n_cameras, 1))
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    up2 = np.cross(right, fwd)
    # world <- cam axes: x=right, y=-up2, z=-fwd  (Snavely -Z forward)
    Rwc = np.stack([right, -up2, -fwd], axis=2)
    Rcw = np.transpose(Rwc, (0, 2, 1))
    trans = -np.einsum("cij,cj->ci", Rcw, centers)
    return Rcw, trans


def synthetic_ba(
    n_cameras: int = 49,
    n_points: int = 1000,
    image_size: float = 800.0,
    focal: float = 800.0,
    pixel_noise: float = 1.0,
    point_init_noise: float = 0.05,
    pose_init_noise: float = 0.02,
    seed: int = 0,
) -> BalDataset:
    """Cameras on a ring of radius 5 looking at a point cloud at the origin
    (Snavely convention). Ground truth perturbed for initialization;
    observations carry pixel noise."""
    rng = np.random.default_rng(seed)
    pts_true = rng.uniform(-1.5, 1.5, (n_points, 3))
    Rcw, trans = _ring_cameras(n_cameras, 5.0, 0.3, 2)
    rots, R = _rotations(Rcw)

    pc = np.einsum("cij,pj->cpi", R, pts_true) + trans[:, None, :]
    z = pc[..., 2]
    in_front = z < -0.5
    with np.errstate(divide="ignore", invalid="ignore"):
        xn = -pc[..., 0] / z
        yn = -pc[..., 1] / z
    u = focal * xn
    v = focal * yn
    ok = in_front & (np.abs(u) < image_size / 2) & (np.abs(v) < image_size / 2)
    cam_idx, pt_idx = np.nonzero(ok)
    obs = np.stack([u[ok], v[ok]], axis=1) + rng.normal(0, pixel_noise, (ok.sum(), 2))

    pts0 = pts_true + rng.normal(0, point_init_noise, pts_true.shape)
    rots0 = rots + rng.normal(0, pose_init_noise, rots.shape)
    trans0 = trans + rng.normal(0, pose_init_noise, trans.shape)
    return BalDataset(
        rotations=rots0, translations=trans0,
        focals=np.full(n_cameras, focal), k1=np.zeros(n_cameras), k2=np.zeros(n_cameras),
        points=pts0, cam_indices=cam_idx.astype(np.int32),
        point_indices=pt_idx.astype(np.int32), observations=obs)


def synthetic_ba_large(
    n_cameras: int = 1778,
    n_points: int = 993_923,
    obs_per_camera: int = 2800,
    focal: float = 800.0,
    pixel_noise: float = 1.0,
    point_init_noise: float = 0.05,
    pose_init_noise: float = 0.01,
    seed: int = 0,
) -> BalDataset:
    """Venice/ladybug-scale synthetic BA without the O(C*P) visibility test:
    each camera observes a deterministic pseudo-random subset of points,
    about ``n_cameras * obs_per_camera`` observations in all."""
    rng = np.random.default_rng(seed)
    pts_true = rng.uniform(-2.0, 2.0, (n_points, 3)).astype(np.float64)
    Rcw, trans = _ring_cameras(n_cameras, 6.0, 0.25, 3)
    rots, R = _rotations(Rcw)

    cam_idx_list, pt_idx_list, obs_list = [], [], []
    for i in range(n_cameras):
        crng = np.random.default_rng(seed * 1_000_003 + i)
        cand = crng.integers(0, n_points, size=int(obs_per_camera * 1.3))
        pc = pts_true[cand] @ R[i].T + trans[i]
        z = pc[:, 2]
        ok = z < -0.5
        cand, pc, z = cand[ok], pc[ok], z[ok]
        u = focal * (-pc[:, 0] / z)
        v = focal * (-pc[:, 1] / z)
        keep = (np.abs(u) < 500) & (np.abs(v) < 500)
        take = min(obs_per_camera, int(keep.sum()))
        sel = np.nonzero(keep)[0][:take]
        cam_idx_list.append(np.full(take, i, dtype=np.int32))
        pt_idx_list.append(cand[sel].astype(np.int32))
        obs_list.append(np.stack([u[sel], v[sel]], axis=1)
                        + crng.normal(0, pixel_noise, (take, 2)))

    pts0 = pts_true + rng.normal(0, point_init_noise, pts_true.shape)
    rots0 = rots + rng.normal(0, pose_init_noise, rots.shape)
    trans0 = trans + rng.normal(0, pose_init_noise, trans.shape)
    return BalDataset(
        rotations=rots0, translations=trans0,
        focals=np.full(n_cameras, focal), k1=np.zeros(n_cameras), k2=np.zeros(n_cameras),
        points=pts0, cam_indices=np.concatenate(cam_idx_list),
        point_indices=np.concatenate(pt_idx_list), observations=np.concatenate(obs_list))
