"""Synthetic datasets (counterpart of ``apex_tpu/io/synthetic.py``): the
SE2 ring and manhattan pose graphs, the SE3 sphere and 3D-lattice pose
graphs and the bundle-adjustment generators. Host-side numpy; the group
operations run through the port's own manifold functions in f64 on the
CPU, with the same random draws in the same order, so a seed gives the same
arrays as the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from ..manifolds import SE2, SE3, so3
from ..manifolds.utils import mat_to_quat, quat_to_mat
from .bal import BalDataset
from .graph import Edge, Graph


def _integrate(G, start, steps):
    """Cumulative compose start, start∘s0, start∘s0∘s1, ... -> [K+1, S],
    one step at a time in f64."""
    out = [torch.as_tensor(start, dtype=torch.float64)]
    for s in torch.as_tensor(steps, dtype=torch.float64):
        out.append(G.compose(out[-1], s))
    return torch.stack(out).numpy()


def synthetic_pose_graph_2d(
    n_poses: int = 434,
    trajectory: str = "ring",
    odom_noise=(0.02, 0.02, 0.005),
    loop_stride: int = 0,
    info_weight: float = 100.0,
    seed: int = 0,
) -> Graph:
    """SE2 pose graph: a noisy odometry chain closed into a ring, plus a
    loop closure every ``loop_stride`` poses; initialized by integrating the
    noisy odometry. ``trajectory`` "ring" is a closed circle, "manhattan" an
    M3500-style grid walk. Every edge's noise is drawn with ``odom_noise``,
    as the reference does (its ``loop_noise`` argument is unused there, and
    not taken here)."""
    rng = np.random.default_rng(seed)
    if trajectory == "ring":
        step = np.array([2 * np.pi / n_poses * 5.0, 0.0, 2 * np.pi / n_poses])
        steps = np.tile(step, (n_poses - 1, 1))
    elif trajectory == "manhattan":
        turns = rng.choice([0.0, np.pi / 2, -np.pi / 2], size=n_poses - 1, p=[0.8, 0.1, 0.1])
        steps = np.stack([np.ones(n_poses - 1), np.zeros(n_poses - 1), turns], axis=1)
    else:
        raise ValueError(f"unknown trajectory {trajectory!r}")
    truth = _integrate(SE2, np.zeros(3), steps)

    src = list(range(n_poses - 1)) + [n_poses - 1]
    dst = list(range(1, n_poses)) + [0]
    if loop_stride > 0:
        src += list(range(0, n_poses - loop_stride, loop_stride))
        dst += list(range(loop_stride, n_poses, loop_stride))
    src = np.asarray(src)
    dst = np.asarray(dst)

    rels = SE2.between(torch.from_numpy(truth[src]), torch.from_numpy(truth[dst])).numpy()
    # a plain sum on the storage vector, not plus: the reference's measurement
    meas = rels + rng.normal(0, 1.0, rels.shape) * np.asarray(odom_noise)[None, :]

    info = np.diag([info_weight] * 3)
    g = Graph()
    g.edges_se2 = [Edge(int(src[k]), int(dst[k]), meas[k], info) for k in range(len(src))]
    est = _integrate(SE2, truth[0], meas[:n_poses - 1])
    g.vertices_se2 = {i: est[i] for i in range(n_poses)}
    return g


def synthetic_pose_graph_3d(
    n_poses: int = 2500,
    rings: int = 50,
    odom_noise_t: float = 0.05,
    odom_noise_r: float = 0.01,
    info_weight: float = 100.0,
    seed: int = 0,
    closure_strides: tuple = (1,),
) -> Graph:
    """SE3 pose graph shaped like sphere2500: poses spiral over a sphere
    (``rings`` latitudes), odometry along the spiral plus loop closures
    between rings ``closure_strides`` apart; initialized by integrating
    the noisy odometry."""
    rng = np.random.default_rng(seed)
    per_ring = n_poses // rings
    radius = 10.0

    k = np.arange(n_poses)
    ring = k // per_ring
    pos_in_ring = k % per_ring
    phi = np.pi * (ring + 1) / (rings + 1)
    theta = 2 * np.pi * pos_in_ring / per_ring
    p = radius * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=1)
    yaw = theta + np.pi / 2
    q = so3.exp(torch.from_numpy(
        np.stack([np.zeros(n_poses), np.zeros(n_poses), yaw], axis=1))).numpy()
    truth = np.concatenate([p, q], axis=1)

    src = list(range(n_poses - 1))
    dst = list(range(1, n_poses))
    n_odom = len(src)
    for stride in closure_strides:
        span = stride * per_ring
        src += list(range(n_poses - span))
        dst += list(range(span, n_poses))
    src = np.asarray(src)
    dst = np.asarray(dst)

    rels = SE3.between(torch.from_numpy(truth[src]), torch.from_numpy(truth[dst]))
    tau = np.concatenate([rng.normal(0, odom_noise_t, (len(src), 3)),
                          rng.normal(0, odom_noise_r, (len(src), 3))], axis=1)
    meas = SE3.plus(rels, torch.from_numpy(tau)).numpy()

    info = np.diag([info_weight] * 6)
    g = Graph()
    g.edges_se3 = [Edge(int(src[i]), int(dst[i]), meas[i], info) for i in range(len(src))]
    est = _integrate(SE3, truth[0], meas[:n_odom])
    g.vertices_se3 = {i: est[i] for i in range(n_poses)}
    return g


def synthetic_pose_graph_grid3d(
    nx: int = 10,
    ny: int = 10,
    nz: int = 10,
    spacing: float = 1.0,
    noise_t: float = 0.05,
    noise_r: float = 0.01,
    info_weight: float = 100.0,
    seed: int = 0,
) -> Graph:
    """SE3 pose graph on a 3D lattice, the shape of the grid3D dataset: one
    vertex per lattice point, relative-pose edges to the +x, +y and +z
    neighbours. No 1-D ordering makes it banded (its RCM bandwidth is about
    nx*ny blocks), so it takes the general-sparsity tier
    (``linalg/sparse_general.py``). Initialized by perturbing the ground
    truth, the first vertex left exact."""
    rng = np.random.default_rng(seed)
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    p = spacing * np.stack([ii, jj, kk], axis=-1).reshape(-1, 3).astype(float)
    n = p.shape[0]
    yaw = rng.uniform(-0.3, 0.3, n)
    q = so3.exp(torch.from_numpy(np.stack([np.zeros(n), np.zeros(n), yaw], axis=1))).numpy()
    truth = np.concatenate([p, q], axis=1)

    def vid(a, b, c):
        return (a * ny + b) * nz + c

    src, dst = [], []
    for a in range(nx):
        for b in range(ny):
            for c in range(nz):
                v = vid(a, b, c)
                if a + 1 < nx:
                    src.append(v)
                    dst.append(vid(a + 1, b, c))
                if b + 1 < ny:
                    src.append(v)
                    dst.append(vid(a, b + 1, c))
                if c + 1 < nz:
                    src.append(v)
                    dst.append(vid(a, b, c + 1))
    src = np.asarray(src)
    dst = np.asarray(dst)
    rels = SE3.between(torch.from_numpy(truth[src]), torch.from_numpy(truth[dst]))
    tau = np.concatenate([rng.normal(0, noise_t, (len(src), 3)),
                          rng.normal(0, noise_r, (len(src), 3))], axis=1)
    meas = SE3.plus(rels, torch.from_numpy(tau)).numpy()

    info = np.diag([info_weight] * 6)
    g = Graph()
    g.edges_se3 = [Edge(int(src[i]), int(dst[i]), meas[i], info) for i in range(len(src))]
    pert = np.concatenate([rng.normal(0, 0.1, (n, 3)), rng.normal(0, 0.02, (n, 3))], axis=1)
    est = SE3.plus(torch.from_numpy(truth), torch.from_numpy(pert)).numpy()
    est[0] = truth[0]
    g.vertices_se3 = {i: est[i] for i in range(n)}
    return g


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
