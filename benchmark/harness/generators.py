"""The benchmark's seeded data: frozen copies of the solver's synthetic
generators (the same random draws in the same order, so a seed gives the
same arrays), written against ``lie.py`` in f64 on the CPU.

Each returns a dict of numpy arrays, which the harness hands to the
program through its own types and to the reference as they are:

- bundle adjustment (BAL layout): ``rotations`` [C, 3] axis-angle and
  ``translations`` [C, 3] world-to-camera, ``focals``, ``k1``, ``k2`` [C],
  ``points`` [P, 3], ``cam_indices``, ``point_indices`` [K] int32,
  ``observations`` [K, 2] pixels (the camera looks down -Z);
- pose graphs: ``vertices`` [N, 7] SE(3) storage, ``src``, ``dst`` [E]
  int64, ``measurements`` [E, 7]; the information matrix is 100 I for
  every edge.

A generator not in ``GENERATORS`` is a file of its own,
``benchmark/generators/<name>.py``, found by its name: it defines
``generate(seed, **params)``, which returns one of these layouts, and
``SMALL``, its parameters for a rehearsal on the CPU.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

from . import lie

INFO_WEIGHT = 100.0


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _integrate(start, steps):
    """start, start*s0, start*s0*s1, ... composed one at a time: [K+1, 7]."""
    out = [_t(start)]
    for s in _t(steps):
        out.append(lie.se3_compose(out[-1], s))
    return torch.stack(out).numpy()


def pose_graph_3d(n_poses=2500, rings=50, odom_noise_t=0.05, odom_noise_r=0.01, seed=0,
                  closure_strides=(1,)):
    """A sphere2500-shaped SE(3) graph: poses spiral over a sphere of
    ``rings`` latitudes, odometry along the spiral and closures between
    rings ``closure_strides`` apart; initialized by integrating the noisy
    odometry."""
    rng = np.random.default_rng(seed)
    per_ring = n_poses // rings
    k = np.arange(n_poses)
    ring, pos = k // per_ring, k % per_ring
    phi = np.pi * (ring + 1) / (rings + 1)
    theta = 2 * np.pi * pos / per_ring
    p = 10.0 * np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                         np.cos(phi)], axis=1)
    yaw = theta + np.pi / 2
    q = lie.so3_exp(_t(np.stack([np.zeros(n_poses), np.zeros(n_poses), yaw], 1))).numpy()
    truth = np.concatenate([p, q], axis=1)

    src = list(range(n_poses - 1))
    dst = list(range(1, n_poses))
    n_odom = len(src)
    for stride in closure_strides:
        span = stride * per_ring
        src += list(range(n_poses - span))
        dst += list(range(span, n_poses))
    src, dst = np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64)

    rels = lie.se3_between(_t(truth[src]), _t(truth[dst]))
    tau = np.concatenate([rng.normal(0, odom_noise_t, (len(src), 3)),
                          rng.normal(0, odom_noise_r, (len(src), 3))], axis=1)
    meas = lie.se3_compose(rels, lie.se3_exp(_t(tau))).numpy()
    est = _integrate(truth[0], meas[:n_odom])
    return {"vertices": est, "src": src, "dst": dst, "measurements": meas}


def _ring_cameras(n_cameras, radius, wobble, harmonic):
    ang = 2 * np.pi * np.arange(n_cameras) / n_cameras
    centers = radius * np.stack([np.cos(ang), np.sin(ang), wobble * np.sin(harmonic * ang)], 1)
    fwd = -centers / np.linalg.norm(centers, axis=1, keepdims=True)
    up = np.tile(np.array([0.0, 0.0, 1.0]), (n_cameras, 1))
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    up2 = np.cross(right, fwd)
    Rcw = np.transpose(np.stack([right, -up2, -fwd], axis=2), (0, 2, 1))
    return Rcw, -np.einsum("cij,cj->ci", Rcw, centers)


def ba_large(n_cameras=1778, n_points=993_923, obs_per_camera=2800, focal=800.0,
             pixel_noise=1.0, point_init_noise=0.05, pose_init_noise=0.01, seed=0):
    """Cameras on a wobbling ring looking at a cube of points; each camera
    observes a pseudo-random subset of at most ``obs_per_camera`` points in
    front of it and inside a 1000-pixel square."""
    rng = np.random.default_rng(seed)
    pts_true = rng.uniform(-2.0, 2.0, (n_points, 3))
    Rcw, trans = _ring_cameras(n_cameras, 6.0, 0.25, 3)
    qs = lie.mat_to_quat(_t(Rcw))
    rots, R = lie.so3_log(qs).numpy(), lie.quat_to_mat(qs).numpy()

    cams, pts, obs = [], [], []
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
        cams.append(np.full(take, i, dtype=np.int32))
        pts.append(cand[sel].astype(np.int32))
        obs.append(np.stack([u[sel], v[sel]], 1) + crng.normal(0, pixel_noise, (take, 2)))

    return {
        "points": pts_true + rng.normal(0, point_init_noise, pts_true.shape),
        "rotations": rots + rng.normal(0, pose_init_noise, rots.shape),
        "translations": trans + rng.normal(0, pose_init_noise, trans.shape),
        "focals": np.full(n_cameras, focal), "k1": np.zeros(n_cameras),
        "k2": np.zeros(n_cameras), "cam_indices": np.concatenate(cams),
        "point_indices": np.concatenate(pts), "observations": np.concatenate(obs),
    }


GENERATORS = {
    "ba_large": ba_large,
    "pose_graph_3d": pose_graph_3d,
}
# the generators that are files of their own
FILES = Path(__file__).resolve().parents[1] / "generators"
# the scene and its noise in every run: the solver's own ladder's seed
NOISE_SEED = 0


def from_file(name):
    """The generator file ``FILES/<name>.py`` as a module."""
    path = FILES / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"unknown generator {name!r}: not one of {sorted(GENERATORS)} "
                         f"and no file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_generators_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def draw(name, seed, params):
    """The generator ``name``'s data for ``seed`` and ``params``."""
    if name in GENERATORS:
        return GENERATORS[name](seed=seed, **params)
    return from_file(name).generate(seed=seed, **params)


def make(spec, seed):
    """A configuration's data for a run's seed: the generator's scene and
    noise of ``NOISE_SEED``, turned into a frame drawn from the run's seed
    (``rotate``), so that every run does the same work on different
    numbers."""
    return rotate(draw(spec["name"], NOISE_SEED, spec["params"]), seed)


def rotate(data, seed):
    """The whole scene turned by one rotation R drawn from ``seed`` (uniform
    on SO(3)) about the world origin: poses premultiplied by R, or for
    world-to-camera cameras postmultiplied by R^-1 with the points turned by
    R. Relative poses, measurements, projections, the cost and every norm
    the solver tests are unchanged, and the solver's steps turn with the
    scene."""
    q = np.random.default_rng(seed).normal(size=4)
    q = lie.quat_normalize(_t(q / np.linalg.norm(q)))
    if "vertices" in data:
        frame = torch.cat([torch.zeros(3, dtype=torch.float64), q])
        v = lie.se3_compose(frame.expand(data["vertices"].shape[0], 7), _t(data["vertices"]))
        return dict(data, vertices=v.numpy())
    cams = lie.quat_mul(lie.so3_exp(_t(data["rotations"])), lie.quat_conj(q))
    return dict(data, rotations=lie.so3_log(cams).numpy(),
                points=lie.quat_rotate(q, _t(data["points"])).numpy())

