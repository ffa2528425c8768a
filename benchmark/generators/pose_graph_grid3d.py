"""A grid3D-shaped SE(3) pose graph (SE-Sync's ``data/grid3D.g2o``: 8,000
poses, 22,236 edges, a robot's path through a 20 x 20 x 20 lattice).

``lattice`` is a frozen copy of the port's ``synthetic_pose_graph_grid3d``
(the same random draws in the same order, written against ``lie.py``):
one pose per lattice point, an edge to each +x, +y and +z neighbour, the
measurements its relative poses with noise, the poses the truth perturbed
(the first left exact). ``generate`` keeps of those edges the odometry of
a boustrophedon (snake) path through the lattice, which visits every pose,
and all other lattice edges but ``dropped`` of them, drawn by a generator
of its own (``EDGE_SEED``) so that every run keeps the same edges; every
array it keeps is the lattice's, unchanged. At 20^3 the lattice has
22,800 edges, the path 7,999, and ``dropped`` = 564 leaves grid3D's
22,236.
"""

import numpy as np
import torch
from harness import lie

# the lattice for a rehearsal on the CPU: 512 poses whose +x edges span
# 256 blocks, 1,536 columns, under the name ordering
SMALL = {"nx": 2, "ny": 16, "nz": 16, "dropped": 27}
# the draw of the dropped edges, the same in every run
EDGE_SEED = 2236


def lattice(nx, ny, nz, spacing=1.0, noise_t=0.05, noise_r=0.01, seed=0):
    """Every lattice edge: {vertices [N, 7], src, dst [E], measurements
    [E, 7]}, as the port's ``synthetic_pose_graph_grid3d`` gives them."""
    rng = np.random.default_rng(seed)
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    p = spacing * np.stack([ii, jj, kk], axis=-1).reshape(-1, 3).astype(float)
    n = p.shape[0]
    yaw = rng.uniform(-0.3, 0.3, n)
    q = lie.so3_exp(torch.from_numpy(np.stack([np.zeros(n), np.zeros(n), yaw], axis=1))).numpy()
    truth = np.concatenate([p, q], axis=1)

    v = np.arange(n).reshape(nx, ny, nz)
    src, dst = [], []
    for a in range(nx):
        for b in range(ny):
            for c in range(nz):
                if a + 1 < nx:
                    src.append(v[a, b, c])
                    dst.append(v[a + 1, b, c])
                if b + 1 < ny:
                    src.append(v[a, b, c])
                    dst.append(v[a, b + 1, c])
                if c + 1 < nz:
                    src.append(v[a, b, c])
                    dst.append(v[a, b, c + 1])
    src, dst = np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64)
    rels = lie.se3_between(torch.from_numpy(truth[src]), torch.from_numpy(truth[dst]))
    tau = np.concatenate([rng.normal(0, noise_t, (len(src), 3)),
                          rng.normal(0, noise_r, (len(src), 3))], axis=1)
    meas = lie.se3_compose(rels, lie.se3_exp(torch.from_numpy(tau))).numpy()
    pert = np.concatenate([rng.normal(0, 0.1, (n, 3)), rng.normal(0, 0.02, (n, 3))], axis=1)
    est = lie.se3_compose(torch.from_numpy(truth), lie.se3_exp(torch.from_numpy(pert))).numpy()
    est[0] = truth[0]
    return {"vertices": est, "src": src, "dst": dst, "measurements": meas}


def snake(nx, ny, nz):
    """The poses in the order of a boustrophedon path: along z, row by row
    in y, layer by layer in x, each row and layer walked back the other
    way, so that each step goes to a lattice neighbour."""
    v = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    order, row = [], 0
    for a in range(nx):
        for b in (range(ny) if a % 2 == 0 else range(ny - 1, -1, -1)):
            order.extend(v[a, b] if row % 2 == 0 else v[a, b, ::-1])
            row += 1
    return np.asarray(order, dtype=np.int64)


def generate(seed, nx=20, ny=20, nz=20, dropped=564):
    """The lattice's poses with the snake path's odometry and all other
    lattice edges but ``dropped``, in the lattice's edge order."""
    full = lattice(nx, ny, nz, seed=seed)
    src, dst = full["src"], full["dst"]
    path = snake(nx, ny, nz)
    odometry = set(zip(np.minimum(path[:-1], path[1:]).tolist(),
                       np.maximum(path[:-1], path[1:]).tolist()))
    on_path = np.asarray([(int(i), int(j)) in odometry for i, j in zip(src, dst)])
    others = np.flatnonzero(~on_path)
    drop = np.random.default_rng(EDGE_SEED).choice(others, size=dropped, replace=False)
    keep = np.ones(src.shape[0], dtype=bool)
    keep[drop] = False
    return {"vertices": full["vertices"], "src": src[keep], "dst": dst[keep],
            "measurements": full["measurements"][keep]}
