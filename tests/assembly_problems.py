"""Bundle-adjustment problems of the assembly kernels' tests
(``test_torch_schur.py`` on the CPU, ``test_torch_cuda.py`` on the card).
It imports no JAX."""

import apex_tpu_torch as apx
from apex_tpu_torch.factors.projection import OPTIMIZE_MODES, ProjectionFactor
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.manifolds.utils import quat_to_mat


def assembly_scene():
    """A small venice-shaped scene: landmarks seen 1 to 8 times, so the
    bucketed layout makes four groups (caps 1, 2, 4, 8) with weight-0
    padding."""
    return synthetic.synthetic_ba_large(n_cameras=10, n_points=600, obs_per_camera=150,
                                        pixel_noise=0.3)


def camera_major_problem(ds, mode="self_calibration", loss=None, fix_first=True):
    """``ds`` as one group of BAL rows in the dataset's own order, camera
    by camera, as a caller adding each image's observations gives them:
    not sorted by landmark, unlike ``build_ba_problem``'s layouts."""
    optimize = OPTIMIZE_MODES[mode]
    C, P = ds.num_cameras, ds.num_points
    poses = [f"pose_{i:04d}" for i in range(C)]
    intrinsics = [f"intr_{i:04d}" for i in range(C)]
    points = [f"pt_{j:05d}" for j in range(P)]
    problem = apx.Problem()
    problem.add_variables_batch(poses, "SE3", ds.camera_se3())
    problem.add_variables_batch(points, "R3", ds.points)
    slots = [(poses, ds.cam_indices), (points, ds.point_indices)]
    data = {"obs": ds.observations}
    if "intrinsics" in optimize:
        problem.add_variables_batch(intrinsics, "R3", ds.intrinsics())
        slots.append((intrinsics, ds.cam_indices))
    else:
        data["const_intrinsics"] = ds.intrinsics()[ds.cam_indices]
    problem.add_residual_block_batch(slots, ProjectionFactor.template("bal_pinhole", optimize),
                                     data, loss=loss)
    if fix_first:
        problem.fix_variable(poses[0])
    return problem


def behind_a_camera(cp, values):
    """``values`` (a tuple of pool tensors) with the landmark of the first
    group's first row moved behind that row's camera, to camera frame
    (0.1, 0.1, 1): BAL cameras look down -Z, so the row's ok mask is
    false."""
    g = cp.groups[0]
    pose = values[g.pool_ids[0]][g.indices[0][0]]
    R = quat_to_mat(pose[3:])
    moved = [v.clone() for v in values]
    moved[g.pool_ids[1]][g.indices[1][0]] = R.T @ (
        pose.new_tensor([0.1, 0.1, 1.0]) - pose[:3])
    return tuple(moved)
