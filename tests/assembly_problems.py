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


def pinhole_problem(intrinsics_free=False):
    """A group that the assembly kernels do not take: the pinhole camera of
    ``chip_smoke.selfcal_scene`` (6 cameras, 120 points, every point in
    every view), Huber(2), the first pose fixed and the second pose's x.
    Each camera's intrinsics are a variable of its own where
    ``intrinsics_free`` (entities of pose and intrinsics, De = 10), else
    per-row constants (entities of the pose alone, De = 6)."""
    from chip_smoke import SELFCAL_MODELS, selfcal_arrays, selfcal_scene

    poses, pts = selfcal_scene()
    a = selfcal_arrays("pinhole", SELFCAL_MODELS["pinhole"], poses, pts, shared=False)
    C, P = a["poses0"].shape[0], a["pts0"].shape[0]
    pose_names = [f"pose_{i:03d}" for i in range(C)]
    problem = apx.Problem()
    problem.add_variables_batch(pose_names, "SE3", a["poses0"])
    problem.add_variables_batch([f"pt_{j:04d}" for j in range(P)], "R3", a["pts0"])
    slots = [(pose_names, a["cam_idx"]), ([f"pt_{j:04d}" for j in range(P)], a["pt_idx"])]
    data = {"obs": a["obs"]}
    if intrinsics_free:
        intr_names = [f"intr_{i:04d}" for i in range(C)]
        problem.add_variables_batch(intr_names, "R4", a["intr0"])
        slots.append((intr_names, a["cam_idx"]))
        optimize = OPTIMIZE_MODES["self_calibration"]
    else:
        data["const_intrinsics"] = a["intr0"][a["cam_idx"]]
        optimize = OPTIMIZE_MODES["bundle_adjustment"]
    problem.add_residual_block_batch(slots, ProjectionFactor.template("pinhole", optimize),
                                     data, loss=apx.HuberLoss(2.0))
    problem.fix_variable(pose_names[0])
    problem.fix_variable(pose_names[1], indices=[0])
    return problem
