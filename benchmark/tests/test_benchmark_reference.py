"""The yardstick against the program at small sizes on the CPU: the frozen
generators give the program's arrays, the plain reference's objective is
the program's, and the program's landmark numbering is the one the
comparison assumes. These are the only tests that read the program's
generators and internals."""

import numpy as np
import pytest
import torch
from harness import compare, generators, lie, program, reference

import apex_tpu_torch as apx
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.manifolds import SE3, so3

SEEDS = [0, 2**31 + 17]


def _graph_arrays(g):
    n = len(g.vertices_se3)
    return (np.stack([g.vertices_se3[i] for i in range(n)]),
            np.asarray([e.frm for e in g.edges_se3]), np.asarray([e.to for e in g.edges_se3]),
            np.stack([e.measurement for e in g.edges_se3]))


@pytest.mark.parametrize("seed", SEEDS)
def test_pose_graph_generator_equals_the_programs(seed):
    mine = generators.pose_graph_3d(n_poses=240, rings=8, seed=seed)
    v, src, dst, meas = _graph_arrays(
        synthetic.synthetic_pose_graph_3d(n_poses=240, rings=8, seed=seed))
    np.testing.assert_array_equal(mine["src"], src)
    np.testing.assert_array_equal(mine["dst"], dst)
    np.testing.assert_allclose(mine["vertices"], v, rtol=0, atol=1e-13)
    np.testing.assert_allclose(mine["measurements"], meas, rtol=0, atol=1e-13)


def test_the_pose_graph_has_sphere2500s_size():
    data = generators.pose_graph_3d(n_poses=2500, rings=50)
    assert data["vertices"].shape[0] == 2500 and data["src"].shape[0] == 4949


@pytest.mark.parametrize("seed", SEEDS)
def test_ba_generator_equals_the_programs(seed):
    mine = generators.ba_large(n_cameras=16, n_points=2000, obs_per_camera=150, seed=seed,
                               pixel_noise=0.3)
    theirs = synthetic.synthetic_ba_large(n_cameras=16, n_points=2000, obs_per_camera=150,
                                          seed=seed, pixel_noise=0.3)
    for key in program.BAL_FIELDS:
        np.testing.assert_allclose(mine[key], getattr(theirs, key), rtol=0, atol=1e-13)


def test_lie_functions_equal_the_programs():
    gen = torch.Generator().manual_seed(3)
    tau = torch.randn((64, 6), generator=gen, dtype=torch.float64)
    tau[:8] *= 1e-7  # the small-angle branches
    x = lie.se3_exp(torch.randn((64, 6), generator=gen, dtype=torch.float64))
    for mine, theirs in ((lie.se3_exp(tau), SE3.exp(tau)), (lie.se3_log(x), SE3.log(x)),
                         (lie.se3_compose(x, x.flip(0)), SE3.compose(x, x.flip(0))),
                         (lie.so3_exp(tau[:, 3:]), so3.exp(tau[:, 3:])),
                         (lie.se3_plus(x, tau), SE3.normalize(SE3.plus(x, tau)))):
        torch.testing.assert_close(mine, theirs, rtol=0, atol=1e-12)


def _ba_problem(data):
    ds = program.to_input("bundle_adjustment", data)
    problem = program.build("bundle_adjustment", ds, {"mode": "self_calibration"})
    return problem, program.compile_problem(problem, {"dtype": "float64"}, "cpu")


def _perturbed(cp, scale=1e-2):
    gen = torch.Generator().manual_seed(1)
    dx = scale * torch.randn(cp.total_dof, generator=gen, dtype=torch.float64)
    return cp.apply_step(cp.initial_values(), dx)


def test_the_reference_cost_is_the_programs_on_a_small_ba():
    data = generators.ba_large(n_cameras=12, n_points=1500, obs_per_camera=120, seed=4,
                               pixel_noise=0.3)
    _, cp = _ba_problem(data)
    ref = reference.BundleAdjustment(data, torch.float64, torch.device("cpu"))
    for values in (cp.initial_values(), _perturbed(cp)):
        arrays = compare.program_arrays("bundle_adjustment", data, cp.values_dict(values))
        ours = float(ref.cost(tuple(torch.as_tensor(a) for a in arrays)))
        assert ours == pytest.approx(float(cp.cost(values)), rel=1e-12)


def test_the_reference_cost_is_the_programs_on_a_small_pose_graph():
    data = generators.pose_graph_3d(n_poses=200, rings=8, seed=6)
    cp = program.compile_problem(program.to_input("pose_graph", data).to_problem(),
                                 {"dtype": "float64"}, "cpu")
    ref = reference.PoseGraph(data, torch.float64, torch.device("cpu"))
    for values in (cp.initial_values(), _perturbed(cp, 1e-1)):
        arrays = compare.program_arrays("pose_graph", data, cp.values_dict(values))
        ours = float(ref.cost(tuple(torch.as_tensor(a) for a in arrays)))
        assert ours == pytest.approx(float(cp.cost(values)), rel=1e-12)


def test_the_landmark_numbering_is_the_programs():
    data = generators.ba_large(n_cameras=12, n_points=1500, obs_per_camera=120, seed=8)
    problem, _ = _ba_problem(data)
    new = compare.point_new_ids(data["point_indices"], data["points"].shape[0])
    np.testing.assert_array_equal(problem._pt_perm[new], np.arange(data["points"].shape[0]))


@pytest.mark.parametrize("kind", ["bundle_adjustment", "pose_graph"])
def test_the_reference_solve_follows_the_programs_python_mode(kind):
    if kind == "bundle_adjustment":
        data = generators.ba_large(n_cameras=12, n_points=1500, obs_per_camera=120, seed=2,
                                   pixel_noise=0.3)
        opts = {"linear_solver_type": "schur_implicit", "schur_preconditioner": "schur_jacobi",
                "pcg_max_iterations": 15, "max_iterations": 5}
        cp = _ba_problem(data)[1]
    else:
        data = generators.pose_graph_3d(n_poses=200, rings=8, seed=2)
        opts = {"linear_solver_type": "sparse_cholesky", "damping": "auto",
                "cost_tolerance": 1e-4, "max_iterations": 100}
        cp = program.compile_problem(program.to_input(kind, data).to_problem(),
                                     {"dtype": "float64"}, "cpu")
    ours = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(mode="python", **opts)).optimize(cp)
    settings = reference.Settings(**{k: v for k, v in opts.items()
                                     if k in reference.Settings.__dataclass_fields__})
    ref = reference.levenberg_marquardt(reference.PROBLEMS[kind](data, torch.float64, "cpu"),
                                        settings)
    assert (ours.status.name, ours.iterations) == (ref.status, ref.iterations)
    assert ours.final_cost == pytest.approx(ref.final_cost, rel=1e-7)


def test_a_runs_seed_moves_the_frame_not_the_work():
    spec = {"name": "pose_graph_3d", "params": {"n_poses": 200, "rings": 8}}
    settings = reference.Settings(max_iterations=100, cost_tolerance=1e-4, damping="auto")
    runs = []
    for seed in (1, 2**31 + 3):
        data = generators.make(spec, seed)
        runs.append((data, reference.levenberg_marquardt(
            reference.PoseGraph(data, torch.float64, "cpu"), settings)))
    (d1, r1), (d2, r2) = runs
    assert np.abs(d1["vertices"] - d2["vertices"]).max() > 0.1
    np.testing.assert_array_equal(d1["measurements"], d2["measurements"])
    assert (r1.status, r1.iterations) == (r2.status, r2.iterations)
    assert r1.final_cost == pytest.approx(r2.final_cost, rel=1e-10)
    # the same solution in two frames: no gap once the gauge is taken out
    assert compare.x_gap("pose_graph", r1.values, r2.values, None) < 1e-8
