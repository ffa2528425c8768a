"""End-to-end bundle adjustment of the PyTorch port against apex_tpu (its
block path, APEX_TPU_UNIFORM=0), on the CPU in f64; plus the port's I/O,
CLI, device policy and import boundary."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.io import bal as jax_bal
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.ba import build_ba_problem, rmse
from apex_tpu_torch.io import bal, synthetic
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

REPO = Path(__file__).resolve().parent.parent
EXACT = dict(pcg_forcing=False, pcg_tolerance=1e-10, pcg_max_iterations=500)


@pytest.fixture(scope="module")
def small_ba():
    return synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)


def _solve_both(ds, **kw):
    def cfg(pkg):
        return pkg.LevenbergMarquardtConfig(linear_solver_type="schur_implicit",
                                            max_iterations=30, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_UNIFORM", "0")
        rj = jax_apx.LevenbergMarquardt(cfg(jax_apx)).optimize(
            jax_build(ds).compile(dtype=np.float64))
    rt = apx.LevenbergMarquardt(cfg(apx)).optimize(
        build_ba_problem(ds).compile(dtype=torch.float64, device="cpu"))
    return rj, rt


def test_exact_solve_matches_apex_tpu(small_ba):
    """Exact inner solves: the same LM trajectory, so the same iterations
    and status; the final cost agrees to rounding (rtol 1e-8)."""
    rj, rt = _solve_both(small_ba, **EXACT)
    assert rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status)) == apx.Status.PARAMETER_TOLERANCE_REACHED
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    assert rt.successful_steps == rj.successful_steps
    for name, v in rj.variables.items():
        np.testing.assert_allclose(rt.variables[name], v, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(rt.variables["pose_0000"], small_ba.camera_se3()[0],
                               atol=1e-12)  # the gauge camera stays fixed


@pytest.mark.parametrize("options", [
    {},  # the defaults: forcing sequence + guarded warm start
    {"pcg_q_tolerance": 0.1},
    {"damping": "auto"},
    {"schur_preconditioner": "block_diagonal"},
    {"use_jacobi_scaling": True},  # no warm start on that path
], ids=["default", "q_tolerance", "damping_auto", "block_diagonal", "jacobi_scaling"])
def test_inexact_solves_match_apex_tpu(small_ba, options):
    """Inexact PCG solves: the same iterations and status; the final cost to
    rtol 1e-6."""
    rj, rt = _solve_both(small_ba, **options)
    assert rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status))
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-6)
    assert rmse(rt.final_cost, small_ba.num_observations) < 1.0


@pytest.mark.parametrize("make", ["synthetic_ba", "synthetic_ba_large"])
def test_synthetic_arrays_match(make):
    kw = (dict(n_cameras=8, n_points=150, seed=0) if make == "synthetic_ba"
          else dict(n_cameras=5, n_points=80, obs_per_camera=40, seed=1))
    t = getattr(synthetic, make)(**kw)
    j = getattr(jax_synthetic, make)(**kw)
    for field in ("rotations", "translations", "focals", "k1", "k2", "points",
                  "cam_indices", "point_indices", "observations"):
        np.testing.assert_allclose(getattr(t, field), getattr(j, field),
                                   rtol=1e-12, atol=1e-12, err_msg=field)


def test_bal_roundtrip_and_fixture(tmp_path, small_ba):
    p = tmp_path / "test.bal"
    bal.save_bal(p, small_ba)
    ds2 = bal.load_bal(p)
    assert (ds2.num_cameras, ds2.num_points, ds2.num_observations) == (
        small_ba.num_cameras, small_ba.num_points, small_ba.num_observations)
    np.testing.assert_allclose(ds2.points, small_ba.points, rtol=1e-12)
    np.testing.assert_allclose(ds2.observations, small_ba.observations, rtol=1e-9)
    fixture = REPO / "tests" / "fixtures" / "bal_excerpt.txt"
    t, j = bal.load_bal(fixture), jax_bal.load_bal(fixture)
    for field in ("rotations", "translations", "focals", "k1", "k2", "points",
                  "cam_indices", "point_indices", "observations"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    np.testing.assert_allclose(t.camera_se3(), j.camera_se3(), rtol=0, atol=1e-15)


def test_cli_cpu(capsys):
    from apex_tpu_torch.cli.bundle_adjustment import main

    rc = main(["--synthetic", "--cameras", "6", "--points", "80", "--max-iterations", "5",
               "--platform", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Optimization completed!" in out and "Final RMSE" in out


def test_no_card_no_fallback(monkeypatch, small_ba):
    """Asking for the card where there is none raises; nothing falls back
    to the CPU."""
    from apex_tpu_torch.cli.bundle_adjustment import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--synthetic", "--cameras", "4", "--points", "40", "--platform", "cuda"])
    with pytest.raises(RuntimeError, match="cuda"):
        build_ba_problem(small_ba).compile(device="cuda")


def test_entry_points_default_to_the_card(small_ba):
    """``compile()`` and ``optimize(Problem)`` with no device ask for the
    card; without one they raise and return no CPU result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; test_torch_cuda.py checks the default lands on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        build_ba_problem(small_ba).compile()
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type="schur_implicit", max_iterations=3)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        apx.LevenbergMarquardt(cfg).optimize(build_ba_problem(small_ba))


def test_sparse_general_matches_apex_tpu(small_ba):
    """The general-sparsity tier on bundle adjustment (mixed block DOF: SE3
    poses, R3 intrinsics and landmarks, padded to 6): the same iterations,
    status and final cost (rtol 1e-8) as apex_tpu."""
    def cfg(pkg):
        return pkg.LevenbergMarquardtConfig(linear_solver_type="sparse_general",
                                            max_iterations=30)

    rj = jax_apx.LevenbergMarquardt(cfg(jax_apx)).optimize(
        jax_build(small_ba).compile(dtype=np.float64))
    rt = apx.LevenbergMarquardt(cfg(apx)).optimize(
        build_ba_problem(small_ba).compile(dtype=torch.float64, device="cpu"))
    assert rt.iterations == rj.iterations and rt.status == apx.Status(int(rj.status))
    assert rt.converged and rmse(rt.final_cost, small_ba.num_observations) < 0.55 * rmse(
        rt.initial_cost, small_ba.num_observations)
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)


@pytest.mark.parametrize("solver", ["pcg", "sparse_general"])
def test_not_ported_paths_raise(small_ba, solver):
    """The last solvers jit mode took (ROADMAP A.8b) run it on bundle
    adjustment: python mode's iterations, status and final cost (rtol
    1e-12). Every solver of the menu now runs in both modes."""
    cp = build_ba_problem(small_ba).compile(device="cpu")
    rp, rj = (apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type=solver, mode=mode)).optimize(cp) for mode in ("python", "jit"))
    assert (rj.iterations, rj.status) == (rp.iterations, rp.status)
    np.testing.assert_allclose(rj.final_cost, rp.final_cost, rtol=1e-12)


def test_other_losses_not_ported():
    """The loss menu is ported (ROADMAP A.4): the CLIs' names build the
    constructors' losses."""
    from apex_tpu_torch.core.losses import CauchyLoss, Loss, TukeyBiweightLoss, loss_by_name

    assert loss_by_name("cauchy", 1.0) == CauchyLoss(1.0)
    assert Loss("tukey_biweight", (4.0,)) == TukeyBiweightLoss(4.0)


def test_tf32_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import apex_tpu_torch, apex_tpu_torch.cli.bundle_adjustment\n"
        "import apex_tpu_torch.kernels.landmark_blocks, apex_tpu_torch.convert\n"
        "import apex_tpu_torch.kernels.spd_inverse, apex_tpu_torch.kernels.graph_conditional\n"
        "import apex_tpu_torch.optim.graphs, apex_tpu_torch.cli.pose_graph\n"
        "import apex_tpu_torch.cameras.extended, apex_tpu_torch.manifolds.sim3\n"
        "import apex_tpu_torch.manifolds.sgal3, apex_tpu_torch.manifolds.se23\n"
        "import apex_tpu_torch.factors.base, apex_tpu_torch.cameras.pinhole\n"
        "import apex_tpu_torch.errors, apex_tpu_torch.config, apex_tpu_torch.utils.logger\n"
        "import apex_tpu_torch.utils.profiling, apex_tpu_torch.core.checkpoint\n"
        "import apex_tpu_torch.observers, apex_tpu_torch.observers.visualization\n"
        "import apex_tpu_torch.io.datasets, apex_tpu_torch.cli.download_datasets\n"
        "import apex_tpu_torch.io.rosbag, apex_tpu_torch.io.dds, apex_tpu_torch.cli.bag_tools\n"
        "import apex_tpu_torch.examples.compare_solvers, apex_tpu_torch.examples.compare_optimizers\n"
        "import apex_tpu_torch.examples.covariance_estimation, apex_tpu_torch.examples.custom_factor\n"
        "import apex_tpu_torch.examples.load_graph_file\n"
        "import apex_tpu_torch.examples.loss_function_comparison\n"
        "import apex_tpu_torch.examples.visualize_graph_file\n"
        "import apex_tpu_torch.examples.visualize_optimization\n"
        "import apex_tpu_torch.parallel, apex_tpu_torch.parallel.schur_partitioned\n"
        "import apex_tpu_torch.graft_entry, apex_tpu_torch.examples.multichip_ba\n"
        "import apex_tpu_torch.benches.ladder, apex_tpu_torch.benches.odometry_pose_benchmark\n"
        "import apex_tpu_torch.benches.bundle_adjustment_benchmark\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'apex_tpu')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
