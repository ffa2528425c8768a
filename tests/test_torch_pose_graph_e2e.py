"""End-to-end SE3 pose graphs through the PyTorch port's sparse_cholesky
(band assembly + block cyclic reduction) on the CPU in f64: the certified
medium fixture, a synthetic sphere against apex_tpu, the CLI on SE2 and
SE3 graphs, the switch to the general tier above a 1536-column bandwidth,
the paths that are not ported, and the import boundary."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu.io import load_g2o as jax_load_g2o
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.convert import values_from_jax
from apex_tpu_torch.io import synthetic
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
# tests/test_medium_fixture.py: certified f64 optimum and iterations
MEDIUM_SE3 = ("medium_se3_250.g2o", 5.132992631561506e-01, 6)
CERTIFIED = dict(max_iterations=100, cost_tolerance=1e-10, parameter_tolerance=1e-14,
                 gradient_tolerance=1e-14)
BENCH = dict(max_iterations=100, cost_tolerance=1e-4, damping="auto")


def test_medium_fixture_reaches_certified_cost():
    fname, cost, iters = MEDIUM_SE3
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type="sparse_cholesky", **CERTIFIED)
    r = apx.LevenbergMarquardt(cfg).optimize(
        apx.load_g2o(FIXTURES / fname).to_problem().compile(dtype=torch.float64, device="cpu"))
    assert r.converged
    np.testing.assert_allclose(r.final_cost, cost, rtol=1e-8)
    assert r.iterations == iters


@pytest.fixture(scope="module")
def sphere500():
    kw = dict(n_poses=500, rings=10, seed=0)
    return synthetic.synthetic_pose_graph_3d(**kw), jax_synthetic.synthetic_pose_graph_3d(**kw)


@pytest.mark.parametrize("options", [{}, {"use_jacobi_scaling": True}],
                         ids=["default", "jacobi_scaling"])
def test_sphere_matches_apex_tpu(sphere500, options):
    """sparse_cholesky with damping="auto", as bench.py's pose-graph rungs
    run it: the same iterations and status, final cost to rtol 1e-8."""
    gt, gj = sphere500
    rj = jax_apx.LevenbergMarquardt(jax_apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", **BENCH, **options)).optimize(
        gj.to_problem().compile(dtype=np.float64))
    rt = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", **BENCH, **options)).optimize(
        gt.to_problem().compile(dtype=torch.float64, device="cpu"))
    assert rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status))
    assert rt.converged and rt.final_cost < 0.01 * rt.initial_cost
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)


def test_sphere_first_step_matches_apex_tpu(sphere500):
    """The first LM step: damping from "auto", then dx, g and cost of the
    banded solve, from the same values in both packages. The first pose is
    fixed: without it only the damping (2.4e-10 here) holds the 6-DOF
    gauge, and dx then agrees to 2.2e-7 of its largest entry, not 1e-9
    (measured; with the gauge fixed, 4.7e-12)."""
    gt, gj = sphere500
    jcp = gj.to_problem(fix_first=True).compile(dtype=np.float64)
    cp = gt.to_problem(fix_first=True).compile(dtype=torch.float64, device="cpu")
    jvals = jcp.initial_values()
    values = values_from_jax(cp, [np.asarray(v) for v in jvals], jcp.pools)
    jlm = jax_apx.LevenbergMarquardt(jax_apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", **BENCH))
    lm = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(
        linear_solver_type="sparse_cholesky", **BENCH))
    jdamp = float(jlm._init_damping_state(jcp, jvals))
    damp = lm._init_damping_state(cp, values)
    np.testing.assert_allclose(damp, jdamp, rtol=1e-12)
    jdx, jg, jcost, _, _ = jlm._make_solve_fn(jcp)(
        jvals, jnp.asarray(jdamp), jnp.asarray(0), jnp.ones(jcp.total_dof))
    dx, g, cost, _, predicted = lm._make_solve_fn(cp)(
        values, damp, 0, torch.ones(cp.total_dof, dtype=torch.float64))
    assert predicted is None
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(jdx)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-12)


def test_values_from_jax_se3_pool():
    g = apx.load_g2o(FIXTURES / "sphere_excerpt.g2o")
    jcp = jax_load_g2o(FIXTURES / "sphere_excerpt.g2o").to_problem().compile(
        dtype=np.float64)
    cp = g.to_problem().compile(dtype=torch.float32, device="cpu")
    arrays = [np.asarray(v) for v in jcp.initial_values()]
    values = values_from_jax(cp, arrays, jcp.pools)
    assert len(values) == 1 and values[0].dtype == torch.float32
    assert cp.pools[0].manifold.name == "SE3" and values[0].shape == (g.num_vertices, 7)
    np.testing.assert_allclose(values[0].numpy(), arrays[0], rtol=1e-7)
    with pytest.raises(ValueError, match="shape"):
        values_from_jax(cp, [arrays[0][:-1]], jcp.pools)


def test_problem_block_api():
    p = apx.Problem()
    ident = np.array([0, 0, 0, 1.0, 0, 0, 0])
    p.add_variable("x0", "SE3", ident)
    bid = p.add_residual_block(["x0", "x1"], apx.BetweenFactor("SE3", ident))
    assert p.variable_names == ["x0", "x1"] and p.num_residual_blocks == 1
    with pytest.raises(ValueError, match="redeclared"):
        p.add_variable("x1", "R3")
    with pytest.raises(ValueError, match="binds 2"):
        p.add_residual_block(["x0"], apx.BetweenFactor("SE3", ident))
    with pytest.raises(ValueError, match="no initial value"):
        p.compile(device="cpu")
    p.remove_residual_block(bid)
    assert p.num_residual_blocks == 0


def test_cli_cpu(capsys, tmp_path):
    from apex_tpu_torch.cli.pose_graph import main

    out = tmp_path / "optimized.g2o"
    rc = main(["--file", str(FIXTURES / MEDIUM_SE3[0]), "--platform", "cpu",
               "--save-output", str(out)])
    assert rc == 0
    table = capsys.readouterr().out
    assert "COST_TOLERANCE_REACHED" in table and "chi2 after" in table
    assert apx.load_g2o(out).num_vertices == 250


def test_cli_module_runs_with_profile():
    """--profile writes its trace under the system's temporary directory,
    not into the package tree."""
    import tempfile

    from apex_tpu_torch.cli.pose_graph import TRACE_PATH

    assert TRACE_PATH.is_relative_to(tempfile.gettempdir())
    assert not TRACE_PATH.is_relative_to(REPO)
    TRACE_PATH.unlink(missing_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.cli.pose_graph", "--synthetic", "sphere",
         "--poses", "100", "--platform", "cpu", "--max-iterations", "3", "--profile"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "lm" in proc.stdout and "profiler trace written" in proc.stderr
    assert "cr.eliminate" in TRACE_PATH.read_text()


@pytest.mark.parametrize("argv,match", [
    # --jit runs every optimizer and solver (ROADMAP A.8b is done): these
    # three raised until then and now solve (match None)
    (["--synthetic", "sphere", "--optimizer", "gn", "--jit", "--linear-solver", "sparse_qr"],
     None),
    (["--synthetic", "sphere", "--optimizer", "dl", "--jit"], None),
    (["--dataset", "sphere2500"], "ROADMAP A.10"),
    (["--synthetic", "sphere", "--jit", "--linear-solver", "pcg"], None),
], ids=["gn", "dl", "dataset", "jit"])
def test_cli_not_ported_paths_raise(argv, match, capsys):
    from apex_tpu_torch.cli.pose_graph import main

    argv = argv + ["--poses", "100", "--platform", "cpu"]
    if match is None:
        assert main(argv) == 0
        assert "COST_TOLERANCE_REACHED" in capsys.readouterr().out
        return
    with pytest.raises(NotImplementedError, match=match):
        main(argv)


@pytest.mark.parametrize("optimizer", ["lm", "gn", "dl"])
def test_cli_jit_runs(optimizer, capsys):
    """--jit solves with LM, Gauss-Newton and DogLeg: the jit row equals
    the python one (status, iterations, costs as printed)."""
    from apex_tpu_torch.cli.pose_graph import main

    argv = ["--file", str(FIXTURES / MEDIUM_SE3[0]), "--optimizer", optimizer,
            "--platform", "cpu"]
    rows = []
    for extra in ([], ["--jit"]):
        assert main(argv + extra) == 0
        rows.append(capsys.readouterr().out.strip().splitlines()[-1].split()[:6])
    assert rows[0] == rows[1] and rows[1][1] == "COST_TOLERANCE_REACHED"


@pytest.mark.parametrize("argv,graph", [
    (["--synthetic", "ring", "--poses", "60"], "SE2"),
    (["--synthetic", "manhattan", "--poses", "100", "--linear-solver", "dense_qr"], "SE2"),
    (["--file", str(FIXTURES / "toro_excerpt.graph"), "--loss", "cauchy"], "SE2"),
    (["--file", str(FIXTURES / "medium_se2_300.g2o"), "--linear-solver", "dense_cholesky"],
     "SE2"),
    (["--synthetic", "sphere", "--poses", "100", "--loss", "cauchy", "--loss-scale", "0.5"],
     "SE3"),
    (["--synthetic", "sphere", "--poses", "100", "--linear-solver", "dense_cholesky"], "SE3"),
    (["--synthetic", "sphere", "--poses", "100", "--optimizer", "gn"], "SE3"),
    (["--synthetic", "ring", "--poses", "60", "--optimizer", "dl"], "SE2"),
    (["--synthetic", "ring", "--poses", "60", "--linear-solver", "sparse_qr"], "SE2"),
    (["--synthetic", "sphere", "--poses", "100", "--linear-solver", "pcg"], "SE3"),
    (["--synthetic", "sphere", "--poses", "100", "--linear-solver", "sparse_general"], "SE3"),
], ids=["ring", "manhattan", "toro", "se2", "loss", "dense", "gn", "dl", "sparse_qr", "pcg",
        "sparse_general"])
def test_cli_ported_paths_run(argv, graph, capsys):
    """The paths that raised before SE2, the loss menu, the dense tier, the
    other optimizers, the small solver tiers and the general tier were
    ported: each solves on the CPU and prints the report table."""
    from apex_tpu_torch.cli.pose_graph import main

    assert main(argv + ["--platform", "cpu"]) == 0
    captured = capsys.readouterr()
    assert f"({graph})" in captured.err
    row = captured.out.strip().splitlines()[-1].split()
    optimizer = argv[argv.index("--optimizer") + 1] if "--optimizer" in argv else "lm"
    assert row[0] == optimizer and "TOLERANCE_REACHED" in row[1]
    assert float(row[4]) < float(row[3])  # final cost below the initial


@pytest.mark.parametrize("solver", ["sparse_cholesky", "pcg", "sparse_general"])
def test_cli_optimizer_all(solver, capsys):
    """``--optimizer all``: one row per optimizer, all at the certified
    cost (rtol 1e-3 of the printed figures); DogLeg, which has neither pcg
    nor sparse_general, takes sparse_cholesky."""
    from apex_tpu_torch.cli.pose_graph import main

    assert main(["--file", str(FIXTURES / MEDIUM_SE3[0]), "--optimizer", "all",
                 "--linear-solver", solver, "--platform", "cpu"]) == 0
    rows = [line.split() for line in capsys.readouterr().out.strip().splitlines()[-3:]]
    assert [r[0] for r in rows] == ["lm", "gn", "dl"]
    assert all("TOLERANCE_REACHED" in r[1] for r in rows)
    np.testing.assert_allclose([float(r[4]) for r in rows], MEDIUM_SE3[1], rtol=1e-3)


def test_cli_unknown_loss_exits():
    from apex_tpu_torch.cli.pose_graph import main

    with pytest.raises(SystemExit, match="unknown loss 'bogus'; known: none, adaptive_barron"):
        main(["--synthetic", "ring", "--poses", "20", "--loss", "bogus", "--platform", "cpu"])


def test_wide_band_takes_the_general_tier():
    """Above a 1536-column bandwidth sparse_cholesky solves by the
    general-sparsity tier, as the JAX package does; a given panel keeps the
    banded tier. Both reach the exact optimum of this noise-free chain."""
    p = apx.Problem()
    ident = np.array([0, 0, 0, 1.0, 0, 0, 0])
    for i in range(300):
        p.add_variable(f"x{i}", "SE3", ident)
    for i in range(299):
        p.add_residual_block([f"x{i}", f"x{i + 1}"], apx.BetweenFactor("SE3", ident))
    p.add_residual_block(["x0", "x299"], apx.BetweenFactor("SE3", ident))
    cp = p.compile(device="cpu", ordering="name")
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type="sparse_cholesky", max_iterations=2)
    lm = apx.LevenbergMarquardt(cfg)
    assert lm._make_solve_fn(cp).general_sparse.healthy()
    assert lm.optimize(cp).final_cost == 0.0
    cfg.banded_panel = 1800
    assert not hasattr(apx.LevenbergMarquardt(cfg)._make_solve_fn(cp), "general_sparse")
    assert apx.LevenbergMarquardt(cfg).optimize(cp).final_cost == 0.0


def _pose_graph_problem(pkg, graph, loss_of):
    """graph's problem built edge by edge in package pkg, with edge k's
    loss loss_of(pkg, k, edge)."""
    p = pkg.Problem()
    for vid in sorted(graph.vertices_se3):
        p.add_variable(f"x{vid}", "SE3", graph.vertices_se3[vid])
    for k, e in enumerate(graph.edges_se3):
        p.add_residual_block([f"x{e.frm}", f"x{e.to}"],
                             pkg.BetweenFactor("SE3", e.measurement), loss_of(pkg, k, e))
    return p


def _huber_all(pkg, k, e):
    return pkg.HuberLoss(1.0)


def _huber_loops_mixed_scales(pkg, k, e):
    # odometry plain L2; loop closures Huber with three scales, so one group
    # stacks different loss parameters and a second group follows it
    return None if abs(e.to - e.frm) == 1 else pkg.HuberLoss((0.5, 1.0, 2.0)[k % 3])


@pytest.mark.parametrize("loss_of", [_huber_all, _huber_loops_mixed_scales],
                         ids=["huber", "mixed"])
def test_huber_pose_graph_matches_apex_tpu(loss_of):
    """Robust losses on single residual blocks, grouped by (signature, loss
    kind) with stacked parameters: the same iterations and status as
    apex_tpu, initial cost to rtol 1e-12 and final cost to rtol 1e-8."""
    path = FIXTURES / MEDIUM_SE3[0]
    cfg = dict(linear_solver_type="sparse_cholesky", max_iterations=20)
    rj = jax_apx.LevenbergMarquardt(jax_apx.LevenbergMarquardtConfig(**cfg)).optimize(
        _pose_graph_problem(jax_apx, jax_load_g2o(path), loss_of).compile(dtype=np.float64))
    rt = apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(**cfg)).optimize(
        _pose_graph_problem(apx, apx.load_g2o(path), loss_of).compile(
            dtype=torch.float64, device="cpu"))
    assert rt.iterations == rj.iterations
    assert rt.status == apx.Status(int(rj.status))
    assert rt.final_cost < 0.05 * rt.initial_cost
    np.testing.assert_allclose(rt.initial_cost, rj.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(rt.final_cost, rj.final_cost, rtol=1e-8)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import apex_tpu_torch, apex_tpu_torch.cli.bundle_adjustment, "
        "apex_tpu_torch.cli.pose_graph\n"
        "import apex_tpu_torch.linalg.banded, apex_tpu_torch.factors.between\n"
        "import apex_tpu_torch.io.g2o, apex_tpu_torch.io.graph, apex_tpu_torch.io.synthetic\n"
        "import apex_tpu_torch.io.toro, apex_tpu_torch.linalg.dense, apex_tpu_torch.factors.prior\n"
        "import apex_tpu_torch.manifolds.se2, apex_tpu_torch.manifolds.so2\n"
        "import apex_tpu_torch.core.losses, apex_tpu_torch.core.corrector\n"
        "import apex_tpu_torch.optim.gauss_newton, apex_tpu_torch.optim.dogleg\n"
        "import apex_tpu_torch.core.covariance, apex_tpu_torch.linalg.banded_qr\n"
        "import apex_tpu_torch.linalg.iterative, apex_tpu_torch.linalg.schur\n"
        "import apex_tpu_torch.linalg.sparse_general\n"
        "import apex_tpu_torch.cameras.extended, apex_tpu_torch.manifolds.sim3\n"
        "import apex_tpu_torch.manifolds.sgal3, apex_tpu_torch.manifolds.se23\n"
        "import apex_tpu_torch.factors.base\n"
        "g = apex_tpu_torch.io.synthetic.synthetic_pose_graph_2d(20).to_problem(fix_first=True)\n"
        "for solver in ('sparse_qr', 'pcg'):\n"
        "    apex_tpu_torch.DogLeg(apex_tpu_torch.DogLegConfig()).optimize(\n"
        "        g.compile(device='cpu'))\n"
        "    apex_tpu_torch.LevenbergMarquardt(apex_tpu_torch.LevenbergMarquardtConfig(\n"
        "        linear_solver_type=solver, compute_covariances=True)).optimize(\n"
        "        g.compile(device='cpu'))\n"
        "apex_tpu_torch.io.synthetic.synthetic_pose_graph_3d(40, 4).to_problem()\n"
        "apex_tpu_torch.LevenbergMarquardt(apex_tpu_torch.LevenbergMarquardtConfig(\n"
        "    linear_solver_type='sparse_general')).optimize(apex_tpu_torch.io.synthetic\n"
        "    .synthetic_pose_graph_grid3d(3, 3, 2).to_problem().compile(device='cpu'))\n"
        "apex_tpu_torch.io.synthetic.synthetic_pose_graph_2d(40).to_problem()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'apex_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
