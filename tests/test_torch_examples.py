"""The port's eight single-device examples (``apex_tpu_torch.examples``)
against their JAX twins in ``examples/``, f64 on the CPU.

Each port example runs with ``--platform cpu``. Two checks per example:

- its printed text equals the JAX script's token for token, apart from the
  time columns of the two comparison tables and the summaries' ``in ...
  ms``. Numbers printed at full precision (``repr`` of a float: the
  displacement statistics of ``visualize_optimization``) are held at rtol
  1e-8 instead, since both packages' solves agree to about 1e-14, not to
  the last bit;
- the rows it returns, at full precision, equal the same solves through
  ``apex_tpu``'s API: iterations and status equal, values at rtol 1e-8.
  The JAX side is the twin script itself, run once per module
  (``jax_runs``) with ``LevenbergMarquardt.optimize`` wrapped to keep
  every ``SolverResult`` it returns.

The JAX scripts run in a temporary working directory, and the two graph
file examples read a file generated into it, so that nothing lands in the
repository or in the shared ``/tmp`` names of the scripts' defaults.

"ATE vs clean" of ``loss_function_comparison`` is held at rtol 1e-8 like
every other value: both solves leave the gauge free (no ``fix_first``), so
it follows LM's path, and the two packages' paths agree that closely."""

import ast
import contextlib
import importlib
import io
import json
import math
import os
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

import apex_tpu.optim.lm as jax_lm
from apex_tpu.io import load_g2o as jax_load_g2o
from apex_tpu_torch.ba import rmse
from apex_tpu_torch.io import save_g2o, synthetic
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = ["compare_solvers", "compare_optimizers", "covariance_estimation", "custom_factor",
            "load_graph_file", "loss_function_comparison", "visualize_graph_file",
            "visualize_optimization"]
GRAPHS = {"load_graph_file": lambda: synthetic.synthetic_pose_graph_2d(n_poses=100, seed=7),
          "visualize_graph_file": lambda: synthetic.synthetic_pose_graph_3d(n_poses=150, rings=6)}
TIMED = ("compare_solvers", "compare_optimizers")  # tables with a seconds column
RTOL = 1e-8


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory for the scripts, with the two graph files."""
    d = tmp_path_factory.mktemp("examples")
    for name, make in GRAPHS.items():
        save_g2o(str(d / f"{name}.g2o"), make())
    return d


def _argv(name, workdir):
    return [str(workdir / f"{name}.g2o")] if name in GRAPHS else []


@pytest.fixture(scope="module")
def jax_runs(workdir):
    """Each JAX twin run once: (stdout, the ``SolverResult`` of every solve,
    in order)."""
    cache = {}

    def run(name):
        if name not in cache:
            results, depth = [], [0]
            optimize = jax_lm.LevenbergMarquardt.optimize

            def recording(self, *a, **kw):
                depth[0] += 1
                try:
                    res = optimize(self, *a, **kw)
                finally:
                    depth[0] -= 1
                if depth[0] == 0:
                    results.append(res)
                return res

            out = io.StringIO()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_lm.LevenbergMarquardt, "optimize", recording)
                mp.chdir(workdir)
                mp.setattr(sys, "argv", [name] + _argv(name, workdir))
                mp.setattr(sys, "path", list(sys.path))
                with contextlib.redirect_stdout(out):
                    runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name="__main__")
            cache[name] = out.getvalue(), results
        return cache[name]

    return run


@pytest.fixture(scope="module")
def port_runs(workdir):
    """Each port example run once with ``--platform cpu``: (stdout, rows)."""
    cache = {}

    def run(name):
        if name not in cache:
            module = importlib.import_module(f"apex_tpu_torch.examples.{name}")
            out = io.StringIO()
            with pytest.MonkeyPatch.context() as mp:
                mp.chdir(workdir)
                with contextlib.redirect_stdout(out):
                    rows = module.main(_argv(name, workdir) + ["--platform", "cpu"])
            cache[name] = out.getvalue(), rows
        return cache[name]

    return run


def _normalized(name, text):
    text = re.sub(r" in \d+\.\d ms", " in <ms>", text)
    if name in TIMED:
        text = re.sub(r" +\d+\.\d\ds$", " <s>", text, flags=re.M)
    return [line.split() for line in text.splitlines()]


def _full_precision(token):
    digits = re.sub(r"[^0-9]", "", token.split("e")[0])
    try:
        return float(token) if len(digits.lstrip("0")) >= 12 else None
    except ValueError:
        return None


@pytest.mark.parametrize("name", EXAMPLES)
def test_printed_text_equals_jax(name, jax_runs, port_runs):
    want, got = _normalized(name, jax_runs(name)[0]), _normalized(name, port_runs(name)[0])
    assert len(got) == len(want), (got, want)
    for line_got, line_want in zip(got, want):
        assert len(line_got) == len(line_want), (line_got, line_want)
        for a, b in zip(line_got, line_want):
            if a == b:
                continue
            x, y = _full_precision(a.strip("{}[],:'")), _full_precision(b.strip("{}[],:'"))
            assert x is not None and y is not None, (a, b, line_got)
            assert math.isclose(x, y, rel_tol=RTOL), (a, b)


def _assert_result(row, res):
    assert row["status"] == res.status.name
    assert row["iterations"] == res.iterations
    np.testing.assert_allclose([row["initial_cost"], row["final_cost"]],
                               [res.initial_cost, res.final_cost], rtol=RTOL)


@pytest.mark.parametrize("name", EXAMPLES)
def test_rows_equal_jax(name, jax_runs, port_runs, workdir):
    out, results = jax_runs(name)
    rows = port_runs(name)[1]
    if name == "compare_solvers":
        assert [r["solver"] for r in rows] == ["dense_cholesky", "dense_qr", "schur_explicit",
                                               "schur_implicit"]
        n_obs = 3599
        for row, res in zip(rows, results, strict=True):
            _assert_result(row, res)
            np.testing.assert_allclose(row["rmse"], rmse(res.final_cost, n_obs), rtol=RTOL)
    elif name == "compare_optimizers":
        assert [r["optimizer"] for r in rows] == ["LM", "GN", "DogLeg"]
        for row, res in zip(rows, results, strict=True):
            _assert_result(row, res)
    elif name == "covariance_estimation":
        (res,) = results
        _assert_result(rows[0], res)
        for row in rows[1:]:
            sigma = np.sqrt(np.diag(res.covariances[row["pose"]]))
            np.testing.assert_allclose([row["sigma_x"], row["sigma_y"], row["sigma_theta"]],
                                       sigma, rtol=RTOL, atol=1e-300)
        assert [r["pose"] for r in rows[1:]] == [f"x{i}" for i in range(0, 40, 5)]
    elif name == "custom_factor":
        (res,) = results
        _assert_result(rows[0], res)
        np.testing.assert_allclose(rows[0]["landmark"], res.variables["lm"], rtol=RTOL)
    elif name == "load_graph_file":
        (res,) = results
        (row,) = rows
        _assert_result(row, res)
        g = jax_load_g2o(_argv(name, workdir)[0])
        assert (row["vertices"], row["edges"], row["kind"]) == (100, 100, "SE2")
        np.testing.assert_allclose([row["chi2_before"], row["chi2_after"]],
                                   [g.chi2(), g.chi2(res.variables)], rtol=RTOL)
    elif name == "loss_function_comparison":
        clean, *solves = results
        assert [r["loss"] for r in rows] == ["none", "huber", "cauchy", "geman_mcclure",
                                             "tukey", "welsch"]
        for row, res in zip(rows, solves, strict=True):
            _assert_result(row, res)
            ate = np.mean([np.linalg.norm(res.variables[k][:2] - clean.variables[k][:2])
                           for k in res.variables])
            np.testing.assert_allclose(row["ate"], ate, rtol=RTOL)
    elif name == "visualize_graph_file":
        assert results == []
        g = jax_load_g2o(_argv(name, workdir)[0])
        pts = np.stack([g.vertices_se3[k][:3] for k in sorted(g.vertices_se3)])
        (row,) = rows
        assert (row["vertices"], row["edges"], row["rerun"]) == (150, 274, False)
        np.testing.assert_array_equal(row["min"], pts.min(axis=0))
        np.testing.assert_array_equal(row["max"], pts.max(axis=0))
    elif name == "visualize_optimization":
        (res,) = results
        (row,) = rows
        _assert_result(row, res)
        stats = ast.literal_eval(out.split("camera displacement stats: ")[1].splitlines()[0])
        kinds = ast.literal_eval(out.split("logged records by kind: ")[1].splitlines()[0])
        assert row["records_by_kind"] == kinds
        assert row["displacements"]["cameras"]["count"] == stats["count"] == 150
        for key in ("avg", "min", "max"):
            np.testing.assert_allclose(row["displacements"]["cameras"][key], stats[key],
                                       rtol=RTOL)
    else:
        raise AssertionError(name)


def test_multichip_ba_matches_jax(tmp_path):
    """``multichip_ba`` on 2 gloo ranks on the CPU, as a user runs it: exit
    0, its text equal to the JAX script's on conftest's 8 virtual devices
    apart from the first line (ranks against devices, by design), and the
    cost of every LM iteration at rtol 1e-8 (the JAX side's recorded by
    wrapping the step its ``make_sharded_schur_step`` returns)."""
    import subprocess

    import apex_tpu.parallel as jax_par

    code = ("import json, sys\n"
            "from apex_tpu_torch.examples import multichip_ba\n"
            "rows = multichip_ba.main(['2', '--platform', 'cpu'])\n"
            "print('ROWS ' + json.dumps(rows), file=sys.stderr)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    rows = json.loads([s for s in proc.stderr.splitlines() if s.startswith("ROWS ")][-1][5:])

    costs, make = [], jax_par.make_sharded_schur_step

    def recording(*a, **kw):
        step, shard_args = make(*a, **kw)

        def recorded(*s):
            out = step(*s)
            costs.append(float(out[3]))
            return out

        recorded.solve = step.solve
        return recorded, shard_args

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_par, "make_sharded_schur_step", recording)
        mp.chdir(tmp_path)
        mp.setattr(sys, "argv", ["multichip_ba.py", "8"])
        mp.setattr(sys, "path", list(sys.path))
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(REPO / "examples" / "multichip_ba.py"), run_name="__main__")
    want, got = out.getvalue().splitlines(), proc.stdout.splitlines()
    assert got[0].startswith("ranks: 2 (gloo on cpu) | partitioned path: True | 1600 ")
    assert want[0].startswith("mesh: 8 devices | plane path: True | 1600 ")
    assert got[1:] == want[1:]
    assert len(costs) == len(rows) - 1 == 8
    np.testing.assert_allclose([r["cost"] for r in rows[1:]], costs, rtol=RTOL)
