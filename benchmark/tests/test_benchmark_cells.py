"""The harness on the CPU: every file found by name, the contract's shape of
BENCHMARK.json, a small rehearsal of each cell, the control and the faults
that ``correct`` must catch, and the modules a run may not load."""

import dataclasses
import json
import math
import re
import subprocess
import sys

import numpy as np
import pytest
import small
from harness import cell, compare, program

ROOT = small.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = small.workloads()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_load_by_name(workload):
    spec = cell.load(ROOT, workload)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert set(compare.ORDER) <= set(spec["limits"])
    assert callable(spec["loop"].window) and callable(spec["loop"].compared)
    assert {m["name"] for m in spec["per_layer"]} == set(spec["readers"])
    assert all(callable(r) for r in spec["readers"].values())
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]


def test_benchmark_json_keeps_the_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1].startswith("benchmark/")
    assert 1 <= SPEC["run_seconds"] <= 51
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and c["name"] in used and not c["reduced"]
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert set(m["workloads"]) <= set(WORKLOADS)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()


def _well_formed(line, spec, trace):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["setup_split_s"]) == {"start_s", "data_s", "build_s", "compile_s", "warmup_s"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    for name, (value, limit) in line["checks"].items():
        assert value is not None and limit is not None, name
    dev = line["device"]
    assert dev["count"] == 1 and isinstance(dev["memory_peak_bytes"], int)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and dev["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in spec["per_layer"]}
        assert "lm_iters" in line["metrics"]
    else:
        assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
        assert all(v["value"] > 0 for k, v in line["metrics"].items() if k != "peak_mem_gib")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_rehearsal_prints_a_correct_well_formed_line(workload, trace):
    spec = small.spec(workload)
    rc, line = small.run(spec, seed=2**31 + 9, trace=trace)
    assert rc == 0 and line["correct"], line
    _well_formed(line, spec, trace)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_one_precision_lower_is_not_correct(workload):
    rc, line = small.run(small.spec(workload), seed=11, control=True)
    assert rc == 0 and line["correct"] is False
    assert [k for k, (v, lim) in line["checks"].items() if v is None or v > lim], line["checks"]


def _unchanged(result, cp):
    """A solve whose steps leave its state as it was."""
    return dataclasses.replace(result, final_cost=result.initial_cost,
                               variables=cp.values_dict(cp.initial_values()))


def _altered(result, cp):
    """One returned variable altered where the answer is produced."""
    variables = dict(result.variables)
    name = sorted(variables)[len(variables) // 2]
    variables[name] = np.asarray(variables[name]) + 1e-3
    return dataclasses.replace(result, variables=variables)


def _half(source):
    """Half of the residuals left out: every other observation or edge."""
    if hasattr(source, "observations"):
        keep = slice(0, None, 2)
        return dataclasses.replace(source, cam_indices=source.cam_indices[keep],
                                   point_indices=source.point_indices[keep],
                                   observations=source.observations[keep])
    half = dataclasses.replace(source)
    half.edges_se3 = source.edges_se3[::2]
    return half


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    solver, build = program.solver, program.build
    if fault == "half":
        monkeypatch.setattr(program, "build", lambda kind, source, opts: build(
            kind, _half(source), opts))
    else:
        wrong = _unchanged if fault == "unchanged" else _altered

        def broken_solver(opts):
            lm = solver(opts)
            optimize = lm.optimize
            lm.optimize = lambda cp: wrong(optimize(cp), cp)
            return lm

        monkeypatch.setattr(program, "solver", broken_solver)
    rc, line = small.run(small.spec(workload), seed=5)
    assert rc == 0 and line["correct"] is False, line["checks"]


def test_a_run_loads_no_jax_and_no_benchmark_of_the_program(tmp_path):
    code = (
        "import sys, small\n"
        "rc, line = small.run(small.spec('pg_sphere2500.solve'), trace=1)\n"
        "assert line['correct'], line\n"
        "print(sorted(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(ROOT / "benchmark" / "tests"), timeout=600,
                          env={"PYTHONPATH": f"{ROOT}:{ROOT / 'benchmark'}",
                               "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    modules = eval(proc.stdout.strip().splitlines()[-1])
    top = {m.split(".")[0] for m in modules}
    assert not top & cell.FORBIDDEN
    assert "apex_tpu_torch" in top  # the program ran
    assert not [m for m in modules if m.startswith("apex_tpu_torch.benches") or m == "bench"
                or m.split(".")[0] == "benches"]


def _yardstick_modules(references, path=()):
    """The top-level modules that the harness's yardstick and every
    reference file in ``references`` load, in a process of their own with
    ``path`` first on ``sys.path``."""
    code = ("import importlib.util, pathlib, sys\n"
            f"sys.path[:0] = {[str(p) for p in path]!r}\n"
            "from harness import compare, generators, lie, reference, roofline\n"
            f"for p in sorted(pathlib.Path({str(references)!r}).glob('*.py')):\n"
            "    s = importlib.util.spec_from_file_location(f'reference_{p.stem}', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(ROOT / "benchmark"), timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(eval(proc.stdout.strip().splitlines()[-1]))


def test_the_yardstick_imports_nothing_of_the_program(tmp_path):
    """Nor does any reference file under ``benchmark/references``; a file
    that imports the program is seen."""
    top = _yardstick_modules(ROOT / "benchmark" / "references")
    assert not top & (cell.FORBIDDEN | {"apex_tpu_torch"})
    (tmp_path / "stub").mkdir()
    (tmp_path / "stub" / "apex_tpu_torch.py").write_text("")
    (tmp_path / "refs").mkdir()
    (tmp_path / "refs" / "leaky.py").write_text("import apex_tpu_torch  # noqa: F401\n")
    assert "apex_tpu_torch" in _yardstick_modules(tmp_path / "refs", [tmp_path / "stub"])


def test_no_benchmark_file_names_the_programs_benchmarks():
    pattern = re.compile(r"apex_tpu_torch\.benches|import bench\b|from benches|bench\.py")
    files = [p for p in (ROOT / "benchmark").rglob("*.py") if "tests" not in p.parts]
    assert files and not [p for p in files if pattern.search(p.read_text())]


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_device):
    rc, line = small.run(small.spec("pg_sphere2500.solve"), seed=3, trace=1, device=cuda_device)
    assert rc == 0 and line["correct"], line
    assert line["device"]["busy_s"] > 0 and math.isfinite(line["metrics"]["lm_iters"]["value"])


def test_a_run_without_a_card_fails_and_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    spec = small.spec("pg_sphere2500.solve")
    assert cell.run(spec, 1, 0.5, 0, 0.0) != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_without_the_program_fails_and_prints_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pg_sphere2500.solve",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""
