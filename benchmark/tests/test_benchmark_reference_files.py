"""A configuration's plain reference found by name: ``"reference": "<name>"``
in a configuration file makes ``benchmark/references/<name>.py`` judge it
(``cell.reference_for``); without the key each cell keeps the built-in
reference, its allowed solver values and its compared numbers."""

import json
import re
import shutil
import sys

import pytest
import small
import torch
from harness import cell, compare, reference

WORKLOAD = "ba_venice1778.fixed5"
SEED = 2**31 + 9
# a file that judges as the built-in BA reference does, and records the
# dtype of every problem it builds
RECORDING = """
from harness import reference

KIND = "bundle_adjustment"
MODELS = {"linear_solver_type": {"schur_implicit"}, "schur_preconditioner": {"schur_jacobi"}}
BUILT = []


class PROBLEM(reference.BundleAdjustment):
    def __init__(self, data, dtype, device):
        BUILT.append(dtype)
        super().__init__(data, dtype, device)
"""
# the linear solvers the built-in references modelled before references
# could be files
LINEAR_SOLVERS = {"bundle_adjustment": {"schur_implicit"}, "pose_graph": {"sparse_cholesky"}}
# each cell's small rehearsal at SEED, its numbers compared before references
# could be files (benchmark/tests/small.py sizes, one CPU thread)
BEFORE = {
    "pg_sphere2500.solve": {
        "status_mismatches": 0.0, "iteration_gap": 0.0,
        "initial_cost_rel": 1.2472633994114317e-15, "final_cost_rel": 3.436864363552469e-13,
        "x_gap": 1.1423331298543645e-09, "cost_at_x_rel": 8.9964114221305e-14},
    "ba_venice1778.fixed5": {
        "status_mismatches": 0.0, "iteration_gap": 0.0, "initial_cost_rel": 0.0,
        "final_cost_rel": 5.5999629980940104e-11, "x_gap": 6.995298917900072e-08,
        "cost_at_x_rel": 2.080321881698499e-15},
    "pg_grid3d8000.solve_optimum": {
        "status_mismatches": 0.0, "iteration_gap": 0.0,
        "initial_cost_rel": 4.5113116766934004e-15, "final_cost_rel": 1.6633431830037536e-13,
        "x_gap": 3.0842697777796383e-10, "cost_at_x_rel": 1.3805155074157193e-13},
}


def _tree(tmp_path, source, name="recording", workload=WORKLOAD):
    """A copy of the benchmark under ``tmp_path`` whose cell's configuration
    names the reference ``name``, with ``source`` as its file (none where
    ``source`` is None)."""
    shutil.copy(small.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(small.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = next(w["config"] for w in spec["workloads"] if w["name"] == workload)
    path = tmp_path / next(c["file"] for c in spec["configs"] if c["name"] == config)
    path.write_text(json.dumps(dict(json.loads(path.read_text()), reference=name)))
    if source is not None:
        (tmp_path / "benchmark" / "references").mkdir()
        (tmp_path / "benchmark" / "references" / f"{name}.py").write_text(source)
    return tmp_path


def _small(root, workload=WORKLOAD):
    spec = cell.load(root, workload)
    gen = spec["config"]["generator"]
    gen["params"] = small.small_params(gen["name"])
    return spec


@pytest.mark.parametrize("control", [False, True])
def test_a_reference_file_judges_as_the_builtin_reference_bit_for_bit(tmp_path, control):
    spec = _small(_tree(tmp_path, RECORDING))
    module_problem = spec["reference"].problem
    assert issubclass(module_problem, reference.BundleAdjustment)
    assert module_problem is not reference.BundleAdjustment
    rc, line = small.run(spec, seed=SEED, control=control)
    rc0, line0 = small.run(small.spec(WORKLOAD), seed=SEED, control=control)
    assert rc == rc0 == 0
    assert line["correct"] is line0["correct"] is (not control), line["checks"]
    assert line["checks"] == line0["checks"]
    built = module_problem.__init__.__globals__["BUILT"]
    assert built == ([torch.float32] if control else []) + [torch.float64]


def test_a_reference_that_has_no_file_stops_the_run_naming_the_path(tmp_path):
    root = _tree(tmp_path, None, name="absent")
    path = root / "benchmark" / "references" / "absent.py"
    with pytest.raises(SystemExit, match=re.escape(str(path))):
        cell.load(root, WORKLOAD)


@pytest.mark.parametrize("field, value", [("linear_solver_type", "schur_implicit"),
                                          ("optimizer", "dogleg")])
def test_a_solver_value_outside_the_files_models_raises(tmp_path, field, value):
    """The file's ``MODELS`` replace the built-in values of the fields they
    name, and leave the built-in values of the others."""
    source = RECORDING.replace('{"schur_implicit"}', '{"sparse_schur"}')
    spec = _small(_tree(tmp_path, source))
    opts = dict(cell.solver_options(spec, None), linear_solver_type="sparse_schur")
    assert isinstance(cell.reference_settings(spec["reference"], opts), reference.Settings)
    with pytest.raises(ValueError, match=f"does not model {field}={value!r}"):
        cell.reference_settings(spec["reference"], dict(opts, **{field: value}))


def test_a_reference_file_of_another_problem_is_refused(tmp_path):
    root = _tree(tmp_path, RECORDING.replace('KIND = "bundle_adjustment"', 'KIND = "pose_graph"'))
    with pytest.raises(SystemExit, match="serves 'pose_graph'"):
        cell.load(root, WORKLOAD)


def test_a_reference_files_settings_carry_a_field_of_its_own(tmp_path):
    source = RECORDING + """
import dataclasses


@dataclasses.dataclass
class Settings(reference.Settings):
    block_columns: int = 0
"""
    spec = _small(_tree(tmp_path, source))
    opts = dict(cell.solver_options(spec, None), block_columns=64)
    settings = cell.reference_settings(spec["reference"], opts)
    assert isinstance(settings, spec["reference"].settings) and settings.block_columns == 64
    assert settings.pcg_max_iterations == 15
    not_settings = source.replace("class Settings(reference.Settings)", "class Settings")
    (tmp_path / "other").mkdir()
    with pytest.raises(SystemExit, match="do not extend"):
        cell.load(_tree(tmp_path / "other", not_settings), WORKLOAD)


@pytest.mark.parametrize("workload", small.workloads())
def test_a_cell_without_the_key_keeps_the_builtin_reference_and_its_numbers(workload):
    spec = small.spec(workload)
    kind = spec["config"]["problem"]
    ref = spec["reference"]
    assert (ref.problem, ref.settings) == (reference.PROBLEMS[kind], reference.Settings)
    assert ref.models == {"optimizer": {"levenberg_marquardt"}, "mode": None, "dtype": None,
                          "linear_solver_type": LINEAR_SOLVERS[kind],
                          "schur_preconditioner": {"schur_jacobi"}}
    rc, line = small.run(spec, seed=SEED)
    assert rc == 0 and line["correct"], line
    assert {k: line["checks"][k][0] for k in compare.ORDER} == BEFORE[workload]


@pytest.mark.parametrize("control", [False, True])
def test_a_reference_that_loads_the_jax_package_gives_no_result(tmp_path, monkeypatch, control):
    """A forbidden module that the reference loads in its solves, after the
    window, is caught before the result line, in the window's run and in the
    control's."""
    (tmp_path / "stub").mkdir()
    (tmp_path / "stub" / "apex_tpu.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    source = RECORDING + """

    def step(self, *args):
        import apex_tpu  # noqa: F401

        return super().step(*args)
"""
    (tmp_path / "tree").mkdir()
    spec = _small(_tree(tmp_path / "tree", source))
    assert "apex_tpu" not in sys.modules
    try:
        rc, line = small.run(spec, seed=SEED, control=control)
        assert "apex_tpu" in sys.modules
    finally:
        sys.modules.pop("apex_tpu", None)
    assert (rc, line) == (3, None)
