"""The port's dataset registry (``apex_tpu_torch.io.datasets``) against the
JAX package's, the cache under ``APEX_TPU_DATA_DIR``, and the CLIs'
``--dataset`` served from the cache, on the CPU.

No test reaches the network: an autouse fixture points the cache at a
temporary directory and replaces ``urllib.request.urlopen`` with a stub
that raises, so a file that is not cached fails at once with the
registry's ``ConnectionError``."""

import bz2
import shutil
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import apex_tpu.io.datasets as jax_datasets
from apex_tpu_torch.io import datasets, save_bal, synthetic
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
# tests/test_medium_fixture.py: the certified f64 optimum of the SE2 fixture
MEDIUM_SE2 = ("medium_se2_300.g2o", 5.668402411723587e-02)


@pytest.fixture(autouse=True)
def offline(tmp_path, monkeypatch):
    """The cache in a temporary directory, and every download refused."""
    urls = []

    def refuse(url, *args, **kwargs):
        urls.append(url)
        raise OSError("network disabled in tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("APEX_TPU_DATA_DIR", str(tmp_path / "cache"))
    return urls


def test_registry_matches_apex_tpu():
    assert datasets.POSE_GRAPH_DATASETS == jax_datasets.POSE_GRAPH_DATASETS
    assert datasets.BAL_PROBLEMS == jax_datasets.BAL_PROBLEMS
    assert datasets.BAL_URL_PREFIX == jax_datasets.BAL_URL_PREFIX
    assert len(datasets.POSE_GRAPH_DATASETS) == 11 and len(datasets.BAL_PROBLEMS) == 7


def test_cache_dir(tmp_path, monkeypatch):
    assert datasets.cache_dir() == tmp_path / "cache" == jax_datasets.cache_dir()
    assert datasets.cache_dir().is_dir()
    monkeypatch.delenv("APEX_TPU_DATA_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert datasets.cache_dir() == tmp_path / "home" / ".cache" / "apex_tpu"


def test_cached_pose_graph_is_served(offline):
    dest = datasets.cache_dir() / "intel.g2o"
    shutil.copy(FIXTURES / MEDIUM_SE2[0], dest)
    assert datasets.ensure_pose_graph_dataset("intel") == dest
    assert jax_datasets.ensure_pose_graph_dataset("intel") == dest
    assert offline == []


def test_bal_bz2_is_decompressed(offline):
    text = b"2 1 1\n0 0 1.0 2.0\n"
    fname = datasets.BAL_PROBLEMS["trafalgar-21"][1]
    with bz2.open(datasets.cache_dir() / fname, "wb") as f:
        f.write(text)
    path = datasets.ensure_ba_dataset("trafalgar-21")
    assert path.name == "problem-21-11315-pre.txt" and path.read_bytes() == text
    assert datasets.ensure_ba_dataset("trafalgar-21") == path  # the text file, cached
    assert offline == []


@pytest.mark.parametrize("ensure,name", [("ensure_pose_graph_dataset", "sphere2500"),
                                         ("ensure_ba_dataset", "venice-1778")])
def test_miss_raises_connection_error(offline, ensure, name):
    """A file that is not cached is downloaded, and the refusal surfaces as
    the registry's ``ConnectionError`` with no partial file left."""
    with pytest.raises(ConnectionError, match="failed to download https://.*network egress"):
        getattr(datasets, ensure)(name)
    assert len(offline) == 1 and offline[0].startswith("https://")
    assert list(datasets.cache_dir().iterdir()) == []
    with pytest.raises(ConnectionError, match="failed to download"):
        getattr(jax_datasets, ensure)(name)


def test_unknown_name_raises_key_error():
    with pytest.raises(KeyError, match="unknown dataset 'nope'"):
        datasets.ensure_pose_graph_dataset("nope")
    with pytest.raises(KeyError, match="unknown BAL problem 'nope'"):
        datasets.ensure_ba_dataset("nope")


def test_pose_graph_cli_dataset(capsys):
    """``--dataset intel`` served from a cached copy of the certified SE2
    fixture: the CLI reaches its certified cost (as printed, 5 digits)."""
    from apex_tpu_torch.cli.pose_graph import main

    shutil.copy(FIXTURES / MEDIUM_SE2[0], datasets.cache_dir() / "intel.g2o")
    assert main(["--dataset", "intel", "--platform", "cpu", "--cost-tolerance", "1e-10"]) == 0
    out = capsys.readouterr()
    assert "loaded intel: 300 vertices" in out.err and "(SE2)" in out.err
    row = out.out.strip().splitlines()[-1].split()
    assert row[0] == "lm" and row[1].endswith("_REACHED")
    np.testing.assert_allclose(float(row[4]), MEDIUM_SE2[1], rtol=1e-4)


def test_ba_cli_dataset(tmp_path, capsys):
    """``--dataset ladybug-49`` served from a small synthetic problem
    written under the registry's file name: the same report as ``--file``
    on that file, and the cost falls."""
    from apex_tpu_torch.cli.bundle_adjustment import main

    path = datasets.cache_dir() / "problem-49-7776-pre.txt"
    save_bal(path, synthetic.synthetic_ba(n_cameras=5, n_points=60, seed=2))
    reports = []
    for source in (["--dataset", "ladybug-49"], ["--file", str(path)]):
        assert main(source + ["--solver", "explicit", "--platform", "cpu"]) == 0
        out = capsys.readouterr()
        assert "BA problem: 5 cameras, 60 points" in out.err
        reports.append([line for line in out.out.splitlines() if "Time:" not in line])
    assert reports[0] == reports[1]
    costs = {line.split(":")[0].strip(): float(line.split(":")[1])
             for line in reports[0] if "cost:" in line}
    assert costs["Final cost"] < 0.1 * costs["Initial cost"]


def test_download_cli(offline, capsys):
    from apex_tpu_torch.cli.download_datasets import main

    shutil.copy(FIXTURES / MEDIUM_SE2[0], datasets.cache_dir() / "intel.g2o")
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    assert f"cache dir: {datasets.cache_dir()}" in out
    lines = {line.split()[0]: line for line in out.splitlines()[1:] if line.startswith("  ")}
    assert lines.keys() == datasets.POSE_GRAPH_DATASETS.keys() | datasets.BAL_PROBLEMS.keys()
    assert "[cached]" in lines["intel"] and "[-]" in lines["sphere2500"]
    assert main(["intel"]) == 0 and capsys.readouterr().out.startswith("intel: ")
    assert main(["sphere2500", "--ba", "nope"]) == 1
    err = capsys.readouterr().err
    assert "sphere2500: FAILED (failed to download" in err and "nope: FAILED" in err
    assert len(offline) == 1
