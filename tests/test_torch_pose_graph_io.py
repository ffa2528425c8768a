"""Pose-graph I/O of the PyTorch port against apex_tpu: the G2O and TORO
readers and writers, chi^2, the graph-to-problem build and the synthetic
sphere, ring and manhattan graphs."""

from pathlib import Path

import numpy as np
import pytest

from apex_tpu.io import load_g2o as jax_load_g2o
from apex_tpu.io import load_toro as jax_load_toro
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.io import Graph, load_g2o, load_toro, save_g2o, save_toro, synthetic
from apex_tpu_torch.io.graph import full_to_upper_tri, upper_tri_to_full
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _assert_graphs_equal(t, j, rtol=0.0, atol=0.0):
    assert sorted(t.vertices_se3) == sorted(j.vertices_se3)
    assert sorted(t.vertices_se2) == sorted(j.vertices_se2)
    for vid in j.vertices_se3:
        np.testing.assert_allclose(t.vertices_se3[vid], j.vertices_se3[vid],
                                   rtol=rtol, atol=atol)
    for vid in j.vertices_se2:
        np.testing.assert_allclose(t.vertices_se2[vid], j.vertices_se2[vid],
                                   rtol=rtol, atol=atol)
    for te, je in zip(t.edges_se3 + t.edges_se2, j.edges_se3 + j.edges_se2, strict=True):
        assert (te.frm, te.to) == (je.frm, je.to)
        np.testing.assert_allclose(te.measurement, je.measurement, rtol=rtol, atol=atol)
        np.testing.assert_array_equal(te.information, je.information)


@pytest.mark.parametrize("fname", ["sphere_excerpt.g2o", "medium_se3_250.g2o",
                                   "medium_se2_300.g2o"])
def test_load_g2o_matches_apex_tpu(fname):
    t, j = load_g2o(FIXTURES / fname), jax_load_g2o(FIXTURES / fname)
    assert (t.num_vertices, t.num_edges, t.is_se3) == (j.num_vertices, j.num_edges, j.is_se3)
    _assert_graphs_equal(t, j, atol=1e-15)


def test_save_g2o_roundtrip(tmp_path):
    g = load_g2o(FIXTURES / "medium_se3_250.g2o")
    out = tmp_path / "roundtrip.g2o"
    save_g2o(out, g)
    _assert_graphs_equal(load_g2o(out), g, atol=1e-15)


def test_malformed_lines_raise(tmp_path):
    bad = tmp_path / "bad.g2o"
    bad.write_text("VERTEX_SE3:QUAT 0 1 2 3 0 0 0\n")
    with pytest.raises(ValueError, match="malformed"):
        load_g2o(bad)
    bad.write_text("VERTEX_SE3:QUAT 0 1 2 3 0 0 0 0\n")
    with pytest.raises(ValueError, match="quaternion"):
        load_g2o(bad)


def test_upper_triangle_roundtrip():
    vals = np.arange(1.0, 22.0)
    M = upper_tri_to_full(vals, 6)
    np.testing.assert_array_equal(M, M.T)
    np.testing.assert_array_equal(full_to_upper_tri(M), vals)
    assert M[0, 5] == 6.0 and M[1, 1] == 7.0


@pytest.mark.parametrize("fname", ["sphere_excerpt.g2o", "medium_se3_250.g2o"])
def test_chi2_matches_apex_tpu(fname):
    t, j = load_g2o(FIXTURES / fname), jax_load_g2o(FIXTURES / fname)
    np.testing.assert_allclose(t.chi2(), j.chi2(), rtol=1e-12)
    # at other values: every vertex moved a little
    rng = np.random.default_rng(0)
    values = {f"x{vid}": v + np.concatenate([0.01 * rng.normal(size=3), np.zeros(4)])
              for vid, v in t.vertices_se3.items()}
    np.testing.assert_allclose(t.chi2(values), j.chi2(values), rtol=1e-12)
    assert Graph().chi2() == 0.0


def test_synthetic_sphere2500_matches_apex_tpu():
    """The full sphere2500 graph: 2,500 noisy odometry steps integrated one
    after the other, so rounding compounds along the chain. Measurements
    agree to 1e-15; vertices to rtol 1e-10 of the largest coordinate (the
    measured gap is 8.1e-13 of it; single coordinates near zero differ by
    up to 2e-9 of their own size)."""
    kw = dict(n_poses=2500, rings=50, seed=0)
    t, j = synthetic.synthetic_pose_graph_3d(**kw), jax_synthetic.synthetic_pose_graph_3d(**kw)
    assert (t.num_vertices, t.num_edges) == (j.num_vertices, j.num_edges) == (2500, 4949)
    vt = np.stack([t.vertices_se3[i] for i in range(2500)])
    vj = np.stack([j.vertices_se3[i] for i in range(2500)])
    np.testing.assert_allclose(vt, vj, rtol=1e-10, atol=1e-10 * np.abs(vj).max())
    for te, je in zip(t.edges_se3, j.edges_se3, strict=True):
        assert (te.frm, te.to) == (je.frm, je.to)
        np.testing.assert_allclose(te.measurement, je.measurement, rtol=1e-12, atol=1e-15)
        np.testing.assert_array_equal(te.information, je.information)


def test_to_problem_matches_apex_tpu():
    """Same variables, residual blocks, fixed first pose, and compiled
    column layout and group order as the JAX package's."""
    t, j = load_g2o(FIXTURES / "medium_se3_250.g2o"), jax_load_g2o(FIXTURES / "medium_se3_250.g2o")
    pt, pj = t.to_problem(fix_first=True), j.to_problem(fix_first=True)
    assert pt.variable_names == pj.variable_names
    assert pt.num_residual_blocks == pj.num_residual_blocks == 474
    ct, cj = pt.compile(device="cpu"), pj.compile(dtype=np.float64)
    assert ct.total_dof == cj.total_dof and ct.total_residual_dim == cj.total_residual_dim
    assert [g.count for g in ct.groups] == [g.count for g in cj.groups]
    for gt, gj in zip(ct.groups, cj.groups, strict=True):
        for a, b in zip(gt.cols, gj.cols, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(gt.data["meas"].numpy(), np.asarray(gj.data["meas"]))
    np.testing.assert_array_equal(ct.pools[0].free_mask.numpy(), np.asarray(cj.pools[0].free_mask))


@pytest.mark.parametrize("kw", [
    dict(n_poses=100, trajectory="ring", seed=1),
    dict(n_poses=150, trajectory="manhattan", loop_stride=10, seed=3),
    dict(n_poses=300, trajectory="manhattan", loop_stride=2, seed=0),
], ids=["ring", "manhattan_loops", "manhattan_m3500_stride"])
def test_synthetic_se2_matches_apex_tpu(kw):
    """The same draws in the same order (manhattan: the turns, then the
    noise): measurements and the integrated vertices within 1e-10 of the
    largest coordinate."""
    t, j = synthetic.synthetic_pose_graph_2d(**kw), jax_synthetic.synthetic_pose_graph_2d(**kw)
    assert (t.num_vertices, t.num_edges, t.is_se3) == (j.num_vertices, j.num_edges, False)
    n = kw["n_poses"]
    vt = np.stack([t.vertices_se2[i] for i in range(n)])
    vj = np.stack([j.vertices_se2[i] for i in range(n)])
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-10 * np.abs(vj).max())
    mt = np.stack([e.measurement for e in t.edges_se2])
    mj = np.stack([e.measurement for e in j.edges_se2])
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-10 * np.abs(mj).max())
    assert [(e.frm, e.to) for e in t.edges_se2] == [(e.frm, e.to) for e in j.edges_se2]
    for te, je in zip(t.edges_se2, j.edges_se2):
        np.testing.assert_array_equal(te.information, je.information)
    np.testing.assert_allclose(t.chi2(), j.chi2(), rtol=1e-10)
    with pytest.raises(ValueError, match="trajectory"):
        synthetic.synthetic_pose_graph_2d(n_poses=10, trajectory="spiral")


def test_load_toro_matches_apex_tpu(tmp_path):
    """TORO's information order I11 I12 I22 I33 I13 I23 unscrambled as the
    JAX package does; the writer round-trips; SE3 graphs are refused."""
    path = FIXTURES / "toro_excerpt.graph"
    t, j = load_toro(path), jax_load_toro(path)
    assert (t.num_vertices, t.num_edges) == (j.num_vertices, j.num_edges) == (14, 15)
    _assert_graphs_equal(t, j)
    np.testing.assert_array_equal(t.edges_se2[0].information,
                                  load_g2o(FIXTURES / "intel_excerpt.g2o").edges_se2[0].information)
    out = tmp_path / "roundtrip.toro"
    save_toro(out, t)
    _assert_graphs_equal(load_toro(out), t)
    with pytest.raises(ValueError, match="SE2"):
        save_toro(tmp_path / "se3.toro", load_g2o(FIXTURES / "sphere_excerpt.g2o"))
    bad = tmp_path / "bad.graph"
    bad.write_text("EDGE2 0 1 1.0 0.0\n")
    with pytest.raises(ValueError, match="malformed"):
        load_toro(bad)
