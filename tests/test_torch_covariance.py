"""Covariance estimation of the port against apex_tpu, on the CPU in f64:
each block to rtol 1e-8 of its largest entry (both invert the same H by
Cholesky; a block's small entries carry the rounding of its large ones)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu.core import covariance as jax_cov
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.convert import values_from_jax
from apex_tpu_torch.core import covariance as cov
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.linalg import dense
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)


def _assert_blocks(got, want, rtol=1e-8):
    assert set(got) == set(want)
    for n, w in want.items():
        w = np.asarray(w)
        assert got[n].shape == w.shape, n
        assert np.abs(got[n] - w).max() <= rtol * max(np.abs(w).max(), 1e-300), n


@pytest.fixture(scope="module")
def ring():
    """A 20-pose SE2 ring with the first pose and one coordinate of another
    fixed, and a mid-solve state shared by both packages."""
    kw = dict(n_poses=20, seed=41)
    pj = jax_synthetic.synthetic_pose_graph_2d(**kw).to_problem(fix_first=True)
    pt = synthetic.synthetic_pose_graph_2d(**kw).to_problem(fix_first=True)
    for p in (pj, pt):
        p.fix_variable("x7", [2])
    jcp = pj.compile(dtype=np.float64)
    tcp = pt.compile(dtype=torch.float64, device="cpu")
    dx = np.random.default_rng(2).normal(scale=1e-2, size=jcp.total_dof)
    jvals = jcp.apply_step(jcp.initial_values(), jnp.asarray(dx))
    tvals = values_from_jax(tcp, [np.asarray(v) for v in jvals], jcp.pools)
    return pj, pt, jcp, tcp, jvals, tvals


def test_global_free_mask(ring):
    _, _, jcp, tcp, _, _ = ring
    mask = cov._global_free_mask(tcp)
    np.testing.assert_array_equal(mask.numpy(), jax_cov._global_free_mask(jcp))
    assert mask.dtype == torch.float64 and int((mask == 0).sum()) == 4


def test_covariance_from_hessian():
    A = np.random.default_rng(0).normal(size=(12, 12))
    H = A @ A.T + 12 * np.eye(12)
    got = dense.covariance_from_hessian(torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(got, np.linalg.inv(H), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(got, np.asarray(jax_apx.linalg.dense.covariance_from_hessian(
        jnp.asarray(H))), rtol=1e-10, atol=1e-14)
    # not positive definite: NaN, never an exception
    assert torch.isnan(dense.covariance_from_hessian(-torch.from_numpy(H))).all()


@pytest.mark.parametrize("names", [None, ["x0", "x3", "x7"]], ids=["all", "selected"])
def test_compute_covariances(ring, names):
    _, _, jcp, tcp, jvals, tvals = ring
    got = cov.compute_covariances(tcp, tvals, names)
    _assert_blocks(got, jax_cov.compute_covariances(jcp, jvals, names))
    assert len(got) == (20 if names is None else 3)
    assert np.abs(got["x0"]).max() == 0.0  # a fixed variable's block is zero
    assert np.abs(got["x7"][2]).max() == 0.0 and np.abs(got["x7"][:, 2]).max() == 0.0
    np.testing.assert_allclose(got["x3"], got["x3"].T, atol=1e-10 * np.abs(got["x3"]).max())


def test_compute_covariances_for_dense_route(ring):
    _, _, jcp, tcp, jvals, tvals = ring
    names = ["x0", "x7", "x19"]
    got = cov.compute_covariances_for(tcp, tvals, names)
    _assert_blocks(got, jax_cov.compute_covariances_for(jcp, jvals, names))
    _assert_blocks({"x19": got["x19"]}, cov.compute_covariances(tcp, tvals, ["x19"]))
    # as in apex_tpu, this route returns a fixed DOF's pinned unit diagonal
    # unmasked (the banded route and compute_covariances zero it)
    np.testing.assert_array_equal(got["x0"], np.eye(3))


def test_banded_route_matches_apex_tpu(ring):
    """The banded route called directly (the graph is far below the 4096
    DOF at which compute_covariances_for takes it)."""
    _, _, jcp, tcp, jvals, tvals = ring
    names = ["x0", "x7", "x12"]
    got = cov._banded_covariances_for(tcp, tvals, names)
    _assert_blocks(got, jax_cov._banded_covariances_for(jcp, jvals, names))
    _assert_blocks(got, cov.compute_covariances(tcp, tvals, names))
    assert np.abs(got["x0"]).max() == 0.0


def test_routing_above_4096_dof(monkeypatch):
    """Above 4096 DOF a band-shaped problem takes the banded route and never
    forms the dense H (tests/test_pose_graph_e2e.py holds the two routes
    together at that size; here the small ring above does, and this pins the
    routing): the blocks are the banded route's own."""
    g = synthetic.synthetic_pose_graph_2d(n_poses=1400, trajectory="manhattan",
                                          loop_stride=2, seed=0)
    cp = g.to_problem(fix_first=True).compile(dtype=torch.float64, device="cpu")
    assert cp.total_dof == 4200
    vals = cp.initial_values()
    names = ["x0", "x5", "x700", "x1399"]
    monkeypatch.setattr(cp, "assemble_normal", None)  # the dense H must not be needed
    sel = cov.compute_covariances_for(cp, vals, names)
    _assert_blocks(sel, cov._banded_covariances_for(cp, vals, names), rtol=0)
    assert np.abs(sel["x0"]).max() == 0 and np.trace(sel["x700"]) > np.trace(sel["x5"]) > 0
    # a graph below 4096 DOF takes the dense route
    small = synthetic.synthetic_pose_graph_2d(n_poses=30, seed=0).to_problem().compile(
        dtype=torch.float64, device="cpu")
    monkeypatch.setattr(small, "assemble_normal", None)
    with pytest.raises(TypeError):
        cov.compute_covariances_for(small, small.initial_values(), ["x1"])


@pytest.mark.parametrize("kind", ["lm", "gn", "dl"])
def test_solver_result_covariances_match_apex_tpu(ring, kind):
    """``compute_covariances=True`` fills ``SolverResult.covariances`` with
    numpy blocks by variable name, at the solution."""
    pj, pt, jcp, tcp, _, _ = ring
    name = {"lm": "LevenbergMarquardt", "gn": "GaussNewton", "dl": "DogLeg"}[kind]

    def solve(pkg, cp):
        cfg = getattr(pkg, name + "Config")(compute_covariances=True)
        return getattr(pkg, name)(cfg).optimize(cp)

    rt = solve(apx, tcp)
    assert isinstance(rt.covariances["x5"], np.ndarray) and rt.covariances["x5"].shape == (3, 3)
    tr = [np.trace(rt.covariances[f"x{i}"]) for i in range(1, 10)]
    assert tr[-1] > tr[0]  # uncertainty grows with the distance from the anchor
    if kind == "lm":  # one JAX solve; the three optimizers share the covariance code
        rj = solve(jax_apx, jcp)
        assert rt.iterations == rj.iterations
        _assert_blocks(rt.covariances, rj.covariances, rtol=1e-6)
    assert apx.LevenbergMarquardt().optimize(tcp).covariances is None
