"""Compiled BA problems of the port against apex_tpu's on
synthetic_ba(8, 150, seed=0), bucketed layout, f64: pools, column layout,
Huber-corrected residuals and Jacobians of the projection group kernel
(rtol 1e-11, atol 1e-9: pixel-scale values), and cost. A second dataset with
uneven observation counts gives several buckets and weight-0 padding rows."""

import numpy as np
import pytest
import torch

from apex_tpu.ba import build_ba_problem as jax_build
from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.io import synthetic


DATASETS = {
    "small": lambda: synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0),
    "uneven": lambda: synthetic.synthetic_ba_large(
        n_cameras=6, n_points=200, obs_per_camera=60, seed=1),
}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def compiled(request):
    ds = DATASETS[request.param]()
    jcp = jax_build(ds, mode="self_calibration").compile(dtype=np.float64)
    tcp = build_ba_problem(ds, mode="self_calibration").compile(
        dtype=torch.float64, device="cpu")
    return jcp, tcp


def test_pools_and_layout(compiled):
    jcp, tcp = compiled
    assert tcp.total_dof == jcp.total_dof
    assert tcp.total_residual_dim == jcp.total_residual_dim
    assert [p.manifold.name for p in tcp.pools] == [p.manifold.name for p in jcp.pools]
    for pid, (tp, jp) in enumerate(zip(tcp.pools, jcp.pools)):
        assert tp.names == jp.names
        np.testing.assert_array_equal(tp.values0.numpy(), np.asarray(jp.values0))
        np.testing.assert_array_equal(tp.free_mask.numpy(), np.asarray(jp.free_mask))
        np.testing.assert_array_equal(tp.cols.numpy(), np.asarray(jp.cols))
        np.testing.assert_array_equal(tcp.host_pool_cols[pid], jcp.host_pool_cols[pid])
    assert len(tcp.groups) == len(jcp.groups)  # one group per bucket
    for gi, (tg, jg) in enumerate(zip(tcp.groups, jcp.groups)):
        assert tg.count == jg.count and tg.pool_ids == jg.pool_ids
        np.testing.assert_array_equal(tg.weights.numpy(), np.asarray(jg.weights))
        for s in range(len(tg.manifolds)):
            np.testing.assert_array_equal(tcp.host_group_cols[gi][s], jcp.host_group_cols[gi][s])
            np.testing.assert_array_equal(tg.indices[s].numpy(), np.asarray(jg.indices[s]))


@pytest.mark.parametrize("ordering,n_cameras,n_points", [
    ("rcm", 8, 150),   # forced reverse Cuthill-McKee
    ("auto", 30, 400),  # wide name-order band: auto may switch to RCM
])
def test_column_layout_orderings(ordering, n_cameras, n_points):
    ds = synthetic.synthetic_ba(n_cameras=n_cameras, n_points=n_points, seed=2)
    jcp = jax_build(ds).compile(dtype=np.float64, ordering=ordering)
    tcp = build_ba_problem(ds).compile(device="cpu", ordering=ordering)
    for pid in range(len(jcp.pools)):
        np.testing.assert_array_equal(tcp.host_pool_cols[pid], jcp.host_pool_cols[pid])
    name_cols = build_ba_problem(ds).compile(device="cpu", ordering="name").host_pool_cols
    if ordering == "rcm":
        assert any(not np.array_equal(tcp.host_pool_cols[p], name_cols[p]) for p in name_cols)


def test_group_linearize_huber(compiled):
    jcp, tcp = compiled
    jvals, tvals = jcp.initial_values(), tcp.initial_values()
    n_outer = n_pad = 0
    for jg, tg in zip(jcp.groups, tcp.groups):
        assert tg.loss_kind == jg.loss_kind == "huber"
        jr, jjacs = jcp.group_linearize(jvals, jg, True)
        tr, tjacs = tcp.group_linearize(tvals, tg, True)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-11, atol=1e-9)
        for tj, jj in zip(tjacs, jjacs):
            np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=1e-11, atol=1e-9)
        raw, _ = tg.kernel(tg.manifolds, tg.data,
                           [tvals[p][i] for p, i in zip(tg.pool_ids, tg.indices)], False)
        n_outer += int(((raw * raw).sum(-1) > 1.0).sum())
        # weight-0 padding rows are exact no-ops
        pad = tg.weights == 0
        assert torch.all(tr[pad] == 0) and all(torch.all(j[pad] == 0) for j in tjacs)
        # the fixed first camera zeroes its pose Jacobian columns
        first = tg.indices[0] == 0
        assert torch.all(tjacs[0][first] == 0)
        n_pad += int(pad.sum())
    assert n_outer > 0  # the Huber branch is exercised
    assert n_pad > 0 or len(tcp.groups) == 1


def test_cost_and_residual_vector(compiled):
    jcp, tcp = compiled
    np.testing.assert_allclose(float(tcp.cost(tcp.initial_values())),
                               float(jcp.cost(jcp.initial_values())), rtol=1e-12)
    np.testing.assert_allclose(tcp.residual_vector(tcp.initial_values()).numpy(),
                               np.asarray(jcp.residual_vector(jcp.initial_values())),
                               rtol=1e-11, atol=1e-9)


def test_flat_layout_matches():
    ds = jax_synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    jcp = jax_build(ds, layout="flat").compile(dtype=np.float64)
    tcp = build_ba_problem(ds, layout="flat").compile(device="cpu")
    assert len(tcp.groups) == 1 and tcp.groups[0].weights is None
    np.testing.assert_allclose(float(tcp.cost(tcp.initial_values())),
                               float(jcp.cost(jcp.initial_values())), rtol=1e-12)
