"""Self-calibration with one intrinsics variable per camera through the
port against the JAX package, on the CPU in f64: ``chip_smoke.py``'s
``selfcal_ring`` (the card's ``camera_full`` scene, shaped as bench's
trafalgar rung) cut to 24 cameras, 1,660 points and 5,760 observations,
with ``RING_FIXED``'s intrinsics held (the principal point, and the
distortion terms the view cannot tell from the focal length), LM with the
bundle adjustment config. Through ``schur_implicit`` each model holds the
JAX solve's iterations and status and its final cost to rtol 1e-8, and
ends within rtol 1e-4 of the port's explicit solve's RMSE: the implicit
path reaches the same optimum."""

import numpy as np
import pytest
import torch

import apex_tpu as jax_apx
import apex_tpu_torch as apx
from apex_tpu import cameras as jax_cameras
from apex_tpu.factors.projection import ProjectionFactor as JaxProjectionFactor
from apex_tpu_torch import cameras
from apex_tpu_torch.ba import rmse
from apex_tpu_torch.factors.projection import ProjectionFactor
from chip_smoke import (FTHETA, RING_FIXED, SELFCAL_MODELS, SELFCAL_SLOTS, build_selfcal,
                        selfcal_arrays, selfcal_ring)
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

MODELS = list(SELFCAL_MODELS) + ["ftheta"]
INTRINSICS = dict(SELFCAL_MODELS, ftheta=FTHETA)


@pytest.fixture(scope="module")
def ring():
    poses, pts, cam_idx, pt_idx = selfcal_ring(n_cams=24, n_pts=1660, per_camera=240)
    return {model: selfcal_arrays(model, INTRINSICS[model], poses, pts, (cam_idx, pt_idx),
                                  shared=False) for model in MODELS}


def _lm(pkg, solver):
    cfg = pkg.LevenbergMarquardtConfig.for_bundle_adjustment()
    cfg.linear_solver_type = solver
    return pkg.LevenbergMarquardt(cfg)


def test_ring_scene():
    """Exactly ``per_camera`` views per camera, 3 or 4 distinct cameras per
    point, every point in front of every camera within 35 degrees of its
    axis."""
    from apex_tpu_torch.manifolds import SE3

    poses, pts, cam_idx, pt_idx = selfcal_ring(n_cams=24, n_pts=1660, per_camera=240)
    assert np.bincount(cam_idx, minlength=24).tolist() == [240] * 24
    views = np.bincount(pt_idx, minlength=1660)
    assert views.min() == 3 and views.max() == 4
    assert len(np.unique(cam_idx * 1660 + pt_idx)) == len(cam_idx)
    p = SE3.act(torch.from_numpy(poses[cam_idx]), torch.from_numpy(pts[pt_idx])).numpy()
    assert p[:, 2].min() > 2.5
    assert np.degrees(np.arctan(np.hypot(p[:, 0], p[:, 1]) / p[:, 2])).max() < 35.0


@pytest.mark.parametrize("model", MODELS)
def test_ring_selfcal_matches_apex_tpu(model, ring):
    arrays = ring[model]
    n_obs = len(arrays["obs"])
    jp = build_selfcal(jax_apx, JaxProjectionFactor.template(jax_cameras.get(model),
                                                             SELFCAL_SLOTS),
                       arrays, model, RING_FIXED[model])
    rj = _lm(jax_apx, "schur_implicit").optimize(jp)
    problem = build_selfcal(apx, ProjectionFactor.template(cameras.get(model), SELFCAL_SLOTS),
                            arrays, model, RING_FIXED[model])
    cp = problem.compile(dtype=torch.float64, device="cpu")
    rt = _lm(apx, "schur_implicit").optimize(cp)
    assert rt.converged
    assert (rt.iterations, rt.status) == (rj.iterations, apx.Status(int(rj.status)))
    np.testing.assert_allclose(rt.final_cost, float(rj.final_cost), rtol=1e-8)
    explicit = _lm(apx, "schur").optimize(cp)
    assert explicit.converged
    np.testing.assert_allclose(rmse(rt.final_cost, n_obs), rmse(explicit.final_cost, n_obs),
                               rtol=1e-4)
    assert rmse(rt.final_cost, n_obs) < 0.55 * rmse(rt.initial_cost, n_obs)
