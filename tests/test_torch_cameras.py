"""The port's camera models against the JAX package's, on the CPU in f64,
for the 9 models and intrinsics of ``tests/test_cameras.py``: projection,
validity mask, Jacobians (closed form for the two pinholes, exact
``torch.func`` autodiff for the extended models), unprojection, the 1e6
sentinel of ``project_batch`` and ``validate_params``; then that file's
numeric-Jacobian, round-trip and behind-the-camera checks on the port
alone, and the registry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import cameras as jax_cameras
from apex_tpu_torch import cameras
from test_cameras import CASES, EPS, sample_points
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

IDS = [c[0] for c in CASES]
TOL = dict(rtol=1e-10, atol=1e-9)


def _inputs(intr, sign, seed=0, n=20):
    pts = np.array(sample_points(sign, n=n, seed=seed))
    intr_b = np.ascontiguousarray(np.broadcast_to(np.asarray(intr), (n, len(intr))))
    return intr_b, pts


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("name,intr,sign", CASES, ids=IDS)
def test_project_and_jacobians_match_apex_tpu(name, intr, sign):
    intr_b, pts = _inputs(intr, sign)
    jc, tc = jax_cameras.get(name), cameras.get(name)
    uv_j, valid_j = jc.project(jnp.asarray(intr_b), jnp.asarray(pts))
    uv_t, valid_t = tc.project(_t(intr_b), _t(pts))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), **TOL)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    Jp_j, Ji_j = jc.jacobians(jnp.asarray(intr_b), jnp.asarray(pts))
    Jp_t, Ji_t = tc.jacobians(_t(intr_b), _t(pts))
    assert Jp_t.shape == (20, 2, 3) and Ji_t.shape == (20, 2, tc.intrinsic_dim)
    np.testing.assert_allclose(Jp_t.numpy(), np.asarray(Jp_j), **TOL)
    np.testing.assert_allclose(Ji_t.numpy(), np.asarray(Ji_j), **TOL)


@pytest.mark.parametrize("name,intr,sign", CASES, ids=IDS)
def test_unproject_matches_apex_tpu(name, intr, sign):
    intr_b, pts = _inputs(intr, sign, seed=3)
    jc, tc = jax_cameras.get(name), cameras.get(name)
    uv, _ = jc.project(jnp.asarray(intr_b), jnp.asarray(pts))
    rays_j = jc.unproject(jnp.asarray(intr_b), uv)
    rays_t = tc.unproject(_t(intr_b), _t(uv))
    np.testing.assert_allclose(rays_t.numpy(), np.asarray(rays_j), **TOL)


@pytest.mark.parametrize("name,intr,sign", CASES, ids=IDS)
def test_project_batch_matches_apex_tpu(name, intr, sign):
    """A mix of points in front of and behind the camera: the sentinel rows
    and the valid rows alike."""
    intr_b, pts = _inputs(intr, sign, seed=5)
    pts[::3, 2] *= -1.0
    want = jax_cameras.get(name).project_batch(jnp.asarray(intr_b), jnp.asarray(pts))
    got = cameras.get(name).project_batch(_t(intr_b), _t(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[::3] == 1e6).all()


# valid parameters, then one bad vector per model: each must raise in both
BAD = {
    "bal_pinhole": [[-5.0, 0.0, 0.0], [800.0, np.nan, 0.0], [800.0, 0.0]],
    "pinhole": [[0.0, 1.0, 0.0, 0.0], [500.0, 510.0, np.inf, 240.0]],
    "rad_tan": [[460.0, -1.0, 320.0, 240.0, 0, 0, 0, 0, 0]],
    "kannala_brandt": [[380.0, 379.0, 318.0, 242.0, 0.01, np.nan, 0.0, 0.0]],
    "fov": [[300.0, 300.0, 320.0, 240.0, 0.0], [300.0, 300.0, 320.0, 240.0, 3.2]],
    "ucm": [[460.0, 460.0, 320.0, 240.0, 1.0], [460.0, 460.0, 320.0, 240.0, -0.1]],
    "eucm": [[460.0, 460.0, 320.0, 240.0, 0.6, 0.0], [460.0, 460.0, 320.0, 240.0, 1.2, 1.0]],
    "double_sphere": [[350.0, 350.0, 320.0, 240.0, -0.2, 1.0]],
    "ftheta": [[320.0, 240.0, 0.0, 5.0, -2.0, 0.3], [320.0, 240.0, 300.0, 5.0]],
}


@pytest.mark.parametrize("name,intr,sign", CASES, ids=IDS)
def test_validate_params_matches_apex_tpu(name, intr, sign):
    jc, tc = jax_cameras.get(name), cameras.get(name)
    good = np.asarray(intr)
    assert jc.validate_params(good) is None and tc.validate_params(_t(good)) is None
    for bad in BAD[name]:
        bad = np.asarray(bad, dtype=np.float64)
        with pytest.raises(ValueError) as want:
            jc.validate_params(bad)
        with pytest.raises(ValueError) as got:
            tc.validate_params(_t(bad))
        assert str(got.value) == str(want.value)


# -- tests/test_cameras.py's checks on the port --------------------------------


@pytest.mark.parametrize("name,intr,sign", CASES, ids=IDS)
def test_jacobians_match_numeric(name, intr, sign):
    cam = cameras.get(name)
    intr_b, pts = (_t(a) for a in _inputs(intr, sign))
    Jp, Ji = cam.jacobians(intr_b, pts)
    _, valid = cam.project(intr_b, pts)
    assert bool(valid.all())
    for k in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[k] = EPS
        num = (cam.project(intr_b, pts + e)[0] - cam.project(intr_b, pts - e)[0]) / (2 * EPS)
        np.testing.assert_allclose(Jp[..., k].numpy(), num.numpy(), atol=1e-5, rtol=1e-5)
    for k in range(cam.intrinsic_dim):
        e = torch.zeros(cam.intrinsic_dim, dtype=torch.float64)
        e[k] = EPS
        num = (cam.project(intr_b + e, pts)[0] - cam.project(intr_b - e, pts)[0]) / (2 * EPS)
        np.testing.assert_allclose(Ji[..., k].numpy(), num.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,intr,sign", CASES, ids=IDS)
def test_project_unproject_roundtrip(name, intr, sign):
    cam = cameras.get(name)
    intr_b, pts = (_t(a) for a in _inputs(intr, sign, seed=3))
    rays = cam.unproject(intr_b, cam.project(intr_b, pts)[0])
    pn = pts / torch.linalg.norm(pts, dim=-1, keepdim=True)
    np.testing.assert_allclose(torch.abs((pn * rays).sum(-1)).numpy(), 1.0, atol=1e-8)


@pytest.mark.parametrize("name,intr,sign", CASES, ids=IDS)
def test_validity_mask_behind_camera(name, intr, sign):
    cam = cameras.get(name)
    behind = torch.tensor([[0.1, 0.2, -sign * 2.0]], dtype=torch.float64)
    intr_b = _t(intr)[None]
    uv, valid = cam.project(intr_b, behind)
    assert not bool(valid[0])
    assert bool(torch.isfinite(uv).all())  # the clamped z keeps it NaN-free
    np.testing.assert_allclose(cam.project_batch(intr_b, behind)[0].numpy(), [1e6, 1e6])


@pytest.mark.parametrize("name,intr,sign", CASES, ids=IDS)
def test_jacobians_on_the_optical_axis_match_apex_tpu(name, intr, sign):
    """A point on the optical axis takes every near-axis branch; its
    Jacobians are finite and equal to the JAX package's (forward-mode
    ``where`` selects the tangent of the taken branch in both)."""
    pts = np.array([[0.0, 0.0, sign * 2.0], [1e-12, -1e-12, sign * 3.0]])
    intr_b = np.ascontiguousarray(np.broadcast_to(np.asarray(intr), (2, len(intr))))
    Jp_j, Ji_j = jax_cameras.get(name).jacobians(jnp.asarray(intr_b), jnp.asarray(pts))
    Jp_t, Ji_t = cameras.get(name).jacobians(_t(intr_b), _t(pts))
    assert bool(torch.isfinite(Jp_t).all() and torch.isfinite(Ji_t).all())
    np.testing.assert_allclose(Jp_t.numpy(), np.asarray(Jp_j), **TOL)
    np.testing.assert_allclose(Ji_t.numpy(), np.asarray(Ji_j), **TOL)


@pytest.mark.parametrize("name,intr,sign", CASES, ids=IDS)
def test_jacobians_keep_f32(name, intr, sign):
    """f32 in, f32 out (a python number times a 0-dim tensor under
    ``jacfwd`` would give float64 tangents), and close to f64's."""
    cam = cameras.get(name)
    intr_b, pts = _inputs(intr, sign)
    Jp, Ji = cam.jacobians(_t(intr_b).float(), _t(pts).float())
    assert Jp.dtype == Ji.dtype == torch.float32
    Jp64, Ji64 = cam.jacobians(_t(intr_b), _t(pts))
    np.testing.assert_allclose(Jp.double().numpy(), Jp64.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(Ji.double().numpy(), Ji64.numpy(), rtol=1e-4, atol=1e-3)


def test_jacobians_broadcast_and_empty():
    """Leading batch dimensions are kept, and an empty batch gives empty
    Jacobians, as in the JAX package."""
    cam = cameras.get("kannala_brandt")
    intr = _t(CASES[3][1])
    pts = _t(sample_points(+1, n=6)).reshape(2, 3, 3)
    Jp, Ji = cam.jacobians(intr.expand(2, 3, 8), pts)
    assert Jp.shape == (2, 3, 2, 3) and Ji.shape == (2, 3, 2, 8)
    flat_p, flat_i = cam.jacobians(intr.expand(6, 8), pts.reshape(6, 3))
    np.testing.assert_array_equal(Jp.reshape(6, 2, 3).numpy(), flat_p.numpy())
    Jp0, Ji0 = cam.jacobians(intr.expand(0, 8), pts[:0, 0])
    assert Jp0.shape == (0, 2, 3) and Ji0.shape == (0, 2, 8)


def test_registry():
    for name, _, _ in CASES:
        cam = cameras.get(name)
        assert cam.name == name and cam is cameras.get(name)
        assert cam.intrinsic_dim == jax_cameras.get(name).intrinsic_dim
        assert cam.forward_sign == jax_cameras.get(name).forward_sign
    with pytest.raises(KeyError):
        cameras.get("not_a_camera")
