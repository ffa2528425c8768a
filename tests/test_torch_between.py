"""BetweenFactor of the PyTorch port on SE3 and SE2 against apex_tpu (f64,
rtol 1e-12), and its Jacobians against central finite differences on the
manifold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.factors.between import BetweenFactor as JBetween
from apex_tpu.manifolds import SE2 as JSE2
from apex_tpu.manifolds import SE3 as JSE3
from apex_tpu_torch.factors import BetweenFactor
from apex_tpu_torch.manifolds import SE2, SE3
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

RTOL = 1e-12
# (port group, JAX group) by name
GROUPS = {"SE3": (SE3, JSE3), "SE2": (SE2, JSE2)}


def _poses(n, seed, G=JSE3):
    t = np.random.default_rng(seed).normal(size=(n, G.dof))
    return np.array(G.exp(jnp.asarray(t)))


def _inputs(scale, G=JSE3):
    """Pose pairs and measurements: measurements near the pairs' relative
    pose (an optimized graph: tiny residual angles) or arbitrary."""
    xi, xj = _poses(32, 1, G), _poses(32, 2, G)
    if scale == "near":
        rel = np.array(G.between(jnp.asarray(xi), jnp.asarray(xj)))
        meas = np.array(G.plus(jnp.asarray(rel), jnp.asarray(
            1e-6 * np.random.default_rng(3).normal(size=(32, G.dof)))))
    else:
        meas = _poses(32, 3, G)
    return xi, xj, meas


def _linearize_torch(xi, xj, meas, compute_jacobian=True, G=SE3):
    return BetweenFactor.linearize(
        (G, G), {"meas": torch.from_numpy(meas)},
        [torch.from_numpy(xi), torch.from_numpy(xj)], compute_jacobian)


def _check_against_apex_tpu(scale, name):
    tg, jg = GROUPS[name]
    xi, xj, meas = _inputs(scale, jg)
    r, (J_i, J_j) = _linearize_torch(xi, xj, meas, G=tg)
    rj, (Jj_i, Jj_j) = JBetween.linearize(
        (jg, jg), {"meas": jnp.asarray(meas)}, [jnp.asarray(xi), jnp.asarray(xj)], True)
    for t_out, j_out in ((r, rj), (J_i, Jj_i), (J_j, Jj_j)):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=RTOL, atol=RTOL)
    r_only, none = _linearize_torch(xi, xj, meas, compute_jacobian=False, G=tg)
    assert none is None
    np.testing.assert_allclose(r_only.numpy(), r.numpy(), rtol=0, atol=1e-15)


def _check_finite_differences(scale, name):
    """dr/dx_k ≈ (r(x ⊞ h e_k) - r(x ⊞ -h e_k)) / 2h for both poses."""
    tg, jg = GROUPS[name]
    xi, xj, meas = _inputs(scale, jg)
    _, jacs = _linearize_torch(xi, xj, meas, G=tg)
    h = 1e-6
    for slot, J in enumerate(jacs):
        for k in range(tg.dof):
            step = np.zeros((32, tg.dof))
            step[:, k] = h
            rs = []
            for sign in (1.0, -1.0):
                x = [torch.from_numpy(xi), torch.from_numpy(xj)]
                x[slot] = tg.plus(x[slot], torch.from_numpy(sign * step))
                rs.append(BetweenFactor.linearize(
                    (tg, tg), {"meas": torch.from_numpy(meas)}, x, False)[0])
            fd = (rs[0] - rs[1]) / (2 * h)
            np.testing.assert_allclose(J[:, :, k].numpy(), fd.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scale", ["near", "far"])
def test_linearize_matches_apex_tpu(scale):
    _check_against_apex_tpu(scale, "SE3")


@pytest.mark.parametrize("scale", ["near", "far"])
def test_jacobians_match_finite_differences(scale):
    _check_finite_differences(scale, "SE3")


@pytest.mark.parametrize("scale", ["near", "far"])
def test_se2_linearize_matches_apex_tpu(scale):
    _check_against_apex_tpu(scale, "SE2")


@pytest.mark.parametrize("scale", ["near", "far"])
def test_se2_jacobians_match_finite_differences(scale):
    _check_finite_differences(scale, "SE2")


def test_factor_descriptor():
    f = BetweenFactor("SE3", np.array([0, 0, 0, 1.0, 0, 0, 0]))
    assert f.signature() == ("between", "SE3")
    assert f.var_manifolds() == ["SE3", "SE3"] and f.residual_dim() == 6
    assert f.group_kernel() == BetweenFactor.linearize
    with pytest.raises(ValueError, match="shape"):
        BetweenFactor("SE3", np.zeros(6))
    f2 = BetweenFactor("SE2", np.zeros(3))
    assert f2.var_manifolds() == ["SE2", "SE2"] and f2.residual_dim() == 3
