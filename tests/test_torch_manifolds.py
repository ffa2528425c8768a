"""SO3/SE3 of the PyTorch port against apex_tpu.manifolds (f64, atol 1e-12),
small-angle branches included. Inputs are numpy arrays from a seed, handed
to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.manifolds import SE3 as JSE3
from apex_tpu.manifolds import SO3 as JSO3
from apex_tpu.manifolds import utils as jutils
from apex_tpu_torch.manifolds import SE3, SO3, get
from apex_tpu_torch.manifolds import utils as tutils

ATOL = 1e-12


def _tangent(n, dof, seed, scale):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, dof))
    if scale == "small":
        # below and around the 1e-10 theta^2 switch
        t[:, -3:] *= 10.0 ** rng.uniform(-9, -4, size=(n, 1))
    elif scale == "zero":
        t[:, -3:] = 0.0
    return t


def _close(t_out, j_out):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)


GROUPS = [("SO3", SO3, JSO3, 3), ("SE3", SE3, JSE3, 6)]
SCALES = ["large", "small", "zero"]


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name,tg,jg,dof", GROUPS)
def test_exp_log(name, tg, jg, dof, scale):
    t = _tangent(64, dof, seed=1, scale=scale)
    _close(tg.exp(torch.from_numpy(t)), jg.exp(jnp.asarray(t)))
    x = np.array(jg.exp(jnp.asarray(t)))
    _close(tg.log(torch.from_numpy(x)), jg.log(jnp.asarray(x)))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name,tg,jg,dof", GROUPS)
def test_compose_plus_normalize(name, tg, jg, dof, scale):
    a = np.array(jg.exp(jnp.asarray(_tangent(32, dof, seed=2, scale="large"))))
    b = np.array(jg.exp(jnp.asarray(_tangent(32, dof, seed=3, scale=scale))))
    d = _tangent(32, dof, seed=4, scale=scale)
    _close(tg.compose(torch.from_numpy(a), torch.from_numpy(b)),
           jg.compose(jnp.asarray(a), jnp.asarray(b)))
    _close(tg.plus(torch.from_numpy(a), torch.from_numpy(d)),
           jg.plus(jnp.asarray(a), jnp.asarray(d)))
    # off-unit quaternions with both signs of w
    raw = a * np.random.default_rng(5).uniform(0.5, 2.0, size=(32, 1))
    raw[::2, -4:] *= -1.0
    _close(tg.normalize(torch.from_numpy(raw)), jg.normalize(jnp.asarray(raw)))


@pytest.mark.parametrize("name,tg,jg,dof", GROUPS)
def test_act_inverse(name, tg, jg, dof):
    x = np.array(jg.exp(jnp.asarray(_tangent(16, dof, seed=6, scale="large"))))
    v = np.random.default_rng(7).normal(size=(16, 3))
    _close(tg.act(torch.from_numpy(x), torch.from_numpy(v)),
           jg.act(jnp.asarray(x), jnp.asarray(v)))
    _close(tg.inverse(torch.from_numpy(x)), jg.inverse(jnp.asarray(x)))


@pytest.mark.parametrize("scale", SCALES)
def test_quat_mat_roundtrip(scale):
    q = np.array(JSO3.exp(jnp.asarray(_tangent(64, 3, seed=8, scale=scale))))
    _close(tutils.quat_to_mat(torch.from_numpy(q)), jutils.quat_to_mat(jnp.asarray(q)))
    R = np.array(jutils.quat_to_mat(jnp.asarray(q)))
    _close(tutils.mat_to_quat(torch.from_numpy(R)), jutils.mat_to_quat(jnp.asarray(R)))


def test_mat_to_quat_every_pivot():
    """Rotations by ~pi about each axis take each of the four Shepperd
    branches."""
    axes = np.eye(3) * (np.pi - 1e-3)
    t = np.concatenate([axes, np.zeros((1, 3)), [[0.3, -0.2, 0.1]]])
    R = np.array(jutils.quat_to_mat(JSO3.exp(jnp.asarray(t))))
    _close(tutils.mat_to_quat(torch.from_numpy(R)), jutils.mat_to_quat(jnp.asarray(R)))


def test_registry():
    assert get("SE3") is SE3 and get("SO3") is SO3
    assert get("R3").dof == 3 and get("R3").storage_dim == 3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get("SE2")
