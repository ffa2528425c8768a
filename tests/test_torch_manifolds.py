"""SO2/SE2/SO3/SE3 of the PyTorch port against apex_tpu.manifolds (f64,
atol 1e-12), small-angle branches included. Inputs are numpy arrays from a
seed, handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.manifolds import SE2 as JSE2
from apex_tpu.manifolds import SE3 as JSE3
from apex_tpu.manifolds import SO2 as JSO2
from apex_tpu.manifolds import SO3 as JSO3
from apex_tpu.manifolds import utils as jutils
from apex_tpu_torch.manifolds import SE2, SE3, SO2, SO3, get
from apex_tpu_torch.manifolds import utils as tutils
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

ATOL = 1e-12
# the rotation part is the last ROT[name] tangent entries; act takes
# vectors of that many entries (3 in 3D, 2 in 2D)
ROT = {"SO3": 3, "SE3": 3, "SO2": 1, "SE2": 1}
ACT_DIM = {"SO3": 3, "SE3": 3, "SO2": 2, "SE2": 2}


def _tangent(n, dof, seed, scale, rot=3):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, dof))
    if scale == "small":
        # below and around the 1e-10 theta^2 switch
        t[:, -rot:] *= 10.0 ** rng.uniform(-9, -4, size=(n, 1))
    elif scale == "zero":
        t[:, -rot:] = 0.0
    return t


def _close(t_out, j_out):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=ATOL)


GROUPS = [("SO3", SO3, JSO3, 3), ("SE3", SE3, JSE3, 6), ("SO2", SO2, JSO2, 1),
          ("SE2", SE2, JSE2, 3)]
SCALES = ["large", "small", "zero"]


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name,tg,jg,dof", GROUPS)
def test_exp_log(name, tg, jg, dof, scale):
    t = _tangent(64, dof, seed=1, scale=scale, rot=ROT[name])
    _close(tg.exp(torch.from_numpy(t)), jg.exp(jnp.asarray(t)))
    x = np.array(jg.exp(jnp.asarray(t)))
    _close(tg.log(torch.from_numpy(x)), jg.log(jnp.asarray(x)))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name,tg,jg,dof", GROUPS)
def test_compose_plus_normalize(name, tg, jg, dof, scale):
    rot = ROT[name]
    a = np.array(jg.exp(jnp.asarray(_tangent(32, dof, seed=2, scale="large", rot=rot))))
    b = np.array(jg.exp(jnp.asarray(_tangent(32, dof, seed=3, scale=scale, rot=rot))))
    d = _tangent(32, dof, seed=4, scale=scale, rot=rot)
    _close(tg.compose(torch.from_numpy(a), torch.from_numpy(b)),
           jg.compose(jnp.asarray(a), jnp.asarray(b)))
    _close(tg.plus(torch.from_numpy(a), torch.from_numpy(d)),
           jg.plus(jnp.asarray(a), jnp.asarray(d)))
    # off-unit quaternions with both signs of w; 2D angles out to 4 pi
    raw = a * np.random.default_rng(5).uniform(0.5, 2.0, size=(32, 1))
    raw[::2, -4:] *= -1.0
    if rot == 1:
        raw[:, -1] *= 2.0
    t_raw = torch.from_numpy(raw)
    _close(tg.normalize(t_raw), jg.normalize(jnp.asarray(raw)))
    np.testing.assert_array_equal(t_raw.numpy(), raw)  # the input is left as it was


@pytest.mark.parametrize("name,tg,jg,dof", GROUPS)
def test_act_inverse(name, tg, jg, dof):
    x = np.array(jg.exp(jnp.asarray(_tangent(16, dof, seed=6, scale="large", rot=ROT[name]))))
    v = np.random.default_rng(7).normal(size=(16, ACT_DIM[name]))
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
    assert get("SE2") is SE2 and get("SO2") is SO2
    assert get("R3").dof == 3 and get("R3").storage_dim == 3
    assert get("Sim3").dof == 7 and get("Sim3").storage_dim == 8
    with pytest.raises(KeyError):
        get("not_a_manifold")


def _tangent_at(n, dof, seed, angle, rot=3):
    """Random tangents whose rotation part (the last ``rot`` entries) has
    norm ``angle`` (None: as drawn)."""
    t = np.random.default_rng(seed).normal(size=(n, dof))
    if angle is not None:
        r = t[:, -rot:]
        t[:, -rot:] = r / np.linalg.norm(r, axis=1, keepdims=True) * angle
    return t


ANGLES = {"random": None, "tiny": 1e-9, "near_pi": np.pi - 1e-6, "zero": 0.0}
JAC_RTOL = 1e-12


def _close_rel(t_out, j_out):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=JAC_RTOL, atol=JAC_RTOL)


@pytest.mark.parametrize("angle", list(ANGLES), ids=list(ANGLES))
@pytest.mark.parametrize("name,tg,jg,dof", GROUPS)
@pytest.mark.parametrize("fn", ["rjac", "ljac", "rjac_inv", "ljac_inv"])
def test_tangent_jacobians(fn, name, tg, jg, dof, angle):
    t = _tangent_at(16, dof, seed=21, angle=ANGLES[angle], rot=ROT[name])
    _close_rel(getattr(tg, fn)(torch.from_numpy(t)), getattr(jg, fn)(jnp.asarray(t)))


@pytest.mark.parametrize("angle", list(ANGLES), ids=list(ANGLES))
@pytest.mark.parametrize("name,tg,jg,dof", GROUPS)
def test_adjoint_and_derived_jacobians(name, tg, jg, dof, angle):
    """adjoint, between_j, compose_j and log_j: every output of the
    port's against the JAX package's."""
    rot = ROT[name]
    a = np.array(jg.exp(jnp.asarray(_tangent_at(16, dof, seed=22, angle=None, rot=rot))))
    b = np.array(jg.exp(jnp.asarray(_tangent_at(16, dof, seed=23, angle=ANGLES[angle],
                                                 rot=rot))))
    # between(a, a∘b) = b, so the between and minus Jacobians see the angle
    ab = np.array(jg.compose(jnp.asarray(a), jnp.asarray(b)))
    ta, tb, tab = (torch.from_numpy(v) for v in (a, b, ab))
    ja, jb, jab = (jnp.asarray(v) for v in (a, b, ab))
    _close_rel(tg.adjoint(ta), jg.adjoint(ja))
    for t_out, j_out in zip(tg.between_j(ta, tab), jg.between_j(ja, jab)):
        _close_rel(t_out, j_out)
    for t_out, j_out in zip(tg.compose_j(ta, tb), jg.compose_j(ja, jb)):
        _close_rel(t_out, j_out)
    for t_out, j_out in zip(tg.log_j(tb), jg.log_j(jb)):
        _close_rel(t_out, j_out)
    for t_out, j_out in zip(tg.minus_j(ta, tab), jg.minus_j(ja, jab)):
        _close_rel(t_out, j_out)


@pytest.mark.parametrize("name,tg,jg,dof", GROUPS)
def test_inverse_and_exp_jacobians(name, tg, jg, dof):
    t = _tangent_at(16, dof, seed=24, angle=None, rot=ROT[name])
    x = np.array(jg.exp(jnp.asarray(t)))
    for t_out, j_out in zip(tg.inverse_j(torch.from_numpy(x)), jg.inverse_j(jnp.asarray(x))):
        _close_rel(t_out, j_out)
    for t_out, j_out in zip(tg.exp_j(torch.from_numpy(t)), jg.exp_j(jnp.asarray(t))):
        _close_rel(t_out, j_out)


@pytest.mark.parametrize("fn", ["q_coeff_1", "q_coeff_2", "q_coeff_3"])
def test_q_coefficients(fn):
    theta2 = np.concatenate([10.0 ** np.linspace(-14, 1, 40), [(np.pi - 1e-6) ** 2]])
    _close_rel(getattr(tutils, fn)(torch.from_numpy(theta2)),
               getattr(jutils, fn)(jnp.asarray(theta2)))
