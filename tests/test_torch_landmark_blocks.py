"""The port's landmark-block inverse against apex_tpu's: the plain PyTorch
version on the CPU against the XLA formulation and the Pallas kernel in
interpret mode (the cases of test_kernels.py). The CUDA kernel is held to
the plain version in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import invert_landmark_blocks_pallas
from apex_tpu.linalg.schur import invert_landmark_blocks as jax_inverse
from apex_tpu_torch.kernels import landmark_blocks as lb
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)


def _blocks(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 3, 3))
    H = A @ np.transpose(A, (0, 2, 1)) + 0.1 * np.eye(3)
    H[5] = np.diag([1e-15, 1.0, 1.0])  # near-singular
    H[17] = np.zeros((3, 3))  # fully degenerate
    H[100] *= 1e12  # huge scale
    return H


def _plain(H):
    return lb.invert_landmark_blocks_plain(torch.from_numpy(H)).numpy()


def _rel(a, ref):
    return np.max(np.abs(a - ref) / (np.abs(ref) + 1.0))


@pytest.mark.parametrize("n,seed", [(2000, 0), (777, 3)])
def test_plain_matches_xla_formulation(n, seed):
    H = _blocks(n, seed)
    out = _plain(H)
    assert np.all(np.isfinite(out))
    # the same formulation in the same order: f64 rounding only
    assert _rel(out, np.asarray(jax_inverse(jnp.asarray(H)))) < 1e-10


def test_plain_matches_pallas_interpret():
    H = _blocks()
    ker = np.asarray(invert_landmark_blocks_pallas(jnp.asarray(H), interpret=True))
    # the Pallas kernel's Newton cos(acos(r)/3) differs from plain acos
    assert _rel(_plain(H), ker) < 1e-7


def test_plain_f32():
    H = _blocks(512, seed=5).astype(np.float32)
    out = _plain(H)
    assert out.dtype == np.float32 and np.all(np.isfinite(out))
    np.testing.assert_allclose(out, np.asarray(jax_inverse(jnp.asarray(H))),
                               rtol=1e-3, atol=1e-4)


def test_inverse_is_actually_inverse():
    rng = np.random.default_rng(7)
    A = rng.normal(size=(64, 3, 3))
    H = A @ np.transpose(A, (0, 2, 1)) + 0.5 * np.eye(3)
    prod = np.einsum("kij,kjl->kil", H, _plain(H))
    np.testing.assert_allclose(prod, np.tile(np.eye(3), (64, 1, 1)), atol=1e-8)


def test_wrapper_takes_plain_version_only_on_cpu():
    H = torch.from_numpy(_blocks(300, seed=9))
    before = lb.launches
    np.testing.assert_array_equal(lb.invert_landmark_blocks(H).numpy(),
                                  lb.invert_landmark_blocks_plain(H).numpy())
    assert lb.launches == before
    with pytest.raises(ValueError):
        lb.invert_landmark_blocks(H.to("meta"))
