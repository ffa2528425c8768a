"""Banded normal equations and block cyclic reduction of the PyTorch port
against apex_tpu.linalg.banded and against dense solves (f64 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.io import synthetic as jax_synthetic
from apex_tpu.linalg import banded as jbanded
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.linalg import banded
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)


def _random_banded_spd(D, half_band, rng):
    """tests/test_banded.py's recipe."""
    A = np.zeros((D, D))
    for i in range(D):
        j0 = max(0, i - half_band + 1)
        A[i, j0:i + 1] = rng.normal(size=i + 1 - j0)
    A = A @ A.T + D * np.eye(D)
    W = 2 * half_band - 1
    mask = np.abs(np.subtract.outer(np.arange(D), np.arange(D))) < W
    return np.where(mask, A, 0.0), W


@pytest.fixture(scope="module")
def sphere300():
    """The same 300-pose sphere compiled by both packages."""
    kw = dict(n_poses=300, rings=10, seed=0)
    cp = synthetic.synthetic_pose_graph_3d(**kw).to_problem().compile(device="cpu")
    jcp = jax_synthetic.synthetic_pose_graph_3d(**kw).to_problem().compile(dtype=np.float64)
    return cp, jcp


def test_block_bandwidth_sphere():
    cp = synthetic.synthetic_pose_graph_3d(n_poses=200, rings=10, seed=0).to_problem().compile(
        device="cpu")
    # odometry (i, i+1) and ring closure (i, i+20): W = 20*6 + 6
    assert banded.block_bandwidth(cp) == 126
    assert banded.default_panel(126) == 128 and banded.default_panel(15) == 16
    assert banded.default_panel(306) == 384 and banded.default_panel(3) == 8


def test_band_plan_matches_apex_tpu(sphere300):
    cp, jcp = sphere300
    asm = banded.BandedNormalAssembler(cp)
    jasm = jbanded.BandedNormalAssembler(jcp)
    assert (asm.W, asm.m, asm.n, asm.D, asm.Dp) == (jasm.W, jasm.m, jasm.n, jasm.D, jasm.Dp)
    np.testing.assert_array_equal(asm._perm.numpy(), np.asarray(jasm._perm))
    np.testing.assert_array_equal(asm._ids.numpy(), np.asarray(jasm._ids))
    assert asm._ids.dtype == torch.int64


def test_assemble_matches_apex_tpu(sphere300):
    """Dg, Cg, g and the cost to 1e-12 of each tensor's largest entry
    (measured: 1.5e-14, 8.7e-14, 7.6e-14; the per-edge residuals already
    differ by ~1e-13 where the two packages round the SE3 chain apart)."""
    cp, jcp = sphere300
    asm = banded.BandedNormalAssembler(cp)
    Dg, Cg, g, cost = asm.assemble(cp.initial_values())
    jDg, jCg, jg, jcost = jbanded.BandedNormalAssembler(jcp).assemble(jcp.initial_values())
    for t_out, j_out in ((Dg, jDg), (Cg, jCg), (g, jg)):
        j_out = np.asarray(j_out)
        np.testing.assert_allclose(t_out.numpy(), j_out, rtol=1e-12,
                                   atol=1e-12 * np.abs(j_out).max())
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-12)
    # the padding identity, on the same input
    padded = asm.pad_diag_ones(torch.from_numpy(np.array(jDg)))
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jbanded.BandedNormalAssembler(jcp).pad_diag_ones(jDg)))


# base_blocks=2 runs the elimination levels; None keeps the default fold
@pytest.mark.parametrize("base_blocks", [2, None])
@pytest.mark.parametrize("D,half_band", [(700, 40), (900, 130), (1500, 160)])
def test_cr_solver_matches_dense(D, half_band, base_blocks):
    rng = np.random.default_rng(D)
    A, W = _random_banded_spd(D, half_band, rng)
    g = rng.normal(size=D)
    solve = banded.make_blocktri_cr_solver(D, W, torch.float64, base_blocks=base_blocks)
    dx = solve(torch.from_numpy(A), torch.from_numpy(g), 0.1).numpy()
    ref = np.linalg.solve(A + 0.1 * np.eye(D), -g)
    assert np.abs(dx - ref).max() / np.abs(ref).max() < 1e-10


def test_cr_solver_f32_with_refinement():
    rng = np.random.default_rng(7)
    A, W = _random_banded_spd(1500, 160, rng)
    g = rng.normal(size=1500)
    solve = banded.make_blocktri_cr_solver(1500, W, torch.float32, base_blocks=2)
    dx = solve(torch.from_numpy(A).float(), torch.from_numpy(g).float(), 0.1).double().numpy()
    ref = np.linalg.solve(A + 0.1 * np.eye(1500), -g)
    assert np.abs(dx - ref).max() / np.abs(ref).max() < 5e-5


@pytest.mark.parametrize("recompute_l0", [False, True])
def test_cr_core_matches_apex_tpu(recompute_l0):
    """The core on a random block-tridiagonal SPD system with 7 blocks
    (odd-count padding at two levels): the same x as the JAX core."""
    rng = np.random.default_rng(3)
    D, m = 7 * 48 - 5, 48
    A, _ = _random_banded_spd(D, 24, rng)
    Ap = np.eye(7 * m)
    Ap[:D, :D] = A
    A4 = Ap.reshape(7, m, 7, m)
    Dg = np.stack([A4[i, :, i] for i in range(7)])
    Cg = np.stack([np.zeros((m, m))] + [A4[i, :, i - 1] for i in range(1, 7)])
    bp = rng.normal(size=(7, m))
    x = banded.make_blocktri_cr_core(D, m, torch.float64, base_blocks=2,
                                     recompute_l0=recompute_l0)(
        *(torch.from_numpy(v) for v in (Dg, Cg, bp)), 1e-3)
    jx = jbanded.make_blocktri_cr_core(D, m, jnp.float64, base_blocks=2,
                                       recompute_l0=recompute_l0)(
        *(jnp.asarray(v) for v in (Dg, Cg, bp)), 1e-3)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-11, atol=1e-13)


def test_retry_ladder_on_indefinite_input_matches_apex_tpu():
    """A shifted down past its smallest eigenvalue, by 1e-3 of its mean
    diagonal after the shift, is indefinite: the first four attempts give
    NaN (no exception), the fifth shift (1e-2 of the mean diagonal) makes
    it definite, in both packages."""
    rng = np.random.default_rng(5)
    D, m = 6 * 32, 32
    A, _ = _random_banded_spd(D, 16, rng)
    lam = np.linalg.eigvalsh(A)[0]
    A = A - (lam + 1e-3 * (np.trace(A) / D - lam)) * np.eye(D)
    A4 = A.reshape(6, m, 6, m)
    Dg = np.stack([A4[i, :, i] for i in range(6)])
    Cg = np.stack([np.zeros((m, m))] + [A4[i, :, i - 1] for i in range(1, 6)])
    bp = rng.normal(size=(6, m))
    x = banded.make_blocktri_cr_core(D, m, torch.float64, base_blocks=2)(
        *(torch.from_numpy(v) for v in (Dg, Cg, bp)))
    jx = np.asarray(jbanded.make_blocktri_cr_core(D, m, jnp.float64, base_blocks=2)(
        *(jnp.asarray(v) for v in (Dg, Cg, bp))))
    assert np.isfinite(jx).all() and torch.isfinite(x).all()
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9, atol=1e-12)
    # the answer is the fifth stage's: (A + 1e-2 mean(diag) I) x = b
    ref = np.linalg.solve(A + 1e-10 * 100 ** 4 * np.trace(A) / D * np.eye(D), bp.reshape(-1))
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-8)


def test_failed_cholesky_is_nan_not_an_exception():
    good = torch.eye(4, dtype=torch.float64) * 2.0
    bad = -torch.eye(4, dtype=torch.float64)
    L = banded._cholesky(torch.stack([good, bad, good]))
    assert torch.isnan(L[1]).all()
    torch.testing.assert_close(L[0], torch.eye(4, dtype=torch.float64) * 2.0 ** 0.5)
    torch.testing.assert_close(L[2], L[0])
