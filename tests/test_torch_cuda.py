"""Tests of the port that need a CUDA card (marker ``cuda``; they skip
without one). This file imports nothing of JAX, so it also runs where only
PyTorch is installed: ``pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import apex_tpu_torch as apx
from apex_tpu_torch.ba import build_ba_problem
from apex_tpu_torch.io import synthetic
from apex_tpu_torch.kernels import landmark_blocks as lb

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _blocks(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 3, 3))
    H = A @ np.transpose(A, (0, 2, 1)) + 0.1 * np.eye(3)
    H[5] = np.diag([1e-15, 1.0, 1.0])  # near-singular
    H[17] = np.zeros((3, 3))  # fully degenerate
    H[100] *= 1e12  # huge scale
    return H


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain(card, dtype):
    H = torch.as_tensor(_blocks(65_132, seed=11), dtype=dtype, device=card)
    before = lb.launches
    k = lb.invert_landmark_blocks(H)
    p = lb.invert_landmark_blocks_plain(H)
    torch.cuda.synchronize()
    assert lb.launches == before + 1
    kn, pn = k.double().cpu().numpy(), p.double().cpu().numpy()
    assert np.all(np.isfinite(kn))
    if dtype == torch.float64:
        assert np.max(np.abs(kn - pn) / (np.abs(pn) + 1.0)) < 1e-10
    else:
        np.testing.assert_allclose(kn, pn, rtol=1e-3, atol=1e-4)


def test_kernel_rejects_what_it_does_not_take(card):
    H = torch.as_tensor(_blocks(300, seed=2), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        lb.invert_landmark_blocks(H.transpose(1, 2))
    with pytest.raises(TypeError):
        lb.invert_landmark_blocks(H.half())
    with pytest.raises(ValueError, match="3, 3"):
        lb.invert_landmark_blocks(H.reshape(-1, 9))


def test_small_solve_card_matches_cpu(card):
    """Exact inner solves in f64: the card and the CPU take the same LM
    path. CUDA index_add_ sums in atomic order, so costs agree to rounding
    (rtol 1e-8), not bitwise."""
    ds = synthetic.synthetic_ba(n_cameras=8, n_points=150, seed=0)
    problem = build_ba_problem(ds)
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type="schur_implicit", max_iterations=30,
                                       pcg_forcing=False, pcg_tolerance=1e-10,
                                       pcg_max_iterations=500)
    before = lb.launches
    rc = apx.LevenbergMarquardt(cfg).optimize(problem.compile(device=card))
    assert lb.launches - before >= rc.iterations
    rh = apx.LevenbergMarquardt(cfg).optimize(problem.compile(device="cpu"))
    assert (rc.iterations, rc.status) == (rh.iterations, rh.status)
    np.testing.assert_allclose(rc.final_cost, rh.final_cost, rtol=1e-8)
