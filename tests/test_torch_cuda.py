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
    """Random SPD blocks plus a near-singular, a zero and a 1e12-scaled
    block (at 5, 17 and 100, or modulo n when there are fewer)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 3, 3))
    H = A @ np.transpose(A, (0, 2, 1)) + 0.1 * np.eye(3)
    H[5 % n] = np.diag([1e-15, 1.0, 1.0])  # near-singular
    H[17 % n] = np.zeros((3, 3))  # fully degenerate
    H[100 % n] *= 1e12  # huge scale
    return H


def _assert_bitwise_plain(H, k):
    p = lb.invert_landmark_blocks_plain(H)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    assert torch.equal(k, p), f"max abs diff {(k - p).abs().max().item()}"


T = lb.TILE


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [1, 2, 3, T - 1, T, T + 1, 2 * T + 3, 65_132])
def test_kernel_matches_plain(card, dtype, P):
    """Every tile count and ragged edge: bitwise the plain version, one
    launch per call."""
    H = torch.as_tensor(_blocks(P, seed=11), dtype=dtype, device=card)
    before = lb.launches
    k = lb.invert_landmark_blocks(H)
    assert lb.launches == before + 1
    _assert_bitwise_plain(H, k)


def test_kernel_needs_16_byte_alignment(card):
    H = torch.as_tensor(_blocks(300, seed=4), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="aligned"):
        lb.invert_landmark_blocks(H[1:])  # 72 B past the allocation


@pytest.mark.parametrize("dtype,skip", [(torch.float64, 2), (torch.float32, 4)])
def test_kernel_takes_aligned_views(card, dtype, skip):
    H = torch.as_tensor(_blocks(2 * T + 7, seed=5), dtype=dtype, device=card)
    view = H[skip:]  # 144 B past the allocation
    assert view.data_ptr() % 16 == 0
    _assert_bitwise_plain(view, lb.invert_landmark_blocks(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_config(card, dtype):
    c = lb.launch_config(dtype)
    assert c["tile_blocks"] == lb.TILE
    assert c["ctas_per_sm"] >= 1 and c["sms"] >= 1


def test_compile_defaults_to_the_card(card):
    ds = synthetic.synthetic_ba(n_cameras=4, n_points=40, seed=1)
    cp = build_ba_problem(ds).compile()
    assert cp.device.type == "cuda"
    # optimize(Problem) compiles with those defaults: the kernel launches
    cfg = apx.LevenbergMarquardtConfig(linear_solver_type="schur_implicit", max_iterations=2)
    before = lb.launches
    apx.LevenbergMarquardt(cfg).optimize(build_ba_problem(ds))
    assert lb.launches > before


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
