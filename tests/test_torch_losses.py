"""The 15 robust losses and the corrector of the PyTorch port against
apex_tpu.core, on a grid of s that takes every branch: 0, 1e-300, around
each loss's switch points, and 1e6. Tolerance: 1e-12 (f64) or 1e-5 (f32) of
each output's largest value over the grid. A pointwise relative tolerance
means nothing where a loss cancels (Welsch's 1 - exp(-s/c^2), Andrews'
1 - cos at small s) or underflows (XLA flushes f32 subnormals to zero,
torch on the CPU keeps them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.core import corrector as jcorrector
from apex_tpu.core import losses as jlosses
from apex_tpu_torch.core import corrector, losses
from test_torch_jit import one_thread  # noqa: F401 (autouse: one BLAS thread per module)

# each constructor at its defaults, and the parameter sets that take the
# other branches (Barron's Cauchy, L2 and general cases; p of the Lp norm)
CASES = [(name, ()) for name in jlosses.LOSS_BY_NAME] + [
    ("huber", (0.5,)), ("cauchy", (1.0,)), ("tukey_biweight", (1.0,)),
    ("andrews_wave", (0.7,)), ("trimmed_mean", (0.5,)), ("lp_norm", (1.0,)),
    ("lp_norm", (2.0,)), ("barron_general", (-2.0, 1.0)), ("barron_general", (2.0, 1.0)),
    ("barron_general", (1.0, 0.5)), ("barron_general", (4.0, 1.0)),
    ("adaptive_barron", (-1.0, 2.0)), ("t_distribution", (2.0,)),
]
IDS = [f"{name}{'-' + '-'.join(map(str, args)) if args else ''}" for name, args in CASES]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _losses(name, args):
    return losses.LOSS_BY_NAME[name](*args), jlosses.LOSS_BY_NAME[name](*args)


def _grid(loss):
    """s = 0, 1e-300, a sweep from 1e-12 to 1e6, and 1 ± 1e-9 times the
    square of each scale-like parameter (and of pi times it)."""
    s = [0.0, 1e-300, 1e6] + list(10.0 ** np.linspace(-12, 5, 35))
    for p in loss.params:
        for c in (abs(p), np.pi * abs(p)):
            s += [c * c * (1 - 1e-9), c * c, c * c * (1 + 1e-9)]
    return np.asarray(s)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name,args", CASES, ids=IDS)
def test_evaluate_matches_apex_tpu(name, args, dtype):
    tl, jl = _losses(name, args)
    assert tl == losses.Loss(jl.kind, tuple(jl.params))
    s = _grid(tl)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    t_out = tl.evaluate(torch.tensor(s, dtype=dtype))
    j_out = jl.evaluate(jnp.asarray(s, dtype=np_dtype))
    for part, t, j in zip(("rho", "rho'", "rho''"), t_out, j_out):
        j = np.asarray(j)
        assert t.dtype == dtype and t.shape == s.shape
        assert torch.isfinite(t).all(), part
        np.testing.assert_allclose(t.numpy(), j, rtol=TOL[dtype],
                                   atol=TOL[dtype] * np.abs(j).max(), err_msg=part)


def test_per_factor_parameters():
    """A [K, P] parameter stack: each row its own loss parameters."""
    s = torch.tensor([0.3, 4.0, 9.0], dtype=torch.float64)
    p = torch.tensor([[1.0], [1.0], [2.0]], dtype=torch.float64)
    rho, rho1, _ = losses.evaluate("huber", p, s)
    jrho, jrho1, _ = jlosses.evaluate("huber", jnp.asarray(p.numpy()), jnp.asarray(s.numpy()))
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=1e-15)
    np.testing.assert_allclose(rho1.numpy(), np.asarray(jrho1), rtol=1e-15)
    np.testing.assert_allclose(rho.numpy(), [0.3, 3.0, 8.0], rtol=1e-15)


def test_tiny_clamp_is_zero_in_f32():
    """rho' of Cauchy at s = inf is max(0, _TINY): _TINY in f64, 0 in f32,
    where the f64 constant underflows, as in the reference."""
    for dtype, np_dtype, want in ((torch.float64, np.float64, losses._TINY),
                                  (torch.float32, np.float32, 0.0)):
        s = torch.tensor([np.inf], dtype=dtype)
        _, rho1, _ = losses.evaluate("cauchy", (1.0,), s)
        _, jrho1, _ = jlosses.evaluate("cauchy", jnp.asarray([1.0], dtype=np_dtype),
                                       jnp.asarray([np.inf], dtype=np_dtype))
        assert float(rho1[0]) == want == float(np.asarray(jrho1)[0])


def test_constructors_and_names():
    assert sorted(losses.LOSS_BY_NAME) == sorted(jlosses.LOSS_BY_NAME)
    for name, make in losses.LOSS_BY_NAME.items():
        t, j = make(), jlosses.LOSS_BY_NAME[name]()
        assert (t.kind, t.params, t.num_params) == (j.kind, tuple(j.params), j.num_params)
        if t.num_params:
            bad = (0.0,) if name not in ("barron_general", "adaptive_barron") else (1.0, 0.0)
            for pkg in (losses, jlosses):
                with pytest.raises(ValueError, match="must be"):
                    pkg.LOSS_BY_NAME[name](*bad)
    for p in (-1.0, 2.5):
        with pytest.raises(ValueError, match="LpNorm"):
            losses.LpNormLoss(p)
    assert losses.loss_by_name("cauchy", 1.0) == losses.CauchyLoss(1.0)
    assert losses.loss_by_name("cauchy") == losses.CauchyLoss()
    with pytest.raises(KeyError):
        losses.Loss("nonesuch")


@pytest.mark.parametrize("name,args", [
    ("trimmed_mean", (1.0,)),  # rho' = 0 outside the scale
    ("tukey_biweight", (1.0,)),  # rho' = 0 outside the scale
    ("andrews_wave", (1.0,)),  # rho'' > 0 below pi/2, rho' = 0 beyond pi
    ("barron_general", (4.0, 1.0)),  # rho'' > 0 everywhere
    ("cauchy", (1.0,)),  # rho'' < 0: the rank-1 correction
    ("l2", ()),
], ids=["trimmed_mean", "tukey", "andrews", "barron_alpha4", "cauchy", "l2"])
def test_corrector_matches_apex_tpu(name, args):
    rng = np.random.default_rng(5)
    r = rng.normal(size=(64, 3)) * 10.0 ** rng.uniform(-3, 1, size=(64, 1))
    r[0] = 0.0
    J = rng.normal(size=(64, 3, 6))
    tl, jl = _losses(name, args)
    p = np.tile(np.asarray(tl.params, dtype=np.float64), (64, 1)).reshape(64, tl.num_params)
    t_coef = corrector.corrector_coefficients(
        tl.kind, torch.from_numpy(p), torch.from_numpy(np.sum(r * r, axis=1)))
    j_coef = jcorrector.corrector_coefficients(jl.kind, jnp.asarray(p), jnp.sum(r * r, axis=1))
    t_r, t_J = corrector.correct(tl.kind, torch.from_numpy(p), torch.from_numpy(r),
                                 torch.from_numpy(J))
    j_r, j_J = jcorrector.correct(jl.kind, jnp.asarray(p), jnp.asarray(r), jnp.asarray(J))
    # alpha / s is compared as alpha: alpha = 1 - sqrt(1 + 2 s rho''/rho')
    # cancels for small s, so one ulp of d is 6e-11 of alpha at s = 3.6e-6
    # (measured), which r r^T (of size s) scales back to an ulp of J~
    s = np.sum(r * r, axis=1)
    t_coef = (*t_coef[:2], t_coef[2] * torch.from_numpy(s))
    j_coef = (*j_coef[:2], j_coef[2] * s)
    for t, j in list(zip(t_coef, j_coef)) + [(t_r, j_r), (t_J, j_J)]:
        assert torch.isfinite(t).all()
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-15)
