"""Robust losses: the 15 kernels of ``apex_tpu/core/losses.py``.

Each loss maps the squared residual norm ``s = ||r||^2`` to
``(rho(s), rho'(s), rho''(s))`` elementwise, with per-factor parameters
``p [..., nparams]``, so one factor group carries per-factor loss
parameters. Both branches of every ``torch.where`` are evaluated, so each
untaken branch is computed from "safe" inputs, as the reference does, and no
NaN reaches the output. ``_EPS`` and ``_TINY`` are f64 constants: in f32
``clamp_min(x, _TINY)`` clamps at 0, as the reference's weak-typed
``maximum`` does.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

_EPS = 2.220446049250313e-16  # f64 machine epsilon, as the reference uses
_TINY = 2.2250738585072014e-308  # f64::MIN_POSITIVE


def _l2(s, p):
    return s, torch.ones_like(s), torch.zeros_like(s)


def _l1(s, p):
    safe = torch.clamp_min(s, _EPS)
    sqrt_s = torch.sqrt(safe)
    small = s < _EPS
    rho = torch.where(small, s, 2.0 * sqrt_s)
    rho1 = torch.where(small, 1.0, 1.0 / sqrt_s)
    rho2 = torch.where(small, 0.0, -1.0 / (2.0 * safe * sqrt_s))
    return rho, rho1, rho2


def _huber(s, p):
    scale = p[..., 0]
    scale2 = scale * scale
    out = s > scale2
    safe = torch.clamp_min(s, _EPS)
    r = torch.sqrt(safe)
    rho1_out = torch.clamp_min(scale / r, _TINY)
    rho = torch.where(out, 2.0 * scale * r - scale2, s)
    rho1 = torch.where(out, rho1_out, 1.0)
    rho2 = torch.where(out, -rho1_out / (2.0 * safe), 0.0)
    return rho, rho1, rho2


def _cauchy(s, p):
    scale = p[..., 0]
    scale2 = scale * scale
    c = 1.0 / scale2
    ssum = 1.0 + s * c
    inv = 1.0 / ssum
    return scale2 * torch.log(ssum) / 2.0, torch.clamp_min(inv, _TINY), -c * inv * inv


def _fair(s, p):
    scale = p[..., 0]
    small = s < _EPS
    safe = torch.clamp_min(s, _EPS)
    x = torch.sqrt(safe)
    cpx = scale + x
    rho = scale * scale * (x / scale - torch.log1p(x / scale))
    rho1 = 0.5 / cpx
    rho2 = -1.0 / (4.0 * safe * cpx * cpx)
    return (torch.where(small, s, rho), torch.where(small, 1.0, rho1),
            torch.where(small, 0.0, rho2))


def _geman_mcclure(s, p):
    scale = p[..., 0]
    c = 1.0 / (scale * scale)
    inv = 1.0 / (1.0 + s * c)
    inv2 = inv * inv
    return s * inv, inv2, -2.0 * c * inv2 * inv


def _welsch(s, p):
    scale = p[..., 0]
    scale2 = scale * scale
    inv_scale2 = 1.0 / scale2
    e = torch.exp(-s * inv_scale2)
    return (scale2 / 2.0) * (1.0 - e), 0.5 * e, -0.5 * inv_scale2 * e


def _tukey(s, p):
    scale = p[..., 0]
    scale2 = scale * scale
    x = torch.sqrt(torch.clamp_min(s, 0.0))
    out = x > scale
    omr = 1.0 - torch.clamp_max(s / scale2, 1.0)
    omr2 = omr * omr
    rho = torch.where(out, scale2 / 6.0, (scale2 / 6.0) * (1.0 - omr * omr2))
    rho1 = torch.where(out, 0.0, 0.5 * omr2)
    rho2 = torch.where(out, 0.0, -(x / scale / scale2) * omr)
    return rho, rho1, rho2


def _andrews_wave(s, p):
    scale = p[..., 0]
    scale2 = scale * scale
    x = torch.sqrt(torch.clamp_min(s, 0.0))
    out = x > math.pi * scale
    arg = torch.where(out, 0.0, x / scale)
    rho = torch.where(out, 2.0 * scale2, scale2 * (1.0 - torch.cos(arg)))
    rho1 = torch.where(out, 0.0, 0.5 * torch.sin(arg))
    rho2 = torch.where(out, 0.0, (0.25 / scale) * torch.cos(arg) / torch.clamp_min(x, _EPS))
    return rho, rho1, rho2


def _ramsay_ea(s, p):
    scale = p[..., 0]  # 'a'
    x = torch.sqrt(torch.clamp_min(s, 0.0))
    ax = scale * x
    e = torch.exp(-ax)
    rho = (1.0 / (scale * scale)) * (1.0 - e * (1.0 + ax))
    return rho, 0.5 * e, -(scale / (4.0 * torch.clamp_min(x, _EPS))) * e


def _trimmed_mean(s, p):
    scale2 = p[..., 0] * p[..., 0]
    inlier = s <= scale2
    zero = torch.zeros_like(s)
    return torch.where(inlier, s / 2.0, scale2 / 2.0), torch.where(inlier, 0.5, zero), zero


def _lp_norm(s, p):
    e0 = p[..., 0] / 2.0
    e1 = e0 - 1.0
    e2 = e1 - 1.0
    small = s < _EPS
    safe = torch.clamp_min(s, _EPS)
    return (torch.where(small, s, safe ** e0), torch.where(small, 1.0, e0 * safe ** e1),
            torch.where(small, 0.0, e0 * e1 * safe ** e2))


def _barron_general(s, p):
    alpha, scale = p[..., 0], p[..., 1]
    scale2 = scale * scale

    # alpha ~ 0: Cauchy-like
    denom = 1.0 + s / scale2
    inv = 1.0 / denom
    rho_c = (scale2 / 2.0) * torch.log(denom)
    rho1_c = torch.clamp_min(inv, _TINY)
    rho2_c = -inv * inv / scale2

    # general case
    x = torch.sqrt(torch.clamp_min(s, 0.0))
    absa = torch.abs(alpha)
    inner = absa / 2.0 * (x / scale) ** 2 + 1.0
    rho_g = (absa / scale2) * (inner ** (alpha / 2.0) - 1.0)
    rho1_g = 0.5 * inner ** (alpha / 2.0 - 1.0)
    rho2_g = (alpha - 2.0) / (4.0 * scale2) * inner ** (alpha / 2.0 - 2.0)

    is_cauchy = absa < 1e-6
    is_l2 = torch.abs(alpha - 2.0) < 1e-6
    rho = torch.where(is_cauchy, rho_c, torch.where(is_l2, s, rho_g))
    rho1 = torch.where(is_cauchy, rho1_c, torch.where(is_l2, 1.0, rho1_g))
    rho2 = torch.where(is_cauchy, rho2_c, torch.where(is_l2, 0.0, rho2_g))
    return rho, rho1, rho2


def _t_distribution(s, p):
    nu = p[..., 0]
    half = (nu + 1.0) / 2.0
    denom = nu + s
    return half * torch.log(1.0 + s / nu), half / denom, -half / (denom * denom)


_KERNELS = {
    "l2": (_l2, 0),
    "l1": (_l1, 0),
    "huber": (_huber, 1),
    "cauchy": (_cauchy, 1),
    "fair": (_fair, 1),
    "geman_mcclure": (_geman_mcclure, 1),
    "welsch": (_welsch, 1),
    "tukey_biweight": (_tukey, 1),
    "andrews_wave": (_andrews_wave, 1),
    "ramsay_ea": (_ramsay_ea, 1),
    "trimmed_mean": (_trimmed_mean, 1),
    "lp_norm": (_lp_norm, 1),
    "barron_general": (_barron_general, 2),
    "t_distribution": (_t_distribution, 1),
    "adaptive_barron": (_barron_general, 2),
}


@functools.lru_cache(maxsize=None)
def _params_tensor(params: tuple, dtype, device) -> torch.Tensor:
    """A loss's parameter tuple as a tensor, built once per dtype and device
    (a host-to-device copy, which a captured CUDA graph cannot hold)."""
    return torch.tensor(params, dtype=dtype, device=device)


def evaluate(kind: str, params, s):
    """Evaluate loss ``kind`` elementwise: s (...,) -> (rho, rho', rho'')."""
    fn, nparams = _KERNELS[kind]
    if isinstance(params, tuple):
        params = _params_tensor(params, s.dtype, s.device)
    else:
        params = torch.as_tensor(params, dtype=s.dtype, device=s.device)
    if nparams and params.ndim == 1 and params.shape[0] == nparams:
        params = params.expand(s.shape + (nparams,))
    return fn(s, params)


@dataclasses.dataclass(frozen=True)
class Loss:
    """Robust loss descriptor (kind + parameter vector)."""

    kind: str
    params: tuple = ()

    def __post_init__(self):
        if self.kind not in _KERNELS:
            raise KeyError(f"unknown loss {self.kind!r}")

    def evaluate(self, s):
        return evaluate(self.kind, self.params, s)

    @property
    def num_params(self) -> int:
        return _KERNELS[self.kind][1]


def _check_positive(name, value):
    if not value > 0:
        raise ValueError(f"{name} scale must be positive, got {value}")


def L2Loss() -> Loss:
    return Loss("l2")


def L1Loss() -> Loss:
    return Loss("l1")


def HuberLoss(scale: float = 1.345) -> Loss:
    _check_positive("Huber", scale)
    return Loss("huber", (scale,))


def CauchyLoss(scale: float = 2.3849) -> Loss:
    _check_positive("Cauchy", scale)
    return Loss("cauchy", (scale,))


def FairLoss(scale: float = 1.3998) -> Loss:
    _check_positive("Fair", scale)
    return Loss("fair", (scale,))


def GemanMcClureLoss(scale: float = 1.0) -> Loss:
    _check_positive("GemanMcClure", scale)
    return Loss("geman_mcclure", (scale,))


def WelschLoss(scale: float = 2.9846) -> Loss:
    _check_positive("Welsch", scale)
    return Loss("welsch", (scale,))


def TukeyBiweightLoss(scale: float = 4.6851) -> Loss:
    _check_positive("TukeyBiweight", scale)
    return Loss("tukey_biweight", (scale,))


def AndrewsWaveLoss(scale: float = 1.339) -> Loss:
    _check_positive("AndrewsWave", scale)
    return Loss("andrews_wave", (scale,))


def RamsayEaLoss(scale: float = 0.3) -> Loss:
    _check_positive("RamsayEa", scale)
    return Loss("ramsay_ea", (scale,))


def TrimmedMeanLoss(scale: float = 2.0) -> Loss:
    _check_positive("TrimmedMean", scale)
    return Loss("trimmed_mean", (scale,))


def LpNormLoss(p: float = 1.5) -> Loss:
    if not 0.0 < p <= 2.0:
        raise ValueError(f"LpNorm p must be in (0, 2], got {p}")
    return Loss("lp_norm", (p,))


def BarronGeneralLoss(alpha: float = 0.0, scale: float = 1.0) -> Loss:
    _check_positive("Barron", scale)
    return Loss("barron_general", (alpha, scale))


def TDistributionLoss(nu: float = 5.0) -> Loss:
    _check_positive("TDistribution nu", nu)
    return Loss("t_distribution", (nu,))


def AdaptiveBarronLoss(alpha: float = 0.0, scale: float = 1.0) -> Loss:
    _check_positive("AdaptiveBarron", scale)
    return Loss("adaptive_barron", (alpha, scale))


LOSS_BY_NAME = {
    "l2": L2Loss,
    "l1": L1Loss,
    "huber": HuberLoss,
    "cauchy": CauchyLoss,
    "fair": FairLoss,
    "geman_mcclure": GemanMcClureLoss,
    "welsch": WelschLoss,
    "tukey_biweight": TukeyBiweightLoss,
    "andrews_wave": AndrewsWaveLoss,
    "ramsay_ea": RamsayEaLoss,
    "trimmed_mean": TrimmedMeanLoss,
    "lp_norm": LpNormLoss,
    "barron_general": BarronGeneralLoss,
    "t_distribution": TDistributionLoss,
    "adaptive_barron": AdaptiveBarronLoss,
}


def loss_by_name(name: str, scale: float | None = None) -> Loss:
    """The CLIs' ``--loss``/``--loss-scale`` pair as a Loss: the
    constructor's default parameters when ``scale`` is None, else ``scale``
    as its first argument."""
    fn = LOSS_BY_NAME[name]
    return fn() if scale is None else fn(scale)
