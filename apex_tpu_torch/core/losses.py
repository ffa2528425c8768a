"""Robust losses (counterpart of ``apex_tpu/core/losses.py``).

Each loss maps the squared residual norm ``s = ||r||^2`` to
``(rho(s), rho'(s), rho''(s))`` elementwise, with per-factor parameters
``p [..., nparams]``. The port has L2 and Huber, the two the
bundle-adjustment path uses; the other 13 kernels are ROADMAP A.4.
"""

from __future__ import annotations

import dataclasses

import torch

_EPS = 2.220446049250313e-16  # f64 machine epsilon, as the reference uses
_TINY = 2.2250738585072014e-308  # f64::MIN_POSITIVE

_NOT_PORTED = ("l1", "cauchy", "fair", "geman_mcclure", "welsch",
               "tukey_biweight", "andrews_wave", "ramsay_ea", "trimmed_mean",
               "lp_norm", "barron_general", "t_distribution", "adaptive_barron")


def _l2(s, p):
    return s, torch.ones_like(s), torch.zeros_like(s)


def _huber(s, p):
    scale = p[..., 0]
    scale2 = scale * scale
    out = s > scale2
    safe = torch.clamp_min(s, _EPS)
    r = torch.sqrt(safe)
    rho1_out = torch.clamp_min(scale / r, _TINY)
    rho = torch.where(out, 2.0 * scale * r - scale2, s)
    rho1 = torch.where(out, rho1_out, torch.ones_like(s))
    rho2 = torch.where(out, -rho1_out / (2.0 * safe), torch.zeros_like(s))
    return rho, rho1, rho2


_KERNELS = {"l2": (_l2, 0), "huber": (_huber, 1)}


def _kernel(kind: str):
    if kind in _KERNELS:
        return _KERNELS[kind]
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"loss {kind!r} is not ported yet (ROADMAP A.4); the port has l2 and huber")
    raise KeyError(f"unknown loss {kind!r}")


def evaluate(kind: str, params, s):
    """Evaluate loss ``kind`` elementwise: s (...,) -> (rho, rho', rho'')."""
    fn, nparams = _kernel(kind)
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
        _kernel(self.kind)

    @property
    def num_params(self) -> int:
        return _KERNELS[self.kind][1]


def L2Loss() -> Loss:
    return Loss("l2")


def HuberLoss(scale: float = 1.345) -> Loss:
    if not scale > 0:
        raise ValueError(f"Huber scale must be positive, got {scale}")
    return Loss("huber", (scale,))


def loss_by_name(name: str, scale: float) -> Loss:
    """The CLI's ``--loss``/``--loss-scale`` pair as a Loss."""
    return HuberLoss(scale) if name == "huber" else Loss(name)
