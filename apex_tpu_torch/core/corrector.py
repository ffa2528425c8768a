"""Ceres-style corrector (counterpart of ``apex_tpu/core/corrector.py``):
rescale residuals and rank-1-correct Jacobians so the robustified problem
becomes reweighted least squares.

    s = ||r||^2,  sqrt_rho1 = sqrt(rho'(s))
    if s == 0 or rho'' <= 0: residual_scaling = sqrt_rho1, alpha/s = 0
    else: alpha = 1 - sqrt(max(1 + 2 s rho''/rho', 0)),
          residual_scaling = sqrt_rho1 / (1 - alpha), alpha_sq_norm = alpha / s
    r~ = residual_scaling r,   J~ = sqrt_rho1 (J - alpha_sq_norm r r^T J)

``r`` is (..., d) and ``J`` (..., d, n).
"""

from __future__ import annotations

import torch

from .losses import evaluate


def corrector_coefficients(kind: str, params, s):
    """(sqrt_rho1, residual_scaling, alpha_sq_norm), elementwise in s."""
    _, rho1, rho2 = evaluate(kind, params, s)
    sqrt_rho1 = torch.sqrt(rho1)
    trivial = (s == 0.0) | (rho2 <= 0.0)
    safe_s = torch.where(s == 0.0, torch.ones_like(s), s)
    safe_rho1 = torch.where(rho1 == 0.0, torch.ones_like(rho1), rho1)
    d = torch.clamp_min(1.0 + 2.0 * s * rho2 / safe_rho1, 0.0)
    alpha = 1.0 - torch.sqrt(d)
    residual_scaling = torch.where(trivial, sqrt_rho1, sqrt_rho1 / (1.0 - alpha))
    alpha_sq_norm = torch.where(trivial, torch.zeros_like(s), alpha / safe_s)
    return sqrt_rho1, residual_scaling, alpha_sq_norm


def correct(kind: str, params, r, J=None):
    """Apply the corrector to r (..., d) and optionally J (..., d, n).
    Returns (r_tilde, J_tilde_or_None)."""
    s = torch.sum(r * r, dim=-1)
    sqrt_rho1, residual_scaling, alpha_sq_norm = corrector_coefficients(kind, params, s)
    r_tilde = residual_scaling[..., None] * r
    if J is None:
        return r_tilde, None
    rTJ = torch.einsum("...d,...dn->...n", r, J)
    J_tilde = sqrt_rho1[..., None, None] * (
        J - alpha_sq_norm[..., None, None] * r[..., :, None] * rTJ[..., None, :]
    )
    return r_tilde, J_tilde
