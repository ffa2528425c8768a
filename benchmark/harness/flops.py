"""The yardstick of the compute-bound kernel metrics: published FP64 peaks
per card, and the floating-point operations each kernel's work needs,
counted from its shapes."""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, FP64 tensor core, dense, at the full 700 W limit
FP64_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 67e12,
}


def cholesky_solve_flops(n) -> float:
    """One dense Cholesky factorization of an n x n matrix (n^3 / 3) and the
    two triangular solves of one right-hand side with its factor (2 n^2)."""
    return n ** 3 / 3.0 + 2.0 * n ** 2


def share_of_fp64_peak(device_kind, flops, seconds):
    """The least time the operations take at the card's FP64 peak over the
    measured time, in percent; None for a card with no entry."""
    peak = FP64_PEAK_FLOPS.get(device_kind)
    if peak is None or not seconds:
        return None
    return 100.0 * (flops / peak) / seconds
