"""The yardstick of the kernel metrics: published peaks per card, and the
bytes each kernel's work needs, counted from its shapes (each input byte
read once, each output byte written once)."""

from __future__ import annotations

import torch

# NVIDIA's data sheet, H100 SXM, dense rates, at the full 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def landmark_inverse_bytes(n_blocks, dtype) -> int:
    """[P, 3, 3] symmetric blocks in, [P, 3, 3] inverses out."""
    return 2 * n_blocks * 9 * itemsize(dtype)


def spd_inverse_bytes(n_blocks, n, dtype) -> int:
    """[B, n, n] blocks in, [B, n, n] clamped inverses out."""
    return 2 * n_blocks * n * n * itemsize(dtype)


def share_of_bandwidth(device_kind, n_bytes, seconds):
    """The least time the bytes take at the card's HBM bandwidth over the
    measured time, in percent; None for a card with no entry."""
    peak = PEAKS.get(device_kind)
    if peak is None or not seconds:
        return None
    return 100.0 * (n_bytes / peak["hbm_bytes_per_s"]) / seconds
