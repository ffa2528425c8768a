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


def schur_assemble_bytes(n_obs, n_cameras, n_points, dtype) -> int:
    """The bytes one assembly of the implicit Schur blocks needs, for BAL
    pinhole observations with self-calibration (camera blocks of 9: pose 6,
    focal and two radial terms): per observation its two pixels, its
    weight, its three pool indices (int64) and its coupling W [9, 3]
    written; each variable read once (a camera's 7 pose and 3 intrinsic
    values, a point's 3); the pose's 6 free-parameter flags once per camera
    and the loss parameter once; written once, H_pp and g_p per point (12
    values), H_cc and g_c per camera (90) and the cost. Observations, not
    the program's padded rows, and no intermediate the program chooses to
    store."""
    floats = (n_obs * (2 + 1 + 27) + n_cameras * (7 + 3 + 6 + 90) + n_points * (3 + 12)
              + 1 + 1)
    return floats * itemsize(dtype) + n_obs * 3 * 8


def share_of_bandwidth(device_kind, n_bytes, seconds):
    """The least time the bytes take at the card's HBM bandwidth over the
    measured time, in percent; None for a card with no entry."""
    peak = PEAKS.get(device_kind)
    if peak is None or not seconds:
        return None
    return 100.0 * (n_bytes / peak["hbm_bytes_per_s"]) / seconds
