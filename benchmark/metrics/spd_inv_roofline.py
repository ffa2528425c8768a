"""spd_inv_roofline: the SPD clamped block inverse
(``kernels.spd_inverse.spd_clamped_inv``, the Schur-Jacobi preconditioner's
blocks) at the cell's [cameras, 9, 9] and dtype, timed alone after the
window by CUDA events over many calls, as a share of the least time its
bytes take at the card's HBM bandwidth (the blocks read once, the inverses
written once). Bundle-adjustment cells only."""

import torch

from harness import roofline


def read(record):
    if record.kind != "bundle_adjustment" or record.device.type != "cuda":
        return None
    from apex_tpu_torch.kernels.spd_inverse import spd_clamped_inv

    C, n = record.data["focals"].shape[0], 9
    gen = torch.Generator(device=record.device).manual_seed(0)
    A = torch.randn((C, n, n), generator=gen, dtype=record.dtype, device=record.device)
    blocks = A @ A.mT + n * torch.eye(n, dtype=record.dtype, device=record.device)
    seconds = record.time_kernel(spd_clamped_inv, (blocks,))
    return roofline.share_of_bandwidth(
        record.device_kind, roofline.spd_inverse_bytes(C, n, record.dtype), seconds)
