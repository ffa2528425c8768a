"""landmark_inv_roofline: the landmark-block inverse
(``linalg.schur.landmark_inverse``) at the cell's landmark count and dtype,
timed alone after the window by CUDA events over many calls, as a share of
the least time its bytes take at the card's HBM bandwidth: [P, 3, 3] read
once and written once. Bundle-adjustment cells only."""

import torch

from harness import roofline


def read(record):
    if record.kind != "bundle_adjustment" or record.device.type != "cuda":
        return None
    from apex_tpu_torch.linalg.schur import landmark_inverse

    P = record.data["points"].shape[0]
    gen = torch.Generator(device=record.device).manual_seed(0)
    A = torch.randn((P, 3, 3), generator=gen, dtype=record.dtype, device=record.device)
    blocks = A @ A.mT + torch.eye(3, dtype=record.dtype, device=record.device)
    seconds = record.time_kernel(landmark_inverse, (blocks,))
    return roofline.share_of_bandwidth(
        record.device_kind, roofline.landmark_inverse_bytes(P, record.dtype), seconds)
