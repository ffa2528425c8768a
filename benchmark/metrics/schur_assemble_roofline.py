"""schur_assemble_roofline: the assembly kernels' share of their roofline,
in percent: the least time the bytes of one assembly of the implicit Schur
blocks take at the card's HBM bandwidth (``roofline.schur_assemble_bytes``,
from the cell's observations, cameras and points), over the device time
stamped in ``schur.assemble>schur.assemble_kernel`` (every group's kernel
calls) per ``schur.assemble`` of the traced pass. None off the card."""

import numpy as np

from harness import roofline, trace


def read(record):
    t = trace.usable(record)
    if t is None or record.kind != "bundle_adjustment":
        return None
    kernel_ns = trace.phase_ns(t, "schur.assemble>schur.assemble_kernel")
    assembles = trace.phase_count(t, "schur.assemble")
    if not kernel_ns or not assembles:
        return None
    data = record.data
    n_bytes = roofline.schur_assemble_bytes(
        data["observations"].shape[0], np.unique(data["cam_indices"]).size,
        np.unique(data["point_indices"]).size, record.dtype)
    return roofline.share_of_bandwidth(record.device_kind, n_bytes, kernel_ns / 1e9 / assembles)
