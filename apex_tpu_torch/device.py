"""Device and dtype policy of the PyTorch port.

- f64 is the default compile dtype, as in ``apex_tpu`` (the H100 has native
  FP64, so it is also the parity mode on the card), f32 under
  ``APEX_TPU_NO_X64=1`` (``config.default_dtype``). f32 is the speed mode.
- The device is always explicit. ``"cuda"`` on a machine without CUDA raises:
  nothing probes for a card and carries on on the CPU.
- TF32 is off for matmuls and cuDNN: it keeps about three decimal digits,
  which silently destroys normal equations of a second-order solver.
"""

from __future__ import annotations

import torch

from .config import default_dtype


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``"cpu"``, ``"cuda"``, ``"cuda:N"`` or a ``torch.device``; a CUDA
    device that this machine does not have raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {str(dev)!r} does not exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cpu or cuda)")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """``None`` (``config.default_dtype()``: f64 unless ``APEX_TPU_NO_X64=1``)
    or ``torch.float32`` / ``torch.float64``."""
    if dtype is None:
        return default_dtype()
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype!r} (torch.float32 or torch.float64)")
    return dtype
