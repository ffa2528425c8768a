"""The ``ctypes`` binding of ``csrc/trace_stamp.cu``: the device phase stamps
of ``utils/profiling.py`` (``%globaltimer`` read where a traced span opens
and closes on a stream, capturable into a CUDA graph).

Each function raises ``RuntimeError`` with the CUDA error's name when its
entry point fails. The library is built with ``nvcc`` into
``build/apex_tpu_torch/`` at first use (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes

from . import build as _build

SOURCE = _build.CSRC / "trace_stamp.cu"
# int64 slots per phase row: summed ns, occurrences, open time, first open,
# last close, and one spare (rows of 48 bytes)
ROW = 6
_lib = None


def build():
    """Compile (once per source and flag set), load and bind the library."""
    global _lib
    if _lib is None:
        lib = _build.shared_library("trace_stamp")
        for name in ("ts_open", "ts_close", "ts_now"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            fn.restype = ctypes.c_int
        lib.ts_error_string.argtypes = [ctypes.c_int]
        lib.ts_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _call(name, ptr, device):
    lib = _lib or build()
    err = getattr(lib, name)(ptr, _build.current_stream(device), device)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           f"({lib.ts_error_string(err).decode()})")


def open_(row_ptr, device):
    """Enqueue the open stamp of the phase row at ``row_ptr`` on the
    current stream of ``device``."""
    _call("ts_open", row_ptr, device)


def close(row_ptr, device):
    """Enqueue the close stamp of the phase row at ``row_ptr``."""
    _call("ts_close", row_ptr, device)


def now(out_ptr, device):
    """Enqueue a write of ``%globaltimer`` to the int64 at ``out_ptr``."""
    _call("ts_now", out_ptr, device)
