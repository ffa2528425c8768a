"""SPD-clamped block inverse: the CUDA kernel ``csrc/spd_clamped_inv.cu`` and
its plain PyTorch version.

It computes ``apex_tpu/linalg/utils.py::spd_clamped_inv``, which the JAX
package leaves to XLA: a batched symmetric inverse with the eigenvalues
clamped to ``rel_floor * max(max|w|, 1)``, so that the result is SPD (the
entity-merged Schur-Jacobi blocks can be indefinite, and PCG does not
tolerate an indefinite preconditioner). The floors are the JAX package's:
1e-12 relative in f64, 1e-6 in f32. Both versions read the lower triangle
of each block, as ``torch.linalg.eigh`` does.

``spd_clamped_inv`` launches the kernel for every CUDA tensor, f32 and
f64, in python mode and in jit mode, and counts each launch in
``launches``; under CUDA graph capture it counts in ``captured`` instead,
and ``optim/graphs.py`` counts the replayed launches. It takes the plain
version only for a tensor on the CPU. Callers reach it through this
module (``spd_inverse.spd_clamped_inv``), so a run can wrap it to see the
shapes its path gives it. ``torch.linalg.eigh`` on the card reads its error flag back, so
the plain version cannot be captured; the kernel reads nothing back.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

SOURCE = _build.CSRC / "spd_clamped_inv.cu"
# the warp kernel takes blocks up to WARP_N; larger ones, up to MAX_N, go to
# the CTA kernel, which works in a scratch of 2 n^2 + n values per block
WARP_N = 32
MAX_N = 1024

launches = 0
captured = 0

_fns: dict = {}
_config = None


def build() -> dict:
    """Compile the kernel (once per source and flag set), load it and bind
    its entry points: ``{dtype: C function}``."""
    global _config
    if _fns:
        return _fns
    lib = _build.shared_library("spd_clamped_inv")
    for dtype, name in ((torch.float32, "spd_clamped_inv_f32"),
                        (torch.float64, "spd_clamped_inv_f64")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    _config = lib.spd_clamped_inv_config
    _config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    _config.restype = ctypes.c_int
    return _fns


def launch_config(dtype, n) -> dict:
    """Blocks per CTA (a warp each up to ``WARP_N``), threads and dynamic
    shared bytes per CTA, and the sweep cap for blocks of size ``n``."""
    build()
    info = (ctypes.c_int * 4)()
    err = _config(int(dtype == torch.float64), n, info)
    if err != 0:
        raise RuntimeError(f"spd_clamped_inv config failed: CUDA error {err}")
    return dict(zip(("blocks_per_cta", "threads", "shared_bytes", "sweep_cap"), info))


def default_floor(dtype) -> float:
    return 1e-6 if dtype == torch.float32 else 1e-12


def spd_clamped_inv_plain(blocks, rel_floor=None):
    """The plain PyTorch version: eigh, clamp, V diag(1/w) V^T."""
    if blocks.numel() == 0:
        return blocks
    if rel_floor is None:
        rel_floor = default_floor(blocks.dtype)
    w, V = torch.linalg.eigh(blocks)
    floor = torch.clamp_min(torch.amax(torch.abs(w), dim=-1, keepdim=True), 1.0)
    w = torch.maximum(w, rel_floor * floor)
    return (V / w[..., None, :]) @ V.transpose(-1, -2)


def spd_clamped_inv(blocks, rel_floor=None):
    """[B, n, n] symmetric blocks -> their SPD-clamped inverses. A CUDA
    tensor goes through the kernel (f32 or f64, n <= 1024); a CPU tensor
    through the plain version."""
    global launches, captured
    if blocks.device.type == "cpu":
        return spd_clamped_inv_plain(blocks, rel_floor)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if blocks.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"blocks must be float32 or float64, got {blocks.dtype}")
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be [B, n, n], got {tuple(blocks.shape)}")
    B, n = blocks.shape[0], blocks.shape[1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"block size {n} outside the kernel's 1..{MAX_N}")
    if rel_floor is None:
        rel_floor = default_floor(blocks.dtype)
    x = blocks.contiguous()
    out = torch.empty_like(x)
    if B == 0:
        return out
    work = x.new_empty(B * (2 * n * n + n)) if n > WARP_N else None
    fn = (_fns or build())[x.dtype]
    index = x.get_device()
    err = fn(x.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(), B, n,
             float(rel_floor), index, _build.current_stream(index))
    if err != 0:
        raise RuntimeError(f"spd_clamped_inv kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out
