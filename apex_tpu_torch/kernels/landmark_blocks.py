"""Landmark-block inverse: the CUDA kernel ``csrc/landmark_blocks.cu`` and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``apex_tpu/kernels/landmark_blocks.py::
invert_landmark_blocks_pallas``. Both versions compute the XLA formulation
``apex_tpu/linalg/schur.py::invert_landmark_blocks``: the eigenvalue-
conditioned regularized inverse of symmetric 3x3 blocks, ``[P,3,3] ->
[P,3,3]``.

``invert_landmark_blocks`` launches the kernel for every CUDA tensor, f32
and f64, at every size, and counts each launch in ``launches``. Under CUDA
graph capture the launch is recorded into the graph, not made: it counts in
``captured`` instead, and each replay of that graph counts its recorded
launches (``optim/graphs.py``). It takes the plain version only for a
tensor on the CPU. The kernel is built with ``nvcc``
into ``build/apex_tpu_torch/`` at first use and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "landmark_blocks.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

# Kernel launches made by invert_landmark_blocks since import (or since a
# caller last set it to 0), and launches it recorded into CUDA graphs.
launches = 0
captured = 0

# Blocks per tile of the kernel (its kThreads): the bulk copies move whole
# tiles, and the masked edge takes the last P mod TILE blocks.
TILE = 256

# {dtype: C entry point} and PyTorch's current-stream lookup, bound by build().
_fns: dict = {}
_stream = None
_config = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build() -> dict:
    """Compile the kernel (once per source and flag set), load it and bind
    its entry points: ``{dtype: C function}``."""
    global _stream, _config
    if _fns:
        return _fns
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"liblandmark_blocks_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for dtype, name in ((torch.float32, "invert_landmark_blocks_f32"),
                        (torch.float64, "invert_landmark_blocks_f64")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    _config = lib.invert_landmark_blocks_config
    _config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    _config.restype = ctypes.c_int
    # the raw cudaStream_t of PyTorch's current stream on a device index, as
    # an int (what Triton's launcher uses); no torch.cuda.Stream is made
    _stream = torch._C._cuda_getCurrentRawStream
    return _fns


def launch_config(dtype, device=0) -> dict:
    """The kernel's launch configuration for ``dtype`` on a CUDA device
    index: blocks per tile, stages, shared bytes, SMs, resident CTAs per SM
    and registers per thread."""
    build()
    info = (ctypes.c_int * 7)()
    err = _config(int(dtype == torch.float64), device, info)
    if err != 0:
        raise RuntimeError(f"invert_landmark_blocks config failed: CUDA error {err}")
    keys = ("tile_blocks", "in_stages", "out_stages", "shared_bytes", "sms",
            "ctas_per_sm", "registers")
    return dict(zip(keys, info))


def _thresholds(dtype):
    """(eig_floor, cond_max, rel): the reference's f64 constants, about
    their square roots in f32."""
    return (1e-5, 1e6, 1e-5) if dtype == torch.float32 else (1e-12, 1e10, 1e-8)


def sym3x3_eigvals(A):
    """Closed-form eigenvalues of symmetric 3x3 blocks (trigonometric
    method), (..., 3); diagonal blocks (p2 < 1e-30) give their diagonal."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) * (a00 - q) + (a11 - q) * (a11 - q) + (a22 - q) * (a22 - q) + 2.0 * p1
    # the 1e-300 floor underflows to 0 in f32; the diagonal branch below is
    # a select, so the NaN it then gives is never used
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-300))
    diag_only = p2 < 1e-30

    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = (A - q[..., None, None] * eye) / p[..., None, None]
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    eigs = torch.stack([e1, e2, e3], dim=-1)
    diag = torch.stack([a00, a11, a22], dim=-1)
    return torch.where(diag_only[..., None], diag, eigs)


def inv3x3(A):
    """Batched 3x3 inverse by adjugate / determinant."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.stack([
        torch.stack([A11, A12, A13], dim=-1),
        torch.stack([A21, A22, A23], dim=-1),
        torch.stack([A31, A32, A33], dim=-1),
    ], dim=-2)
    return adj * (1.0 / det)[..., None, None]


def invert_landmark_blocks_plain(Hpp):
    """The plain PyTorch version: ill-conditioned or near-singular blocks get
    a scaled identity added before the inverse."""
    eig_floor, cond_max, rel = _thresholds(Hpp.dtype)
    eigs = sym3x3_eigvals(Hpp)
    emin = torch.amin(eigs, dim=-1)
    emax = torch.amax(eigs, dim=-1)
    bad = (emin < eig_floor) | (emax > cond_max * torch.clamp_min(emin, eig_floor * 1e-3))
    reg = torch.where(bad, torch.abs(emin) + rel * torch.clamp_min(emax, 1.0) + eig_floor,
                      torch.zeros_like(emin))
    eye = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    return inv3x3(Hpp + reg[..., None, None] * eye)


def invert_landmark_blocks(Hpp):
    """[P,3,3] symmetric blocks -> regularized inverses [P,3,3]. A CUDA
    tensor goes through the kernel (contiguous, 16-byte aligned, f32 or f64
    required); a CPU tensor through the plain version."""
    global launches, captured
    if Hpp.device.type == "cpu":
        return invert_landmark_blocks_plain(Hpp)
    if Hpp.device.type != "cuda":
        raise ValueError(f"unsupported device {Hpp.device}")
    if Hpp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"landmark blocks must be float32 or float64, got {Hpp.dtype}")
    if Hpp.dim() != 3 or tuple(Hpp.shape[1:]) != (3, 3):
        raise ValueError(f"landmark blocks must be [P, 3, 3], got {tuple(Hpp.shape)}")
    if not Hpp.is_contiguous():
        raise ValueError("landmark blocks must be contiguous")
    P = Hpp.shape[0]
    out = torch.empty_like(Hpp)
    if P == 0:
        return out
    if Hpp.data_ptr() % 16:
        raise ValueError("landmark blocks must start at a 16-byte aligned address "
                         "(the kernel's bulk copies need it)")
    fn = (_fns or build())[Hpp.dtype]
    index = Hpp.get_device()
    err = fn(Hpp.data_ptr(), out.data_ptr(), P, index, _stream(index))
    if err != 0:
        raise RuntimeError(f"invert_landmark_blocks kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out
