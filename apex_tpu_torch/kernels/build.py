"""The build of the port's CUDA sources: ``nvcc`` into a shared library with
a plain C interface under ``build/apex_tpu_torch/``, loaded with ``ctypes``.

Each library is built once per source and flag set (its file name carries
a hash of both), at the first call that needs it; a concurrent build in
another process writes its own temporary file and renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def shared_library(name: str, flags=NVCC_FLAGS) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` with ``flags`` unless the library of this
    source and flag set is built already, and load it."""
    source = CSRC / f"{name}.cu"
    tag = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {source.name} failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def current_stream(device_index: int) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on a device
    index, as an int (what Triton's launcher uses); no stream is made."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device_index)
