"""A one-axis process mesh over ``torch.distributed``: the port's
counterpart of ``jax.sharding.Mesh`` with its ``axis_name``.

One rank is one process, and every cross-device sum of the JAX package
(``jax.lax.psum``) is ``ProcessMesh.all_reduce``. The sharded steps use
``all_reduce`` only, so the same code runs

- on gloo ranks on the CPU;
- on gloo ranks that share one card (gloo reduces CUDA tensors through
  host memory; NCCL refuses two ranks on one card);
- on an NCCL world with one card per rank.

Nothing picks a backend or a device by probing: ``launch`` takes both, and
asking for ``"cuda"`` without a card raises (``device.resolve_device``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device

BACKENDS = ("gloo", "nccl")
# a rank that waits longer than this in a collective raises
TIMEOUT = datetime.timedelta(minutes=10)


class ProcessMesh:
    """This process's place in an initialized process group: ``rank``,
    ``size`` and ``device``, and the sum over the ranks.

    ``all_reduces``, ``all_reduce_bytes`` and ``all_reduce_seconds`` count
    every ``all_reduce`` since construction (or since a caller set them to
    0). The seconds are host time around the collective; with ``timed``
    the device is synchronized before and after each one, so that they
    hold the collective alone."""

    def __init__(self, group=None, device="cuda", timed: bool = False):
        self.device = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialized torch.distributed "
                               "process group (see parallel.mesh.launch)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.timed = timed
        self.all_reduces = 0
        self.all_reduce_bytes = 0
        self.all_reduce_seconds = 0.0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``. Every rank
        gets the same bits."""
        sync = self.timed and t.is_cuda
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        if sync:
            torch.cuda.synchronize(t.device)
        self.all_reduce_seconds += time.perf_counter() - t0
        self.all_reduces += 1
        self.all_reduce_bytes += t.numel() * t.element_size()
        return t

    def all_reduce_many(self, *tensors):
        """Sum several tensors of one dtype over the ranks with one
        collective (packed into one flat buffer); returns new tensors of
        the same shapes."""
        buf = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce(buf)
        out, at = [], 0
        for t in tensors:
            out.append(buf[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return tuple(out)


def rank_device(backend: str, device, rank: int) -> torch.device:
    """The device of ``rank``: under NCCL card ``rank`` (one card per
    rank); under gloo ``device`` itself, shared by every rank (``"cuda"``
    is card 0)."""
    dev = torch.device(device)
    if backend == "nccl":
        return torch.device("cuda", rank)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def _check_world(n_ranks: int, backend: str, device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be at least 1, got {n_ranks}")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs device 'cuda'")
        if torch.cuda.device_count() < n_ranks:
            raise RuntimeError(
                f"nccl needs one card per rank: {n_ranks} ranks, "
                f"{torch.cuda.device_count()} cards (gloo ranks may share a card)")


def _rank_main(rank, n_ranks, backend, device, store, fn, args, timed):
    dev = rank_device(backend, device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}/store",
                            world_size=n_ranks, rank=rank, timeout=TIMEOUT,
                            device_id=dev if backend == "nccl" else None)
    try:
        result = fn(ProcessMesh(device=dev, timed=timed), *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(store, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(fn, n_ranks: int, backend: str, device, *args, timed: bool = False):
    """Run ``fn(mesh, *args)`` on ``n_ranks`` new processes (start method
    ``spawn``), one rank each, and return the ranks' results in rank order.

    ``backend`` is ``"nccl"`` (``device="cuda"``, one card per rank: raises
    where there are fewer cards than ranks) or ``"gloo"`` (the CPU, or
    ranks that share ``device``). The ranks meet through a file store in a
    new temporary directory, not a TCP port, so that worlds started at
    once never collide. ``fn`` and ``args`` are pickled (``fn`` by its
    import path) and each result is pickled back; an exception in a rank
    raises here. ``timed`` is ``ProcessMesh``'s."""
    _check_world(n_ranks, backend, device)
    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_mesh_") as store:
        mp.start_processes(_rank_main, args=(n_ranks, backend, str(device), store, fn, args,
                                             timed),
                           nprocs=n_ranks, join=True, start_method="spawn")
        results = []
        for r in range(n_ranks):
            with open(os.path.join(store, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
