"""The JAX package's eight single-device example scripts (``examples/``),
ported. Each is a module with ``main(argv=None)``, run as

    python -m apex_tpu_torch.examples.<name> [--platform cpu|cuda]

``--platform`` is the torch device (default ``cuda``, which raises without a
card; nothing falls back to the CPU), passed to ``Problem.compile``. Each
prints its JAX twin's table letter for letter (times aside) and returns the
rows it prints at full precision: a list of dicts."""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device


def parse(doc: str, argv=None, path_help: str = ""):
    """(arguments, device) of an example; ``path_help`` adds the optional
    positional graph file of the two graph-file examples."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    if path_help:
        p.add_argument("path", nargs="?", default=None, help=path_help)
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="torch device (default cuda; no fallback to cpu)")
    args = p.parse_args(argv)
    return args, resolve_device(args.platform)


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def result_row(res) -> dict:
    """A ``SolverResult``'s printed fields at full precision."""
    return dict(status=res.status.name, iterations=res.iterations,
                initial_cost=res.initial_cost, final_cost=res.final_cost)
