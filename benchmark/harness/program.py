"""The system under test, driven through its public API only:
``apex_tpu_torch.ba.build_ba_problem`` and ``Graph.to_problem`` build a
``Problem``, ``Problem.compile`` places it on the device, and
``LevenbergMarquardt(config).optimize`` solves it. The inputs reach the
program through its own in-memory types, ``BalDataset`` and ``Graph``.

The program is imported inside the functions, so that the harness's own
modules load without it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}
BAL_FIELDS = ("rotations", "translations", "focals", "k1", "k2", "points", "cam_indices",
              "point_indices", "observations")


@dataclasses.dataclass
class Answer:
    """What one solve returned, as the caller reads it."""

    status: str
    iterations: int
    initial_cost: float
    final_cost: float
    variables: dict  # name -> host array


def to_input(kind, data):
    """The generator's arrays as the program's data type."""
    if kind == "bundle_adjustment":
        from apex_tpu_torch.io.bal import BalDataset

        return BalDataset(**{k: data[k] for k in BAL_FIELDS})
    from apex_tpu_torch.io.graph import Edge, Graph

    from .generators import INFO_WEIGHT

    info = np.diag([INFO_WEIGHT] * 6)
    graph = Graph()
    graph.vertices_se3 = dict(enumerate(data["vertices"]))
    graph.edges_se3 = [Edge(int(i), int(j), m, info) for i, j, m in
                       zip(data["src"], data["dst"], data["measurements"])]
    return graph


def build(kind, source, build_options):
    """A ``Problem`` from the program's data type."""
    if kind == "bundle_adjustment":
        from apex_tpu_torch.ba import build_ba_problem

        return build_ba_problem(source, **build_options)
    return source.to_problem(**build_options)


def compile_problem(problem, solver, device):
    return problem.compile(dtype=DTYPES[solver["dtype"]], device=device)


def solver(solver_options):
    """A new ``LevenbergMarquardt`` with the configuration's fields (those
    the harness reads itself, ``optimizer`` and ``dtype``, left out)."""
    import apex_tpu_torch as apx

    fields = {k: v for k, v in solver_options.items() if k not in ("optimizer", "dtype")}
    return apx.LevenbergMarquardt(apx.LevenbergMarquardtConfig(**fields))


def answer(result):
    return Answer(result.status.name, int(result.iterations), float(result.initial_cost),
                  float(result.final_cost), result.variables)


def host_reads():
    from apex_tpu_torch.optim import graphs

    return graphs.host_reads


def set_launch_hook(hook):
    """Wrap each launch of a parent CUDA graph (None removes the hook)."""
    from apex_tpu_torch.optim import graphs

    graphs.launch_hook = hook
