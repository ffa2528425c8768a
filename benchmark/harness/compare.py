"""The comparison that decides ``correct``: each answer the program gave is
held to the reference's solve of the same inputs, number by number, each
against a limit of its own (``benchmark/limits/<cell>.json``), and every
answer of the window to the quality gate its traffic states.

Numbers, each the worst over the answers compared:

- ``status_mismatches``: answers whose status differs from the reference's;
- ``iteration_gap``: |LM iterations - the reference's|;
- ``initial_cost_rel``, ``final_cost_rel``: |cost - reference cost| over the
  reference cost, at the start and at the end;
- ``x_gap``: the widest gap between what the returned variables and the
  reference's say, measured where the problem fixes them: for bundle
  adjustment the observations they predict, in pixels (the scale of the
  scene and its trade with the focal lengths are all but free, so the
  variables themselves differ along those directions by rounding); for
  pose graphs each pose relative to the first (the gauge is free), per
  column over the largest magnitude of that column in the reference;
- ``cost_at_x_rel``: the reference's cost at the returned variables against
  the cost the program reported with them, over the reference cost.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import lie

CONVERGED = {"CONVERGED", "COST_TOLERANCE_REACHED", "PARAMETER_TOLERANCE_REACHED",
             "GRADIENT_TOLERANCE_REACHED", "MIN_COST_THRESHOLD_REACHED"}
ORDER = ("status_mismatches", "iteration_gap", "initial_cost_rel", "final_cost_rel", "x_gap",
         "cost_at_x_rel")


def point_new_ids(point_indices, n_points):
    """The program's landmark numbering (its documented layout): landmarks
    bucket-major by observation count rounded up to a power of two, then by
    original index, unobserved ones last. -> new id of each original point."""
    counts = np.bincount(point_indices, minlength=n_points)
    caps = np.maximum(1, 2 ** np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64))
    order = np.lexsort((np.arange(n_points), np.where(counts > 0, caps, np.int64(1) << 62)))
    new = np.empty(n_points, dtype=np.int64)
    new[order] = np.arange(n_points)
    return new


def program_arrays(kind, data, variables):
    """The program's returned variables in the reference's layout."""
    if kind == "bundle_adjustment":
        C = data["focals"].shape[0]
        new = point_new_ids(data["point_indices"], data["points"].shape[0])
        return (np.stack([variables[f"pose_{i:04d}"] for i in range(C)]),
                np.stack([variables[f"intr_{i:04d}"] for i in range(C)]),
                np.stack([variables[f"pt_{j:05d}"] for j in new]))
    return (np.stack([variables[f"x{i}"] for i in range(data["vertices"].shape[0])]),)


def _relative_poses(vertices, sign_of=None):
    """Each pose relative to the first; the quaternion's sign that of
    ``sign_of``'s row (q and -q are one rotation)."""
    v = torch.as_tensor(vertices, dtype=torch.float64)
    rel = lie.se3_between(v[:1], v)
    q = rel[:, 3:]
    if sign_of is not None:
        q = torch.where(torch.sum(q * torch.as_tensor(sign_of[:, 3:]), -1, keepdim=True) < 0, -q, q)
    return torch.cat([rel[:, :3], q], -1).numpy()


def x_gap(kind, prog, ref, ref_problem):
    if kind == "bundle_adjustment":
        dev, dt = ref_problem.x0[0].device, ref_problem.x0[0].dtype

        def predicted(arrays):
            return ref_problem.predict(tuple(torch.as_tensor(a, dtype=torch.float64, device=dev)
                                             .to(dt) for a in arrays))

        gap = float(torch.max(torch.abs(predicted(prog) - predicted(ref))))
        return gap if math.isfinite(gap) else math.inf
    b = _relative_poses(ref[0])
    a = _relative_poses(prog[0], sign_of=b)
    scale = np.abs(b).max(axis=0)
    gap = float((np.abs(a - b).max(axis=0) / np.where(scale > 0, scale, 1.0)).max())
    return gap if math.isfinite(gap) else math.inf


def _rel(a, b):
    d = abs(a - b) / abs(b) if b else abs(a - b)
    return d if math.isfinite(d) else math.inf


def numbers(kind, cases):
    """``cases``: (data, reference result, reference problem, [answers]) with
    the answers' variables where they were kept (else None)."""
    out = dict.fromkeys(ORDER, 0.0)
    for data, ref, ref_problem, answers in cases:
        for ans in answers:
            out["status_mismatches"] += ans.status != ref.status
            out["iteration_gap"] = max(out["iteration_gap"], abs(ans.iterations - ref.iterations))
            out["initial_cost_rel"] = max(out["initial_cost_rel"],
                                          _rel(ans.initial_cost, ref.initial_cost))
            out["final_cost_rel"] = max(out["final_cost_rel"], _rel(ans.final_cost, ref.final_cost))
            arrays = getattr(ans, "arrays", None)
            if arrays is None:
                if ans.variables is None:
                    continue
                arrays = program_arrays(kind, data, ans.variables)
            out["x_gap"] = max(out["x_gap"], x_gap(kind, arrays, ref.values, ref_problem))
            dev, dt = ref_problem.x0[0].device, ref_problem.x0[0].dtype
            at_x = float(ref_problem.cost(tuple(torch.as_tensor(a, dtype=dt, device=dev)
                                                for a in arrays)))
            out["cost_at_x_rel"] = max(out["cost_at_x_rel"],
                                       abs(at_x - ans.final_cost) / abs(ref.final_cost))
    return out


def gate_numbers(gate, answers, n_obs):
    """The traffic's quality gate over every answer of the window."""
    out = {}
    if "rmse_px_below" in gate:
        out["rmse_px"] = max((math.sqrt(a.final_cost / n) for a, n in zip(answers, n_obs)),
                             default=math.inf)
    if "max_cost_left" in gate:
        out["cost_left"] = max((a.final_cost / a.initial_cost for a in answers), default=math.inf)
    if gate.get("converged"):
        out["not_converged"] = float(sum(a.status not in CONVERGED for a in answers))
    return out


def gate_limits(gate):
    return {"rmse_px": gate.get("rmse_px_below"), "cost_left": gate.get("max_cost_left"),
            "not_converged": 0.0}


def checks(values, limits):
    """[(name, value, limit, ok)]: ``rmse_px`` must stay below its limit,
    every other number at or below it; a NaN fails."""
    rows = []
    for name, value in values.items():
        limit = limits[name]
        ok = value < limit if name == "rmse_px" else value <= limit
        rows.append((name, value, limit, bool(ok)))
    return rows
