"""Pose-graph container of the G2O and TORO loaders (counterpart of
``apex_tpu/io/graph.py``): vertices and edges with measurement and
information matrix. The information matrix serves the chi^2 report only;
the optimizer minimizes unweighted between-factor residuals, as the JAX
package does.

Storage: SE2 ``[x, y, theta]``; SE3 ``[tx, ty, tz, qw, qx, qy, qz]``
(w-first; g2o files are qx, qy, qz, qw and are converted on load).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.profiling import annotate


@dataclasses.dataclass
class Edge:
    frm: int
    to: int
    measurement: np.ndarray  # [3] SE2 or [7] SE3 storage
    information: np.ndarray  # [3, 3] or [6, 6]


@dataclasses.dataclass
class Graph:
    vertices_se2: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    vertices_se3: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    edges_se2: List[Edge] = dataclasses.field(default_factory=list)
    edges_se3: List[Edge] = dataclasses.field(default_factory=list)

    @property
    def is_se3(self) -> bool:
        return len(self.vertices_se3) > 0

    @property
    def num_vertices(self) -> int:
        return len(self.vertices_se2) + len(self.vertices_se3)

    @property
    def num_edges(self) -> int:
        return len(self.edges_se2) + len(self.edges_se3)

    def _parts(self):
        if self.is_se3:
            return "SE3", self.vertices_se3, self.edges_se3
        return "SE2", self.vertices_se2, self.edges_se2

    @annotate("graph.to_problem")
    def to_problem(self, loss=None, fix_first: bool = False):
        """A Problem with one BetweenFactor per edge; vertex i is variable
        ``x{i}``."""
        from ..core.problem import Problem
        from ..factors.between import BetweenFactor

        manifold, vertices, edges = self._parts()
        problem = Problem()
        for vid in sorted(vertices):
            problem.add_variable(f"x{vid}", manifold, vertices[vid])
        for e in edges:
            problem.add_residual_block(
                [f"x{e.frm}", f"x{e.to}"],
                BetweenFactor(manifold, e.measurement), loss)
        if fix_first and vertices:
            problem.fix_variable(f"x{sorted(vertices)[0]}")
        return problem

    def chi2(self, values: Optional[Dict[str, np.ndarray]] = None) -> float:
        """Information-weighted chi^2 = sum r^T Omega r with
        r = Log(T_meas^{-1} (T_i^{-1} T_j)), in f64 on the CPU."""
        from ..manifolds import get as get_manifold

        manifold, vertices, edges = self._parts()
        if not edges:
            return 0.0
        G = get_manifold(manifold)

        def val(vid):
            return values[f"x{vid}"] if values is not None else vertices[vid]

        def stack(rows):
            return torch.from_numpy(np.stack(rows).astype(np.float64))

        xi = stack([val(e.frm) for e in edges])
        xj = stack([val(e.to) for e in edges])
        meas = stack([e.measurement for e in edges])
        infos = stack([e.information for e in edges])
        r = G.log(G.compose(G.inverse(meas), G.compose(G.inverse(xi), xj)))
        return float(torch.einsum("ki,kij,kj->", r, infos, r))


def upper_tri_to_full(vals, n):
    """Row-major upper-triangular values -> symmetric full matrix."""
    M = np.zeros((n, n))
    iu = np.triu_indices(n)
    M[iu] = np.asarray(vals, dtype=np.float64)
    M.T[iu] = M[iu]
    return M


def full_to_upper_tri(M):
    return list(np.asarray(M)[np.triu_indices(M.shape[0])])
