"""TORO reader and writer, SE2 only (counterpart of ``apex_tpu/io/toro.py``):

- ``VERTEX2 id x y theta``
- ``EDGE2 i j dx dy dtheta I11 I12 I22 I33 I13 I23`` (TORO's information
  order)
"""

from __future__ import annotations

import numpy as np

from .graph import Edge, Graph


def load_toro(path) -> Graph:
    g = Graph()
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            try:
                if tag == "VERTEX2":
                    g.vertices_se2[int(parts[1])] = np.array([float(x) for x in parts[2:5]])
                elif tag == "EDGE2":
                    meas = np.array([float(x) for x in parts[3:6]])
                    i11, i12, i22, i33, i13, i23 = (float(x) for x in parts[6:12])
                    info = np.array([[i11, i12, i13], [i12, i22, i23], [i13, i23, i33]])
                    g.edges_se2.append(Edge(int(parts[1]), int(parts[2]), meas, info))
            except (IndexError, ValueError) as e:
                raise ValueError(f"{path}:{lineno}: malformed {tag} line: {e}") from e
    return g


def save_toro(path, graph: Graph):
    if graph.is_se3:
        raise ValueError("the TORO writer takes SE2 graphs only")
    with open(path, "w") as f:
        for vid in sorted(graph.vertices_se2):
            x, y, th = graph.vertices_se2[vid]
            f.write(f"VERTEX2 {vid} {x:.17e} {y:.17e} {th:.17e}\n")
        for e in graph.edges_se2:
            m, I = e.measurement, e.information
            f.write(f"EDGE2 {e.frm} {e.to} {m[0]:.17e} {m[1]:.17e} {m[2]:.17e} "
                    f"{I[0, 0]:.17e} {I[0, 1]:.17e} {I[1, 1]:.17e} {I[2, 2]:.17e} "
                    f"{I[0, 2]:.17e} {I[1, 2]:.17e}\n")
