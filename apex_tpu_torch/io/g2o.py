"""G2O reader and writer in plain Python (counterpart of
``apex_tpu/io/g2o.py``; its native C++ parser is not ported):

- ``VERTEX_SE2 id x y theta``
- ``VERTEX_SE3:QUAT id x y z qx qy qz qw`` (stored w-first)
- ``EDGE_SE2 i j dx dy dtheta`` + 6 upper-triangular information values
- ``EDGE_SE3:QUAT i j tx ty tz qx qy qz qw`` + 21 upper-triangular values

Other tags are skipped. Quaternions are normalized on load; a norm below
1e-3 or not finite is rejected.
"""

from __future__ import annotations

import numpy as np

from .graph import Edge, Graph, full_to_upper_tri, upper_tri_to_full


def _norm_quat_wfirst(qx, qy, qz, qw, where=""):
    q = np.array([qw, qx, qy, qz])
    n = np.linalg.norm(q)
    if not np.isfinite(n) or n < 1e-3:
        raise ValueError(f"invalid quaternion norm {n} {where}")
    return q / n


def load_g2o(path) -> Graph:
    g = Graph()
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            try:
                if tag == "VERTEX_SE2":
                    g.vertices_se2[int(parts[1])] = np.array([float(x) for x in parts[2:5]])
                elif tag == "VERTEX_SE3:QUAT":
                    t = [float(x) for x in parts[2:5]]
                    q = _norm_quat_wfirst(*(float(x) for x in parts[5:9]),
                                          where=f"line {lineno}")
                    g.vertices_se3[int(parts[1])] = np.array(t + list(q))
                elif tag == "EDGE_SE2":
                    meas = np.array([float(x) for x in parts[3:6]])
                    info = upper_tri_to_full([float(x) for x in parts[6:12]], 3)
                    g.edges_se2.append(Edge(int(parts[1]), int(parts[2]), meas, info))
                elif tag == "EDGE_SE3:QUAT":
                    t = [float(x) for x in parts[3:6]]
                    q = _norm_quat_wfirst(*(float(x) for x in parts[6:10]),
                                          where=f"line {lineno}")
                    info = upper_tri_to_full([float(x) for x in parts[10:31]], 6)
                    g.edges_se3.append(
                        Edge(int(parts[1]), int(parts[2]), np.array(t + list(q)), info))
            except (IndexError, ValueError, TypeError) as e:
                raise ValueError(f"{path}:{lineno}: malformed {tag} line: {e}") from e
    return g


def save_g2o(path, graph: Graph):
    with open(path, "w") as f:
        for vid in sorted(graph.vertices_se2):
            x, y, th = graph.vertices_se2[vid]
            f.write(f"VERTEX_SE2 {vid} {x:.17e} {y:.17e} {th:.17e}\n")
        for vid in sorted(graph.vertices_se3):
            v = graph.vertices_se3[vid]
            # storage [t, qw, qx, qy, qz] -> file x y z qx qy qz qw
            f.write(f"VERTEX_SE3:QUAT {vid} {v[0]:.17e} {v[1]:.17e} {v[2]:.17e} "
                    f"{v[4]:.17e} {v[5]:.17e} {v[6]:.17e} {v[3]:.17e}\n")
        for e in graph.edges_se2:
            vals = " ".join(f"{x:.17e}" for x in full_to_upper_tri(e.information))
            m = e.measurement
            f.write(f"EDGE_SE2 {e.frm} {e.to} {m[0]:.17e} {m[1]:.17e} {m[2]:.17e} {vals}\n")
        for e in graph.edges_se3:
            vals = " ".join(f"{x:.17e}" for x in full_to_upper_tri(e.information))
            m = e.measurement
            f.write(f"EDGE_SE3:QUAT {e.frm} {e.to} {m[0]:.17e} {m[1]:.17e} {m[2]:.17e} "
                    f"{m[4]:.17e} {m[5]:.17e} {m[6]:.17e} {m[3]:.17e} {vals}\n")
