"""Factor-graph Graphviz export (port of :mod:`uslam_tpu.eval.graphviz`):
the reference's ``graph.saveGraph("graph.dot")`` (batch.py:338), variable
nodes x_i, v_i, b, l_j and one box node per factor."""

from __future__ import annotations

import numpy as np

from uslam_tpu_torch.graph.builder import GraphArrays


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def graph_to_dot(graph: GraphArrays, num_poses: int, num_landmarks: int) -> str:
    lines = ["graph factor_graph {", "  node [shape=circle];"]
    for i in range(num_poses):
        lines.append(f'  x{i} [label="x{i}"];')
        lines.append(f'  v{i} [label="v{i}"];')
    lines.append('  b0 [label="b"];')
    for j in range(num_landmarks):
        lines.append(f'  l{j} [label="l{j}", shape=point];')
    lines.append('  node [shape=box, style=filled, fillcolor=gray, width=0.15, label=""];')

    factors = [("x0",), ("v0",)]                    # pose and velocity priors
    if float(_np(graph.priors.bias_weight)) > 0:
        factors.append(("b0",))
    for k in np.nonzero(_np(graph.imu.mask) > 0)[0]:
        factors.append((f"x{k}", f"v{k}", f"x{k+1}", f"v{k+1}", "b0"))
    for i in np.nonzero(_np(graph.dvl.mask) > 0)[0]:
        factors.append((f"v{i}", f"x{i}"))
    cam, lm = _np(graph.stereo.cam_idx), _np(graph.stereo.lm_idx)
    for f in np.nonzero(_np(graph.stereo.mask) > 0)[0]:
        factors.append((f"x{cam[f]}", f"l{lm[f]}"))
    for fid, vars_ in enumerate(factors):
        lines.append(f"  f{fid};")
        lines += [f"  f{fid} -- {v};" for v in vars_]
    lines.append("}")
    return "\n".join(lines)


def save_graph_dot(path: str, graph: GraphArrays, num_poses: int, num_landmarks: int) -> None:
    with open(path, "w") as f:
        f.write(graph_to_dot(graph, num_poses, num_landmarks))
