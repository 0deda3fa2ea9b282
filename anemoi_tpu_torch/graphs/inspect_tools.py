"""Graph statistics, sparse export and an overview plot.

Copy of ``anemoi_tpu.graphs.inspect_tools``: degree and length statistics
per edge set, each edge set as a scipy sparse matrix, and
:func:`plot_graph` (matplotlib, imported when it draws).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import scipy.sparse as sp

from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.graphs.transforms import great_circle_distance


def edge_statistics(graph: Graph) -> Dict[str, dict]:
    """Degree / length statistics per edge set."""
    out = {}
    for (src, dst), es in graph.edges.items():
        in_deg = np.bincount(es.edge_index[1], minlength=graph[dst].num_nodes)
        out_deg = np.bincount(es.edge_index[0], minlength=graph[src].num_nodes)
        lengths = great_circle_distance(
            graph[src].coords[es.edge_index[0]], graph[dst].coords[es.edge_index[1]]
        )
        out[f"{src}->{dst}"] = {
            "num_edges": es.num_edges,
            "in_degree": {"min": int(in_deg.min()), "mean": float(in_deg.mean()),
                          "max": int(in_deg.max())},
            "out_degree": {"min": int(out_deg.min()), "mean": float(out_deg.mean()),
                           "max": int(out_deg.max())},
            "length_rad": {"min": float(lengths.min()), "mean": float(lengths.mean()),
                           "max": float(lengths.max())},
            "isolated_dst": int((in_deg == 0).sum()),
        }
    return out


def export_to_sparse(graph: Graph, output_dir: str) -> Dict[str, str]:
    """Save each edge set as a scipy CSR matrix ``<src>__to__<dst>.npz``:
    matrix[dst, src] = the edge's first one-column attribute, else 1."""
    os.makedirs(output_dir, exist_ok=True)
    written = {}
    for (src, dst), es in graph.edges.items():
        weights = np.ones(es.num_edges, dtype=np.float32)
        for attr in es.attributes.values():
            if attr.ndim == 2 and attr.shape[1] == 1:
                weights = attr[:, 0].astype(np.float32)
                break
        mat = sp.csr_matrix(
            (weights, (es.edge_index[1], es.edge_index[0])),
            shape=(graph[dst].num_nodes, graph[src].num_nodes),
        )
        path = os.path.join(output_dir, f"{src}__to__{dst}.npz")
        sp.save_npz(path, mat)
        written[f"{src}->{dst}"] = path
    return written


def plot_graph(graph: Graph, output_path: str, max_points: int = 20000) -> str:
    """Node scatter maps and in-degree histograms in one figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_node_sets = len(graph.nodes)
    n_edge_sets = len(graph.edges)
    fig, axes = plt.subplots(
        2, max(n_node_sets, n_edge_sets), figsize=(5 * max(n_node_sets, n_edge_sets), 8)
    )
    axes = np.atleast_2d(axes)

    for i, (name, ns) in enumerate(graph.nodes.items()):
        ax = axes[0, i]
        coords = np.rad2deg(ns.coords)
        if len(coords) > max_points:
            sel = np.random.default_rng(0).choice(len(coords), max_points, replace=False)
            coords = coords[sel]
        ax.scatter(coords[:, 1], coords[:, 0], s=0.5)
        ax.set_title(f"nodes '{name}' ({ns.num_nodes})")
        ax.set_xlabel("lon")
        ax.set_ylabel("lat")

    for i, ((src, dst), es) in enumerate(graph.edges.items()):
        ax = axes[1, i]
        in_deg = np.bincount(es.edge_index[1], minlength=graph[dst].num_nodes)
        ax.hist(in_deg, bins=30)
        ax.set_title(f"in-degree {src}->{dst} (E={es.num_edges})")

    fig.tight_layout()
    fig.savefig(output_path, dpi=100)
    plt.close(fig)
    return output_path
