"""Graph visualisation (matplotlib).

Copy of ``anemoi_tpu.graphs.plotting``: static figures (PNG/PDF by
extension) of a graph's attribute distributions, node maps and sub-graph
edge maps; matplotlib is imported when a figure is drawn.

- :func:`plot_distribution_node_attributes` / `..._edge_attributes` --
  histogram grid of every attribute of every node/edge set
- :func:`plot_nodes` -- lat/lon scatter of one node set, optionally coloured
  by an attribute
- :func:`plot_subgraph` -- edge map of one edge set, subsampled for
  readability
- :func:`plot_isolated_nodes` -- nodes with no incident edges
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from anemoi_tpu_torch.graphs.graph import Graph

LOGGER = logging.getLogger(__name__)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")  # headless
    import matplotlib.pyplot as plt

    return plt


def _deg(coords_rad: np.ndarray) -> tuple:
    lat = np.rad2deg(coords_rad[:, 0])
    lon = np.rad2deg(coords_rad[:, 1])
    lon = np.where(lon > 180.0, lon - 360.0, lon)
    return lat, lon


def plot_nodes(
    graph: Graph,
    nodes_name: str,
    attribute: Optional[str] = None,
    out_file: Optional[str] = None,
    s: float = 1.0,
):
    """Lat/lon scatter of one node set, coloured by ``attribute`` if given."""
    plt = _mpl()
    ns = graph[nodes_name]
    lat, lon = _deg(ns.coords)
    fig, ax = plt.subplots(figsize=(10, 5))
    c = None
    if attribute is not None:
        c = np.asarray(ns.attributes[attribute]).reshape(len(lat), -1)[:, 0]
    sc = ax.scatter(lon, lat, c=c, s=s, cmap="viridis")
    if attribute is not None:
        fig.colorbar(sc, ax=ax, label=attribute)
    ax.set_xlim(-180, 180)
    ax.set_ylim(-90, 90)
    ax.set_xlabel("lon")
    ax.set_ylabel("lat")
    ax.set_title(f"{nodes_name} ({ns.num_nodes} nodes)")
    if out_file:
        fig.savefig(out_file, dpi=150, bbox_inches="tight")
        plt.close(fig)
        LOGGER.info("Wrote %s", out_file)
    return fig


def plot_subgraph(
    graph: Graph,
    edges_key: tuple,
    out_file: Optional[str] = None,
    max_edges: int = 3000,
    seed: int = 0,
):
    """Edge map of one (src, dst) edge set; subsampled to ``max_edges`` for
    readability.  Antimeridian-crossing edges are dropped from the render
    (they would draw across the map)."""
    plt = _mpl()
    src_name, dst_name = edges_key[0], edges_key[-1]
    es = graph[tuple(edges_key)] if len(edges_key) != 2 else graph[edges_key]
    src_lat, src_lon = _deg(graph[src_name].coords)
    dst_lat, dst_lon = _deg(graph[dst_name].coords)
    ei = es.edge_index
    if ei.shape[1] > max_edges:
        rng = np.random.default_rng(seed)
        keep = rng.choice(ei.shape[1], size=max_edges, replace=False)
        ei = ei[:, keep]
    x0, y0 = src_lon[ei[0]], src_lat[ei[0]]
    x1, y1 = dst_lon[ei[1]], dst_lat[ei[1]]
    ok = np.abs(x1 - x0) < 180.0
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(
        np.stack([x0[ok], x1[ok]]), np.stack([y0[ok], y1[ok]]),
        color="tab:blue", lw=0.3, alpha=0.5,
    )
    ax.scatter(x1, y1, s=1.0, color="tab:red", zorder=3)
    ax.set_xlim(-180, 180)
    ax.set_ylim(-90, 90)
    ax.set_title(f"{src_name} -> {dst_name} ({es.num_edges} edges)")
    if out_file:
        fig.savefig(out_file, dpi=150, bbox_inches="tight")
        plt.close(fig)
        LOGGER.info("Wrote %s", out_file)
    return fig


def plot_isolated_nodes(graph: Graph, out_file: Optional[str] = None):
    """Highlight nodes with no incident edge in any edge set."""
    plt = _mpl()
    fig, axes = plt.subplots(
        1, max(len(graph.nodes), 1), figsize=(6 * max(len(graph.nodes), 1), 4),
        squeeze=False,
    )
    for ax, (name, ns) in zip(axes[0], graph.nodes.items()):
        connected = np.zeros(ns.num_nodes, dtype=bool)
        for (src, dst), es in graph.edges.items():
            if src == name:
                connected[es.edge_index[0]] = True
            if dst == name:
                connected[es.edge_index[1]] = True
        lat, lon = _deg(ns.coords)
        ax.scatter(lon[connected], lat[connected], s=0.5, color="lightgray")
        ax.scatter(
            lon[~connected], lat[~connected], s=4.0, color="tab:red",
            label=f"{(~connected).sum()} isolated",
        )
        ax.legend(loc="lower left")
        ax.set_title(name)
    if out_file:
        fig.savefig(out_file, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def _attr_histograms(sets: dict, kind: str, out_file: Optional[str]):
    plt = _mpl()
    rows = [
        (str(name), attr_name, np.asarray(vals, dtype=np.float64).reshape(-1))
        for name, obj in sets.items()
        for attr_name, vals in obj.attributes.items()
        if np.issubdtype(np.asarray(vals).dtype, np.number)
    ]
    n = max(len(rows), 1)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
    for ax, (set_name, attr_name, vals) in zip(axes[0], rows):
        ax.hist(vals[np.isfinite(vals)], bins=40, color="tab:blue")
        ax.set_title(f"{set_name}\n{attr_name}", fontsize=8)
    fig.suptitle(f"{kind} attribute distributions")
    if out_file:
        fig.savefig(out_file, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_distribution_node_attributes(graph: Graph, out_file: Optional[str] = None):
    """Histogram grid of every numeric node attribute."""
    return _attr_histograms(dict(graph.nodes), "node", out_file)


def plot_distribution_edge_attributes(graph: Graph, out_file: Optional[str] = None):
    """Histogram grid of every numeric edge attribute."""
    sets = {f"{s}->{d}": es for (s, d), es in graph.edges.items()}
    return _attr_histograms(sets, "edge", out_file)
