"""Heterogeneous graph container.

Copy of ``anemoi_tpu.graphs.graph``: a numpy-backed container of named node
sets and named directed edge sets.  Edges are stored **sorted by destination
node** with a CSR ``dst_ptr`` (the invariant the attention kernel reads).
:meth:`Graph.save` / :meth:`Graph.load` use the JAX package's flat ``.npz``
layout (no pickle), so either package loads a graph the other wrote.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

EdgeKey = Tuple[str, str]  # (src_nodes_name, dst_nodes_name)


@dataclass
class NodeSet:
    """A named set of nodes with lat/lon coordinates (radians) and attributes."""

    coords: np.ndarray  # [num_nodes, 2] (lat, lon) in radians
    attributes: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return int(self.coords.shape[0])


@dataclass
class EdgeSet:
    """A named set of directed edges between two node sets.

    ``edge_index`` is ``[2, num_edges]`` with row 0 = src, row 1 = dst.
    Once :meth:`sort_by_dst` has run, edges are ordered by destination and
    ``dst_ptr`` is the CSR pointer over destinations
    (``dst_ptr[d]:dst_ptr[d+1]`` are the edges into destination ``d``).
    """

    edge_index: np.ndarray  # [2, num_edges] int64
    attributes: Dict[str, np.ndarray] = field(default_factory=dict)
    dst_ptr: Optional[np.ndarray] = None  # [num_dst + 1] when dst-sorted

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def is_dst_sorted(self) -> bool:
        return self.dst_ptr is not None

    def sort_by_dst(self, num_dst: int) -> "EdgeSet":
        """Return a copy with edges stably sorted by destination + CSR pointer."""
        order = np.argsort(self.edge_index[1], kind="stable")
        ei = self.edge_index[:, order]
        attrs = {k: v[order] for k, v in self.attributes.items()}
        counts = np.bincount(ei[1], minlength=num_dst)
        dst_ptr = np.zeros(num_dst + 1, dtype=np.int64)
        np.cumsum(counts, out=dst_ptr[1:])
        return EdgeSet(edge_index=ei, attributes=attrs, dst_ptr=dst_ptr)

    def attribute_matrix(self, names: Optional[list] = None) -> np.ndarray:
        """Concatenate named edge attributes into a [num_edges, F] feature matrix."""
        keys = names if names is not None else sorted(self.attributes)
        cols = [self.attributes[k] for k in keys]
        cols = [v[:, None] if v.ndim == 1 else v for v in cols]
        if not cols:
            return np.zeros((self.num_edges, 0), dtype=np.float32)
        return np.concatenate(cols, axis=-1).astype(np.float32)


class Graph:
    """Named node sets + named directed edge sets."""

    def __init__(self) -> None:
        self.nodes: Dict[str, NodeSet] = {}
        self.edges: Dict[EdgeKey, EdgeSet] = {}

    def __getitem__(self, key):
        """``graph["data"]`` is a NodeSet, ``graph[("data", "hidden")]`` an EdgeSet."""
        return self.nodes[key] if isinstance(key, str) else self.edges[key]

    def __setitem__(self, key, value) -> None:
        if isinstance(key, str):
            if not isinstance(value, NodeSet):
                raise TypeError(f"nodes[{key!r}] must be a NodeSet")
            self.nodes[key] = value
            return
        if not isinstance(value, EdgeSet):
            raise TypeError(f"edges[{key!r}] must be an EdgeSet")
        self.edges[tuple(key)] = value

    def node_names(self) -> list:
        return list(self.nodes)

    def save(self, path: str) -> None:
        arrays: Dict[str, np.ndarray] = {}
        meta = {"nodes": {}, "edges": {}}
        for name, ns in self.nodes.items():
            arrays[f"n|{name}|coords"] = ns.coords
            meta["nodes"][name] = {"attributes": sorted(ns.attributes)}
            for k, v in ns.attributes.items():
                arrays[f"n|{name}|a|{k}"] = v
        for (src, dst), es in self.edges.items():
            base = f"e|{src}|{dst}"
            arrays[f"{base}|edge_index"] = es.edge_index
            if es.dst_ptr is not None:
                arrays[f"{base}|dst_ptr"] = es.dst_ptr
            meta["edges"][f"{src}|{dst}"] = {"attributes": sorted(es.attributes)}
            for k, v in es.attributes.items():
                arrays[f"{base}|a|{k}"] = v
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "Graph":
        data = np.load(path, allow_pickle=False)
        meta = json.loads(bytes(data["__meta__"]).decode())
        g = cls()
        for name, info in meta["nodes"].items():
            attrs = {k: data[f"n|{name}|a|{k}"] for k in info["attributes"]}
            g.nodes[name] = NodeSet(coords=data[f"n|{name}|coords"], attributes=attrs)
        for key, info in meta["edges"].items():
            src, dst = key.split("|")
            base = f"e|{src}|{dst}"
            attrs = {k: data[f"{base}|a|{k}"] for k in info["attributes"]}
            dst_ptr = data[f"{base}|dst_ptr"] if f"{base}|dst_ptr" in data else None
            g.edges[(src, dst)] = EdgeSet(
                edge_index=data[f"{base}|edge_index"], attributes=attrs, dst_ptr=dst_ptr
            )
        return g
