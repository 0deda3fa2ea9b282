"""Sparse projection of node fields through dst-sorted weighted edges.

Port of ``anemoi_tpu.ops.sparse_projector.SparseProjector``: ``[..., rows,
V]`` onto ``[..., num_dst, V]``, ``out[d] = sum_e w_e x[src_e]`` over the
edges into ``d``.  Its users are ``TruncatedConnection``
(``models/layers/residual.py``) and ``MultiscaleLossWrapper``
(``training/losses/multiscale.py``).  The JAX package computes it with
``jnp.take`` and ``jax.ops.segment_sum`` outside any Pallas kernel, so here
it is PyTorch on both the CPU and the card.

The sum is deterministic: each destination's edges sit in one row of a
padded table built on the host from the dst CSR (width: the largest
in-degree), and the projection is one gather and one sum over the table's
width, in the same order on every run.  A padded slot adds an exact zero
whatever the row it gathers holds, so a NaN or inf in ``x`` reaches only the
destinations with an edge from it, as in ``segment_sum``.  The
backward (``P^T g``) runs the same way over the source-sorted transpose
table, as a ``torch.autograd.Function``; it is not ``index_add_``, whose
atomics on the card vary the last bits from run to run (the truncated
residual runs inside every forecast step, and a served forecast is checked
bit for bit).  The padded tables cost ``num_dst * max in-degree`` index and
weight entries: 3 a row for KNN-3 projections.

Types: the weights stay float32 (``row_normalize`` divides them by each
destination's total in float64 on the host, as the JAX package does), so a
bf16 ``x`` gives a float32 projection, as ``take(x) * w`` promotes in JAX.
The tables are copied to a device once, on the first call there; the
projector is no ``nn.Module``, so a model's cast to bf16 leaves them exact.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _padded_rows(seg: np.ndarray, num_seg: int) -> Tuple[np.ndarray, np.ndarray]:
    """For ascending segment ids ``seg [E]``: ``table [num_seg, width]``, the
    edge ids of each segment in order, ``E`` in the padding, and its mask."""
    counts = np.bincount(seg, minlength=num_seg)
    width = max(int(counts.max(initial=0)), 1)
    ptr = np.zeros(num_seg + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    slot = np.arange(seg.shape[0]) - ptr[seg]
    table = np.full((num_seg, width), seg.shape[0], dtype=np.int64)
    table[seg, slot] = np.arange(seg.shape[0])
    return table, table < seg.shape[0]


class _Table:
    """A padded gather-and-sum table: ``out[r] = sum_j w[r, j] x[idx[r, j]]``."""

    def __init__(self, rows: np.ndarray, gather: np.ndarray, w: np.ndarray, num_rows: int):
        table, mask = _padded_rows(rows, num_rows)
        ext_gather = np.append(gather, 0)
        ext_w = np.append(w, np.float32(0.0))
        self.index = ext_gather[table]  # [num_rows, width]
        self.weight = np.where(mask, ext_w[table], 0.0).astype(np.float32)
        self.mask = None if mask.all() else mask  # None: no padded slot
        self._on: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device
        if dev not in self._on:
            self._on[dev] = (torch.as_tensor(self.index, device=dev),
                             torch.as_tensor(self.weight, device=dev),
                             None if self.mask is None else torch.as_tensor(self.mask, device=dev))
        index, weight, mask = self._on[dev]
        n, width = index.shape
        gathered = x.index_select(-2, index.reshape(-1))
        gathered = gathered.reshape(x.shape[:-2] + (n, width, x.shape[-1]))
        terms = gathered * weight[..., None].to(torch.promote_types(x.dtype, weight.dtype))
        if mask is not None:
            terms = torch.where(mask[..., None], terms, terms.new_zeros(()))
        return terms.sum(-2)


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, projector):
        ctx.projector, ctx.n_src, ctx.dtype = projector, x.shape[-2], x.dtype
        return projector.forward_table.apply(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.projector.transpose_table(ctx.n_src).apply(g).to(ctx.dtype), None


class SparseProjector:
    """Project ``[..., rows, V]`` onto ``[..., num_dst, V]`` through sparse
    weights.  ``edge_index [2, E]`` (src, dst) with dst ascending (asserted,
    as in the JAX package); ``weights [E]`` or ``[E, 1]``; ``row_normalize``
    divides each output row by its total incoming weight."""

    def __init__(self, edge_index, weights, num_dst: int, row_normalize: bool = True):
        ei = np.asarray(edge_index).astype(np.int64)
        w = np.asarray(weights, dtype=np.float32).reshape(-1)
        if ei.ndim != 2 or ei.shape[0] != 2 or ei.shape[1] != w.shape[0]:
            raise ValueError(f"edge_index {ei.shape} and weights {w.shape} do not match")
        if not np.all(np.diff(ei[1]) >= 0):
            raise ValueError("SparseProjector needs dst-sorted edges")
        if row_normalize:
            sums = np.zeros(num_dst, dtype=np.float64)
            np.add.at(sums, ei[1], w)
            w = (w / np.maximum(sums[ei[1]], 1e-12)).astype(np.float32)
        self.src, self.dst, self.w = ei[0], ei[1], w
        self.num_dst = int(num_dst)
        self.forward_table = _Table(self.dst, self.src, self.w, self.num_dst)
        # the transpose, x_ct[src] += w * g[dst], from the triplets sorted by src
        order = np.argsort(self.src, kind="stable")
        self.t_src, self.t_dst, self.t_w = self.src[order], self.dst[order], self.w[order]
        self._transpose: Dict[int, _Table] = {}

    def transpose_table(self, n_src: int) -> _Table:
        if n_src not in self._transpose:
            self._transpose[n_src] = _Table(self.t_src, self.t_dst, self.t_w, n_src)
        return self._transpose[n_src]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Project.apply(x, self)

    @classmethod
    def from_graph(cls, graph, edges_name, edge_weight_attribute: Optional[str] = None,
                   src_node_weight_attribute: Optional[str] = None,
                   row_normalize: bool = True) -> "SparseProjector":
        """From the ``(src, dst)`` sub-graph of a ``Graph``: weights from an
        edge attribute, a source-node attribute, or 1."""
        src_name, dst_name = edges_name[0], edges_name[-1]
        sub = graph[(src_name, dst_name)]
        ei = np.asarray(sub.edge_index)
        if edge_weight_attribute is not None:
            w = np.asarray(sub.attributes[edge_weight_attribute]).reshape(-1)
        elif src_node_weight_attribute is not None:
            w = np.asarray(graph[src_name].attributes[src_node_weight_attribute]).reshape(-1)[ei[0]]
        else:
            w = np.ones(ei.shape[1], dtype=np.float32)
        order = np.argsort(ei[1], kind="stable")
        return cls(ei[:, order], w[order], num_dst=graph[dst_name].num_nodes,
                   row_normalize=row_normalize)

    @classmethod
    def from_file(cls, file_path, row_normalize: bool = True) -> "SparseProjector":
        """From an ``.npz`` with ``src``/``dst``/``weights`` (and optionally
        ``num_dst``), or scipy-CSR-style ``indptr``/``indices``/``data``."""
        z = np.load(file_path)
        if "indptr" in z:
            indptr, indices, w = z["indptr"], z["indices"], z["data"]
            num_dst = len(indptr) - 1
            dst = np.repeat(np.arange(num_dst), np.diff(indptr))
            ei = np.stack([indices.astype(np.int64), dst.astype(np.int64)])
        else:
            ei = np.stack([z["src"].astype(np.int64), z["dst"].astype(np.int64)])
            w = z["weights"]
            num_dst = int(z["num_dst"]) if "num_dst" in z else int(ei[1].max()) + 1
            order = np.argsort(ei[1], kind="stable")
            ei, w = ei[:, order], w[order]
        return cls(ei, w, num_dst=num_dst, row_normalize=row_normalize)

    def as_dense(self) -> np.ndarray:
        """The ``[num_dst, rows]`` matrix (tests and inspection)."""
        m = np.zeros((self.num_dst, int(self.src.max()) + 1), np.float32)
        np.add.at(m, (self.dst, self.src), self.w)
        return m
