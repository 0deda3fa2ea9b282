"""Halo-exchange ("edges") model parallelism over a ``torch.distributed`` model group.

Port of ``anemoi_tpu.parallel.halo``, the parts that compute.  The hidden
mesh and the data grid are split in contiguous row blocks over the model
group (``parallel/partition.py``); before each sparse attention every rank
sends the key/value rows its peers read to them with ONE ``all_to_all`` of
equal ``[S, h_pair, C]`` buffers, then attends for its own destinations over
the source space ``[local rows | S * h_pair halo rows]`` with the port's
attention op (K1 forward, K3 + K4 backward on the card) on its own CSR.

Where the JAX package runs one program inside ``shard_map``, here each rank
holds its rows and every cross-rank step is an explicit collective with an
explicit backward:

- :func:`gather_send_rows_b`: the send buffer, whose backward sums each
  row's slots through the transpose tables (gather-only, deterministic);
- :func:`halo_exchange_b`: the ``all_to_all`` as an autograd Function whose
  backward is the reverse ``all_to_all`` (the exchange is its own adjoint),
  followed by that gather;
- :func:`route_rows_b` and :func:`permute_rows`: row routings whose backward
  is the inverse routing.

Under ``halo_overlap`` (:func:`halo_gt_attention`) the destinations split
into interior rows (every source local) and boundary rows: the interior rows
attend to the local keys and values while the exchange is in flight
(``async_op``), the boundary rows after it.  The key and value rows travel
in one buffer.

The TPU's slot layouts (``shard_paged_tables``, ``shard_split_paged_tables``,
``_sub_padded_tables``' transpose tables, ``_tables_to_padded``) have no
counterpart: the CUDA kernels read the per-shard CSR.  :func:`shard_tables`
and :func:`shard_split_tables` keep the JAX tables that describe the graph
(and equal them element for element); :class:`HaloShard` turns one rank's
share into device CSRs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from anemoi_tpu_torch.ops.gt_attention import SourceOrder, gt_attention, gt_attention_fe
from anemoi_tpu_torch.parallel.distributed import all_to_all
from anemoi_tpu_torch.parallel.partition import ShardedGraph


# --- boundary-row gather with gather-only backward ---------------------------
class _GatherSendRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send_idx, send_mask, send_t_idx, send_t_mask):
        b, c = x.shape[0], x.shape[-1]
        buf = x.index_select(1, send_idx.reshape(-1)).reshape((b,) + send_idx.shape + (c,))
        ctx.save_for_backward(send_t_idx, send_t_mask)
        return torch.where(send_mask[None, ..., None], buf, torch.zeros((), dtype=x.dtype,
                                                                          device=x.device))

    @staticmethod
    def backward(ctx, g):
        send_t_idx, send_t_mask = ctx.saved_tensors
        b, c = g.shape[0], g.shape[-1]
        flat = torch.cat([g.reshape(b, -1, c), g.new_zeros(b, 1, c)], dim=1)
        gathered = flat.index_select(1, send_t_idx.reshape(-1)).reshape(
            (b,) + send_t_idx.shape + (c,))  # [B, n_local, T, C]
        d_x = torch.where(send_t_mask[None, ..., None], gathered, 0.0).sum(2)
        return d_x, None, None, None, None


def gather_send_rows_b(x: torch.Tensor, shard: "HaloShard") -> torch.Tensor:
    """x ``[B, n_local_src, C]`` -> send buffer ``[B, S, h_pair, C]`` (masked
    rows zero); the backward sums each row's slots (``send_transpose_*``)."""
    return _GatherSendRows.apply(x, shard.send_idx, shard.send_mask, shard.send_t_idx,
                                 shard.send_t_mask)


def gather_send_rows(x_local: torch.Tensor, shard: "HaloShard") -> torch.Tensor:
    """x_local ``[n_local_src, C]`` -> ``[S, h_pair, C]``."""
    return gather_send_rows_b(x_local[None], shard)[0]


class _Exchange(torch.autograd.Function):
    """``[B, S, h, C]`` send buffer -> ``[S, B, h, C]`` received rows (block
    ``j`` from rank ``j`` of the group), asynchronously when a ``pending``
    list is given: the caller waits on its last entry before reading the
    result.  Backward: the reverse all_to_all (synchronous)."""

    @staticmethod
    def forward(ctx, send, group, pending):
        ctx.group = group
        work = all_to_all(send.transpose(0, 1), group, async_op=pending is not None)
        if pending is not None:
            pending.append(work)
        return work.out

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group).wait().transpose(0, 1), None, None


def _received(recv: torch.Tensor) -> torch.Tensor:
    """``[S, B, h, C]`` -> ``[B, S * h, C]`` (the halo rows in source-id order)."""
    s, b, h, c = recv.shape
    return recv.transpose(0, 1).reshape(b, s * h, c)


def halo_exchange_b(x: torch.Tensor, shard: "HaloShard") -> torch.Tensor:
    """``[B, n_local_src, C]`` -> ``[B, n_local_src + S * h_pair, C]``: local
    rows, then the rows received from each peer.  Collective over the
    model group."""
    recv = _Exchange.apply(gather_send_rows_b(x, shard), shard.group, None)
    return torch.cat([x, _received(recv)], dim=1)


def halo_exchange(x_local: torch.Tensor, shard: "HaloShard") -> torch.Tensor:
    """``[n_local_src, C]`` -> ``[n_local_src + S * h_pair, C]``."""
    return halo_exchange_b(x_local[None], shard)[0]


# --- row routings -----------------------------------------------------------
class _Route(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_idx, bwd_idx, dim):
        ctx.save_for_backward(bwd_idx)
        ctx.dim = dim
        xp = torch.cat([x, x.new_zeros(x.shape[:dim] + (1,) + x.shape[dim + 1:])], dim=dim)
        return xp.index_select(dim, fwd_idx)

    @staticmethod
    def backward(ctx, g):
        (bwd_idx,) = ctx.saved_tensors
        dim = ctx.dim
        gp = torch.cat([g, g.new_zeros(g.shape[:dim] + (1,) + g.shape[dim + 1:])], dim=dim)
        return gp.index_select(dim, bwd_idx), None, None, None


def route_rows_b(x: torch.Tensor, fwd_idx: torch.Tensor, bwd_idx: torch.Tensor) -> torch.Tensor:
    """``out[:, m] = x[:, fwd_idx[m]]`` (index ``x.shape[1]``: a zero row),
    with the gather ``bwd_idx`` as its backward; the two must be inverse on
    the valid entries (each input row used exactly once)."""
    return _Route.apply(x, fwd_idx, bwd_idx, 1)


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x [B, N, C]`` with zero rows appended up to ``rows`` (a rank's
    block of a partition)."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[1])) if rows > x.shape[1] else x


def permute_rows(x: torch.Tensor, perm: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
    """Rows of ``x [E, F]`` in a shard's layout ``[E_loc, F]`` (``perm``; pad
    slots = row ``E``, zero), with the gather ``inv_perm [E]`` (a row's slot,
    or ``E_loc`` for a row of another shard) as its backward."""
    return _Route.apply(x, perm.reshape(-1), inv_perm, 0)


# --- interior/boundary destination split ------------------------------------
def interior_boundary_rows(sg: ShardedGraph) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per shard ``(interior_rows, boundary_rows)``: a destination row is on
    the boundary iff one of its sources lives in the halo region (local
    source ids are ``< n_local_src``)."""
    interior, boundary = [], []
    for s in range(sg.n_shards):
        is_halo = sg.mask[s] & (sg.src_slots[s] >= sg.n_local_src)
        bnd = is_halo.any(axis=1)
        interior.append(np.flatnonzero(~bnd))
        boundary.append(np.flatnonzero(bnd))
    return interior, boundary


def _edge_tables(mask: np.ndarray, src_slots: np.ndarray, edge_slots: np.ndarray, e_loc: int,
                 n_rows: int, k_in: int) -> Dict[str, np.ndarray]:
    """The per-edge tables of one shard's destination rows (the JAX
    ``PaddedCSR`` fields the graph defines): each local edge's flat slot
    ``dst * k_in + within``, destination and source, padded to ``e_loc``."""
    dst, within = np.nonzero(mask)
    eids = edge_slots[dst, within].astype(np.int64)
    egs = np.full(e_loc, n_rows * k_in, np.int32)
    ed = np.zeros(e_loc, np.int32)
    es = np.zeros(e_loc, np.int32)
    egs[eids] = (dst * k_in + within).astype(np.int32)
    ed[eids] = dst
    es[eids] = src_slots[dst, within]
    return {"edge_gather_slot": egs, "edge_dst": ed, "edge_src": es}


def _sub_rows(sg: ShardedGraph, rows_per_shard, n_sub: int, prefix: str) -> Dict[str, np.ndarray]:
    """The tables of each shard's destination-row subset, padded to
    ``n_sub`` rows (per-shard edge ids kept, so both subsets index the
    shard's one ``[E_loc]`` edge array)."""
    k_in = sg.src_slots.shape[-1]
    e_loc = sg.edge_attr_perm.shape[1]
    out: Dict[str, list] = {}
    for s in range(sg.n_shards):
        rows = rows_per_shard[s]
        sub = {"src_slots": np.zeros((n_sub, k_in), dtype=sg.src_slots.dtype),
               "edge_slots": np.full((n_sub, k_in), e_loc, dtype=sg.edge_slots.dtype),
               "mask": np.zeros((n_sub, k_in), dtype=bool)}
        sub["mask"][: len(rows)] = sg.mask[s][rows]
        sub["src_slots"][: len(rows)] = sg.src_slots[s][rows]
        sub["edge_slots"][: len(rows)] = sg.edge_slots[s][rows]
        sub.update(_edge_tables(sub["mask"], sub["src_slots"], sub["edge_slots"], e_loc, n_sub,
                                k_in))
        for key, value in sub.items():
            out.setdefault(prefix + key, []).append(value)
    return {k: np.stack(v) for k, v in out.items()}


def shard_split_tables(sg: ShardedGraph) -> Dict[str, np.ndarray]:
    """Interior/boundary split tables for the halo-overlap path, stacked
    ``[S, ...]``: the routing pair ``ib_split_idx`` / ``ib_combine_idx`` and
    each subset's ``int_`` / ``bnd_`` destination tables (the interior rows'
    sources are local, the boundary rows' in ``[local | halo]``)."""
    interior, boundary = interior_boundary_rows(sg)
    n_int = max(max((len(r) for r in interior), default=1), 1)
    n_bnd = max(max((len(r) for r in boundary), default=1), 1)
    split_idx = np.full((sg.n_shards, n_int + n_bnd), sg.n_local, np.int32)
    combine_idx = np.zeros((sg.n_shards, sg.n_local), np.int32)
    for s in range(sg.n_shards):
        split_idx[s, : len(interior[s])] = interior[s]
        split_idx[s, n_int : n_int + len(boundary[s])] = boundary[s]
        combine_idx[s, interior[s]] = np.arange(len(interior[s]))
        combine_idx[s, boundary[s]] = n_int + np.arange(len(boundary[s]))
    tables = {"ib_split_idx": split_idx, "ib_combine_idx": combine_idx}
    tables.update(_sub_rows(sg, interior, n_int, "int_"))
    tables.update(_sub_rows(sg, boundary, n_bnd, "bnd_"))
    return tables


def shard_tables(sg: ShardedGraph) -> Dict[str, np.ndarray]:
    """The per-shard tables stacked ``[S, ...]``: the destination slots
    (``src_slots`` in the ``[local | halo]`` source space of ``n_local_src
    + S * h_pair`` rows, ``edge_slots``, ``mask``), the per-edge tables and
    the send/transpose tables of the exchange."""
    k_in = sg.src_slots.shape[-1]
    e_loc = sg.edge_attr_perm.shape[1]
    out: Dict[str, list] = {}
    for s in range(sg.n_shards):
        for key, value in _edge_tables(sg.mask[s], sg.src_slots[s], sg.edge_slots[s], e_loc,
                                       sg.n_local, k_in).items():
            out.setdefault(key, []).append(value)
    tables = {k: np.stack(v) for k, v in out.items()}
    tables.update(src_slots=sg.src_slots, edge_slots=sg.edge_slots, mask=sg.mask,
                  send_idx=sg.send_idx, send_mask=sg.send_mask,
                  send_transpose_idx=sg.send_transpose_idx,
                  send_transpose_mask=sg.send_transpose_mask)
    return tables


# --- one rank's share, on its device ----------------------------------------
@dataclass
class ShardCSR:
    """One destination-row set of a shard as the attention op takes it: the
    dst-sorted CSR over its source space, the source order of the backward,
    and the rows of the shard's ``[E_loc]`` edge array its edges read
    (``eids``; None when they are the first ``num_edges`` in order)."""

    edge_index: torch.Tensor  # [2, E] int32
    dst_ptr: torch.Tensor  # [num_dst + 1] int32
    source: SourceOrder
    num_src: int
    num_dst: int
    eids: Optional[torch.Tensor]  # [E] int64

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @classmethod
    def from_slots(cls, mask, src_slots, edge_slots, num_src: int, device,
                   contiguous: bool = False) -> "ShardCSR":
        dst, within = np.nonzero(mask)
        src = src_slots[dst, within].astype(np.int64)
        eids = edge_slots[dst, within].astype(np.int64)
        n_rows = mask.shape[0]
        dst_ptr = np.zeros(n_rows + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=n_rows), out=dst_ptr[1:])
        edge_index = torch.as_tensor(np.stack([src, dst]).astype(np.int32), device=device)
        if contiguous and not np.array_equal(eids, np.arange(len(eids))):
            raise AssertionError("a shard's edges must be its first edges, in order")
        return cls(edge_index=edge_index,
                   dst_ptr=torch.as_tensor(dst_ptr.astype(np.int32), device=device),
                   source=SourceOrder.of(edge_index, num_src), num_src=int(num_src),
                   num_dst=int(n_rows),
                   eids=None if contiguous else torch.as_tensor(eids, device=device))


@dataclass
class HaloShard:
    """One rank's share of one halo-partitioned edge set: its block of
    destination (``n_local``) and source (``n_local_src``) rows, the exchange
    tables, the edge permutation into its ``[E_loc]`` layout, and the CSRs
    its attention runs on (``full``, or ``interior`` + ``boundary`` with the
    routing pair under ``overlap``).  ``group`` is the model group."""

    group: object
    num_shards: int
    index: int
    n_local: int
    n_local_src: int
    num_dst: int  # real rows of the whole destination / source sets
    num_src: int
    h_pair: int
    send_idx: torch.Tensor  # [S, h_pair] local rows sent to each peer
    send_mask: torch.Tensor
    send_t_idx: torch.Tensor  # [n_local_src, T] flat send slots of each row
    send_t_mask: torch.Tensor
    edge_perm: torch.Tensor  # [E_loc] global edge of each local slot (pad: E)
    edge_perm_inv: torch.Tensor  # [E] local slot of each edge (another shard's: E_loc)
    full: Optional[ShardCSR]
    interior: Optional[ShardCSR] = None
    boundary: Optional[ShardCSR] = None
    split_idx: Optional[torch.Tensor] = None  # [n_int + n_bnd]
    combine_idx: Optional[torch.Tensor] = None  # [n_local]

    @property
    def overlap(self) -> bool:
        return self.interior is not None

    def _rows(self, n_local: int, total: int) -> slice:
        lo = min(self.index * n_local, total)
        return slice(lo, min(lo + n_local, total))

    @property
    def dst_rows(self) -> slice:
        """This rank's real destination rows of the whole set."""
        return self._rows(self.n_local, self.num_dst)

    @property
    def src_rows(self) -> slice:
        return self._rows(self.n_local_src, self.num_src)

    @classmethod
    def build(cls, sg: ShardedGraph, tables: Dict[str, np.ndarray], index: int, group,
              device, num_dst: int, num_src: int, num_edges: int) -> "HaloShard":
        """Rank ``index``'s share of the stacked tables (:func:`shard_tables`,
        plus :func:`shard_split_tables` for the overlap path)."""
        s = index

        def dev(a, dtype=torch.long):
            return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

        e_loc = sg.edge_attr_perm.shape[1]
        perm = sg.edge_attr_perm[s]
        inv = np.full(num_edges, e_loc, np.int64)
        valid = sg.edge_pad_mask[s]
        inv[perm[valid]] = np.flatnonzero(valid)
        n_ext = sg.n_local_src + sg.n_shards * sg.h_pair
        shard = cls(
            group=group, num_shards=sg.n_shards, index=s, n_local=sg.n_local,
            n_local_src=sg.n_local_src, num_dst=int(num_dst), num_src=int(num_src),
            h_pair=sg.h_pair, send_idx=dev(sg.send_idx[s]),
            send_mask=dev(sg.send_mask[s], torch.bool),
            send_t_idx=dev(sg.send_transpose_idx[s]),
            send_t_mask=dev(sg.send_transpose_mask[s], torch.bool),
            edge_perm=dev(perm), edge_perm_inv=dev(inv), full=None,
        )
        if "ib_split_idx" in tables:
            shard.interior = ShardCSR.from_slots(tables["int_mask"][s], tables["int_src_slots"][s],
                                                 tables["int_edge_slots"][s], sg.n_local_src,
                                                 device)
            shard.boundary = ShardCSR.from_slots(tables["bnd_mask"][s], tables["bnd_src_slots"][s],
                                                 tables["bnd_edge_slots"][s], n_ext, device)
            shard.split_idx = dev(tables["ib_split_idx"][s])
            shard.combine_idx = dev(tables["ib_combine_idx"][s])
        else:
            shard.full = ShardCSR.from_slots(tables["mask"][s], tables["src_slots"][s],
                                             tables["edge_slots"][s], n_ext, device,
                                             contiguous=True)
        return shard


def _depends_on(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out`` tied to ``x`` in the autograd graph by an empty sum: the
    backward then reaches ``x``'s exchange on every rank, as the collective
    needs, even where no edge read a received row."""
    return out + x.narrow(1, 0, 0).sum().to(out.dtype)


def halo_gt_attention(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, shard: HaloShard,
    num_heads: int, *, edges: Optional[torch.Tensor] = None,
    edge_attr: Optional[torch.Tensor] = None, weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None, plain: bool = False,
) -> torch.Tensor:
    """This rank's destinations of the graph attention, with the halo
    exchange of the keys and values over the model group.

    ``query [B, n_local, HD]``, ``key``/``value [B, n_local_src, HD]``: the
    rank's padded blocks.  The edge features are in the rank's ``[E_loc]``
    layout (:func:`permute_rows`): pre-projected ``edges [E_loc, HD]``, or
    raw ``edge_attr [E_loc, F]`` with the projection ``weight [F, HD]``,
    ``bias`` fused into the kernel (K1).  The gradients of ``weight`` and
    ``bias`` are this rank's share: the training step sums every replicated
    parameter's gradient over the model group, as ``shard_map``'s transpose
    sums it in the JAX package.  A CSR set without edges runs no kernel
    and gives zeros."""
    hd = value.shape[-1]
    feats = edges if edges is not None else edge_attr

    def attend(q, k, v, csr: ShardCSR):
        if csr.num_edges == 0:
            return q.new_zeros(q.shape[:-1] + (hd,))
        e = (feats.narrow(0, 0, csr.num_edges) if csr.eids is None
             else feats.index_select(0, csr.eids))
        if edges is not None:
            out, _ = gt_attention(q, k, v, e, csr.edge_index, csr.dst_ptr, num_heads,
                                  plain=plain, source=csr.source)
        else:
            out, _ = gt_attention_fe(q, k, v, e, weight, bias, csr.edge_index, csr.dst_ptr,
                                     num_heads, plain=plain, source=csr.source)
        return out

    kv = torch.cat([key, value], dim=-1)
    send = gather_send_rows_b(kv, shard)
    if not shard.overlap:
        kv_ext = torch.cat([kv, _received(_Exchange.apply(send, shard.group, None))], dim=1)
        out = attend(query, kv_ext[..., :hd].contiguous(), kv_ext[..., hd:].contiguous(),
                     shard.full)
        return _depends_on(out, kv_ext) if shard.full.num_edges == 0 else out
    # the interior rows attend while the exchange is in flight
    pending: list = []
    recv = _Exchange.apply(send, shard.group, pending)
    n_int = shard.interior.num_dst
    q_split = route_rows_b(query, shard.split_idx, shard.combine_idx)
    out_int = attend(q_split[:, :n_int].contiguous(), key, value, shard.interior)
    pending[-1].wait()
    kv_ext = torch.cat([kv, _received(recv)], dim=1)
    out_bnd = attend(q_split[:, n_int:].contiguous(), kv_ext[..., :hd].contiguous(),
                     kv_ext[..., hd:].contiguous(), shard.boundary)
    if shard.boundary.num_edges == 0:
        out_bnd = _depends_on(out_bnd, kv_ext)
    return route_rows_b(torch.cat([out_int, out_bnd], dim=1), shard.combine_idx,
                        shard.split_idx)
