"""Graph partitioning for model-parallel (spatial) sharding.

Port of ``anemoi_tpu.parallel.partition`` (``ShardedGraph``,
``partition_graph``, ``verify_sharded_graph``): the same host numpy, so both
packages partition a graph into the same tables, element for element.

- nodes are padded to a multiple of the model-group size and split into equal
  contiguous shards (each rank of the model group owns one; the padded rows
  carry no edges),
- dst-sorted edges split at shard boundaries (O(1) thanks to the dst-sort
  invariant, ref khop_edges.py:37-48), padded to the max per-shard count,
- for the halo strategy, each shard's non-local source nodes are enumerated
  per peer shard into fixed-size send/recv tables, so the runtime exchange
  is a single ``all_to_all`` of equal-shaped buffers (``parallel/halo.py``).

Everything here is host-side numpy, computed once at model build.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ShardedGraph:
    """Per-shard padded tables, stacked on a leading shard axis.

    With `halo`: src ids in ``csr_*`` tables are LOCAL ids into
    [local nodes | halo buffer] of size n_local_src + h_max.
    Without: src ids are GLOBAL (use with an all-gathered source array).

    Bipartite graphs (mappers: data->hidden / hidden->data) partition the
    src and dst node sets independently: dst nodes into ``n_local`` rows per
    shard, src nodes into ``n_local_src`` (equal to ``n_local`` for the
    homogeneous processor graph).
    """

    n_shards: int
    n_local: int  # padded dst nodes per shard
    n_local_src: int  # padded src nodes per shard (== n_local when square)
    n_total_padded: int
    node_mask: np.ndarray  # [S, n_local] valid-node mask
    # stacked PaddedCSR-style tables [S, ...]
    src_slots: np.ndarray
    edge_slots: np.ndarray
    mask: np.ndarray
    edge_attr_perm: np.ndarray  # [S, E_loc] global edge id per local edge (pad=E)
    edge_pad_mask: np.ndarray  # [S, E_loc]
    # halo exchange tables (None-size arrays when halo disabled)
    h_pair: int  # per-peer halo buffer size (padded)
    send_idx: np.ndarray  # [S, S, h_pair] LOCAL node ids this shard sends to peer j
    send_mask: np.ndarray  # [S, S, h_pair]
    # backward transpose: for each local node, slots in the flat send buffer
    send_transpose_idx: np.ndarray  # [S, n_local, T_max] flat send-slot ids (pad = S*h_pair)
    send_transpose_mask: np.ndarray  # [S, n_local, T_max]
    halo: bool = True


def partition_graph(
    edge_index: np.ndarray,
    dst_ptr: np.ndarray,
    num_nodes: int,
    n_shards: int,
    halo: bool = True,
    bucket_multiple: int = 8,
    verify: bool = True,
    num_src_nodes: int | None = None,
) -> ShardedGraph:
    """Partition a dst-sorted graph across ``n_shards``.

    ``num_src_nodes``: size of the SOURCE node set when it differs from the
    destination set (bipartite mapper graphs, ref khop_edges.py handles the
    same via the src/dst shape args) -- src nodes partition contiguously into
    their own ``n_local_src`` rows per shard."""
    num_edges = edge_index.shape[1]
    n_local = _round_up(int(np.ceil(num_nodes / n_shards)), bucket_multiple)
    n_src_nodes = num_nodes if num_src_nodes is None else int(num_src_nodes)
    n_local_src = _round_up(int(np.ceil(n_src_nodes / n_shards)), bucket_multiple)
    n_total_padded = n_local * n_shards
    node_mask = (
        np.arange(n_total_padded).reshape(n_shards, n_local) < num_nodes
    )

    # per-shard edge ranges via the CSR pointer (O(1) slicing)
    bounds = [int(dst_ptr[min(s * n_local, num_nodes)]) for s in range(n_shards + 1)]
    counts = np.diff(bounds)
    e_loc_raw = int(counts.max()) if len(counts) else 1

    # max in-degree over ALL nodes in one pass (k_in is shared across shards)
    deg_all = np.diff(dst_ptr)
    k_in_max = int(deg_all.max()) if len(deg_all) else 1
    k_in = _round_up(max(k_in_max, 1), bucket_multiple)

    src_slots = np.zeros((n_shards, n_local, k_in), dtype=np.int32)
    edge_slots_arr = np.full((n_shards, n_local, k_in), 0, dtype=np.int32)
    mask = np.zeros((n_shards, n_local, k_in), dtype=bool)
    e_loc = _round_up(max(e_loc_raw, 1), bucket_multiple)
    edge_attr_perm = np.full((n_shards, e_loc), num_edges, dtype=np.int32)
    edge_pad_mask = np.zeros((n_shards, e_loc), dtype=bool)

    halo_src_lists: List[np.ndarray] = []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        ei = edge_index[:, lo:hi]
        ne = hi - lo
        dst_local = (ei[1] - s * n_local).astype(np.int64)
        within = np.zeros(ne, dtype=np.int64)
        # position within each dst's segment (edges dst-sorted)
        if ne:
            seg_start = np.r_[0, np.flatnonzero(np.diff(dst_local)) + 1]
            seg_id = np.zeros(ne, dtype=np.int64)
            seg_id[seg_start[1:]] = 1
            seg_id = np.cumsum(seg_id)
            within = np.arange(ne) - seg_start[seg_id]
        edge_attr_perm[s, :ne] = np.arange(lo, hi)
        edge_pad_mask[s, :ne] = True
        # local edge slot ids [n_local, k_in]
        edge_slots_arr[s][dst_local, within] = np.arange(ne, dtype=np.int32)
        mask[s][dst_local, within] = True
        src_slots[s][dst_local, within] = ei[0]  # GLOBAL src for now
        halo_src_lists.append(ei[0])

    # local edge-slot table: edge ids local to the shard. Convert to the
    # flat-slot convention used by padded ops: edge_slots indexes a local
    # edge-feature array of length e_loc (+pad row).
    for s in range(n_shards):
        pad_val = e_loc
        es = edge_slots_arr[s]
        es = np.where(mask[s], es, pad_val)
        edge_slots_arr[s] = es

    if not halo:
        sg = ShardedGraph(
            n_shards=n_shards,
            n_local=n_local,
            n_local_src=n_local_src,
            n_total_padded=n_total_padded,
            node_mask=node_mask,
            src_slots=src_slots,
            edge_slots=edge_slots_arr,
            mask=mask,
            edge_attr_perm=edge_attr_perm,
            edge_pad_mask=edge_pad_mask,
            h_pair=0,
            send_idx=np.zeros((n_shards, n_shards, 0), np.int32),
            send_mask=np.zeros((n_shards, n_shards, 0), bool),
            send_transpose_idx=np.zeros((n_shards, n_local_src, 0), np.int32),
            send_transpose_mask=np.zeros((n_shards, n_local_src, 0), bool),
            halo=False,
        )
        return sg

    # --- halo tables (fully vectorised; no per-edge Python loops) -------
    # for each (owner j -> consumer s): nodes owned by j that s's edges read
    needed = [[np.array([], dtype=np.int64)] * n_shards for _ in range(n_shards)]
    h_pair_max = 1
    for s in range(n_shards):
        srcs = np.unique(halo_src_lists[s])
        owner = srcs // n_local_src
        remote = owner != s
        srcs_r, owner_r = srcs[remote], owner[remote]
        # split the sorted-by-owner runs in one pass
        cuts = np.searchsorted(owner_r, np.arange(n_shards + 1))
        for j in range(n_shards):
            if j == s:
                continue
            sel = srcs_r[cuts[j] : cuts[j + 1]]
            needed[s][j] = sel
            h_pair_max = max(h_pair_max, len(sel))
    h_pair = _round_up(h_pair_max, bucket_multiple)

    # send_idx[j, s]: local ids shard j sends to shard s  (row j = my sends)
    send_idx = np.zeros((n_shards, n_shards, h_pair), dtype=np.int32)
    send_mask = np.zeros((n_shards, n_shards, h_pair), dtype=bool)
    for j in range(n_shards):
        for s in range(n_shards):
            sel = needed[s][j] if s != j else np.array([], dtype=np.int64)
            send_idx[j, s, : len(sel)] = (sel - j * n_local_src).astype(np.int32)
            send_mask[j, s, : len(sel)] = True

    # remap each shard's global src ids -> [local | halo buffer] ids.
    # Halo buffer layout on shard s: concat over peers j (incl. self slot,
    # which stays masked) of the received h_pair rows, i.e. global position of
    # node g owned by j != s: n_local_src + j*h_pair + position in needed[s][j].
    for s in range(n_shards):
        remap = np.zeros(n_local_src * n_shards, dtype=np.int64)
        for j in range(n_shards):
            sel = needed[s][j]
            if len(sel):
                remap[sel] = n_local_src + j * h_pair + np.arange(len(sel))
        flat = src_slots[s].reshape(-1).astype(np.int64)
        local_lo = s * n_local_src
        is_local = (flat >= local_lo) & (flat < local_lo + n_local_src)
        out = np.where(is_local, flat - local_lo, remap[flat])
        src_slots[s] = out.reshape(n_local, k_in).astype(np.int32)
    src_slots = np.where(mask, src_slots, 0)

    # backward transpose: per local node, the flat send-buffer slots using it
    flat_nodes = send_idx.reshape(n_shards, -1)  # [S, S*h_pair]
    flat_valid = send_mask.reshape(n_shards, -1)
    t_counts = np.zeros((n_shards, n_local_src), dtype=np.int64)
    for j in range(n_shards):
        np.add.at(t_counts[j], flat_nodes[j][flat_valid[j]], 1)
    t_max = _round_up(max(1, int(t_counts.max())), 4)
    send_transpose_idx = np.full(
        (n_shards, n_local_src, t_max), n_shards * h_pair, dtype=np.int32
    )
    send_transpose_mask = np.zeros((n_shards, n_local_src, t_max), dtype=bool)
    for j in range(n_shards):
        slots = np.flatnonzero(flat_valid[j])
        nodes = flat_nodes[j][slots]
        order = np.argsort(nodes, kind="stable")
        nodes_s, slots_s = nodes[order], slots[order]
        # position of each entry within its node's run
        run_start = np.r_[0, np.flatnonzero(np.diff(nodes_s)) + 1]
        seg_id = np.zeros(len(nodes_s), dtype=np.int64)
        seg_id[run_start[1:]] = 1
        within = np.arange(len(nodes_s)) - run_start[np.cumsum(seg_id)]
        send_transpose_idx[j][nodes_s, within] = slots_s
        send_transpose_mask[j][nodes_s, within] = True

    sg = ShardedGraph(
        n_shards=n_shards,
        n_local=n_local,
        n_local_src=n_local_src,
        n_total_padded=n_total_padded,
        node_mask=node_mask,
        src_slots=src_slots,
        edge_slots=edge_slots_arr,
        mask=mask,
        edge_attr_perm=edge_attr_perm,
        edge_pad_mask=edge_pad_mask,
        h_pair=h_pair,
        send_idx=send_idx,
        send_mask=send_mask,
        send_transpose_idx=send_transpose_idx,
        send_transpose_mask=send_transpose_mask,
        halo=True,
    )
    if verify:
        verify_sharded_graph(sg, edge_index)
    return sg


def verify_sharded_graph(sg: ShardedGraph, edge_index: np.ndarray) -> None:
    """Independent halo-symmetry check (the build-time counterpart of
    anemoi-core's runtime halo verifier).

    Reconstructs every masked edge slot's GLOBAL source id from the send
    tables alone -- a halo id on shard s resolves through what the OWNER shard
    says it sends (send(j, s) == recv(s, j) symmetry) -- and asserts it
    matches the original dst-sorted edge_index.  Fully vectorised."""
    S, h_pair = sg.n_shards, sg.h_pair
    n_local_src = sg.n_local_src
    # recv_global[s, j, pos]: global id shard s receives from j at pos
    recv_global = sg.send_idx.astype(np.int64) + (
        np.arange(S, dtype=np.int64)[:, None, None] * n_local_src
    )  # indexed [owner j, consumer s, pos]
    num_edges = edge_index.shape[1]
    # walk each shard's masked slots in edge order and compare
    order_src = np.full(num_edges, -1, dtype=np.int64)
    for s in range(S):
        m = sg.mask[s]
        if not m.any():
            continue
        dst, within = np.nonzero(m)
        ids = sg.src_slots[s][dst, within].astype(np.int64)
        is_local = ids < n_local_src
        g = np.where(is_local, ids + s * n_local_src, 0)
        halo_ids = ids - n_local_src
        j = np.clip(halo_ids // max(h_pair, 1), 0, S - 1)
        pos = halo_ids - j * h_pair
        halo_valid = ~is_local
        if halo_valid.any():
            jj, pp = j[halo_valid], pos[halo_valid]
            if not sg.send_mask[jj, s, pp].all():
                raise AssertionError(
                    f"halo symmetry violated: shard {s} reads halo rows its "
                    "peers do not send (send/recv tables out of sync)"
                )
            g[halo_valid] = recv_global[jj, s, pp]
        # edge slot -> original global edge id
        eids = sg.edge_attr_perm[s][
            np.where(sg.edge_slots[s][dst, within] < sg.edge_attr_perm.shape[1],
                     sg.edge_slots[s][dst, within], 0)
        ]
        order_src[eids] = g
    mismatch = order_src != edge_index[0]
    if mismatch.any():
        bad = int(np.flatnonzero(mismatch)[0])
        raise AssertionError(
            f"halo tables resolve edge {bad} src to {order_src[bad]}, "
            f"expected {edge_index[0, bad]}"
        )
