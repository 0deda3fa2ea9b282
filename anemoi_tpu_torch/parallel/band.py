"""The band halo: the dense Transformer processor under ``edges``.

The processor's sliding-window attention reads, for row ``i``, the rows
``|i - j| <= w`` of the whole sequence (the hidden mesh in its order).  Under
``edges`` each rank of a model group holds its block of those rows (the
partition's blocks, ``parallel/mesh.block_rows``).  :class:`BandShard`
fetches the rows ``[max(0, start - w), min(N, end + w))`` around the rank's
real rows ``[start, end)`` -- its extended block -- from the ranks that own
them, with ONE ``all_to_all`` of equal ``[S, h, C]`` buffers (each peer's
rows inside the extended block, ``h`` the most one rank sends another; a
window wider than a block reaches past the neighbours and takes rows from
every rank).  The rank then runs the band attention (K6 forward, K7
backward on the card) on the extended block and keeps its own rows: the
band of an own row lies inside the extended block, and ALiBi and the
softcap depend only on ``i - j``; rotary embeddings rotate by the global
position (``offset``).  The exchange's backward is the reverse
``all_to_all``, so the halo rows' q, k and v cotangents return to their
owners.

The choice between full attention and the band (JAX ``_window_attention``)
is made on the one-process length ``N``: with no window, or ``2 w + 1 >=
N`` off the Pallas path, the extended block is the whole sequence and the
attention full.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from anemoi_tpu_torch.parallel.mesh import block_rows, grid_block


def full_or_band(window_size: Optional[int], attention_impl: str, n: int) -> bool:
    """Whether the one-process attention over ``n`` rows is full
    (``models/layers/attention.self_attention``'s rule)."""
    return window_size is None or (attention_impl != "pallas" and 2 * int(window_size) + 1 >= n)


@dataclass
class BandShard:
    """One rank's share of the Transformer processor under ``edges``: its
    block of the ``num_nodes`` rows, the window, whether the attention is
    full (then the extended block is the whole sequence), and the exchange
    tables."""

    group: object
    num_shards: int
    index: int
    num_nodes: int
    window_size: Optional[int]
    full: bool
    send_idx: torch.Tensor = field(repr=False)  # [S * h] local rows sent to each peer (pad: n_local)
    recv_counts: List[int] = field(default_factory=list)  # real rows received from each peer
    h: int = 0

    @classmethod
    def build(cls, group, num_shards: int, index: int, num_nodes: int,
              window_size: Optional[int], attention_impl: str, device) -> "BandShard":
        """The tables of rank ``index``; every rank computes all ranks'
        ranges, so the buffer size ``h`` agrees."""
        full = full_or_band(window_size, attention_impl, num_nodes)
        reach = num_nodes if full else int(window_size)
        blocks = [grid_block(num_nodes, num_shards, j) for j in range(num_shards)]
        ext = [(max(0, b.start - reach), min(num_nodes, b.stop + reach)) if b.stop > b.start
               else (0, 0) for b in blocks]

        def overlap(j, i):  # rows of j's block inside i's extended block
            lo, hi = max(blocks[j].start, ext[i][0]), min(blocks[j].stop, ext[i][1])
            return (lo, hi) if hi > lo else (blocks[j].start, blocks[j].start)

        h = max([overlap(j, i)[1] - overlap(j, i)[0] for i in range(num_shards)
                 for j in range(num_shards) if i != j] or [0])
        n_local = block_rows(num_nodes, num_shards)
        send = np.full((num_shards, max(h, 1)), n_local, np.int64)
        for i in range(num_shards):
            if i != index:
                lo, hi = overlap(index, i)
                send[i, : hi - lo] = np.arange(lo, hi) - blocks[index].start
        recv = [0 if j == index else overlap(j, index)[1] - overlap(j, index)[0]
                for j in range(num_shards)]
        return cls(group, num_shards, index, num_nodes, window_size, full,
                   torch.as_tensor(send[:, :h].reshape(-1), device=device), recv, h)

    @property
    def n_local(self) -> int:
        return block_rows(self.num_nodes, self.num_shards)

    @property
    def dst_rows(self) -> slice:
        return grid_block(self.num_nodes, self.num_shards, self.index)

    src_rows = dst_rows

    @property
    def ext_rows(self) -> slice:
        """The extended block: the rows the rank's attention runs on."""
        own = self.dst_rows
        if own.stop == own.start:
            return slice(own.start, own.start)
        lo = own.start - sum(self.recv_counts[: self.index])
        return slice(lo, own.stop + sum(self.recv_counts[self.index + 1:]))


def band_rows(x: torch.Tensor, shard: BandShard) -> torch.Tensor:
    """``x [B, n_local, C]`` (the rank's padded block) -> ``[B, L, C]``, the
    rows of its extended block in order.  Collective over the model group."""
    from anemoi_tpu_torch.parallel.halo import _depends_on, _Exchange

    own = shard.dst_rows
    n = own.stop - own.start
    if shard.h == 0:
        return x[:, :n]
    b, c = x.shape[0], x.shape[-1]
    xp = torch.cat([x, x.new_zeros(b, 1, c)], dim=1)
    send = xp.index_select(1, shard.send_idx).reshape(b, shard.num_shards, shard.h, c)
    recv = _Exchange.apply(send, shard.group, None)  # [S, B, h, C]
    parts = []
    for j, count in enumerate(shard.recv_counts):
        if j == shard.index:
            parts.append(x[:, :n])
        elif count:
            parts.append(recv[j, :, :count])
    # every rank's backward reaches its exchange, as the collective needs
    return _depends_on(torch.cat(parts, dim=1), recv)


def band_mhsa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shard: BandShard,
    softcap: Optional[float] = None, alibi_slopes: Optional[torch.Tensor] = None,
    rotary: bool = False, plain: bool = False,
) -> torch.Tensor:
    """The sliding-window self-attention of this rank's rows ``[B, n_local,
    H, D]`` (q/k normed, not yet rotated) under ``edges``: over its extended
    block, full or band by the one-process rule; returns ``[B, n_local, H,
    D]`` (zeros on the pad rows)."""
    from anemoi_tpu_torch.models.layers.attention import (
        apply_rotary_embeddings,
        full_attention_plain,
    )
    from anemoi_tpu_torch.ops.window_attention import band_attention

    b, n_loc, h, d = q.shape
    ext = band_rows(torch.cat([t.reshape(b, n_loc, h * d) for t in (q, k, v)], dim=-1), shard)
    length = ext.shape[1]
    if length == 0:  # a rank without rows
        return q.new_zeros(q.shape) + ext.sum().to(q.dtype)
    qe, ke, ve = (t.reshape(b, length, h, d).contiguous() for t in ext.split(h * d, dim=-1))
    rows = shard.ext_rows
    if rotary:
        qe, ke = apply_rotary_embeddings(qe, ke, offset=rows.start)
    softcap = float(softcap) if softcap else None
    if shard.full:
        out = full_attention_plain(qe, ke, ve, softcap, alibi_slopes)
    else:
        out = band_attention(qe, ke, ve, shard.window_size, softcap, alibi_slopes, plain)
    own = shard.dst_rows
    out = out[:, own.start - rows.start : own.stop - rows.start]
    pad = n_loc - out.shape[1]
    if pad > 0:
        out = torch.cat([out, out.new_zeros((b, pad, h, d))], dim=1)
    return out
