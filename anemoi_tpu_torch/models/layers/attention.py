"""Dense multi-head self-attention with sliding windows, and cross attention.

Port of ``anemoi_tpu.models.layers.attention``: ``get_alibi_slopes``,
``apply_rotary_embeddings``, ``window_attention_plain`` (the port's copy of
``_window_attention``), ``MultiHeadSelfAttention`` and
``MultiHeadCrossAttention``.  The projections are anemoi-core's separate
``lin_q``, ``lin_k``, ``lin_v`` and ``projection`` (the JAX package fuses
the self-attention's first three into one ``qkv`` Dense, names the cross
attention's ``q``, ``k``, ``v``, and both last ones ``out_proj``;
``models/port.py`` maps the names).

The band runs through ``anemoi_tpu_torch.ops.window_attention`` (K6 forward
and K7 backward on the card).  The cross attention is dense: every query
attends to every key.  The JAX package computes it with ``einsum`` ->
softmax -> ``einsum``, outside any Pallas kernel, so it is no kernel port:
its plain version (:func:`cross_attention_plain`, float32 arithmetic) runs
on the CPU, and on CUDA tensors :func:`cross_attention` calls
``scaled_dot_product_attention`` restricted to its flash and
memory-efficient backends, which never form the ``[B, H, Nq, Nk]`` logits
(at o96 -> ico-5 with 16 heads the plain version's logits alone take 26 GB
in float32).  A shape neither backend takes raises; the math backend is
never picked.  Under Ulysses sequence parallelism (``shard_strategy:
heads``) the self-attention takes a ``parallel/heads.HeadsShard``: the
rank's rows of q, k and v go through ``ulysses_mhsa`` (one all-to-all to
the whole sequence for the rank's heads, the band or full attention on its
real rows, the all-to-all back); under ``edges`` a
``parallel/band.BandShard``: ``band_mhsa``, the band over the rank's
extended block (the window's rows around its block, fetched from the
ranks that own them).  Under model shards the cross attention takes the
rank's queries over the whole source set, its keys and values gathered
(``parallel/rows.BlockShard``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from anemoi_tpu_torch.models.layers.normalization import QKNorm
from anemoi_tpu_torch.ops.window_attention import band_attention, softcap_alibi
from anemoi_tpu_torch.parallel.band import BandShard, band_mhsa
from anemoi_tpu_torch.parallel.heads import ulysses_mhsa
from anemoi_tpu_torch.parallel.rows import BlockShard


def get_alibi_slopes(num_heads: int) -> torch.Tensor:
    """ALiBi slopes per head (float32): powers of 2 descending, with the
    interleaved extra slopes for a head count that is not a power of 2."""

    def slopes_pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        s = slopes_pow2(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        s = slopes_pow2(closest) + slopes_pow2(2 * closest)[0::2][: num_heads - closest]
    return torch.tensor(s, dtype=torch.float32)


def apply_rotary_embeddings(
    q: torch.Tensor, k: torch.Tensor, base: float = 10000.0, offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE over the sequence axis: rotate the two halves of each head dim
    by position-dependent angles (an odd last lane passes through).  q, k:
    ``[..., N, H, D]``, whose first row is at position ``offset`` of the
    sequence.  Plain tensor code, as in the JAX package."""
    n, _, d = q.shape[-3:]
    half = d // 2
    inv = 1.0 / (base ** (torch.arange(half, dtype=torch.float32) / max(half, 1)))
    ang = torch.arange(offset, offset + n, dtype=torch.float32)[:, None] * inv[None]  # [N, half]
    cos = torch.cos(ang)[:, None, :].to(q.device, q.dtype)  # [N, 1, half]
    sin = torch.sin(ang)[:, None, :].to(q.device, q.dtype)

    def rot(x):
        x1, x2 = x[..., :half], x[..., half : 2 * half]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return torch.cat([out, x[..., 2 * half :]], dim=-1) if 2 * half < d else out

    return rot(q), rot(k)


def full_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Every position attends to every position, ``[B, N, H, D]``; float32
    arithmetic, the output rounded once to the input type."""
    acc = torch.promote_types(q.dtype, torch.float32)
    n, d = q.shape[1], q.shape[3]
    logits = torch.einsum("bnhd,bmhd->bhnm", q.to(acc), k.to(acc)) / math.sqrt(d)
    pos = torch.arange(n, device=q.device)
    logits = softcap_alibi(logits, (pos[:, None] - pos[None, :]).abs(), softcap, alibi_slopes, 1)
    alpha = torch.softmax(logits, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", alpha, v.to(acc)).to(q.dtype)


def self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: Optional[int],
    softcap: Optional[float] = None, alibi_slopes: Optional[torch.Tensor] = None,
    attention_impl: str = "xla", plain: bool = False,
) -> torch.Tensor:
    """``MultiHeadSelfAttention``'s dispatch (JAX ``attention.py:191-213``):
    full attention with no window, or on the XLA path when ``2w + 1 >= n``;
    otherwise the band -- on the Pallas path always, even when ``2w + 1 >=
    n``, where it is another function than the XLA path's.  The band goes
    to K6/K7 on the card (``plain`` selects its plain version)."""
    softcap = float(softcap) if softcap else None
    n = q.shape[1]
    if window_size is None or (attention_impl != "pallas" and 2 * int(window_size) + 1 >= n):
        return full_attention_plain(q, k, v, softcap, alibi_slopes)
    return band_attention(q, k, v, window_size, softcap, alibi_slopes, plain)


def window_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: Optional[int],
    softcap: Optional[float] = None, alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``_window_attention``: full attention with no window or when ``2w + 1
    >= n``, else the band, in plain PyTorch (the XLA path's function)."""
    return self_attention(q, k, v, window_size, softcap, alibi_slopes, "xla", plain=True)


class MultiHeadSelfAttention(nn.Module):
    """MHSA over the node/sequence dim of ``[B, N, C]`` features; with
    ``qk_norm``, q and k are normalised per head (``qk_norm_type``
    ``layernorm`` or ``rmsnorm``) before the product.

    ``plain_attention`` selects the band's plain PyTorch version instead of
    the CUDA kernels, so that a run on the card can be compared with it."""

    def __init__(
        self, num_channels: int, num_heads: int, attn_channels: Optional[int] = None,
        window_size: Optional[int] = None, qkv_bias: bool = False, qk_norm: bool = False,
        softcap: Optional[float] = None, use_alibi_slopes: bool = False,
        use_rotary_embeddings: bool = False, attention_impl: str = "xla",
        qk_norm_type: str = "layernorm",
    ) -> None:
        super().__init__()
        if attention_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown attention_impl '{attention_impl}'")
        hd = attn_channels or num_channels
        if hd % num_heads:
            raise ValueError(f"attn_channels {hd} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.attn_channels = hd
        self.window_size = window_size
        self.softcap = softcap
        self.use_rotary_embeddings = use_rotary_embeddings
        self.attention_impl = attention_impl
        self.lin_q = nn.Linear(num_channels, hd, bias=qkv_bias)
        self.lin_k = nn.Linear(num_channels, hd, bias=qkv_bias)
        self.lin_v = nn.Linear(num_channels, hd, bias=qkv_bias)
        self.projection = nn.Linear(hd, num_channels)
        self.q_norm = QKNorm(hd // num_heads, qk_norm_type) if qk_norm else None
        self.k_norm = QKNorm(hd // num_heads, qk_norm_type) if qk_norm else None
        # float32 constants, kept out of the parameters and buffers so that a
        # cast of the model to bf16 leaves them exact
        self.alibi_slopes = get_alibi_slopes(num_heads) if use_alibi_slopes else None
        self.plain_attention = False

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """``x [B, N, C]``; under model shards, the rank's padded rows and
        its ``shard``: a ``HeadsShard`` under ``heads`` (the JAX
        ``ulysses_mhsa`` path, whatever ``attention_impl``), a
        ``BandShard`` under ``edges`` (the band halo)."""
        b, n, _ = x.shape
        h, d = self.num_heads, self.attn_channels // self.num_heads
        q = self.lin_q(x).view(b, n, h, d)
        k = self.lin_k(x).view(b, n, h, d)
        v = self.lin_v(x).view(b, n, h, d)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        slopes = self.alibi_slopes
        if slopes is not None and slopes.device != x.device:
            slopes = self.alibi_slopes = slopes.to(x.device)
        if isinstance(shard, BandShard):
            out = band_mhsa(q, k, v, shard, self.softcap, slopes, self.use_rotary_embeddings,
                            self.plain_attention)
            return self.projection(out.reshape(b, n, self.attn_channels))
        if shard is not None:
            out = ulysses_mhsa(q, k, v, shard, self.window_size, self.softcap, slopes,
                               self.use_rotary_embeddings, self.plain_attention)
            return self.projection(out.reshape(b, n, self.attn_channels))
        if self.use_rotary_embeddings:
            q, k = apply_rotary_embeddings(q, k)
        out = self_attention(q, k, v, self.window_size, self.softcap, slopes,
                             self.attention_impl, self.plain_attention)
        return self.projection(out.reshape(b, n, self.attn_channels))


def cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Every query attends to every key: ``q [B, Nq, H, D]``, ``k``, ``v [B,
    Nk, H, D]`` -> ``[B, Nq, H, D]``; float32 arithmetic, the output rounded
    once to the input type."""
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.to(acc), k.to(acc)) / math.sqrt(q.shape[-1])
    alpha = torch.softmax(logits, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", alpha, v.to(acc)).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense cross attention, ``[B, Nq, H, D]``: the plain version on CPU
    tensors, ``scaled_dot_product_attention`` on its flash or
    memory-efficient backend on CUDA tensors; any other device raises."""
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"no cross attention for device {q.device}")
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        out = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)


class MultiHeadCrossAttention(nn.Module):
    """Cross attention of ``[B, Nq, C]`` queries (``x_dst``) over ``[B, Nk,
    C]`` keys and values (``x_src``), through :func:`cross_attention`, which
    picks its version by the device alone
    (``AnemoiModelInterface.use_plain_attention`` does not reach it: at the
    mappers' full size the plain version does not fit on the card).  With
    ``qk_norm``, q and k are normalised per head (``qk_norm_type``
    ``layernorm`` or ``rmsnorm``) before the product."""

    def __init__(self, num_channels: int, num_heads: int, attn_channels: Optional[int] = None,
                 qkv_bias: bool = False, qk_norm: bool = False,
                 qk_norm_type: str = "layernorm") -> None:
        super().__init__()
        hd = attn_channels or num_channels
        if hd % num_heads:
            raise ValueError(f"attn_channels {hd} not divisible by num_heads {num_heads}")
        self.num_heads, self.attn_channels = num_heads, hd
        self.lin_q = nn.Linear(num_channels, hd, bias=qkv_bias)
        self.lin_k = nn.Linear(num_channels, hd, bias=qkv_bias)
        self.lin_v = nn.Linear(num_channels, hd, bias=qkv_bias)
        self.projection = nn.Linear(hd, num_channels)
        self.q_norm = QKNorm(hd // num_heads, qk_norm_type) if qk_norm else None
        self.k_norm = QKNorm(hd // num_heads, qk_norm_type) if qk_norm else None

    def forward(self, x_src: torch.Tensor, x_dst: torch.Tensor,
                shard: Optional[BlockShard] = None) -> torch.Tensor:
        """Under model shards (``shard``) the rank's queries attend over the
        whole source set: its keys and values are gathered from every
        rank's rows, their gradient summed back to the rows' owners."""
        b, nq, _ = x_dst.shape
        h, d = self.num_heads, self.attn_channels // self.num_heads
        hd = self.attn_channels
        k, v = self.lin_k(x_src), self.lin_v(x_src)
        if shard is not None:
            kv = shard.gather_src(torch.cat([k, v], dim=-1))
            k, v = kv[..., :hd], kv[..., hd:]
        nk = k.shape[1]
        q = self.lin_q(x_dst).view(b, nq, h, d)
        k = k.reshape(b, nk, h, d)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        out = cross_attention(q, k, v.reshape(b, nk, h, d))
        return self.projection(out.reshape(b, nq, self.attn_channels))
