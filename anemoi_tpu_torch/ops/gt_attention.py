"""Sparse multi-head graph-transformer attention over a dst-sorted CSR.

The math of ``anemoi_tpu.ops.segment.graph_transformer_attention`` and of the
TPU kernel ``paged_gt.py:_fwd_kernel``: for destination i and head h, over
the incoming edges j -> i,

    a_ij  = softmax_j( q_i . (k_j + e_ij) / sqrt(d) )
    out_i = sum_j a_ij (v_j + e_ij)

with ``e_ij`` either given (``gt_attention``, pre-projected ``[E, HD]``) or
projected from raw attributes (``gt_attention_fe``, ``attr [E, F] @ W [F, HD]
+ b``).  Both return ``(out, lse)``: ``out`` ``[..., Nd, HD]`` in the input
type, ``lse`` ``[..., Nd, H]`` in float32.  A destination with no incoming
edges gets ``out = 0`` and ``lse = -inf``.  ``query`` is ``[Nd, HD]`` or
``[B, Nd, HD]``; edges, attributes and weights are shared over the batch.

Dispatch: CPU tensors (or ``plain=True``) run the plain PyTorch version in
this module; CUDA tensors launch the hand-written kernel
(``anemoi_tpu_torch/kernels``), with no fallback -- a kernel that cannot run
raises.  ``stabilize`` is accepted for parity with the JAX op and has no
effect: the running max of the online softmax is always exact.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def gt_attention_plain(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
    edges: Optional[torch.Tensor], edge_index: torch.Tensor, dst_ptr: torch.Tensor,
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (float32 segment max-shift softmax through
    ``scatter_reduce``/``index_add_``) of ``[B, Nd, HD]`` attention."""
    b, nd, hd = query.shape
    h, d = num_heads, hd // num_heads
    src = edge_index[0].long()
    dst = edge_index[1].long()
    n_e = src.shape[0]
    q = query.float().reshape(b, nd, h, d)
    k_e = key.float().reshape(b, -1, h, d)[:, src]
    v_e = value.float().reshape(b, -1, h, d)[:, src]
    if edges is not None:
        e = edges.float().reshape(1, n_e, h, d)
        k_e = k_e + e
        v_e = v_e + e
    logits = (q[:, dst] * k_e).sum(-1) / math.sqrt(d)  # [B, E, H]
    idx = dst.view(1, n_e, 1).expand(b, n_e, h)
    seg_max = torch.full((b, nd, h), -math.inf, device=query.device).scatter_reduce(
        1, idx, logits, reduce="amax", include_self=True
    )
    p = torch.exp(logits - seg_max[:, dst])
    den = torch.zeros((b, nd, h), device=query.device).index_add_(1, dst, p)
    num = torch.zeros((b, nd, h, d), device=query.device).index_add_(1, dst, p[..., None] * v_e)
    out = torch.where(den[..., None] > 0, num / den.clamp_min(1e-30)[..., None], 0.0)
    lse = seg_max + torch.log(den)  # -inf + -inf = -inf for empty destinations
    return out.reshape(b, nd, hd).to(query.dtype), lse


def _batched(fn, query, key, value, *args):
    if query.dim() == 2:
        out, lse = fn(query[None], key[None], value[None], *args)
        return out[0], lse[0]
    return fn(query, key, value, *args)


def _use_plain(query: torch.Tensor, plain: bool) -> bool:
    if plain or query.device.type == "cpu":
        return True
    if query.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {query.device}")
    return False


def gt_attention(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, edges: torch.Tensor,
    edge_index: torch.Tensor, dst_ptr: torch.Tensor, num_heads: int,
    stabilize: bool = True, plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with pre-projected edge features ``edges [E, HD]`` (the
    counterpart of ``paged_gt_attention_flat``; kernel K2 on the card)."""
    del stabilize
    if _use_plain(query, plain):
        return _batched(gt_attention_plain, query, key, value, edges, edge_index, dst_ptr, num_heads)
    from anemoi_tpu_torch.kernels.gt_attention import gt_attention_edge

    return _batched(gt_attention_edge, query, key, value, edges, edge_index, dst_ptr, num_heads)


def gt_attention_fe(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
    edge_attr: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    edge_index: torch.Tensor, dst_ptr: torch.Tensor, num_heads: int,
    stabilize: bool = True, plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with the edge projection fused: raw ``edge_attr [E, F]``,
    ``weight [F, HD]``, ``bias [HD]`` (the counterpart of
    ``paged_gt_attention_flat_fe``; kernel K1 on the card, which never forms
    the projected ``[E, HD]`` tensor)."""
    del stabilize
    if _use_plain(query, plain):
        edges = edge_attr.float() @ weight.float() + bias.float()
        return _batched(gt_attention_plain, query, key, value, edges, edge_index, dst_ptr, num_heads)
    from anemoi_tpu_torch.kernels.gt_attention import gt_attention_fused_edge

    return _batched(
        gt_attention_fused_edge, query, key, value, edge_attr, weight, bias,
        edge_index, dst_ptr, num_heads,
    )
