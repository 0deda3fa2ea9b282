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

Both ops are differentiable: they run through one ``torch.library`` op,
:func:`gt_attention_fwd`, whose registered autograd is the counterpart of the
JAX package's ``custom_vjp``; ``lse`` is not differentiable.  The backward forms
``delta = sum_head(out * g)`` in float32 and then runs the destination pass
(K3) followed by the source pass (K4), or, with ``fused_bwd``, K3 without its
per-edge ``[B, E, 2HD]`` buffer followed by the fused source pass (K5).  The
source passes walk the source-ordered view ``(src_ptr, src_perm)``
(:func:`source_order`, :class:`SourceOrder`), which the kernel path requires
as ``source``: the model builds it once per edge set
(``SubGraphArrays.source``).

Dispatch: CPU tensors (or ``plain=True``) run the plain PyTorch versions in
this module, forward and backward; CUDA tensors launch the hand-written
kernels (``anemoi_tpu_torch/kernels``), with no fallback -- a kernel that
cannot run raises.  ``stabilize`` is accepted for parity with the JAX op and
has no effect: the running max of the online softmax is always exact.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def source_order(edge_index, num_src: int) -> Tuple[np.ndarray, np.ndarray]:
    """The source-ordered view of a dst-sorted edge list, built on the host:
    ``src_perm [E]``, the edge ids sorted by source and stable by destination,
    and ``src_ptr [Ns + 1]``, the CSR pointer into it (both int32)."""
    src = np.asarray(edge_index[0].cpu() if torch.is_tensor(edge_index) else edge_index[0])
    src_perm = np.argsort(src, kind="stable").astype(np.int32)
    src_ptr = np.zeros(num_src + 1, dtype=np.int32)
    np.cumsum(np.bincount(src, minlength=num_src), out=src_ptr[1:])
    return src_ptr, src_perm


def _acc_type(x: torch.Tensor) -> torch.dtype:
    """float32 for bf16/fp32 inputs, float64 for float64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _project(edges, edge_attr, weight, bias, dtype) -> torch.Tensor:
    if weight is None:
        return edges.to(dtype)
    return edge_attr.to(dtype) @ weight.to(dtype) + bias.to(dtype)


def gt_attention_plain(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
    edges: Optional[torch.Tensor], edge_index: torch.Tensor, dst_ptr: torch.Tensor,
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (float32 segment max-shift softmax through
    ``scatter_reduce``/``index_add_``) of ``[B, Nd, HD]`` attention."""
    b, nd, hd = query.shape
    h, d = num_heads, hd // num_heads
    acc = _acc_type(query)
    src = edge_index[0].long()
    dst = edge_index[1].long()
    n_e = src.shape[0]
    q = query.to(acc).reshape(b, nd, h, d)
    k_e = key.to(acc).reshape(b, -1, h, d)[:, src]
    v_e = value.to(acc).reshape(b, -1, h, d)[:, src]
    if edges is not None:
        e = edges.to(acc).reshape(1, n_e, h, d)
        k_e = k_e + e
        v_e = v_e + e
    logits = (q[:, dst] * k_e).sum(-1) / math.sqrt(d)  # [B, E, H]
    idx = dst.view(1, n_e, 1).expand(b, n_e, h)
    seg_max = torch.full((b, nd, h), -math.inf, device=query.device, dtype=acc).scatter_reduce(
        1, idx, logits, reduce="amax", include_self=True
    )
    p = torch.exp(logits - seg_max[:, dst])
    den = torch.zeros((b, nd, h), device=query.device, dtype=acc).index_add_(1, dst, p)
    num = torch.zeros((b, nd, h, d), device=query.device, dtype=acc).index_add_(
        1, dst, p[..., None] * v_e
    )
    out = torch.where(den[..., None] > 0, num / den.clamp_min(1e-30)[..., None], 0.0)
    lse = seg_max + torch.log(den)  # -inf + -inf = -inf for empty destinations
    return out.reshape(b, nd, hd).to(query.dtype), lse


class AttentionGrads(NamedTuple):
    """Gradients of the attention.  ``dq``, ``dk``, ``dv`` in the input
    type; ``d_edges [E, HD]`` (pre-projected edges) or ``d_attr [E, F]``,
    ``d_weight [F, HD]`` and ``d_bias [HD]`` (fused projection) in float32
    (float64 for float64 inputs), summed over the batch rows.  Gradients not
    asked for are None."""

    dq: torch.Tensor
    dk: torch.Tensor
    dv: torch.Tensor
    d_edges: Optional[torch.Tensor] = None
    d_attr: Optional[torch.Tensor] = None
    d_weight: Optional[torch.Tensor] = None
    d_bias: Optional[torch.Tensor] = None


def gt_attention_bwd_plain(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, edge_index: torch.Tensor,
    num_heads: int, out: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor, *,
    edges: Optional[torch.Tensor] = None, edge_attr: Optional[torch.Tensor] = None,
    weight: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
) -> AttentionGrads:
    """Plain PyTorch backward of ``[B, Nd, HD]`` attention (``index_add_``
    over the edges, float32 arithmetic): the math of the TPU kernels K3-K5.
    ``out`` and ``lse`` are the forward's, ``grad = dL/d out``."""
    b, nd, hd = query.shape
    h, d = num_heads, hd // num_heads
    acc = _acc_type(query)
    src = edge_index[0].long()
    dst = edge_index[1].long()
    n_e, ns = src.shape[0], key.shape[1]
    scale = 1.0 / math.sqrt(d)
    e = _project(edges, edge_attr, weight, bias, acc).reshape(1, n_e, h, d)
    k_eff = key.to(acc).reshape(b, ns, h, d)[:, src] + e
    v_eff = value.to(acc).reshape(b, ns, h, d)[:, src] + e
    q = query.to(acc).reshape(b, nd, h, d)
    g = grad.to(acc).reshape(b, nd, h, d)
    delta = (out.to(acc).reshape(b, nd, h, d) * g).sum(-1)  # [B, Nd, H]
    q_e, g_e = q[:, dst], g[:, dst]
    logits = (q_e * k_eff).sum(-1) * scale  # [B, E, H]
    # gathered at edge destinations only: lse is finite there (-inf marks a
    # destination without edges, which no edge points at)
    alpha = torch.exp(logits - lse.to(acc)[:, dst])
    dl = alpha * ((g_e * v_eff).sum(-1) - delta[:, dst]) * scale
    dk_e = dl[..., None] * q_e
    dv_e = alpha[..., None] * g_e
    dq = torch.zeros_like(q).index_add_(1, dst, dl[..., None] * k_eff)
    dk = torch.zeros((b, ns, h, d), dtype=acc, device=query.device).index_add_(1, src, dk_e)
    dv = torch.zeros_like(dk).index_add_(1, src, dv_e)
    de = (dk_e + dv_e).sum(0).reshape(n_e, hd)
    grads = AttentionGrads(
        dq.reshape(b, nd, hd).to(query.dtype), dk.reshape(b, ns, hd).to(key.dtype),
        dv.reshape(b, ns, hd).to(value.dtype),
    )
    if weight is None:
        return grads._replace(d_edges=de)
    return grads._replace(
        d_attr=de @ weight.to(acc).t(), d_weight=edge_attr.to(acc).t() @ de, d_bias=de.sum(0)
    )


def gt_attention_bwd_src_plain(
    dkv: torch.Tensor, src_ptr: torch.Tensor, src_perm: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 (the TPU kernel ``_reduce_kernel``):
    ``dk``, ``dv [B, Ns, HD]``, the float32 sums of the rows of ``dkv [B, E,
    2HD]`` into their sources through the source-ordered view, rounded once
    to the input type; zeros at sources without edges.  The rows are summed
    in ``src_perm`` order (an ``index_add_`` over the permuted rows, serial on
    the CPU)."""
    acc_type = _acc_type(dkv)
    b, _, two_hd = dkv.shape
    ns, hd = src_ptr.shape[0] - 1, two_hd // 2
    perm = src_perm.long()
    counts = (src_ptr[1:] - src_ptr[:-1]).long()
    sources = torch.repeat_interleave(torch.arange(ns, device=dkv.device), counts)
    acc = torch.zeros((b, ns, two_hd), device=dkv.device, dtype=acc_type).index_add_(
        1, sources, dkv[:, perm].to(acc_type))
    return acc[..., :hd].to(dkv.dtype), acc[..., hd:].to(dkv.dtype)


def gt_attention_bwd_kernels(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, edge_index: torch.Tensor,
    dst_ptr: torch.Tensor, src_ptr: torch.Tensor, src_perm: torch.Tensor, num_heads: int,
    out: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor, *,
    edges: Optional[torch.Tensor] = None, edge_attr: Optional[torch.Tensor] = None,
    weight: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
    fused_bwd: bool = False, edge_grad: bool = True, weight_grad: bool = True,
) -> AttentionGrads:
    """The backward on the card: K3 then K4, or K3 without dkv then K5
    (``fused_bwd``).  Same inputs and outputs as :func:`gt_attention_bwd_plain`;
    ``edge_grad``/``weight_grad`` skip the per-edge and weight gradients."""
    from anemoi_tpu_torch.kernels import gt_attention as kern

    b, nd, hd = query.shape
    grad = grad.contiguous()
    delta = (out.float() * grad.float()).reshape(b, nd, num_heads, -1).sum(-1)
    edge_kw = dict(edges=edges, edge_attr=edge_attr, weight=weight, bias=bias)
    k3 = kern.gt_attention_bwd_dst(
        query, key, value, grad, lse, delta, edge_index, dst_ptr, num_heads,
        emit_dkv=not fused_bwd, edge_grad=edge_grad, weight_grad=weight_grad, **edge_kw,
    )
    if fused_bwd:
        dk, dv = kern.gt_attention_bwd_src_fused(
            query, key, value, grad, lse, delta, edge_index, dst_ptr, src_ptr, src_perm,
            num_heads, **edge_kw,
        )
    else:
        dk, dv = kern.gt_attention_bwd_src(k3.dkv, src_ptr, src_perm)
    grads = AttentionGrads(k3.dq, dk, dv)
    if weight is None:
        return grads._replace(d_edges=k3.d_edge)
    return grads._replace(d_attr=k3.d_edge, d_weight=k3.d_weight, d_bias=k3.d_bias)


class SourceOrder(NamedTuple):
    """The source-ordered view of one edge set on its device (int32)."""

    src_ptr: torch.Tensor
    src_perm: torch.Tensor

    @classmethod
    def of(cls, edge_index: torch.Tensor, num_src: int) -> "SourceOrder":
        """Built on the host (:func:`source_order`), for static edge sets."""
        ptr, perm = source_order(edge_index, num_src)
        dev = edge_index.device
        return cls(torch.as_tensor(ptr, device=dev), torch.as_tensor(perm, device=dev))

    @classmethod
    def on_device(cls, edge_index: torch.Tensor, num_src: int) -> "SourceOrder":
        """The same view built on ``edge_index``'s device with no host round
        trip (edge sets built inside a step): a stable ``argsort`` of the
        sources and a ``searchsorted`` of each source's first edge."""
        src = edge_index[0].long()
        perm = torch.argsort(src, stable=True)
        bounds = torch.arange(num_src + 1, dtype=torch.long, device=src.device)
        ptr = torch.searchsorted(src[perm], bounds)
        return cls(ptr.to(torch.int32), perm.to(torch.int32))


@torch.library.custom_op("anemoi_tpu_torch::gt_attention_fwd", mutates_args=())
def gt_attention_fwd(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
    edges: Optional[torch.Tensor], edge_attr: Optional[torch.Tensor],
    weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
    edge_index: torch.Tensor, dst_ptr: torch.Tensor,
    src_ptr: Optional[torch.Tensor], src_perm: Optional[torch.Tensor],
    num_heads: int, fused_bwd: bool, plain: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, Nd, HD]`` attention as one op, ``(out, lse)``: the plain version
    with ``plain``, else K1 (``weight`` given) or K2.  Being an op, it is
    what a checkpoint policy sees (``models/layers/remat.py``: the
    ``save_attention`` policies keep its outputs, as the JAX package's keep
    the tagged ``paged_attn_out``/``paged_attn_lse``).  ``src_ptr``,
    ``src_perm`` and ``fused_bwd`` steer only the backward."""
    if plain:
        return gt_attention_plain(
            query, key, value, _project(edges, edge_attr, weight, bias, _acc_type(query)),
            edge_index, dst_ptr, num_heads,
        )
    from anemoi_tpu_torch.kernels import gt_attention as kern

    if weight is None:
        return kern.gt_attention_edge(query, key, value, edges, edge_index, dst_ptr, num_heads)
    return kern.gt_attention_fused_edge(
        query, key, value, edge_attr, weight, bias, edge_index, dst_ptr, num_heads
    )


@gt_attention_fwd.register_fake
def _(query, key, value, edges, edge_attr, weight, bias, edge_index, dst_ptr, src_ptr,
      src_perm, num_heads, fused_bwd, plain):
    b, nd, _ = query.shape
    return torch.empty_like(query), query.new_empty((b, nd, num_heads), dtype=_acc_type(query))


def _gt_setup_context(ctx, inputs, output):
    (query, key, value, edges, edge_attr, weight, bias, edge_index, dst_ptr, src_ptr, src_perm,
     num_heads, fused_bwd, plain) = inputs
    out, lse = output
    ctx.save_for_backward(query, key, value, edges, edge_attr, weight, bias, out, lse,
                          edge_index, dst_ptr, src_ptr, src_perm)
    ctx.num_heads, ctx.fused_bwd, ctx.plain = num_heads, fused_bwd, plain
    ctx.mark_non_differentiable(lse)


def _gt_backward(ctx, g_out, _g_lse):
    (query, key, value, edges, edge_attr, weight, bias, out, lse,
     edge_index, dst_ptr, src_ptr, src_perm) = ctx.saved_tensors
    need = ctx.needs_input_grad
    edge_kw = dict(edges=edges, edge_attr=edge_attr, weight=weight, bias=bias)
    if ctx.plain:
        grads = gt_attention_bwd_plain(
            query, key, value, edge_index, ctx.num_heads, out, lse, g_out, **edge_kw
        )
    else:
        grads = gt_attention_bwd_kernels(
            query, key, value, edge_index, dst_ptr, src_ptr, src_perm, ctx.num_heads, out, lse,
            g_out, fused_bwd=ctx.fused_bwd, edge_grad=need[3] or need[4],
            weight_grad=need[5] or need[6], **edge_kw,
        )
    return (grads.dq, grads.dk, grads.dv,
            grads.d_edges if need[3] else None, grads.d_attr if need[4] else None,
            grads.d_weight if need[5] else None, grads.d_bias if need[6] else None,
            *(None,) * 7)


gt_attention_fwd.register_autograd(_gt_backward, setup_context=_gt_setup_context)


def _use_plain(query: torch.Tensor, plain: bool) -> bool:
    if plain or query.device.type == "cpu":
        return True
    if query.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {query.device}")
    return False


def _apply(query, key, value, edges, edge_attr, weight, bias, edge_index, dst_ptr, num_heads,
           plain, source, fused_bwd):
    plain = _use_plain(query, plain)
    if not plain and source is None:
        raise ValueError("the kernel path needs the source-ordered view: pass "
                         "source=SourceOrder.of(edge_index, num_src)")
    src_ptr, src_perm = source if source is not None else (None, None)
    args = (edges, edge_attr, weight, bias, edge_index, dst_ptr, src_ptr, src_perm,
            int(num_heads), bool(fused_bwd), plain)
    if query.dim() == 2:
        out, lse = gt_attention_fwd(query[None], key[None], value[None], *args)
        return out[0], lse[0]
    return gt_attention_fwd(query, key, value, *args)


def gt_attention(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, edges: torch.Tensor,
    edge_index: torch.Tensor, dst_ptr: torch.Tensor, num_heads: int,
    stabilize: bool = True, plain: bool = False, source: Optional[SourceOrder] = None,
    fused_bwd: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with pre-projected edge features ``edges [E, HD]`` (the
    counterpart of ``paged_gt_attention_flat``; kernel K2 on the card, K3 +
    K4 or K3 + K5 for its backward).  The kernel path requires ``source``,
    the edge set's :class:`SourceOrder`."""
    del stabilize
    return _apply(query, key, value, edges, None, None, None, edge_index, dst_ptr, num_heads,
                  plain, source, fused_bwd)


def gt_attention_fe(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
    edge_attr: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    edge_index: torch.Tensor, dst_ptr: torch.Tensor, num_heads: int,
    stabilize: bool = True, plain: bool = False, source: Optional[SourceOrder] = None,
    fused_bwd: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with the edge projection fused: raw ``edge_attr [E, F]``,
    ``weight [F, HD]``, ``bias [HD]`` (the counterpart of
    ``paged_gt_attention_flat_fe``; kernel K1 on the card, which never forms
    the projected ``[E, HD]`` tensor, and K3 + K4 or K3 + K5 for its
    backward, which return ``d_attr``, ``d_weight`` and ``d_bias``).  The
    kernel path requires ``source``, as :func:`gt_attention` does."""
    del stabilize
    return _apply(query, key, value, None, edge_attr, weight, bias, edge_index, dst_ptr,
                  num_heads, plain, source, fused_bwd)
