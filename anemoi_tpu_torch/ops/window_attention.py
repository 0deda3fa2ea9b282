"""Sliding-window (banded) multi-head self-attention over a sequence.

The math of ``anemoi_tpu.models.layers.attention._window_attention`` and of
the TPU kernels in ``anemoi_tpu/ops/pallas/window_attention.py``: for batch
row b, head h and query position i of a sequence of n positions,

    s_ij  = q_i . k_j / sqrt(d)
    s_ij <- cap * tanh(s_ij / cap)             (softcap, when given)
    s_ij <- s_ij - slope_h * |i - j|           (ALiBi, when given)
    out_i = sum_j softmax_j(s_ij) v_j          over |i - j| <= w, 0 <= j < n

Layout ``[B, N, H, D]`` throughout (the JAX package's); ``lse`` is float32
``[B, H, N]``.

This module computes the band ``|i - j| <= w``.  When the band runs and
when full attention runs instead is the JAX ``MultiHeadSelfAttention``'s
rule, kept in ``models/layers/attention.py`` (``self_attention``).

The band is one ``torch.library`` op, :func:`band_attention_fwd`, with a
registered autograd.  On CPU tensors (or with ``plain=True``) it runs
:func:`band_attention_plain`, the port's copy of ``_window_attention``'s
block-banded scheme, and its backward is autograd of it.  On CUDA tensors
its forward launches K6 and its backward K7
(``anemoi_tpu_torch/kernels/window_attention.py``), softcap included; there
is no fallback -- a kernel that cannot run raises.
The plain versions compute in float32 (float64 for float64 inputs) and
round the output once to the input type, as the kernels do.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from anemoi_tpu_torch.ops.gt_attention import _use_plain

NEG = -1e30  # the mask value: fully masked rows stay NaN-free


def _acc_type(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def softcap_alibi(logits, dist, softcap, slopes, head_dim: int):
    """Softcap, then ALiBi; ``dist = |qpos - kpos|``, ``head_dim`` the axis of
    ``logits`` that holds the heads."""
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if slopes is not None:
        shape = [1] * logits.dim()
        shape[head_dim] = -1
        logits = logits - slopes.to(logits).view(shape) * dist.to(logits)
    return logits


def band_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
    softcap: Optional[float] = None, alibi_slopes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The band ``|i - j| <= w`` by ``_window_attention``'s block-banded
    scheme: the sequence is padded to a multiple of ``w`` and each block of
    ``w`` queries meets the previous, its own and the next block of keys
    (``torch.roll`` neighbourhoods; keys outside ``[0, n)`` are masked, so the
    roll's wrap-around never counts).  Any ``n >= 1``.  Returns ``out [B, N,
    H, D]`` in the input type and float32 ``lse [B, H, N]`` (float64 for
    float64 inputs).  Keeps ``[B, H, nb, w, 3w]`` logits."""
    b, n, h, d = q.shape
    w = int(window_size)
    acc = _acc_type(q)
    pad = (-n) % w
    nb = (n + pad) // w

    def blocks(x):
        x = x.to(acc)
        if pad:
            x = torch.cat([x, x.new_zeros(b, pad, h, d)], dim=1)
        return x.reshape(b, nb, w, h, d)

    def neighbourhood(x):
        xb = blocks(x)
        return torch.cat([torch.roll(xb, 1, dims=1), xb, torch.roll(xb, -1, dims=1)], dim=2)

    qb = blocks(q)
    kb, vb = neighbourhood(k), neighbourhood(v)  # [b, nb, 3w, h, d]
    logits = torch.einsum("bnqhd,bnkhd->bhnqk", qb, kb) / math.sqrt(d)  # [b, h, nb, w, 3w]
    block = torch.arange(nb, device=q.device)
    qpos = block[:, None] * w + torch.arange(w, device=q.device)[None, :]  # [nb, w]
    kpos = block[:, None] * w + torch.arange(-w, 2 * w, device=q.device)[None, :]  # [nb, 3w]
    dist = (qpos[:, :, None] - kpos[:, None, :]).abs()  # [nb, w, 3w]
    mask = ((kpos >= 0) & (kpos < n))[:, None, :] & (dist <= w)
    logits = softcap_alibi(logits, dist, softcap, alibi_slopes, 1)
    logits = torch.where(mask, logits, torch.full((), NEG, dtype=acc, device=q.device))
    lse = torch.logsumexp(logits, dim=-1)  # [b, h, nb, w]
    alpha = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
    out = torch.einsum("bhnqk,bnkhd->bnqhd", alpha, vb).reshape(b, nb * w, h, d)[:, :n]
    return out.to(q.dtype), lse.reshape(b, h, nb * w)[..., :n]


def band_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, grad: torch.Tensor, window_size: int,
    softcap: Optional[float] = None, alibi_slopes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward of the band: ``(dq, dk, dv)`` by autograd of
    :func:`band_attention_plain` in float32, each cast to its input's type.
    ``grad = dL/d out``."""
    acc = _acc_type(q)
    leaves = [x.detach().to(acc).requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        out, _ = band_attention_plain(*leaves, window_size, softcap, alibi_slopes)
        grads = torch.autograd.grad(out, leaves, grad.to(acc))
    return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))


@torch.library.custom_op("anemoi_tpu_torch::band_attention_fwd", mutates_args=())
def band_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
    softcap: Optional[float], slopes: Optional[torch.Tensor], plain: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The band as one op, ``(out, lse)``: :func:`band_attention_plain` with
    ``plain``, else K6.  Being an op, it is what a checkpoint policy sees
    (``models/layers/remat.py``: the ``save_attention`` policies keep its
    outputs, as the JAX package's keep the tagged ``flash_attn_out``/
    ``flash_attn_lse``)."""
    if plain:
        return band_attention_plain(q, k, v, window_size, softcap, slopes)
    from anemoi_tpu_torch.kernels import window_attention as kern

    return kern.window_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                     window_size, softcap, slopes)


@band_attention_fwd.register_fake
def _(q, k, v, window_size, softcap, slopes, plain):
    b, n, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, n), dtype=_acc_type(q))


def _band_setup_context(ctx, inputs, output):
    q, k, v, window_size, softcap, slopes, plain = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, slopes)
    ctx.window_size, ctx.softcap, ctx.plain = window_size, softcap, plain
    ctx.mark_non_differentiable(lse)


def _band_backward(ctx, g_out, _g_lse):
    """The plain version's autograd backward, or K7 (dq; dk and dv)."""
    q, k, v, out, lse, slopes = ctx.saved_tensors
    w, softcap = ctx.window_size, ctx.softcap
    if ctx.plain:
        dq, dk, dv = band_attention_bwd_plain(q, k, v, g_out, w, softcap, slopes)
        return dq, dk, dv, None, None, None, None
    from anemoi_tpu_torch.kernels import window_attention as kern

    q, k, v = (x.contiguous() for x in (q, k, v))
    g = g_out.contiguous()
    # delta = rowsum(dO * O) per (batch, head, position), float32 [B, H, N]
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = kern.window_attention_bwd_dq(q, k, v, g, lse, delta, w, softcap, slopes)
    dk, dv = kern.window_attention_bwd_dkv(q, k, v, g, lse, delta, w, softcap, slopes)
    return dq, dk, dv, None, None, None, None


band_attention_fwd.register_autograd(_band_backward, setup_context=_band_setup_context)


def band_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
    softcap: Optional[float] = None, alibi_slopes: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """The band ``|i - j| <= w`` of ``[B, N, H, D]`` inputs, differentiable:
    K6/K7 on CUDA tensors, :func:`band_attention_plain` and its autograd
    backward on CPU tensors or with ``plain=True``.  ``alibi_slopes``:
    float32 ``[H]`` or None (the slopes get no gradient)."""
    softcap = float(softcap) if softcap else None
    plain = _use_plain(q, plain)
    slopes = None if alibi_slopes is None else alibi_slopes.to(q.device, torch.float32)
    return band_attention_fwd(q, k, v, int(window_size), softcap, slopes, plain)[0]


def band_pairs(n: int, window_size: int) -> int:
    """(query, key) pairs of the band per (batch row, head): ``n (2w + 1)``
    less the ``w (w + 1)`` that fall off the two ends (for ``w < n``)."""
    w = min(int(window_size), n - 1)
    return n * (2 * w + 1) - w * (w + 1)

