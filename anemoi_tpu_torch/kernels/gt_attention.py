"""ctypes wrappers of the sparse graph-transformer attention kernels.

Forward (``csrc/gt_attention_fwd.cu``), replacing the TPU kernel
``anemoi_tpu/ops/pallas/paged_gt.py:_fwd_kernel``: K1
(:func:`gt_attention_fused_edge`, ``fuse_edge=True``) and K2
(:func:`gt_attention_edge`, ``fuse_edge=False``).

Backward (``csrc/gt_attention_bwd.cu``): K3 (:func:`gt_attention_bwd_dst`,
replacing ``_bwd_kernel``), K4 (:func:`gt_attention_bwd_src`, replacing
``_reduce_kernel``) and K5 (:func:`gt_attention_bwd_src_fused`, replacing
``_fused_reduce_kernel``).

Each wrapper validates its inputs, allocates the outputs, launches on
PyTorch's current stream, raises if the launch failed, and adds one to its
``launches`` count.  A library is built (``kernels/build.py``) and loaded at
its first launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from anemoi_tpu_torch.kernels.build import load_library

MAX_EDGE_FEATURES = 8  # kMaxEdgeFeatures in the CUDA source
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib_name: str, fn_name: str, argtypes):
    fn = getattr(load_library(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _fwd_entry():
    return _bind("gt_attention_fwd", "gt_attention_fwd",
                 [_I, _I] + [_P] * 10 + [_I] * 6 + [_LL, _LL, ctypes.c_float, _P])


@functools.lru_cache(maxsize=None)
def _bwd_entries():
    lib = "gt_attention_bwd"
    return {
        "blocks": _bind(lib, "gt_attention_bwd_dst_blocks", [_I] * 5 + [_P]),
        "dst": _bind(lib, "gt_attention_bwd_dst",
                     [_I, _I] + [_P] * 17 + [_I] * 7 + [_LL, _LL, ctypes.c_float, _I, _P]),
        "src": _bind(lib, "gt_attention_bwd_src", [_I] + [_P] * 5 + [_I] * 4 + [_P]),
        "src_fused": _bind(lib, "gt_attention_bwd_src_fused",
                           [_I, _I] + [_P] * 14 + [_I] * 6 + [_LL, _LL, ctypes.c_float, _P]),
    }


@functools.lru_cache(maxsize=None)
def _dst_blocks(device_index: int, dtype_code: int, fused: bool, hd: int, num_heads: int,
                f: int) -> int:
    """Blocks of K3 resident on the card at once (its grid-stride width)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _bwd_entries()["blocks"](dtype_code, int(fused), hd, num_heads, f,
                                      ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"gt_attention_bwd_dst_blocks failed: cudaError {rc}")
    return out.value


def dst_instantiation(dtype: torch.dtype, d: int, f: int, fused: bool) -> Tuple[int, int]:
    """(V, FMAX) of the K3 instantiation that a launch takes (``dst_layout``
    and ``dst_kernel`` in the CUDA source): V channels a lane -- 16 bytes, or
    4 or 1 when the head size d is smaller -- and room for FMAX edge features
    (4 or 8; 1 without the fused projection)."""
    vmax = 16 // (torch.finfo(dtype).bits // 8)
    vec = vmax if d >= vmax else (4 if d >= 4 else 1)
    return vec, (4 if f <= 4 else MAX_EDGE_FEATURES) if fused else 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(query, key, value, edge_index, dst_ptr, num_heads):
    if not query.is_cuda:
        raise ValueError("the CUDA attention kernel needs CUDA tensors")
    if query.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {query.dtype} (float32 or bfloat16)")
    if query.dim() != 3 or key.dim() != 3 or key.shape != value.shape:
        raise ValueError("query [B, Nd, HD], key and value [B, Ns, HD] expected")
    b, nd, hd = query.shape
    if key.shape[0] != b or key.shape[2] != hd:
        raise ValueError(f"key/value {tuple(key.shape)} do not match query {tuple(query.shape)}")
    if hd % num_heads:
        raise ValueError(f"HD={hd} is not a multiple of num_heads={num_heads}")
    d = hd // num_heads
    if hd > 1024 or not ((d <= 32 and d & (d - 1) == 0) or d % 32 == 0):
        raise ValueError(
            f"kernel takes HD <= 1024 and a head size that is a power of two <= 32 "
            f"or a multiple of 32 (HD={hd}, d={d})"
        )
    if edge_index.dtype != torch.int32 or dst_ptr.dtype != torch.int32:
        raise TypeError("edge_index and dst_ptr must be int32")
    if dst_ptr.shape != (nd + 1,) or edge_index.dim() != 2 or edge_index.shape[0] != 2:
        raise ValueError("edge_index [2, E] and dst_ptr [Nd + 1] expected")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit")
    for name, t in (("query", query), ("key", key), ("value", value),
                    ("edge_index", edge_index), ("dst_ptr", dst_ptr)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != query.device:
            raise ValueError(f"{name} is on {t.device}, query on {query.device}")
        if t.is_floating_point() and t.dtype != query.dtype:
            raise TypeError(f"{name} is {t.dtype}, query {query.dtype}")
    return b, nd, key.shape[1], hd, d


def _check_edges(query, edge_index, edges, edge_attr, weight, bias):
    """The edge input: pre-projected ``edges [E, HD]`` (K2 side) or raw
    ``edge_attr [E, F]`` with ``weight [F, HD]`` (any strides) and ``bias
    [HD]`` (K1 side).  Returns (edge tensor, F, fused)."""
    hd, n_e = query.shape[-1], edge_index.shape[1]
    if weight is None:
        if edges is None or edges.shape != (n_e, hd) or not edges.is_contiguous():
            raise ValueError(f"edges must be a contiguous [E, HD]; got "
                             f"{None if edges is None else tuple(edges.shape)}")
        if edges.dtype != query.dtype or edges.device != query.device:
            raise TypeError("edges must match query's dtype and device")
        return edges, 0, False
    e, f = edge_attr.shape
    if f > MAX_EDGE_FEATURES or weight.shape != (f, hd) or bias is None or bias.shape != (hd,):
        raise ValueError(
            f"edge_attr [E, F<={MAX_EDGE_FEATURES}], weight [F, HD], bias [HD] expected; got "
            f"{tuple(edge_attr.shape)}, {tuple(weight.shape)}, "
            f"{None if bias is None else tuple(bias.shape)}"
        )
    if e != n_e or not edge_attr.is_contiguous() or not bias.is_contiguous():
        raise ValueError("edge_attr must be contiguous with one row per edge; bias contiguous")
    for t in (edge_attr, weight, bias):
        if t.dtype != query.dtype or t.device != query.device:
            raise TypeError("edge_attr, weight and bias must match query's dtype and device")
    return edge_attr, f, True


def _check_grad_inputs(query, grad, lse, delta, num_heads):
    b, nd, _ = query.shape
    if grad.shape != query.shape or grad.dtype != query.dtype or not grad.is_contiguous():
        raise ValueError("grad must be a contiguous tensor of query's shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, nd, num_heads) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [B, Nd, H]")
    for t in (grad, lse, delta):
        if t.device != query.device:
            raise ValueError("grad, lse and delta must lie on query's device")


def _check_source_order(src_ptr, src_perm, n_src, n_edges, device):
    if src_ptr.dtype != torch.int32 or src_perm.dtype != torch.int32:
        raise TypeError("src_ptr and src_perm must be int32")
    if src_ptr.shape != (n_src + 1,) or src_perm.shape != (n_edges,):
        raise ValueError(f"src_ptr [Ns + 1 = {n_src + 1}] and src_perm [E = {n_edges}] expected; "
                         f"got {tuple(src_ptr.shape)}, {tuple(src_perm.shape)}")
    for t in (src_ptr, src_perm):
        if not t.is_contiguous() or t.device != device:
            raise ValueError("src_ptr and src_perm must be contiguous on the kernel's device")


def _launch(query, key, value, edge_index, dst_ptr, num_heads, edges, edge_attr, weight, bias):
    b, nd, ns, hd, d = _check(query, key, value, edge_index, dst_ptr, num_heads)
    edge, f, fuse = _check_edges(query, edge_index, edges, edge_attr, weight, bias)
    out = torch.empty_like(query)
    lse = torch.empty((b, nd, num_heads), device=query.device, dtype=torch.float32)
    rc = _fwd_entry()(
        _DTYPE_CODES[query.dtype], int(fuse),
        query.data_ptr(), key.data_ptr(), value.data_ptr(),
        edge_index[0].data_ptr(), dst_ptr.data_ptr(), edge.data_ptr(),
        _ptr(weight), _ptr(bias), out.data_ptr(), lse.data_ptr(),
        b, nd, ns, hd, num_heads, f,
        weight.stride(0) if fuse else 0, weight.stride(1) if fuse else 0,
        1.0 / math.sqrt(d), _stream(query),
    )
    if rc != 0:
        raise RuntimeError(f"gt_attention_fwd launch failed: cudaError {rc}")
    return out, lse


def gt_attention_fused_edge(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
    edge_attr: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    edge_index: torch.Tensor, dst_ptr: torch.Tensor, num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: attention with the edge projection ``edge_attr @ weight + bias``
    (raw ``edge_attr [E, F]``, ``weight [F, HD]`` of any strides, ``bias
    [HD]``) formed inside the kernel.  Returns ``out [B, Nd, HD]`` in the
    input type and ``lse [B, Nd, H]`` in float32."""
    out = _launch(query, key, value, edge_index, dst_ptr, num_heads, None, edge_attr, weight, bias)
    gt_attention_fused_edge.launches += 1
    return out


def gt_attention_edge(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, edges: torch.Tensor,
    edge_index: torch.Tensor, dst_ptr: torch.Tensor, num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: attention with pre-projected edge features ``edges [E, HD]``.
    Returns ``out [B, Nd, HD]`` and ``lse [B, Nd, H]`` (float32)."""
    out = _launch(query, key, value, edge_index, dst_ptr, num_heads, edges, None, None, None)
    gt_attention_edge.launches += 1
    return out


class DstGrads(NamedTuple):
    """Outputs of K3.  ``dkv [B, E, 2HD]`` (input type) is None when not
    emitted; ``d_edge`` is float32 ``d_e [E, HD]`` (pre-projected edges) or
    ``d_attr [E, F]`` (fused projection), None when not asked for;
    ``d_weight [F, HD]`` and ``d_bias [HD]`` are float32, fused projection
    only.  Edge gradients are summed over the batch rows."""

    dq: torch.Tensor
    dkv: Optional[torch.Tensor]
    d_edge: Optional[torch.Tensor]
    d_weight: Optional[torch.Tensor]
    d_bias: Optional[torch.Tensor]


def gt_attention_bwd_dst(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, grad: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, edge_index: torch.Tensor, dst_ptr: torch.Tensor,
    num_heads: int, *, edges: Optional[torch.Tensor] = None,
    edge_attr: Optional[torch.Tensor] = None, weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None, emit_dkv: bool = True, edge_grad: bool = True,
    weight_grad: bool = True,
) -> DstGrads:
    """K3, the destination pass of the backward.  ``grad = dL/d out [B, Nd,
    HD]``, ``lse`` from the forward and ``delta = sum_head(out * grad)``, both
    float32 ``[B, Nd, H]``.  The edge input is as in the forward: ``edges``
    (K2) or ``edge_attr``/``weight``/``bias`` (K1).  ``emit_dkv=False`` is
    the fused backward's first pass (K5 then forms dk, dv); ``edge_grad`` and
    ``weight_grad`` skip the per-edge and the weight gradients."""
    b, nd, ns, hd, d = _check(query, key, value, edge_index, dst_ptr, num_heads)
    edge, f, fuse = _check_edges(query, edge_index, edges, edge_attr, weight, bias)
    _check_grad_inputs(query, grad, lse, delta, num_heads)
    n_e = edge_index.shape[1]
    # each lane moves V channels of q, k, v, g and e as one aligned vector
    align = dst_instantiation(query.dtype, d, f, fuse)[0] * query.element_size()
    vectors = (("query", query), ("key", key), ("value", value), ("grad", grad))
    for name, t in vectors + (() if fuse else (("edges", edge),)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must start on a {align}-byte boundary")
    dev, code = query.device, _DTYPE_CODES[query.dtype]
    blocks = _dst_blocks(dev.index if dev.index is not None else torch.cuda.current_device(),
                         code, fuse, hd, num_heads, f)
    dq = torch.empty_like(query)
    dkv = torch.empty((b, n_e, 2 * hd), device=dev, dtype=query.dtype) if emit_dkv else None
    d_edge = (torch.empty((n_e, f if fuse else hd), device=dev, dtype=torch.float32)
              if edge_grad else None)
    dw = db = dw_part = None
    if fuse and weight_grad:
        dw = torch.empty((f, hd), device=dev, dtype=torch.float32)
        db = torch.empty((hd,), device=dev, dtype=torch.float32)
        dw_part = torch.empty((min(nd, blocks), f + 1, hd), device=dev, dtype=torch.float32)
    rc = _bwd_entries()["dst"](
        code, int(fuse), query.data_ptr(), key.data_ptr(), value.data_ptr(), grad.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), edge_index[0].data_ptr(), dst_ptr.data_ptr(),
        edge.data_ptr(), _ptr(weight), _ptr(bias), dq.data_ptr(), _ptr(dkv), _ptr(d_edge),
        _ptr(dw_part), _ptr(dw), _ptr(db),
        b, nd, ns, n_e, hd, num_heads, f,
        weight.stride(0) if fuse else 0, weight.stride(1) if fuse else 0,
        1.0 / math.sqrt(d), blocks, _stream(query),
    )
    if rc != 0:
        raise RuntimeError(f"gt_attention_bwd_dst launch failed: cudaError {rc}")
    gt_attention_bwd_dst.launches += 1
    return DstGrads(dq, dkv, d_edge, dw, db)


def gt_attention_bwd_src(
    dkv: torch.Tensor, src_ptr: torch.Tensor, src_perm: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4, the source pass: ``dk``, ``dv [B, Ns, HD]`` summed from the
    per-edge rows of ``dkv [B, E, 2HD]`` through the source-ordered view
    (``src_ptr [Ns + 1]``, ``src_perm [E]``, int32).  Sources without edges
    get zeros."""
    if not dkv.is_cuda:
        raise ValueError("the CUDA attention kernel needs CUDA tensors")
    if dkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {dkv.dtype} (float32 or bfloat16)")
    if dkv.dim() != 3 or dkv.shape[2] % 2 or dkv.shape[2] > 2048 or not dkv.is_contiguous():
        raise ValueError(f"dkv must be a contiguous [B, E, 2HD] with HD <= 1024; "
                         f"got {tuple(dkv.shape)}")
    b, n_e, two_hd = dkv.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit")
    ns = src_ptr.shape[0] - 1
    _check_source_order(src_ptr, src_perm, ns, n_e, dkv.device)
    hd = two_hd // 2
    dk = torch.empty((b, ns, hd), device=dkv.device, dtype=dkv.dtype)
    dv = torch.empty_like(dk)
    rc = _bwd_entries()["src"](
        _DTYPE_CODES[dkv.dtype], dkv.data_ptr(), src_ptr.data_ptr(), src_perm.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, ns, n_e, hd, _stream(dkv),
    )
    if rc != 0:
        raise RuntimeError(f"gt_attention_bwd_src launch failed: cudaError {rc}")
    gt_attention_bwd_src.launches += 1
    return dk, dv


def gt_attention_bwd_src_fused(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, grad: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, edge_index: torch.Tensor, dst_ptr: torch.Tensor,
    src_ptr: torch.Tensor, src_perm: torch.Tensor, num_heads: int, *,
    edges: Optional[torch.Tensor] = None, edge_attr: Optional[torch.Tensor] = None,
    weight: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5, the fused source pass: ``dk``, ``dv [B, Ns, HD]`` with each edge's
    attention weight and logit gradient recomputed from the destination's
    ``query``, ``grad``, ``lse`` and ``delta`` -- the ``[B, E, 2HD]`` dkv
    buffer of K3 + K4 never exists.  Inputs as for K3, plus the
    source-ordered view."""
    b, nd, ns, hd, d = _check(query, key, value, edge_index, dst_ptr, num_heads)
    edge, f, fuse = _check_edges(query, edge_index, edges, edge_attr, weight, bias)
    _check_grad_inputs(query, grad, lse, delta, num_heads)
    _check_source_order(src_ptr, src_perm, ns, edge_index.shape[1], query.device)
    dk = torch.empty_like(key)
    dv = torch.empty_like(value)
    rc = _bwd_entries()["src_fused"](
        _DTYPE_CODES[query.dtype], int(fuse), query.data_ptr(), key.data_ptr(),
        value.data_ptr(), grad.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        edge_index[1].data_ptr(), src_ptr.data_ptr(), src_perm.data_ptr(), edge.data_ptr(),
        _ptr(weight), _ptr(bias), dk.data_ptr(), dv.data_ptr(),
        b, nd, ns, hd, num_heads, f,
        weight.stride(0) if fuse else 0, weight.stride(1) if fuse else 0,
        1.0 / math.sqrt(d), _stream(query),
    )
    if rc != 0:
        raise RuntimeError(f"gt_attention_bwd_src_fused launch failed: cudaError {rc}")
    gt_attention_bwd_src_fused.launches += 1
    return dk, dv


KERNELS = {
    "K1": gt_attention_fused_edge,
    "K2": gt_attention_edge,
    "K3": gt_attention_bwd_dst,
    "K4": gt_attention_bwd_src,
    "K5": gt_attention_bwd_src_fused,
}
for _fn in KERNELS.values():
    _fn.launches = 0


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """{"K1": n, ...}: each kernel's launches since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}
