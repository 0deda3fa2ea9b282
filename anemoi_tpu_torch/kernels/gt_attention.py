"""ctypes wrappers of the sparse graph-transformer attention kernels.

K1 (:func:`gt_attention_fused_edge`) and K2 (:func:`gt_attention_edge`) are
the two instantiations of ``csrc/gt_attention_fwd.cu``; they replace the TPU
kernel ``anemoi_tpu/ops/pallas/paged_gt.py:_fwd_kernel`` with
``fuse_edge=True`` and ``fuse_edge=False``.  Each wrapper validates its
inputs, allocates the outputs, launches on PyTorch's current stream, raises
if the launch failed, and adds one to its ``launches`` count.  The library is
built (``kernels/build.py``) and loaded at the first launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from anemoi_tpu_torch.kernels.build import load_library

MAX_EDGE_FEATURES = 8  # kMaxEdgeFeatures in the CUDA source
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("gt_attention_fwd").gt_attention_fwd
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 6
        + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


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


def _launch(query, key, value, edge_index, dst_ptr, num_heads, edge, weight, bias, f):
    b, nd, ns, hd, d = _check(query, key, value, edge_index, dst_ptr, num_heads)
    out = torch.empty_like(query)
    lse = torch.empty((b, nd, num_heads), device=query.device, dtype=torch.float32)
    fuse = weight is not None
    rc = _entry()(
        _DTYPE_CODES[query.dtype], int(fuse),
        query.data_ptr(), key.data_ptr(), value.data_ptr(),
        edge_index[0].data_ptr(), dst_ptr.data_ptr(), edge.data_ptr(),
        weight.data_ptr() if fuse else None, bias.data_ptr() if fuse else None,
        out.data_ptr(), lse.data_ptr(),
        b, nd, ns, hd, num_heads, f,
        weight.stride(0) if fuse else 0, weight.stride(1) if fuse else 0,
        1.0 / math.sqrt(d), torch.cuda.current_stream(query.device).cuda_stream,
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
    e, f = edge_attr.shape
    hd = query.shape[-1]
    if f > MAX_EDGE_FEATURES or weight.shape != (f, hd) or bias.shape != (hd,):
        raise ValueError(
            f"edge_attr [E, F<={MAX_EDGE_FEATURES}], weight [F, HD], bias [HD] expected; got "
            f"{tuple(edge_attr.shape)}, {tuple(weight.shape)}, {tuple(bias.shape)}"
        )
    if e != edge_index.shape[1] or not edge_attr.is_contiguous() or not bias.is_contiguous():
        raise ValueError("edge_attr must be contiguous with one row per edge; bias contiguous")
    for t in (edge_attr, weight, bias):
        if t.dtype != query.dtype or t.device != query.device:
            raise TypeError("edge_attr, weight and bias must match query's dtype and device")
    out = _launch(query, key, value, edge_index, dst_ptr, num_heads, edge_attr, weight, bias, f)
    gt_attention_fused_edge.launches += 1
    return out


def gt_attention_edge(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, edges: torch.Tensor,
    edge_index: torch.Tensor, dst_ptr: torch.Tensor, num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: attention with pre-projected edge features ``edges [E, HD]``.
    Returns ``out [B, Nd, HD]`` and ``lse [B, Nd, H]`` (float32)."""
    if edges.shape != (edge_index.shape[1], query.shape[-1]) or not edges.is_contiguous():
        raise ValueError(f"edges must be a contiguous [E, HD]; got {tuple(edges.shape)}")
    if edges.dtype != query.dtype or edges.device != query.device:
        raise TypeError("edges must match query's dtype and device")
    out = _launch(query, key, value, edge_index, dst_ptr, num_heads, edges, None, None, 0)
    gt_attention_edge.launches += 1
    return out


gt_attention_fused_edge.launches = 0
gt_attention_edge.launches = 0
