"""ctypes wrappers of the banded window-attention kernels.

K6 (:func:`window_attention_fwd`, ``csrc/window_attention_fwd.cu``) replaces
the TPU kernel ``anemoi_tpu/ops/pallas/window_attention.py:_flash_band_kernel``;
K7 is two kernels in ``csrc/window_attention_bwd.cu``:
:func:`window_attention_bwd_dq` (replacing ``_flash_bwd_dq_kernel``) and
:func:`window_attention_bwd_dkv` (replacing ``_flash_bwd_dkv_kernel``).

Inputs are ``[B, N, H, D]`` (contiguous, 16-byte aligned; D 16, 32, 64 or
128), float32 or bfloat16; ``lse`` and ``delta`` are float32 ``[B, H, N]``;
``softcap`` None or a positive float; ``slopes`` None or float32 ``[H]`` on
the same card.  The route depends on the type alone: float32 K6 and K7 do
their arithmetic in float32 on CUDA cores; bfloat16 K6 runs its products on
the warpgroup tensor cores (``wgmma`` m64nNk16) and bfloat16 K7 on
``mma.sync`` m16n8k16, both with bf16 inputs and float32 accumulators and
tiles staged with 16-byte ``cp.async`` copies, hence the alignment.
Each wrapper validates its inputs, allocates the outputs, launches on
PyTorch's current stream, raises if the launch failed, and adds one to its
``launches`` count.  The library is built (``kernels/build.py``) and loaded
at the first launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from anemoi_tpu_torch.kernels.build import load_library

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib_name: str, fn_name: str, n_ptrs: int):
    fn = getattr(load_library(lib_name), fn_name)
    fn.argtypes = [_I] + [_P] * n_ptrs + [_I] * 5 + [_F, _F, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entries():
    return {
        "fwd": _bind("window_attention_fwd", "window_attention_fwd", 6),
        "dq": _bind("window_attention_bwd", "window_attention_bwd_dq", 8),
        "dkv": _bind("window_attention_bwd", "window_attention_bwd_dkv", 9),
    }


def _check(q, k, v, window_size, softcap, slopes, *more):
    """Validate the shared inputs; returns (B, N, H, D)."""
    if not q.is_cuda:
        raise ValueError("the CUDA window-attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype} (float32 or bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"q, k, v must be [B, N, H, D]; got {tuple(q.shape)}")
    b, n, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not supported (one of {HEAD_DIMS})")
    if b > 65535 or h > 65535 or n >= 2**31 // (h * d):
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid or indexing")
    if int(window_size) < 0:
        raise ValueError(f"window_size must be >= 0, got {window_size}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or positive, got {softcap}")
    for name, t in (("k", k), ("v", v)) + tuple(("grad", t) for t in more):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match q "
                             f"{tuple(q.shape)} {q.dtype}")
    for t in (q, k, v) + more:
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError("q, k, v (and grad) must be contiguous on one card")
        if t.data_ptr() % 16:
            raise ValueError("q, k, v (and grad) must start on a 16-byte boundary")
    if slopes is not None and (slopes.shape != (h,) or slopes.dtype != torch.float32
                               or slopes.device != q.device or not slopes.is_contiguous()):
        raise ValueError("slopes must be a contiguous float32 [H] on q's card")
    return b, n, h, d


def _check_stats(q, lse, delta):
    b, n, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, n) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous float32 [B, H, N] on q's card")


def _tail(q, window_size, softcap, slopes):
    """The trailing arguments: slopes, B, N, H, D, w, scale, softcap, stream."""
    b, n, h, d = q.shape
    return (None if slopes is None else slopes.data_ptr(), b, n, h, d, int(window_size),
            1.0 / math.sqrt(d), float(softcap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream)


def window_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
    softcap: Optional[float] = None, slopes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: the band ``|i - j| <= window_size``.  Returns ``out [B, N, H, D]``
    in the input type and float32 ``lse [B, H, N]``.  bfloat16 runs on the
    warpgroup tensor cores (P rounded to bf16 for ``P V``), float32 on CUDA
    cores."""
    b, n, h, _ = _check(q, k, v, window_size, softcap, slopes)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), device=q.device, dtype=torch.float32)
    rc = _entries()["fwd"](_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), *_tail(q, window_size, softcap, slopes))
    if rc != 0:
        raise RuntimeError(f"window_attention_fwd launch failed: cudaError {rc}")
    window_attention_fwd.launches += 1
    return out, lse


def window_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, grad: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, window_size: int, softcap: Optional[float] = None,
    slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K7, its query side: ``dq [B, N, H, D]``.  ``grad = dL/d out``, ``lse``
    from K6, ``delta = sum_D(grad * out)`` as float32 ``[B, H, N]``.
    bfloat16 runs on the tensor cores (dS rounded to bf16 for ``dS K``),
    float32 on CUDA cores."""
    _check(q, k, v, window_size, softcap, slopes, grad)
    _check_stats(q, lse, delta)
    dq = torch.empty_like(q)
    rc = _entries()["dq"](_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          grad.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                          *_tail(q, window_size, softcap, slopes))
    if rc != 0:
        raise RuntimeError(f"window_attention_bwd_dq launch failed: cudaError {rc}")
    window_attention_bwd_dq.launches += 1
    return dq


def window_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, grad: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, window_size: int, softcap: Optional[float] = None,
    slopes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7, its key side: ``dk``, ``dv [B, N, H, D]``; inputs as for
    :func:`window_attention_bwd_dq`.  bfloat16 runs on the tensor cores (P
    and dS rounded to bf16 for ``P^T dO`` and ``dS^T Q``), float32 on CUDA
    cores."""
    _check(q, k, v, window_size, softcap, slopes, grad)
    _check_stats(q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _entries()["dkv"](_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           grad.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), *_tail(q, window_size, softcap, slopes))
    if rc != 0:
        raise RuntimeError(f"window_attention_bwd_dkv launch failed: cudaError {rc}")
    window_attention_bwd_dkv.launches += 1
    return dk, dv


KERNELS = {
    "K6": window_attention_fwd,
    "K7_dq": window_attention_bwd_dq,
    "K7_dkv": window_attention_bwd_dkv,
}
for _fn in KERNELS.values():
    _fn.launches = 0


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """{"K6": n, "K7_dq": n, "K7_dkv": n}: launches since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}
