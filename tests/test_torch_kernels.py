"""The CUDA kernels K1 and K2 against the plain PyTorch attention.

The ``cuda`` tests need a card and skip without one.  They import neither
JAX nor the JAX package, so they also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

They cover the head sizes the flagship (d = 32) does not: d < 32 (a
butterfly inside a warp) and d = 64 (a sum across warps), destinations
without edges, and both input types.  Tolerance: float32 1e-4 of max|ref|
(another summation order); bfloat16 2e-2 of max|ref| (the output is rounded
to bfloat16).
"""

import numpy as np
import pytest
import torch

from anemoi_tpu_torch.kernels import gt_attention as kern
from anemoi_tpu_torch.ops.gt_attention import gt_attention, gt_attention_fe


def make_case(rng, num_src, num_dst, hd, f=3, empty_dst=(3, 17)):
    src, dst = [], []
    for d in range(num_dst):
        if d in empty_dst:
            continue
        k = int(rng.integers(1, 12))
        src.append(rng.choice(num_src, size=k, replace=False))
        dst.append(np.full(k, d))
    ei = np.stack([np.concatenate(src), np.concatenate(dst)]).astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(ei[1], minlength=num_dst))]).astype(np.int32)
    arrays = {
        "q": rng.normal(size=(2, num_dst, hd)), "k": rng.normal(size=(2, num_src, hd)),
        "v": rng.normal(size=(2, num_src, hd)), "e": rng.normal(size=(ei.shape[1], hd)),
        "attr": rng.normal(size=(ei.shape[1], f)), "w": 0.3 * rng.normal(size=(f, hd)),
        "b": 0.1 * rng.normal(size=(hd,)),
    }
    return ei, ptr, {k: v.astype(np.float32) for k, v in arrays.items()}


def test_kernel_wrappers_refuse_cpu_tensors():
    """No silent fallback: the kernel wrappers take CUDA tensors only."""
    ei, ptr, a = make_case(np.random.default_rng(0), 20, 10, 8)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    with pytest.raises(ValueError, match="CUDA"):
        kern.gt_attention_edge(t["q"], t["k"], t["v"], t["e"], torch.from_numpy(ei),
                               torch.from_numpy(ptr), 2)
    with pytest.raises(ValueError, match="CUDA"):
        kern.gt_attention_fused_edge(t["q"], t["k"], t["v"], t["attr"], t["w"], t["b"],
                                     torch.from_numpy(ei), torch.from_numpy(ptr), 2)
    assert kern.gt_attention_edge.launches == kern.gt_attention_fused_edge.launches == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d", [(2, 4), (4, 8), (2, 64), (16, 32)])
@pytest.mark.parametrize("fused", [False, True], ids=["K2", "K1"])
def test_kernel_matches_plain(card, fused, heads, d, dtype):
    ei_np, ptr_np, a = make_case(np.random.default_rng(1), 300, 200, heads * d)
    t = {k: torch.from_numpy(v).to(card, dtype) for k, v in a.items()}
    ei, ptr = torch.from_numpy(ei_np).to(card), torch.from_numpy(ptr_np).to(card)
    if fused:
        args = (t["q"], t["k"], t["v"], t["attr"], t["w"], t["b"], ei, ptr, heads)
        fn, wrapper = gt_attention_fe, kern.gt_attention_fused_edge
    else:
        args = (t["q"], t["k"], t["v"], t["e"], ei, ptr, heads)
        fn, wrapper = gt_attention, kern.gt_attention_edge
    before = wrapper.launches
    out, lse = fn(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref, ref_lse = fn(*args, plain=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (out.float() - ref.float()).abs().max()
    assert err <= tol * ref.float().abs().max(), err
    assert torch.equal(lse.isneginf(), ref_lse.isneginf())
    finite = ref_lse.isfinite()
    torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=1e-4, atol=1e-4)
    assert torch.all(out[:, [3, 17]] == 0)
