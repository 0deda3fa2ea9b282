"""The CUDA kernels K1-K5 against the plain PyTorch attention and its
plain backward.

The ``cuda`` tests need a card and skip without one.  They import neither
JAX nor the JAX package, so they also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

They cover the head sizes the flagship (d = 32) does not: d < 32 (a
butterfly inside a warp) and d = 64 (a sum across warps), destinations
without edges, sources without edges (backward), and both input types.
Tolerance, per output: float32 1e-4 of max|ref| (another summation order);
bfloat16 2e-2 of max|ref| (outputs and the dkv buffer are rounded to
bfloat16).
"""

import numpy as np
import pytest
import torch

from anemoi_tpu_torch.kernels import gt_attention as kern
from anemoi_tpu_torch.ops.gt_attention import (
    SourceOrder,
    gt_attention,
    gt_attention_bwd_kernels,
    gt_attention_bwd_plain,
    gt_attention_fe,
)

DEAD_SRC = (0, 5, 299)


def make_case(rng, num_src, num_dst, hd, f=3, empty_dst=(3, 17), dead_src=()):
    src, dst = [], []
    alive = np.setdiff1d(np.arange(num_src), dead_src)
    for d in range(num_dst):
        if d in empty_dst:
            continue
        k = int(rng.integers(1, 12))
        src.append(rng.choice(alive, size=k, replace=False))
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
    with pytest.raises(ValueError, match="source-ordered view"):
        fn(*args)
    before = wrapper.launches
    out, lse = fn(*args, source=SourceOrder.of(ei, 300))
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


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    ei, ptr, a = make_case(np.random.default_rng(0), 20, 10, 8)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ei, ptr = torch.from_numpy(ei), torch.from_numpy(ptr)
    order = SourceOrder.of(ei, 20)
    lse = torch.zeros(2, 10, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kern.gt_attention_bwd_dst(t["q"], t["k"], t["v"], t["q"], lse, lse, ei, ptr, 2,
                                  edges=t["e"])
    with pytest.raises(ValueError, match="CUDA"):
        kern.gt_attention_bwd_src(torch.zeros(2, ei.shape[1], 16), order.src_ptr, order.src_perm)
    with pytest.raises(ValueError, match="CUDA"):
        kern.gt_attention_bwd_src_fused(t["q"], t["k"], t["v"], t["q"], lse, lse, ei, ptr,
                                        order.src_ptr, order.src_perm, 2, edge_attr=t["attr"],
                                        weight=t["w"], bias=t["b"])
    assert kern.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d", [(2, 4), (4, 8), (2, 64), (16, 32)])
@pytest.mark.parametrize("fused", [False, True], ids=["edges", "fused_edge"])
@pytest.mark.parametrize("fused_bwd", [False, True], ids=["K3_K4", "K3_K5"])
def test_backward_kernels_match_plain(card, fused_bwd, fused, heads, d, dtype):
    ei_np, ptr_np, a = make_case(np.random.default_rng(2), 300, 200, heads * d,
                                 dead_src=DEAD_SRC)
    t = {k: torch.from_numpy(v).to(card, dtype) for k, v in a.items()}
    ei, ptr = torch.from_numpy(ei_np).to(card), torch.from_numpy(ptr_np).to(card)
    order = SourceOrder.of(ei, 300)
    edge_kw = (dict(edge_attr=t["attr"], weight=t["w"], bias=t["b"]) if fused
               else dict(edges=t["e"]))
    if fused:
        out, lse = gt_attention_fe(t["q"], t["k"], t["v"], t["attr"], t["w"], t["b"], ei, ptr,
                                   heads, source=order)
    else:
        out, lse = gt_attention(t["q"], t["k"], t["v"], t["e"], ei, ptr, heads, source=order)
    g = torch.randn(out.shape, generator=torch.Generator(card).manual_seed(0), device=card)
    g = g.to(dtype)
    before = kern.launch_counts()
    got = gt_attention_bwd_kernels(t["q"], t["k"], t["v"], ei, ptr, order.src_ptr,
                                   order.src_perm, heads, out, lse, g, fused_bwd=fused_bwd,
                                   **edge_kw)
    torch.cuda.synchronize()
    after = kern.launch_counts()
    assert after["K3"] == before["K3"] + 1
    assert after["K5" if fused_bwd else "K4"] == before["K5" if fused_bwd else "K4"] + 1
    ref = gt_attention_bwd_plain(t["q"], t["k"], t["v"], ei, heads, out, lse, g, **edge_kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    names = ("dq", "dk", "dv") + (("d_attr", "d_weight", "d_bias") if fused else ("d_edges",))
    for name in names:
        x, y = getattr(got, name).float(), getattr(ref, name).float()
        err = (x - y).abs().max()
        assert err <= tol * y.abs().max(), (name, err.item(), y.abs().max().item())
    assert torch.all(got.dk[:, list(DEAD_SRC)] == 0) and torch.all(got.dv[:, list(DEAD_SRC)] == 0)
    assert torch.all(got.dq[:, [3, 17]] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("fused_bwd", [False, True], ids=["K3_K4", "K3_K5"])
def test_autograd_reaches_every_input_on_the_card(card, fused_bwd):
    """The kernel path's autograd: every input, the edge projection's weight
    and bias included, gets the plain path's gradient."""
    ei_np, ptr_np, a = make_case(np.random.default_rng(3), 300, 200, 64)
    ei, ptr = torch.from_numpy(ei_np).to(card), torch.from_numpy(ptr_np).to(card)
    order = SourceOrder.of(ei, 300)
    grads = {}
    for plain in (False, True):
        t = {k: torch.from_numpy(v).to(card).requires_grad_() for k, v in a.items()}
        out, _ = gt_attention_fe(t["q"], t["k"], t["v"], t["attr"], t["w"], t["b"], ei, ptr, 4,
                                 plain=plain, source=order, fused_bwd=fused_bwd)
        (out * torch.linspace(-1, 1, out.numel(), device=card).view(out.shape)).sum().backward()
        grads[plain] = {n: t[n].grad for n in ("q", "k", "v", "attr", "w", "b")}
    for name, ref in grads[True].items():
        got = grads[False][name]
        assert got is not None and got.abs().max() > 0, name
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max(), name
