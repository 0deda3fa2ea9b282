"""The CUDA kernels K1-K7 against the plain PyTorch attention and its
plain backward.

The ``cuda`` tests need a card and skip without one.  They import neither
JAX nor the JAX package, so they also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

They cover the head sizes the flagship (d = 32) does not: d < 32 and d =
64 -- also at HD = 1024 (16 x 64, the Transformer preset's mappers: 1024
threads a block in K1, K4, K5) --, destinations without edges, sources
without edges (backward), and both input types; for the destination pass K3
also a destination of in-degree 75 (three chunks of edge sources) and heads
of 512 channels (a head sum across warps), bitwise repeatability in bf16 and
the refusal of a query or grad off its 16-byte vector boundary.  The banded window kernels K6 (forward: out and lse) and K7 (dq; dk
and dv) are held against ``band_attention_plain`` and its autograd backward,
with softcap, ALiBi, a ragged last tile, a full band over several tiles and
a sequence shorter than one tile, and logits large enough that the running
max jumps between key tiles; bf16 K6 and K7 (tensor cores) must be bitwise
repeatable and refuse tensors off a 16-byte boundary.
Tolerance, per output: float32 1e-4 of max|ref| (another summation order);
bfloat16 2e-2 of max|ref| (outputs and the dkv buffer are rounded to
bfloat16; bf16 K6 also rounds P, bf16 K7 P and dS, for their tensor-core
products).
"""

import numpy as np
import pytest
import torch

from anemoi_tpu_torch.kernels import gt_attention as kern
from anemoi_tpu_torch.kernels import window_attention as wkern
from anemoi_tpu_torch.kernels.build import ptxas_usage
from anemoi_tpu_torch.ops.gt_attention import (
    SourceOrder,
    gt_attention,
    gt_attention_bwd_kernels,
    gt_attention_bwd_plain,
    gt_attention_fe,
)
from anemoi_tpu_torch.models.layers.attention import get_alibi_slopes
from anemoi_tpu_torch.ops.window_attention import (
    band_attention,
    band_attention_bwd_plain,
    band_attention_plain,
)

DEAD_SRC = (0, 5, 299)


def make_case(rng, num_src, num_dst, hd, f=3, empty_dst=(3, 17), dead_src=(), degree=None):
    """A dst-sorted graph of 1-11 edges a destination (``degree``: {dst:
    in-degree} overrides), inputs for batch 2 and an edge projection."""
    src, dst = [], []
    alive = np.setdiff1d(np.arange(num_src), dead_src)
    for d in range(num_dst):
        if d in empty_dst:
            continue
        k = int(rng.integers(1, 12))
        k = (degree or {}).get(d, k)
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
@pytest.mark.parametrize("heads,d", [(2, 4), (4, 8), (2, 64), (16, 32), (16, 64)])
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
@pytest.mark.parametrize("heads,d", [(2, 4), (4, 8), (2, 64), (16, 32), (16, 64)])
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
    check_backward_against_plain(t, ei, ptr, order, heads, out, lse, g, edge_kw, fused,
                                 fused_bwd, dtype)


def check_backward_against_plain(t, ei, ptr, order, heads, out, lse, g, edge_kw, fused,
                                 fused_bwd, dtype):
    """K3 + K4 (or K3 + K5) against the plain backward, per output; sources
    in DEAD_SRC get dk = dv = 0, destinations 3 and 17 (no edges) dq = 0."""
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


# K3 layouts the cases above do not reach: a destination of in-degree 75
# (its edge sources come in three 32-edge chunks), and 2 heads of 512
# channels (64 bf16 or 128 float32 lanes a head: the head sum crosses warps)
K3_CASES = {"in_degree_75": (16, 32, {5: 75}), "two_heads_of_512": (2, 512, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True], ids=["edges", "fused_edge"])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_backward_kernel_layouts_match_plain(card, case, fused, dtype):
    heads, d, degree = K3_CASES[case]
    ei_np, ptr_np, a = make_case(np.random.default_rng(6), 300, 200, heads * d,
                                 dead_src=DEAD_SRC, degree=degree)
    assert np.bincount(ei_np[1]).max() >= (75 if degree else 1)
    t = {k: torch.from_numpy(v).to(card, dtype) for k, v in a.items()}
    ei, ptr = torch.from_numpy(ei_np).to(card), torch.from_numpy(ptr_np).to(card)
    order = SourceOrder.of(ei, 300)
    edge_kw = (dict(edge_attr=t["attr"], weight=t["w"], bias=t["b"]) if fused
               else dict(edges=t["e"]))
    fn = gt_attention_fe if fused else gt_attention
    out, lse = fn(t["q"], t["k"], t["v"], *edge_kw.values(), ei, ptr, heads, source=order)
    g = torch.randn(out.shape, generator=torch.Generator(card).manual_seed(1), device=card)
    check_backward_against_plain(t, ei, ptr, order, heads, out, lse, g.to(dtype), edge_kw,
                                 fused, False, dtype)


def k3_inputs(card, seed, heads, d):
    """bf16 inputs of K3 with the fused projection: (q, k, v, g, lse,
    delta, edge_index, dst_ptr, edge keywords)."""
    ei_np, ptr_np, a = make_case(np.random.default_rng(seed), 300, 200, heads * d)
    t = {k: torch.from_numpy(v).to(card, torch.bfloat16) for k, v in a.items()}
    ei, ptr = torch.from_numpy(ei_np).to(card), torch.from_numpy(ptr_np).to(card)
    edge_kw = dict(edge_attr=t["attr"], weight=t["w"], bias=t["b"])
    out, lse = gt_attention_fe(t["q"], t["k"], t["v"], *edge_kw.values(), ei, ptr, heads,
                               source=SourceOrder.of(ei, 300))
    g = torch.randn(out.shape, generator=torch.Generator(card).manual_seed(2), device=card)
    g = g.to(torch.bfloat16)
    delta = (out.float() * g.float()).reshape(*out.shape[:2], heads, d).sum(-1)
    return t["q"], t["k"], t["v"], g, lse, delta, ei, ptr, edge_kw


@pytest.mark.cuda
def test_backward_kernel_is_deterministic(card):
    """bf16 K3 with the fused projection: a destination's edges belong to one
    group, and dW, dbias sum the blocks' partials in a fixed order, so two
    runs agree bit for bit in every output (dq, dkv, d_attr, dW, dbias)."""
    q, k, v, g, lse, delta, ei, ptr, edge_kw = k3_inputs(card, 7, 16, 32)
    runs = [kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, 16, **edge_kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert first is not None and torch.equal(first, second)


@pytest.mark.cuda
def test_backward_kernel_refuses_misaligned(card):
    """K3 moves 8 bf16 channels a lane as one 16-byte vector: a query or
    grad that starts off a 16-byte boundary is refused before any launch."""
    q, k, v, g, lse, delta, ei, ptr, edge_kw = k3_inputs(card, 8, 2, 32)
    buf = torch.zeros(q.numel() + 1, device=card, dtype=q.dtype)
    bad = buf[1:].view(q.shape)
    bad.copy_(q)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    before = kern.launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        kern.gt_attention_bwd_dst(bad, k, v, g, lse, delta, ei, ptr, 2, **edge_kw)
    with pytest.raises(ValueError, match="16-byte"):
        kern.gt_attention_bwd_dst(q, k, v, bad, lse, delta, ei, ptr, 2, **edge_kw)
    assert kern.launch_counts() == before


def test_window_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 40, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        wkern.window_attention_fwd(q, q, q, 8)
    lse = torch.zeros(1, 2, 40)
    with pytest.raises(ValueError, match="CUDA"):
        wkern.window_attention_bwd_dq(q, q, q, q, lse, lse, 8)
    with pytest.raises(ValueError, match="CUDA"):
        wkern.window_attention_bwd_dkv(q, q, q, q, lse, lse, 8)
    assert wkern.launch_counts() == {"K6": 0, "K7_dq": 0, "K7_dkv": 0}


WINDOW_CASES = {  # name: (B, N, H, D, w, softcap, alibi)
    "plain": (2, 256, 2, 64, 32, None, False),
    "ragged": (1, 300, 4, 32, 64, None, False),
    "softcap_alibi_ragged": (2, 203, 4, 64, 48, 5.0, True),
    "d16_small_window": (1, 130, 2, 16, 5, None, True),
    "d128_window_past_n": (1, 100, 2, 128, 128, 3.0, False),
    "full_band_multi_tile": (1, 1100, 2, 64, 512, None, False),
    "n_below_one_tile": (2, 40, 3, 64, 8, None, False),
    "large_logits": (1, 700, 2, 64, 200, None, False),
}
# q and k scaled up: logits of ~+-100, so the running max jumps between key
# tiles and the correction exp(m_old - m_new) underflows to 0
WINDOW_SCALES = {"large_logits": 6.0}


def window_inputs(case, dtype, device, seed=4):
    b, n, h, d, w, softcap, alibi = WINDOW_CASES[case]
    rng = np.random.default_rng(seed)
    scales = (WINDOW_SCALES.get(case, 1.0),) * 2 + (1.0, 1.0)
    q, k, v, g = (torch.from_numpy((c * rng.normal(size=(b, n, h, d))).astype(np.float32))
                  .to(device, dtype) for c in scales)
    slopes = get_alibi_slopes(h).to(device) if alibi else None
    return (q, k, v, g), w, softcap, slopes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_kernels_match_plain(card, case, dtype):
    (q, k, v, g), w, softcap, slopes = window_inputs(case, dtype, card)
    before = wkern.launch_counts()
    out, lse = wkern.window_attention_fwd(q, k, v, w, softcap, slopes)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = wkern.window_attention_bwd_dq(q, k, v, g, lse, delta, w, softcap, slopes)
    dk, dv = wkern.window_attention_bwd_dkv(q, k, v, g, lse, delta, w, softcap, slopes)
    torch.cuda.synchronize()
    assert wkern.launch_counts() == {n_: c + 1 for n_, c in before.items()}
    ref, ref_lse = band_attention_plain(q, k, v, w, softcap, slopes)
    refs = band_attention_bwd_plain(q, k, v, g, w, softcap, slopes)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, x, y in (("out", out, ref), ("dq", dq, refs[0]), ("dk", dk, refs[1]),
                       ("dv", dv, refs[2])):
        err = (x.float() - y.float()).abs().max()
        assert torch.isfinite(x).all() and err <= tol * y.float().abs().max(), (name, err.item())
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_window_autograd_on_the_card(card):
    """``band_attention`` on CUDA tensors: K6 forward, K7 backward, the
    gradients of the plain version."""
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(1, 150, 2, 32)).astype(np.float32) for _ in range(3)]
    grads = {}
    for plain in (False, True):
        t = [torch.from_numpy(a).to(card).requires_grad_() for a in arrays]
        before = wkern.launch_counts()
        out = band_attention(*t, 20, 4.0, get_alibi_slopes(2), plain=plain)
        (out * torch.linspace(-1, 1, out.numel(), device=card).view(out.shape)).sum().backward()
        moved = {n_: c - before[n_] for n_, c in wkern.launch_counts().items()}
        assert moved == ({"K6": 0, "K7_dq": 0, "K7_dkv": 0} if plain
                         else {"K6": 1, "K7_dq": 1, "K7_dkv": 1})
        grads[plain] = [x.grad for x in t]
    for got, ref in zip(grads[False], grads[True]):
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
def test_window_forward_is_deterministic(card):
    """bf16 K6 (warpgroup tensor cores): each block alone writes its rows in
    a fixed order, so two runs on the same inputs agree bit for bit."""
    (q, k, v, _), w, softcap, slopes = window_inputs("full_band_multi_tile", torch.bfloat16,
                                                     card)
    runs = [wkern.window_attention_fwd(q, k, v, w, softcap, slopes) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_window_backward_is_deterministic(card):
    """bf16 K7_dq and K7_dkv: each block alone writes its rows in a fixed
    order, so two runs on the same inputs agree bit for bit."""
    (q, k, v, g), w, softcap, slopes = window_inputs("plain", torch.bfloat16, card)
    out, lse = wkern.window_attention_fwd(q, k, v, w, softcap, slopes)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    runs = [(wkern.window_attention_bwd_dq(q, k, v, g, lse, delta, w, softcap, slopes),
             *wkern.window_attention_bwd_dkv(q, k, v, g, lse, delta, w, softcap, slopes))
            for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_window_kernel_refuses_misaligned(card):
    """cp.async copies 16 bytes at a time: a tensor that starts off a 16-byte
    boundary is refused before any launch."""
    b, n, h, d = 1, 64, 2, 16
    buf = torch.zeros(b * n * h * d + 1, device=card, dtype=torch.bfloat16)
    bad = buf[1:].view(b, n, h, d)
    good = torch.zeros(b, n, h, d, device=card, dtype=torch.bfloat16)
    lse = torch.zeros(b, h, n, device=card)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    before = wkern.launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        wkern.window_attention_bwd_dq(good, good, good, bad, lse, lse, 8)
    with pytest.raises(ValueError, match="16-byte"):
        wkern.window_attention_bwd_dkv(bad, good, good, good, lse, lse, 8)
    with pytest.raises(ValueError, match="16-byte"):
        wkern.window_attention_fwd(good, bad, good, 8)
    assert wkern.launch_counts() == before


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z14kernel_aIfLi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z14kernel_aIfLi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z14kernel_bILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z14kernel_bILi128EEvv
    96 bytes stack frame, 92 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_usage_parses_build_log():
    assert ptxas_usage(PTXAS_LOG) == {
        "_Z14kernel_aIfLi64EEvv": {"registers": 168, "spill_stores": 0, "spill_loads": 0},
        "_Z14kernel_bILi128EEvv": {"registers": 255, "spill_stores": 92, "spill_loads": 88},
    }
    assert ptxas_usage("") == {}
