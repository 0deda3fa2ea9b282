"""The CUDA kernels K1-K7 against the plain PyTorch attention and its
plain backward.

The ``cuda`` tests need a card and skip without one.  They import neither
JAX nor the JAX package, so they also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

They cover the head sizes the flagship (d = 32) does not: d < 32 and d =
64 -- also at HD = 1024 (16 x 64, the Transformer preset's mappers) --,
destinations without edges, sources without
edges (backward), and both input types; for the kernels that walk
destinations or sources in groups of lanes (K1/K2 forward, K3 and K5
backward) also a destination of in-degree 75 (K1/K2, K3) or a source of
out-degree 75 (K5) -- three 32-edge chunks --, heads of 512 channels (a
head sum across warps), eight raw edge features (K1, K5), bitwise
repeatability in bf16 and the refusal of a vector input off its 16-byte
boundary.  K4 (the source pass) is also held alone against
``gt_attention_bwd_src_plain`` at every width from 6 to 1 024 channels (16-,
8- and 2-byte lanes, lanes past HD), with all sources edgeless, 81 %
edgeless, a source of out-degree 75, a mean out-degree of 12, batch 1 and 4
and more sources than its grid holds groups; its edgeless rows exactly 0 and
its outputs bit for bit those of the plain version on the CPU.  The banded
window kernels K6 (forward: out and lse) and K7 (dq; dk and dv) are held against ``band_attention_plain`` and its autograd backward,
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
    gt_attention_bwd_src_plain,
    gt_attention_fe,
    source_order,
)
from anemoi_tpu_torch.models.layers.attention import get_alibi_slopes
from anemoi_tpu_torch.ops.window_attention import (
    band_attention,
    band_attention_bwd_plain,
    band_attention_plain,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DEAD_SRC = (0, 5, 299)


def make_case(rng, num_src, num_dst, hd, f=3, empty_dst=(3, 17), dead_src=(), degree=None,
              out_degree=None, batch=2):
    """A dst-sorted graph of 1-11 edges a destination (``degree``: {dst:
    in-degree} overrides; ``out_degree``: {src: n} puts each such source on
    the first n destinations that have edges), inputs for ``batch`` rows
    (default 2) and an edge projection."""
    src, dst = [], []
    alive = np.setdiff1d(np.arange(num_src), dead_src)
    placed = dict.fromkeys(out_degree or {}, 0)
    for d in range(num_dst):
        if d in empty_dst:
            continue
        k = int(rng.integers(1, 12))
        k = (degree or {}).get(d, k)
        chosen = rng.choice(alive, size=k, replace=False)
        for s_, n in (out_degree or {}).items():
            if placed[s_] < n and s_ not in chosen[1:]:
                chosen[0] = s_
                placed[s_] += 1
        src.append(chosen)
        dst.append(np.full(k, d))
    ei = np.stack([np.concatenate(src), np.concatenate(dst)]).astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(ei[1], minlength=num_dst))]).astype(np.int32)
    arrays = {
        "q": rng.normal(size=(batch, num_dst, hd)), "k": rng.normal(size=(batch, num_src, hd)),
        "v": rng.normal(size=(batch, num_src, hd)), "e": rng.normal(size=(ei.shape[1], hd)),
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
    check_forward_against_plain(card, np.random.default_rng(1), heads, d, dtype, fused)


# K1/K2 layouts the cases above do not reach: a destination of in-degree 75
# (its edge sources and raw attributes come in three 32-edge chunks), 2 heads
# of 512 channels (the head sum crosses warps through the group's shared
# memory) and, for K1, 8 raw edge features (the FMAX = 8 instantiation)
FWD_CASES = {"in_degree_75": (16, 32, 3, {5: 75}), "two_heads_of_512": (2, 512, 3, None),
             "eight_features": (16, 32, 8, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,fused", [
    ("in_degree_75", False), ("in_degree_75", True), ("two_heads_of_512", False),
    ("two_heads_of_512", True), ("eight_features", True),
])
def test_kernel_layouts_match_plain(card, case, fused, dtype):
    heads, d, f, degree = FWD_CASES[case]
    ei_np = check_forward_against_plain(card, np.random.default_rng(9), heads, d, dtype, fused,
                                        f=f, degree=degree)
    assert np.bincount(ei_np[1]).max() >= (75 if degree else 1)


def check_forward_against_plain(card, rng, heads, d, dtype, fused, f=3, degree=None):
    """K1 (``fused``) or K2 on a batch-2 case against the plain op: out
    within the type's tolerance of max|ref|, lse within 1e-4, destinations
    3 and 17 (no edges) out = 0 and lse = -inf.  Returns the edge index."""
    ei_np, ptr_np, a = make_case(rng, 300, 200, heads * d, f=f, degree=degree)
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
    return ei_np


def k1_inputs(card, seed, heads, d):
    """bf16 inputs of K1 for batch 2: (q, k, v, attr, w, b, edge_index,
    dst_ptr) and the projected edges e."""
    ei_np, ptr_np, a = make_case(np.random.default_rng(seed), 300, 200, heads * d)
    t = {k: torch.from_numpy(v).to(card, torch.bfloat16) for k, v in a.items()}
    ei, ptr = torch.from_numpy(ei_np).to(card), torch.from_numpy(ptr_np).to(card)
    return (t["q"], t["k"], t["v"], t["attr"], t["w"], t["b"], ei, ptr), t["e"]


@pytest.mark.cuda
def test_forward_kernel_is_deterministic(card):
    """bf16 K1: a destination belongs to one group, which walks its edges in
    CSR order with no atomics, so two runs agree bit for bit (out and
    lse)."""
    args, _ = k1_inputs(card, 10, 16, 32)
    runs = [kern.gt_attention_fused_edge(*args, 16) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_forward_kernel_refuses_misaligned(card):
    """K1 and K2 move 8 bf16 channels a lane as one 16-byte vector: a query,
    key, value or (K2) projected edge tensor that starts off a 16-byte
    boundary is refused before any launch."""
    (q, k, v, attr, w, b, ei, ptr), e = k1_inputs(card, 11, 2, 32)

    def off_boundary(x):
        buf = torch.zeros(x.numel() + 1, device=card, dtype=x.dtype)
        bad = buf[1:].view(x.shape)
        bad.copy_(x)
        assert bad.is_contiguous() and bad.data_ptr() % 16
        return bad

    before = kern.launch_counts()
    for name, x in (("query", q), ("key", k), ("value", v)):
        qkv = [off_boundary(y) if y is x else y for y in (q, k, v)]
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte"):
            kern.gt_attention_fused_edge(*qkv, attr, w, b, ei, ptr, 2)
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte"):
            kern.gt_attention_edge(*qkv, e, ei, ptr, 2)
    with pytest.raises(ValueError, match="edges must start on a 16-byte"):
        kern.gt_attention_edge(q, k, v, off_boundary(e), ei, ptr, 2)
    assert kern.launch_counts() == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_a_batch_of_four_members(card, dtype):
    """The ensemble's batch: four members fold into the batch rows (each
    kernel's grid y), 16 heads of 32 as in the flagship.  K1, then K3 + K4
    and K3 + K5 (K3 sums dW and dbias over the four rows) against the plain
    versions."""
    ei_np, ptr_np, a = make_case(np.random.default_rng(11), 300, 200, 512, dead_src=DEAD_SRC,
                                 batch=4)
    t = {k: torch.from_numpy(v).to(card, dtype) for k, v in a.items()}
    ei, ptr = torch.from_numpy(ei_np).to(card), torch.from_numpy(ptr_np).to(card)
    order = SourceOrder.of(ei, 300)
    args = (t["q"], t["k"], t["v"], t["attr"], t["w"], t["b"], ei, ptr, 16)
    before = kern.gt_attention_fused_edge.launches
    out, lse = gt_attention_fe(*args, source=order)
    torch.cuda.synchronize()
    assert kern.gt_attention_fused_edge.launches == before + 1 and out.shape[0] == 4
    ref, ref_lse = gt_attention_fe(*args, plain=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max() <= tol * ref.float().abs().max()
    finite = ref_lse.isfinite()
    torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=1e-4, atol=1e-4)
    g = torch.randn(out.shape, generator=torch.Generator(card).manual_seed(1), device=card)
    edge_kw = dict(edge_attr=t["attr"], weight=t["w"], bias=t["b"])
    for fused_bwd in (False, True):
        check_backward_against_plain(t, ei, ptr, order, 16, out, lse, g.to(dtype), edge_kw,
                                     True, fused_bwd, dtype)


def stretched_decoder_case(rng, num_src=300, num_dst=600, hd=1024):
    """A mapper of the ``stretched_grid`` kind (KNN-3 into the data nodes)
    at small size, its source degrees spread wider than the packaged
    graph's (1 to 104 at o96): each destination has 3 sources; 10 hub
    sources (coarse mesh nodes) have about 50 edges each, 80 more a few,
    and every other source (``DEAD_SRC`` among them) none; destinations 3
    and 17 have no edge."""
    src, dst = [], []
    for d in range(num_dst):
        if d in (3, 17):
            continue
        pool = rng.choice(np.arange(20, 100), size=2, replace=False)
        chosen = [10 + (d % 10)] + list(pool) if d < 520 else list(
            rng.choice(np.arange(20, 100), size=3, replace=False))
        src.append(chosen)
        dst.append([d] * 3)
    ei = np.stack([np.concatenate(src), np.concatenate(dst)]).astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(ei[1], minlength=num_dst))]).astype(np.int32)
    f = 3
    arrays = {"q": rng.normal(size=(1, num_dst, hd)), "k": rng.normal(size=(1, num_src, hd)),
              "v": rng.normal(size=(1, num_src, hd)), "attr": rng.normal(size=(ei.shape[1], f)),
              "w": 0.3 * rng.normal(size=(f, hd)), "b": 0.1 * rng.normal(size=(hd,))}
    return ei, ptr, {k: v.astype(np.float32) for k, v in arrays.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_the_stretched_decoder_degrees(card, dtype):
    """K1, then K3 + K4 and K3 + K5, against the plain versions where most
    sources have no edge and a few about 50 (16 heads of 64: the
    ``stretched`` preset's 1024 channels)."""
    ei_np, ptr_np, a = stretched_decoder_case(np.random.default_rng(13))
    out_degree = np.bincount(ei_np[0], minlength=300)
    assert out_degree.max() >= 50 and (out_degree == 0).sum() >= 200
    assert (out_degree[list(DEAD_SRC)] == 0).all()
    t = {k: torch.from_numpy(v).to(card, dtype) for k, v in a.items()}
    ei, ptr = torch.from_numpy(ei_np).to(card), torch.from_numpy(ptr_np).to(card)
    order = SourceOrder.of(ei, 300)
    args = (t["q"], t["k"], t["v"], t["attr"], t["w"], t["b"], ei, ptr, 16)
    before = kern.gt_attention_fused_edge.launches
    out, lse = gt_attention_fe(*args, source=order)
    torch.cuda.synchronize()
    assert kern.gt_attention_fused_edge.launches == before + 1
    ref, ref_lse = gt_attention_fe(*args, plain=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max() <= tol * ref.float().abs().max()
    finite = ref_lse.isfinite()
    torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=1e-4, atol=1e-4)
    g = torch.randn(out.shape, generator=torch.Generator(card).manual_seed(2), device=card)
    edge_kw = dict(edge_attr=t["attr"], weight=t["w"], bias=t["b"])
    for fused_bwd in (False, True):
        check_backward_against_plain(t, ei, ptr, order, 16, out, lse, g.to(dtype), edge_kw,
                                     True, fused_bwd, dtype)


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


# K5 layouts the cases above do not reach: a source of out-degree 75 (its
# edges come in three 32-edge chunks), 2 heads of 512 channels (64 bf16 or 128
# float32 lanes a head: the head sums cross warps), with the fused projection
# 8 raw edge features (the FMAX = 8 instantiation), and far more sources than
# K5's grid holds groups, so that each group strides over several: HD = 512
# (groups of 64 bf16 or 128 float32 lanes) and HD = 64 (groups of 8 or 16
# lanes sharing a warp).  (heads, d, F, {source: out-degree}, sources,
# destinations)
K5_CASES = {"out_degree_75": (16, 32, 3, {7: 75}, 300, 200),
            "two_heads_of_512": (2, 512, 3, None, 300, 200),
            "eight_features": (16, 32, 8, None, 300, 200),
            "hd512_20000_sources": (16, 32, 3, None, 20000, 4000),
            "hd64_60000_sources": (2, 32, 3, None, 60000, 4000)}


def k5_grid_groups(dtype, heads, d, f, fused):
    """Groups in K5's grid a batch row on this card."""
    v, _ = kern.dst_instantiation(dtype, d, f, fused)
    lanes = heads * d // v
    gs = 1 << (lanes - 1).bit_length() if lanes <= 32 else -(-lanes // 32) * 32
    blocks = kern._resident_blocks("K5", torch.cuda.current_device(), kern._DTYPE_CODES[dtype],
                                   fused, heads * d, heads, f)
    return blocks * max(1, 256 // gs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,fused", [
    ("out_degree_75", False), ("out_degree_75", True), ("two_heads_of_512", False),
    ("two_heads_of_512", True), ("eight_features", True), ("hd512_20000_sources", False),
    ("hd512_20000_sources", True), ("hd64_60000_sources", False), ("hd64_60000_sources", True),
])
def test_fused_source_pass_layouts_match_plain(card, case, fused, dtype):
    """K3 (no dkv) + K5 against the plain backward, batch 2, with the sources
    in DEAD_SRC (no edges) getting dk = dv = 0."""
    heads, d, f, out_degree, n_src, n_dst = K5_CASES[case]
    if n_src > 300:
        assert n_src >= 2 * k5_grid_groups(dtype, heads, d, f, fused)
    ei_np, ptr_np, a = make_case(np.random.default_rng(12), n_src, n_dst, heads * d, f=f,
                                 dead_src=DEAD_SRC, out_degree=out_degree)
    assert np.bincount(ei_np[0]).max() >= (75 if out_degree else 1)
    t = {k: torch.from_numpy(v).to(card, dtype) for k, v in a.items()}
    ei, ptr = torch.from_numpy(ei_np).to(card), torch.from_numpy(ptr_np).to(card)
    order = SourceOrder.of(ei, n_src)
    edge_kw = (dict(edge_attr=t["attr"], weight=t["w"], bias=t["b"]) if fused
               else dict(edges=t["e"]))
    fn = gt_attention_fe if fused else gt_attention
    out, lse = fn(t["q"], t["k"], t["v"], *edge_kw.values(), ei, ptr, heads, source=order)
    g = torch.randn(out.shape, generator=torch.Generator(card).manual_seed(3), device=card)
    check_backward_against_plain(t, ei, ptr, order, heads, out, lse, g.to(dtype), edge_kw,
                                 fused, True, dtype)


@pytest.mark.cuda
def test_fused_source_pass_is_deterministic(card):
    """bf16 K5 with the fused projection: a source's edges belong to one group,
    which sums them in source order with no atomics, so two runs agree bit
    for bit (dk, dv)."""
    q, k, v, g, lse, delta, ei, ptr, edge_kw = k3_inputs(card, 13, 16, 32)
    order = SourceOrder.of(ei, 300)
    runs = [kern.gt_attention_bwd_src_fused(q, k, v, g, lse, delta, ei, ptr, order.src_ptr,
                                            order.src_perm, 16, **edge_kw) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_fused_source_pass_refuses_misaligned(card):
    """K5 moves 8 bf16 channels a lane as one 16-byte vector: a query or grad
    that starts off a 16-byte boundary is refused before any launch."""
    q, k, v, g, lse, delta, ei, ptr, edge_kw = k3_inputs(card, 14, 2, 32)
    order = SourceOrder.of(ei, 300)
    buf = torch.zeros(q.numel() + 1, device=card, dtype=q.dtype)
    bad = buf[1:].view(q.shape)
    bad.copy_(q)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    before = kern.launch_counts()
    for name, args in (("query", (bad, k, v, g)), ("grad", (q, k, v, bad))):
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte"):
            kern.gt_attention_bwd_src_fused(*args, lse, delta, ei, ptr, order.src_ptr,
                                            order.src_perm, 2, **edge_kw)
    assert kern.launch_counts() == before



@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hd512_20000_sources", "hd64_60000_sources"])
def test_fused_source_pass_many_sources_is_deterministic(card, case):
    """bf16 K5 with the fused projection, several sources a group: two runs
    agree bit for bit (dk, dv)."""
    heads, d, f, _, n_src, n_dst = K5_CASES[case]
    assert n_src >= 2 * k5_grid_groups(torch.bfloat16, heads, d, f, True)
    ei_np, ptr_np, a = make_case(np.random.default_rng(15), n_src, n_dst, heads * d, f=f)
    t = {k: torch.from_numpy(x).to(card, torch.bfloat16) for k, x in a.items()}
    ei, ptr = torch.from_numpy(ei_np).to(card), torch.from_numpy(ptr_np).to(card)
    order = SourceOrder.of(ei, n_src)
    edge_kw = dict(edge_attr=t["attr"], weight=t["w"], bias=t["b"])
    out, lse = gt_attention_fe(t["q"], t["k"], t["v"], *edge_kw.values(), ei, ptr, heads,
                               source=order)
    g = torch.randn(out.shape, generator=torch.Generator(card).manual_seed(5), device=card)
    g = g.to(torch.bfloat16)
    delta = (out.float() * g.float()).reshape(*out.shape[:2], heads, d).sum(-1)
    runs = [kern.gt_attention_bwd_src_fused(t["q"], t["k"], t["v"], g, lse, delta, ei, ptr,
                                            order.src_ptr, order.src_perm, heads, **edge_kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert runs[0][0].abs().max() > 0
    for first, second in zip(*runs):
        assert torch.equal(first, second)


# ---- K4 alone ---------------------------------------------------------------

# (sources, edges, share of the sources that have edges, {source: out-degree})
K4_CASES = {
    "mixed": (300, 600, 0.9, None),
    "all_edgeless": (300, 0, 0.0, None),
    "edgeless_81_percent": (10242, 1926, 0.19, None),  # the V-cycle's down set
    "out_degree_75": (300, 600, 0.9, {7: 75}),
    "out_degree_12": (300, 3600, 1.0, None),  # one group a source (mean degree >= 4)
}


def k4_inputs(card, case, hd, batch, dtype, seed=16, num_src=None):
    """dkv [batch, E, 2HD] and the source-ordered view of a random edge
    list whose sources are drawn from a share of the sources (the others
    edgeless); returns (dkv, src_ptr, src_perm, edgeless source mask)."""
    n_src, n_e, share, hubs = K4_CASES[case]
    n_src = num_src or n_src
    rng = np.random.default_rng(seed)
    alive = np.setdiff1d(rng.choice(n_src, size=max(1, int(share * n_src)), replace=False),
                         list(hubs or {}))
    src = rng.choice(alive, size=n_e) if n_e else np.zeros(0, np.int64)
    for s_, n in (hubs or {}).items():
        src[:n] = s_
    rng.shuffle(src)
    ptr, perm = source_order(np.stack([src, np.zeros_like(src)]), n_src)
    dkv = torch.from_numpy(rng.normal(size=(batch, n_e, 2 * hd)).astype(np.float32))
    edgeless = torch.from_numpy(np.bincount(src, minlength=n_src) == 0).to(card)
    return (dkv.to(card, dtype), torch.from_numpy(ptr).to(card), torch.from_numpy(perm).to(card),
            edgeless)


def check_k4(dkv, ptr, perm, edgeless):
    """K4 against its plain version: one launch, each output within the
    type's tolerance of max|ref|, the edgeless sources' rows exactly 0."""
    before = kern.gt_attention_bwd_src.launches
    got = kern.gt_attention_bwd_src(dkv, ptr, perm)
    torch.cuda.synchronize()
    assert kern.gt_attention_bwd_src.launches == before + 1
    ref = gt_attention_bwd_src_plain(dkv, ptr, perm)
    tol = 1e-4 if dkv.dtype == torch.float32 else 2e-2
    for name, x, y in zip(("dk", "dv"), got, ref):
        assert x.shape == y.shape and x.dtype == dkv.dtype, name
        err = (x.float() - y.float()).abs().max() if x.numel() else 0.0
        assert err <= tol * y.float().abs().max(), (name, float(err))
        assert torch.all(x[:, edgeless] == 0), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [6, 8, 12, 32, 64, 128, 256, 512, 1000, 1022, 1024])
def test_K4_matches_plain_at_every_width(card, hd, dtype):
    """Widths of 16-byte lanes (8 bf16 or 4 float32 channels), of 8-byte
    (bf16 at HD 12) and 2- or 4-byte lanes (HD 6, 1022: groups of up to
    1 024 threads), and lanes past HD (1000: 125 of 128 active)."""
    check_k4(*k4_inputs(card, "mixed", hd, 2, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_K4_matches_plain_on_source_degrees(card, case, batch, dtype):
    """All sources edgeless (no dkv row at all), 81 % edgeless, a source of
    out-degree 75 (three 32-edge chunks), a mean out-degree of 12 (a grid of
    one group a source, not the resident stride), at the flagship's HD
    512."""
    dkv, ptr, perm, edgeless = k4_inputs(card, case, 512, batch, dtype)
    if case == "out_degree_75":
        assert int((ptr[8] - ptr[7]).item()) == 75
    check_k4(dkv, ptr, perm, edgeless)


def k4_grid_groups(dtype, hd):
    """Groups in K4's grid on this card."""
    v = kern.src_sum_vector(dtype, hd)
    lanes = hd // v
    gs = 1 << (lanes - 1).bit_length() if lanes <= 32 else -(-lanes // 32) * 32
    blocks = kern._resident_blocks("K4", torch.cuda.current_device(), kern._DTYPE_CODES[dtype],
                                   False, hd, 1, 0)
    return blocks * max(1, 256 // gs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 512])
def test_K4_strides_over_more_sources_than_its_groups(card, hd, dtype):
    """More sources than K4's grid holds groups, at batch 2 (the batch row
    folds into the stride): each group sums several items."""
    groups = k4_grid_groups(dtype, hd)
    n_src = 2 * groups + 7
    dkv, ptr, perm, edgeless = k4_inputs(card, "mixed", hd, 2, dtype, num_src=n_src)
    assert ptr.shape[0] - 1 == n_src >= 2 * groups
    check_k4(dkv, ptr, perm, edgeless)


@pytest.mark.cuda
def test_K4_is_deterministic(card):
    """bf16 K4: a source's rows are summed by one group in src_perm order,
    with no atomics, so two runs agree bit for bit."""
    dkv, ptr, perm, _ = k4_inputs(card, "out_degree_75", 512, 4, torch.bfloat16)
    runs = [kern.gt_attention_bwd_src(dkv, ptr, perm) for _ in range(2)]
    torch.cuda.synchronize()
    assert runs[0][0].abs().max() > 0
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mixed", "edgeless_81_percent", "out_degree_75",
                                  "out_degree_12"])
def test_K4_equals_the_serial_sum_bit_for_bit(card, case, dtype):
    """K4 sums a source's rows in float32 in src_perm order and rounds once,
    as the plain version does on the CPU, where its index_add_ is serial in
    that order (test_source_pass_plain_sums_in_source_order): equal bit for
    bit, at batch 2 and HD 512."""
    dkv, ptr, perm, _ = k4_inputs(card, case, 512, 2, dtype)
    got = kern.gt_attention_bwd_src(dkv, ptr, perm)
    ref = gt_attention_bwd_src_plain(dkv.cpu(), ptr.cpu(), perm.cpu())
    for name, x, y in zip(("dk", "dv"), got, ref):
        assert torch.equal(x.cpu(), y), name


@pytest.mark.cuda
def test_K4_refuses(card):
    """K4 refuses, before any launch: dkv off the boundary of its lanes'
    vectors (16 bytes at bf16 HD 512), HD above 1 024, an odd last
    dimension, a non-contiguous dkv, float16, and int64 source tables."""
    dkv, ptr, perm, _ = k4_inputs(card, "mixed", 512, 1, torch.bfloat16)
    buf = torch.zeros(dkv.numel() + 1, device=card, dtype=dkv.dtype)
    bad = buf[1:].view(dkv.shape)
    bad.copy_(dkv)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    n_e = dkv.shape[1]
    before = kern.launch_counts()
    with pytest.raises(ValueError, match="16-byte boundary"):
        kern.gt_attention_bwd_src(bad, ptr, perm)
    for x in (torch.zeros(1, n_e, 2050, device=card), torch.zeros(1, n_e, 511, device=card),
              torch.cat([dkv, dkv], -1)[..., ::2]):
        with pytest.raises(ValueError, match="dkv must be a contiguous"):
            kern.gt_attention_bwd_src(x, ptr, perm)
    with pytest.raises(TypeError, match="unsupported dtype"):
        kern.gt_attention_bwd_src(dkv.half(), ptr, perm)
    with pytest.raises(TypeError, match="int32"):
        kern.gt_attention_bwd_src(dkv, ptr.long(), perm)
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
