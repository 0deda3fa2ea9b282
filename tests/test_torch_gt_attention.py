"""Sparse graph-transformer attention of the PyTorch port against the JAX
package: the plain PyTorch op (``anemoi_tpu_torch.ops.gt_attention``, what
CPU tensors run) against ``anemoi_tpu.ops.segment`` and against the TPU
kernel ``paged_gt_attention_flat(_fe)`` run in interpret mode, as the JAX
package's own tests run it.  Inputs are made with numpy from a seed and
given to both.  Tolerance rtol/atol 3e-5, the JAX package's own kernel
tolerance (tests/test_paged_gt.py).

The CUDA kernels themselves are held against the plain op on the card in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anemoi_tpu.ops.pallas import paged_gt
from anemoi_tpu.ops.pallas.paged_gt import (
    PagedTables,
    augment_edge_weights,
    build_paged_csr,
    pad_raw_edge_features,
    paged_gt_attention_flat,
    paged_gt_attention_flat_fe,
)
from anemoi_tpu.ops.segment import graph_transformer_attention
from anemoi_tpu_torch.ops.gt_attention import gt_attention, gt_attention_fe, gt_attention_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture
def interpret():
    paged_gt.set_interpret(True)
    yield
    paged_gt.set_interpret(False)


def random_bipartite(rng, num_src, num_dst, k_mean=5, empty_dst=()):
    """Random dst-sorted bipartite edge_index with uneven degrees."""
    srcs, dsts = [], []
    for dd in range(num_dst):
        if dd in empty_dst:
            continue
        k = int(rng.integers(1, 2 * k_mean))
        srcs.append(rng.choice(np.arange(num_src), size=min(k, num_src), replace=False))
        dsts.append(np.full(len(srcs[-1]), dd))
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    o = np.lexsort((src, dst))
    return np.stack([src[o], dst[o]]).astype(np.int64)


def make_case(rng, num_src=50, num_dst=37, h=2, d=8, f=3, spread=1.0, empty_dst=(7, 20)):
    ei = random_bipartite(rng, num_src, num_dst, empty_dst=empty_dst)
    hd = h * d
    ptr = np.zeros(num_dst + 1, np.int64)
    np.cumsum(np.bincount(ei[1], minlength=num_dst), out=ptr[1:])
    case = {
        "ei": ei, "ptr": ptr, "h": h, "num_dst": num_dst,
        "q": (rng.normal(size=(num_dst, hd)) * spread).astype(np.float32),
        "k": (rng.normal(size=(num_src, hd)) * spread).astype(np.float32),
        "v": rng.normal(size=(num_src, hd)).astype(np.float32),
        "e": rng.normal(size=(ei.shape[1], hd)).astype(np.float32),
        "attr": rng.normal(size=(ei.shape[1], f)).astype(np.float32),
        "w": (rng.normal(size=(f, hd)) * 0.3).astype(np.float32),
        "b": (rng.normal(size=(hd,)) * 0.1).astype(np.float32),
    }
    return case


def port(case, fused):
    t = torch.from_numpy
    args = (t(case["ei"].astype(np.int32)), t(case["ptr"].astype(np.int32)), case["h"])
    if fused:
        out, lse = gt_attention_fe(
            t(case["q"]), t(case["k"]), t(case["v"]), t(case["attr"]), t(case["w"]),
            t(case["b"]), *args,
        )
    else:
        out, lse = gt_attention(t(case["q"]), t(case["k"]), t(case["v"]), t(case["e"]), *args)
    return out.numpy(), lse.numpy()


def edges_of(case, fused):
    return case["attr"] @ case["w"] + case["b"] if fused else case["e"]


def segment_ref(case, fused, edges=None):
    nd, hd = case["q"].shape
    h = case["h"]
    d = hd // h
    e = edges_of(case, fused) if edges is None else edges
    out = graph_transformer_attention(
        jnp.asarray(case["q"]).reshape(nd, h, d),
        jnp.asarray(case["k"]).reshape(-1, h, d),
        jnp.asarray(case["v"]).reshape(-1, h, d),
        jnp.asarray(e).reshape(-1, h, d),
        jnp.asarray(case["ei"]),
        num_dst=nd,
    )
    return np.asarray(out).reshape(nd, hd)


def paged_ref(case, fused, stabilize):
    """(out from the public op, lse from the kernel call) in interpret mode."""
    nd = case["num_dst"]
    csr = build_paged_csr(case["ei"], case["k"].shape[0], nd, bd=8, page=8, r=8)
    tab = PagedTables.from_csr(csr)
    q, k, v = (jnp.asarray(case[n]) for n in "qkv")
    kv = jnp.concatenate([k, v], axis=-1)
    if fused:
        raw_p = pad_raw_edge_features(jnp.asarray(csr.pad_edge_array(case["attr"])))
        w_aug = augment_edge_weights(jnp.asarray(case["w"]), jnp.asarray(case["b"]), raw_p.shape[-1])
        out = paged_gt_attention_flat_fe(q, k, v, raw_p, w_aug, case["h"], tab, stabilize)
        _, lse = paged_gt._fwd_call(q, kv, raw_p, tab, case["h"], True, stabilize, w_e=w_aug)
    else:
        e_slots = jnp.asarray(csr.pad_edge_array(case["e"]))
        out = paged_gt_attention_flat(q, k, v, e_slots, case["h"], tab, stabilize)
        _, lse = paged_gt._fwd_call(q, kv, e_slots, tab, case["h"], True, stabilize)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("fused", [False, True], ids=["pre_projected", "fused_edge"])
def test_plain_matches_segment(fused):
    case = make_case(np.random.default_rng(0))
    out, lse = port(case, fused)
    np.testing.assert_allclose(out, segment_ref(case, fused), **TOL)
    # destinations without incoming edges: out = 0 and lse = -inf
    for empty in (7, 20):
        assert np.all(out[empty] == 0.0)
        assert np.all(np.isneginf(lse[empty]))


@pytest.mark.parametrize("stabilize", [True, False], ids=["stabilize", "no_shift"])
@pytest.mark.parametrize("fused", [False, True], ids=["pre_projected", "fused_edge"])
def test_plain_matches_paged_interpret(interpret, fused, stabilize):
    case = make_case(np.random.default_rng(1))
    out, lse = port(case, fused)
    ref_out, ref_lse = paged_ref(case, fused, stabilize)
    np.testing.assert_allclose(out, ref_out, **TOL)
    # the TPU kernel floors an empty denominator at 1e-30 (lse = log 1e-30);
    # the port gives the exact -inf, so compare destinations with edges
    has_edges = np.diff(case["ptr"]) > 0
    np.testing.assert_allclose(lse[has_edges], ref_lse[has_edges], **TOL)
    assert np.all(np.isneginf(lse[~has_edges]))


@pytest.mark.parametrize("fused", [False, True], ids=["pre_projected", "fused_edge"])
def test_large_logit_spread(interpret, fused):
    """The spread-out logits of tests/test_paged_gt.py:372, drawn the same
    way from the same seed (zero edge features): the running max keeps the
    softmax exact; compared with both JAX references at that test's 1e-4."""
    rng = np.random.default_rng(42)
    num_src, num_dst, hd = 24, 16, 8
    ei = random_bipartite(rng, num_src, num_dst, k_mean=4)
    case = {
        "ei": ei, "h": 1, "num_dst": num_dst,
        "ptr": np.concatenate([[0], np.cumsum(np.bincount(ei[1], minlength=num_dst))]),
        "q": (rng.normal(size=(num_dst, hd)) * 6.0).astype(np.float32),
        "k": (rng.normal(size=(num_src, hd)) * 6.0).astype(np.float32),
        "v": rng.normal(size=(num_src, hd)).astype(np.float32),
        "e": np.zeros((ei.shape[1], hd), np.float32),
        "attr": np.asarray(rng.normal(size=(ei.shape[1], 3)), np.float32),
        "w": np.zeros((3, hd), np.float32),
        "b": np.zeros((hd,), np.float32),
    }
    out, lse = port(case, fused)
    np.testing.assert_allclose(out, segment_ref(case, fused), rtol=1e-4, atol=1e-4)
    ref_out, ref_lse = paged_ref(case, fused, True)
    np.testing.assert_allclose(out, ref_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse, ref_lse, rtol=1e-4, atol=1e-4)


def test_fused_edge_bf16_within_card_gate(interpret):
    """The card's bf16 gate for K1's out (2e-2 of max|ref|) holds on the JAX
    kernel itself: ``_fwd_kernel`` through ``paged_gt_attention_flat_fe``
    (interpret mode) on bf16 inputs, with the edge projection fused as on
    the flagship's path, at the flagship's head size (4 heads of 32),
    against the port's float32 ``gt_attention_plain`` on the same
    bf16-rounded values.  Measured max|d| / max|ref|: out 6.0e-3 here (seeds
    0-5: 3.5e-3 - 4.9e-3), a margin of 3x or more.  The card's lse gate
    (1e-3 of max|lse|) is tighter than this reference meets: the JAX kernel
    rounds the projected e, k + e and each product q * (k + e) to bf16
    before the head sums (paged_gt.py:403-413), which puts its lse 1.6e-3
    away here (seeds 0-5: 1.3e-3 - 3.9e-3, up to one bf16 unit roundoff,
    2^-8), while the port's K1 does that arithmetic in float32 and meets
    1e-3 on the card.  So the reference's lse is held to 1e-2."""
    case = make_case(np.random.default_rng(21), h=4, d=32)
    names = ("q", "k", "v", "attr", "w", "b")
    rounded = {**case, **{n: case[n].astype(jnp.bfloat16) for n in names}}
    h, nd = case["h"], case["num_dst"]
    csr = build_paged_csr(case["ei"], case["k"].shape[0], nd, bd=8, page=8, r=8)
    tab = PagedTables.from_csr(csr)
    q, k, v = (jnp.asarray(rounded[n]) for n in "qkv")
    raw = pad_raw_edge_features(jnp.asarray(csr.pad_edge_array(rounded["attr"])))
    w_aug = augment_edge_weights(jnp.asarray(rounded["w"]), jnp.asarray(rounded["b"]),
                                 raw.shape[-1])
    theirs = np.asarray(paged_gt_attention_flat_fe(q, k, v, raw, w_aug, h, tab), np.float32)
    _, their_lse = paged_gt._fwd_call(q, jnp.concatenate([k, v], axis=-1), raw, tab, h, True,
                                      True, w_e=w_aug)
    t = {n: torch.from_numpy(np.asarray(rounded[n], dtype=np.float32)) for n in names}
    ei = torch.from_numpy(case["ei"].astype(np.int32))
    ptr = torch.from_numpy(case["ptr"].astype(np.int32))
    ref, ref_lse = gt_attention_plain(t["q"][None], t["k"][None], t["v"][None],
                                      t["attr"] @ t["w"] + t["b"], ei, ptr, h)
    ref, ref_lse = ref[0].numpy(), ref_lse[0].numpy()
    assert np.abs(theirs - ref).max() <= 2e-2 * np.abs(ref).max()
    has_edges = np.diff(case["ptr"]) > 0
    lse_err = np.abs(np.asarray(their_lse)[has_edges] - ref_lse[has_edges]).max()
    assert lse_err <= 1e-2 * np.abs(ref_lse[has_edges]).max()


def test_batch_rows_are_independent():
    """[B, Nd, HD] input: each batch row equals the unbatched call."""
    rng = np.random.default_rng(3)
    case = make_case(rng)
    t = torch.from_numpy
    ei, ptr = t(case["ei"].astype(np.int32)), t(case["ptr"].astype(np.int32))
    q = t(rng.normal(size=(3,) + case["q"].shape).astype(np.float32))
    k = t(rng.normal(size=(3,) + case["k"].shape).astype(np.float32))
    v = t(rng.normal(size=(3,) + case["v"].shape).astype(np.float32))
    out, lse = gt_attention(q, k, v, t(case["e"]), ei, ptr, case["h"])
    for b in range(3):
        ob, lb = gt_attention(q[b], k[b], v[b], t(case["e"]), ei, ptr, case["h"])
        torch.testing.assert_close(out[b], ob)
        torch.testing.assert_close(lse[b], lb)
