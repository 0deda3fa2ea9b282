"""Gradients of the port's sparse graph-transformer attention against the
JAX package's backward kernels.

The port's autograd ops (``gt_attention`` / ``gt_attention_fe`` on CPU
tensors, which run the plain backward ``gt_attention_bwd_plain``) against
``jax.vjp`` through ``paged_gt_attention_flat`` / ``paged_gt_attention_flat_fe``
with the Pallas kernels run in interpret mode: K3 (``_bwd_kernel``) then K4
(``_reduce_kernel``), or K3 then K5 (``_fused_reduce_kernel``) with
``fused_bwd`` tables.  Inputs are made with numpy from a seed.  Covered:
destinations without edges, sources without edges (exact zeros), batch 2
(edge gradients summed over the rows) and F = 3 raw edge features.  JAX's
slot-layout edge gradients are mapped back through ``slot_pos``; its
augmented ``dW`` (bias lane at row F) is split into ``dW`` and ``db``.
Tolerance rtol/atol 3e-5, the JAX package's own kernel tolerance
(tests/test_paged_gt.py).

K4's function alone, ``gt_attention_bwd_src_plain``, is also held against
``_reduce_kernel`` (through ``_reduce_call``, interpret mode) on the same
dkv rows in the JAX package's slot layout.

The CUDA kernels K3-K5 are held against the plain backward on the card in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.ops.pallas import paged_gt
from anemoi_tpu.ops.pallas.paged_gt import (
    PagedTables,
    _reduce_call,
    augment_edge_weights,
    build_paged_csr,
    pad_raw_edge_features,
    paged_gt_attention_flat,
    paged_gt_attention_flat_fe,
)
from anemoi_tpu_torch.ops.gt_attention import (
    gt_attention,
    gt_attention_bwd_plain,
    gt_attention_bwd_src_plain,
    gt_attention_fe,
    gt_attention_plain,
    source_order,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=3e-5, atol=3e-5)
EMPTY_DST = (7, 20)
DEAD_SRC = (0, 1, 2, 3, 17)


@pytest.fixture
def interpret():
    paged_gt.set_interpret(True)
    yield
    paged_gt.set_interpret(False)


def make_case(seed, batch, num_src=40, num_dst=29, h=2, d=8, f=3):
    """Random dst-sorted bipartite graph with empty destinations and sources
    that no edge leaves, plus inputs for ``batch`` rows and a cotangent."""
    rng = np.random.default_rng(seed)
    alive = np.setdiff1d(np.arange(num_src), DEAD_SRC)
    srcs, dsts = [], []
    for dd in range(num_dst):
        if dd in EMPTY_DST:
            continue
        k = int(rng.integers(1, 10))
        srcs.append(rng.choice(alive, size=k, replace=False))
        dsts.append(np.full(k, dd))
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    o = np.lexsort((src, dst))
    ei = np.stack([src[o], dst[o]]).astype(np.int64)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(ei[1], minlength=num_dst))])
    hd, n_e = h * d, ei.shape[1]

    def normal(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return {
        "ei": ei, "ptr": ptr, "h": h, "num_src": num_src, "num_dst": num_dst,
        "q": normal(batch, num_dst, hd), "k": normal(batch, num_src, hd),
        "v": normal(batch, num_src, hd), "g": normal(batch, num_dst, hd),
        "e": normal(n_e, hd), "attr": normal(n_e, f), "w": normal(f, hd, scale=0.3),
        "b": normal(hd, scale=0.1),
    }


def port_grads(case, fused, fused_bwd, attr_grad=True):
    """Gradients of sum(out * g) through the port's op."""
    t = {k: torch.tensor(case[k], requires_grad=True) for k in ("q", "k", "v", "e", "w", "b")}
    t["attr"] = torch.tensor(case["attr"], requires_grad=attr_grad)
    ei = torch.from_numpy(case["ei"].astype(np.int32))
    ptr = torch.from_numpy(case["ptr"].astype(np.int32))
    squeeze = t["q"].shape[0] == 1  # batch 1 goes in as [Nd, HD]
    q, k, v = (t[n][0] if squeeze else t[n] for n in "qkv")
    if fused:
        out, _ = gt_attention_fe(q, k, v, t["attr"], t["w"], t["b"], ei, ptr, case["h"],
                                 fused_bwd=fused_bwd)
    else:
        out, _ = gt_attention(q, k, v, t["e"], ei, ptr, case["h"], fused_bwd=fused_bwd)
    (out * torch.from_numpy(case["g"][0] if squeeze else case["g"])).sum().backward()
    names = ("q", "k", "v") + (("attr", "w", "b") if fused else ("e",))
    return {n: None if t[n].grad is None else t[n].grad.numpy() for n in names}


def jax_grads(case, fused, fused_bwd):
    """The JAX package's gradients, one batch row at a time (its op is
    unbatched); edge and weight gradients summed over the rows."""
    csr = build_paged_csr(case["ei"], case["num_src"], case["num_dst"], bd=8, page=8, r=8)
    tab = PagedTables.from_csr(csr, fused_bwd=fused_bwd)
    h, f = case["h"], case["attr"].shape[1]
    rows = []
    for b in range(case["q"].shape[0]):
        q, k, v, g = (jnp.asarray(case[n][b]) for n in "qkvg")
        if fused:
            raw = pad_raw_edge_features(jnp.asarray(csr.pad_edge_array(case["attr"])))
            w_aug = augment_edge_weights(jnp.asarray(case["w"]), jnp.asarray(case["b"]),
                                         raw.shape[-1])
            _, vjp = jax.vjp(lambda *a: paged_gt_attention_flat_fe(*a, h, tab),
                             q, k, v, raw, w_aug)
            dq, dk, dv, draw, dw = (np.asarray(x) for x in vjp(g))
            rows.append({"q": dq, "k": dk, "v": dv, "attr": draw[csr.slot_pos, :f],
                         "w": dw[:f], "b": dw[f]})
        else:
            e_slots = jnp.asarray(csr.pad_edge_array(case["e"]))
            _, vjp = jax.vjp(lambda *a: paged_gt_attention_flat(*a, h, tab), q, k, v, e_slots)
            dq, dk, dv, de = (np.asarray(x) for x in vjp(g))
            rows.append({"q": dq, "k": dk, "v": dv, "e": de[csr.slot_pos]})
    out = {n: np.stack([r[n] for r in rows]) for n in "qkv"}
    for n in rows[0].keys() - set("qkv"):
        out[n] = sum(r[n] for r in rows)
    return out


@pytest.mark.parametrize("batch", [1, 2], ids=["batch1", "batch2"])
@pytest.mark.parametrize("fused_bwd", [False, True], ids=["K3_K4", "K3_K5"])
@pytest.mark.parametrize("fused", [False, True], ids=["pre_projected", "fused_edge"])
def test_gradients_match_paged_interpret(interpret, fused, fused_bwd, batch):
    case = make_case(seed=10 + batch, batch=batch)
    ours = port_grads(case, fused, fused_bwd)
    ref = jax_grads(case, fused, fused_bwd)
    for name in ("q", "k", "v"):
        got = ours[name].reshape(ref[name].shape)
        np.testing.assert_allclose(got, ref[name], err_msg=f"d{name}", **TOL)
    for name in ("attr", "w", "b") if fused else ("e",):
        np.testing.assert_allclose(ours[name], ref[name], err_msg=f"d{name}", **TOL)
    # sources that no edge leaves get exact zeros, destinations without edges
    # a zero dq
    dk, dv = (ours[n].reshape(batch, case["num_src"], -1) for n in "kv")
    assert np.all(dk[:, list(DEAD_SRC)] == 0) and np.all(dv[:, list(DEAD_SRC)] == 0)
    assert np.all(ours["q"].reshape(batch, case["num_dst"], -1)[:, list(EMPTY_DST)] == 0)


def test_constant_edge_attributes_still_train_the_projection(interpret):
    """The flagship's edge attributes are constants: no d_attr is formed,
    and W and b still get JAX's gradients."""
    case = make_case(seed=5, batch=1)
    ours = port_grads(case, fused=True, fused_bwd=False, attr_grad=False)
    ref = jax_grads(case, fused=True, fused_bwd=False)
    assert ours["attr"] is None
    np.testing.assert_allclose(ours["w"], ref["w"], **TOL)
    np.testing.assert_allclose(ours["b"], ref["b"], **TOL)


def test_dst_pass_bf16_within_card_gate(interpret):
    """The card's bf16 gate for K3 + K4 (2e-2 of max|ref| per output) holds
    on the JAX kernels themselves: ``_bwd_kernel`` then ``_reduce_kernel``
    (through ``paged_gt_attention_flat_fe``, interpret mode) on bf16 inputs,
    with the edge projection fused as on the flagship's path, against the
    port's float32 plain backward on the same bf16-rounded values.  The JAX
    kernels round dkv and the gradients to bf16 as the port's K3 + K4 do.
    Measured max|d| / max|ref| on these inputs (4 heads of 32, the
    flagship's head size): dq 1.04e-2, dk 9.1e-3, dv 5.1e-3, dW 8.0e-3, db
    2.5e-3 -- so the gate has a 2x margin over rounding that the reference
    itself does."""
    case = make_case(seed=21, batch=1, h=4, d=32)
    names = ("q", "k", "v", "g", "attr", "w", "b")
    rounded = {**case, **{n: case[n].astype(jnp.bfloat16) for n in names}}
    theirs = jax_grads(rounded, fused=True, fused_bwd=False)
    t = {n: torch.from_numpy(np.asarray(rounded[n], dtype=np.float32)) for n in names}
    ei = torch.from_numpy(case["ei"].astype(np.int32))
    ptr = torch.from_numpy(case["ptr"].astype(np.int32))
    h = case["h"]
    out, lse = gt_attention_plain(t["q"], t["k"], t["v"], t["attr"] @ t["w"] + t["b"], ei, ptr, h)
    ref = gt_attention_bwd_plain(t["q"], t["k"], t["v"], ei, h, out, lse, t["g"],
                                 edge_attr=t["attr"], weight=t["w"], bias=t["b"])
    for name, ours in (("q", ref.dq), ("k", ref.dk), ("v", ref.dv), ("w", ref.d_weight),
                       ("b", ref.d_bias)):
        y = ours.numpy()
        x = np.asarray(theirs[name], dtype=np.float32).reshape(y.shape)
        assert np.abs(x - y).max() <= 2e-2 * np.abs(y).max(), f"d{name}"


@pytest.mark.parametrize("fused", [False, True], ids=["pre_projected", "fused_edge"])
def test_plain_backward_gradcheck(fused):
    """Finite differences in float64 at a tiny size, empty destination and
    batch 2 included."""
    ei = torch.tensor([[0, 1, 2, 1, 3, 0], [0, 0, 1, 2, 2, 2]], dtype=torch.int32)
    ptr = torch.tensor([0, 2, 3, 6, 6], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).requires_grad_()

    q, k, v = rnd(2, 4, 8), rnd(2, 5, 8), rnd(2, 5, 8)
    if fused:
        args = (q, k, v, rnd(6, 3), rnd(3, 8), rnd(8))
        assert torch.autograd.gradcheck(
            lambda *a: gt_attention_fe(*a, ei, ptr, 2)[0], args)
    else:
        args = (q, k, v, rnd(6, 8))
        assert torch.autograd.gradcheck(lambda *a: gt_attention(*a, ei, ptr, 2)[0], args)


def test_source_order():
    """src_perm sorts the edges by source, stably by destination; src_ptr
    points into it, empty sources included."""
    ei = np.array([[2, 0, 2, 1, 0], [0, 0, 1, 1, 2]])
    ptr, perm = source_order(ei, num_src=4)
    np.testing.assert_array_equal(perm, [1, 4, 3, 0, 2])
    np.testing.assert_array_equal(ptr, [0, 2, 3, 5, 5])
    assert ptr.dtype == perm.dtype == np.int32


# K4's function: a source graph with sources 0 and 39 (the first and the
# last) and 9-11 edgeless, and hub source 13 read by 20 destinations, so that
# its edges fill several of _reduce_kernel's r-edge slots (r = 8) across
# destination blocks; sources span 5 pages of 8
SRC_DEAD = (0, 9, 10, 11, 39)
SRC_HUB, SRC_HUB_DEGREE = 13, 20


def source_pass_case(seed, batch, hd, num_src=40, num_dst=30):
    """A dst-sorted edge list (1-4 edges a destination plus the hub's) and
    seeded dkv rows [batch, E, 2HD] in float32."""
    rng = np.random.default_rng(seed)
    alive = np.setdiff1d(np.arange(num_src), SRC_DEAD + (SRC_HUB,))
    src, dst = [], []
    for dd in range(num_dst):
        chosen = list(rng.choice(alive, size=int(rng.integers(1, 5)), replace=False))
        if dd < SRC_HUB_DEGREE:
            chosen.append(SRC_HUB)
        src += chosen
        dst += [dd] * len(chosen)
    src, dst = np.asarray(src), np.asarray(dst)
    o = np.lexsort((src, dst))
    ei = np.stack([src[o], dst[o]]).astype(np.int64)
    dkv = rng.normal(size=(batch, ei.shape[1], 2 * hd)).astype(np.float32)
    return ei, dkv


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("batch", [1, 2], ids=["batch1", "batch2"])
def test_source_pass_plain_matches_reduce_kernel(batch, hd):
    """``gt_attention_bwd_src_plain`` against ``_reduce_call`` (the TPU
    kernel K4 replaces, interpret mode, page 8, r 8) on the same dkv rows,
    each batch row on its own (the JAX op is unbatched): dk and dv within
    rtol/atol 3e-5, and exactly 0 at the sources without edges."""
    num_src, num_dst = 40, 30
    ei, dkv = source_pass_case(30 + batch + hd, batch, hd, num_src, num_dst)
    degree = np.bincount(ei[0], minlength=num_src)
    assert degree[SRC_HUB] == SRC_HUB_DEGREE and (degree[list(SRC_DEAD)] == 0).all()
    csr = build_paged_csr(ei, num_src, num_dst, bd=8, page=8, r=8)
    tab = PagedTables.from_csr(csr)
    ptr, perm = source_order(ei, num_src)
    dk, dv = gt_attention_bwd_src_plain(torch.from_numpy(dkv), torch.from_numpy(ptr),
                                        torch.from_numpy(perm))
    assert dk.shape == dv.shape == (batch, num_src, hd) and dk.dtype == torch.float32
    for b in range(batch):
        ref = np.asarray(_reduce_call(jnp.asarray(csr.pad_edge_array(dkv[b])), tab, True))
        np.testing.assert_allclose(dk[b].numpy(), ref[:, :hd], err_msg=f"dk row {b}", **TOL)
        np.testing.assert_allclose(dv[b].numpy(), ref[:, hd:], err_msg=f"dv row {b}", **TOL)
        assert np.all(ref[list(SRC_DEAD)] == 0)
    assert torch.all(dk[:, list(SRC_DEAD)] == 0) and torch.all(dv[:, list(SRC_DEAD)] == 0)


def test_source_pass_plain_sums_in_source_order():
    """The plain version adds each source's rows in ``src_perm`` order in
    float32 and rounds once, as K4 does: bf16 outputs equal a serial numpy
    float32 sum in that order, rounded to bf16, bit for bit."""
    ei, dkv = source_pass_case(7, 2, 16)
    ptr, perm = source_order(ei, 40)
    x = torch.from_numpy(dkv).to(torch.bfloat16)
    dk, dv = gt_attention_bwd_src_plain(x, torch.from_numpy(ptr), torch.from_numpy(perm))
    rows = x.float().numpy()
    want = np.zeros((2, 40, 32), np.float32)
    for s in range(40):
        for p in range(ptr[s], ptr[s + 1]):
            want[:, s] += rows[:, perm[p]]
    want = torch.from_numpy(want).to(torch.bfloat16)
    assert dk.dtype == torch.bfloat16
    assert torch.equal(dk, want[..., :16]) and torch.equal(dv, want[..., 16:])
