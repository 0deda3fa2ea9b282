"""The port's sliding-window attention against the JAX package.

Plain band forward (out and lse) and backward (dq, dk, dv) of
``anemoi_tpu_torch.ops.window_attention`` against
``anemoi_tpu.models.layers.attention._window_attention``, and against the
TPU kernels' own functions run in Pallas interpret mode
(``_flash_window_forward``/``_flash_window_backward``, as
tests/test_pallas_window.py runs them), for plain, softcap, ALiBi and a
sequence that is not a multiple of the window; the ``attention_impl``
dispatch at ``w + 1 < n <= 2w + 1``; ``MultiHeadSelfAttention`` and one
``TransformerProcessorBlock`` against flax, their weights moved by
``state_dict_from_jax`` and loaded strictly.

Tolerance: float32 rtol/atol 3e-5 (the JAX kernel's own test: 2e-5/2e-6;
here sums over up to 3w keys taken in another order).  Two tests run the
JAX kernels on bf16 inputs and hold them to the card's bf16 gates: the
forward to K6's (out 2e-2 of max|ref|, lse 1e-3 of max|lse|), the backward
to K7's (2e-2 of max|ref|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.models.layers.attention import MultiHeadSelfAttention as JaxMHSA
from anemoi_tpu.models.layers.attention import _window_attention
from anemoi_tpu.models.layers.attention import get_alibi_slopes as jax_alibi_slopes
from anemoi_tpu.models.layers.processor import TransformerProcessorBlock as JaxBlock
from anemoi_tpu.ops.pallas.window_attention import (
    _flash_window,
    _flash_window_backward,
    _flash_window_forward,
)
from anemoi_tpu_torch.models.layers.attention import (
    MultiHeadSelfAttention,
    get_alibi_slopes,
    self_attention,
    window_attention_plain,
)
from anemoi_tpu_torch.models.layers.processor import TransformerProcessorBlock
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.ops.window_attention import (
    band_attention_bwd_plain,
    band_attention_plain,
    band_pairs,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=3e-5, atol=3e-5)
W, H, D = 16, 2, 32
CASES = {  # name: (n, softcap, alibi)
    "plain": (64, None, False),
    "softcap": (64, 5.0, False),
    "alibi": (64, None, True),
    "ragged_softcap_alibi": (50, 3.0, True),
}


def qkv(seed, n, b=1, h=H, d=D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3)]


def to_bh(x, n_pad):
    """[B, N, H, D] -> the Pallas kernels' [B*H, N_pad, D], zero-padded."""
    b, n, h, d = x.shape
    x = np.transpose(x, (0, 2, 1, 3)).reshape(b * h, n, d)
    return jnp.asarray(np.pad(x, ((0, 0), (0, n_pad - n), (0, 0))))


def from_bh(x, b, n):
    x = np.asarray(x)[:, :n]
    return np.transpose(x.reshape(b, -1, n, x.shape[-1]), (0, 2, 1, 3))


def slopes_for(alibi, h=H):
    return get_alibi_slopes(h) if alibi else None


def test_alibi_slopes_match_jax():
    for h in (1, 2, 4, 6, 12, 16):
        np.testing.assert_array_equal(get_alibi_slopes(h).numpy(), np.asarray(jax_alibi_slopes(h)))


@pytest.mark.parametrize("case", list(CASES))
def test_band_forward_matches_jax(case):
    n, softcap, alibi = CASES[case]
    q, k, v = qkv(0, n)
    slopes = slopes_for(alibi)
    out, lse = band_attention_plain(*map(torch.from_numpy, (q, k, v)), W, softcap, slopes)
    ref = _window_attention(*map(jnp.asarray, (q, k, v)), W, softcap,
                            None if slopes is None else jnp.asarray(slopes.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)

    n_pad = -(-n // W) * W
    tup = None if slopes is None else tuple(float(s) for s in slopes)
    k_out, k_lse = _flash_window_forward(*(to_bh(x, n_pad) for x in (q, k, v)), W, softcap, n,
                                         H, tup, interpret=True)
    np.testing.assert_allclose(out.numpy(), from_bh(k_out, 1, n), **TOL)
    np.testing.assert_allclose(lse.numpy()[0], np.asarray(k_lse).reshape(H, n_pad)[:, :n], **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_band_backward_matches_jax(case):
    n, softcap, alibi = CASES[case]
    q, k, v = qkv(1, n)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    slopes = slopes_for(alibi)
    got = band_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, g)), W, softcap, slopes)
    jslopes = None if slopes is None else jnp.asarray(slopes.numpy())
    _, vjp = jax.vjp(lambda a, b_, c: _window_attention(a, b_, c, W, softcap, jslopes),
                     *map(jnp.asarray, (q, k, v)))
    for ours, ref in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    if softcap is not None:
        return  # the JAX kernels' backward differentiates _window_attention under softcap
    n_pad = -(-n // W) * W
    tup = None if slopes is None else tuple(float(s) for s in slopes)
    bq, bk, bv, bg = (to_bh(x, n_pad) for x in (q, k, v, g))
    out, lse = _flash_window_forward(bq, bk, bv, W, None, n, H, tup, interpret=True)
    for ours, ref in zip(got, _flash_window_backward(bq, bk, bv, out, lse, bg, W, n, H, tup,
                                                      interpret=True)):
        np.testing.assert_allclose(ours.numpy(), from_bh(ref, 1, n), **TOL)


def test_band_pairs():
    for n, w in ((64, 16), (50, 16), (24, 16), (10242, 512)):
        i = np.arange(n)
        assert band_pairs(n, w) == int((np.abs(i[:, None] - i[None, :]) <= w).sum())
    assert band_pairs(10242, 512) == 10_235_394


def test_attention_impl_dispatch():
    """At w + 1 < n <= 2w + 1 the XLA path computes full attention and the
    Pallas path the band: two different functions, as in the JAX package."""
    n = 24  # W + 1 < 24 <= 2W + 1
    q, k, v = qkv(3, n)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    xla = self_attention(tq, tk, tv, W, attention_impl="xla")
    pallas = self_attention(tq, tk, tv, W, attention_impl="pallas")
    ref_xla = _window_attention(*map(jnp.asarray, (q, k, v)), W)
    np.testing.assert_allclose(xla.numpy(), np.asarray(ref_xla), **TOL)
    np.testing.assert_allclose(window_attention_plain(tq, tk, tv, W).numpy(),
                               np.asarray(ref_xla), **TOL)
    ref_pallas = _flash_window(*(to_bh(x, 32) for x in (q, k, v)), W, None, n, H, None, True)
    np.testing.assert_allclose(pallas.numpy(), from_bh(ref_pallas, 1, n), **TOL)
    assert np.abs(xla.numpy() - pallas.numpy()).max() > 1e-3
    # with 2w + 1 < n both paths take the band
    q, k, v = map(torch.from_numpy, qkv(4, 64))
    torch.testing.assert_close(self_attention(q, k, v, W, attention_impl="xla"),
                               self_attention(q, k, v, W, attention_impl="pallas"))


def randomised(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (0.3 * rng.normal(size=x.shape)).astype(np.float32), params)


def load_component(module, params, prefix):
    """Move flax params of one processor layer into ``module`` (strict)."""
    sd = state_dict_from_jax({"TransformerProcessor_0": {"blocks_0": params}})
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module


MHSA_CASES = {
    "band": dict(window_size=16),
    "band_qknorm_alibi_softcap": dict(window_size=16, qk_norm=True, use_alibi_slopes=True,
                                      softcap=4.0),
    "band_rope_qkv_bias": dict(window_size=16, use_rotary_embeddings=True, qkv_bias=True),
    "full": dict(window_size=None, qk_norm=True),
}


@pytest.mark.parametrize("case", list(MHSA_CASES))
def test_mhsa_matches_flax(case):
    kw = MHSA_CASES[case]
    c, h, n = 32, 4, 50
    x = np.random.default_rng(5).normal(size=(2, n, c)).astype(np.float32)
    jax_mod = JaxMHSA(num_heads=h, **kw)
    shapes = jax.eval_shape(jax_mod.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = randomised(shapes, 6)
    ref = jax_mod.apply({"params": params}, jnp.asarray(x))
    ours = load_component(MultiHeadSelfAttention(c, h, **kw), {"attention": params},
                          "model.processor.proc.0.attention.")
    out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_transformer_block_matches_flax():
    c, h, n = 32, 4, 50
    x = np.random.default_rng(7).normal(size=(1, n, c)).astype(np.float32)
    jax_mod = JaxBlock(num_channels=c, hidden_dim=4 * c, num_heads=h, window_size=16,
                       qk_norm=True, use_alibi_slopes=True)
    shapes = jax.eval_shape(jax_mod.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = randomised(shapes, 8)
    ref, _ = jax_mod.apply({"params": params}, jnp.asarray(x))
    block = load_component(
        TransformerProcessorBlock(c, 4 * c, h, window_size=16, qk_norm=True,
                                  use_alibi_slopes=True),
        params, "model.processor.proc.0.")
    out = block(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", ["plain", "alibi"])
def test_band_forward_bf16_within_card_gate(case):
    """The card's bf16 gates for K6 (out 2e-2 of max|ref|, lse 1e-3 of
    max|lse|) hold on the JAX kernel itself: ``_flash_window_forward`` in
    interpret mode on bf16 inputs against the port's float32
    ``band_attention_plain`` on the same inputs.  The JAX kernel rounds P to
    bf16 for ``P V`` (``p.astype(v.dtype)``) and out on its store, as the
    port's tensor-core K6 does.  Measured max|d| / max|ref| on these inputs:
    out 2.7e-3 plain, 3.0e-3 with ALiBi; lse 1.0e-7 and 1.1e-7 (lse sums
    the float32 P).  So the out gate has a 7x margin over rounding that the
    reference itself does."""
    n, _, alibi = CASES[case]
    slopes = slopes_for(alibi)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in qkv(0, n))
    ref, ref_lse = band_attention_plain(q.float(), k.float(), v.float(), W, None, slopes)
    tup = None if slopes is None else tuple(float(s) for s in slopes)
    bq, bk, bv = (to_bh(x.float().numpy(), n).astype(jnp.bfloat16) for x in (q, k, v))
    out, lse = _flash_window_forward(bq, bk, bv, W, None, n, H, tup, interpret=True)
    got = from_bh(np.asarray(out, dtype=np.float32), 1, n)
    got_lse = np.asarray(lse).reshape(H, n)
    y, y_lse = ref.numpy(), ref_lse.numpy()[0]
    assert np.abs(got - y).max() <= 2e-2 * np.abs(y).max()
    assert np.abs(got_lse - y_lse).max() <= 1e-3 * np.abs(y_lse).max()


@pytest.mark.parametrize("case", ["plain", "alibi"])
def test_band_backward_bf16_within_card_gate(case):
    """The card's bf16 gate for K7 (2e-2 of max|ref|) holds on the JAX
    kernels themselves: ``_flash_window_backward`` in interpret mode on bf16
    inputs against the port's float32 ``band_attention_bwd_plain`` on the same
    inputs.  Measured max|d| / max|ref| on these inputs: 4.7e-3 (dq), 4.7e-3
    (dk), 5.5e-7 (dv) plain; 4.8e-3, 4.7e-3, 1.4e-4 with ALiBi.  The JAX
    kernels round dS to bf16 before its products (``ds.astype(k.dtype)``),
    as the port's tensor-core K7 does; only their dv keeps P in float32.  So
    the gate has a 4x margin over rounding that the reference itself does."""
    n, _, alibi = CASES[case]
    q, k, v = qkv(1, n)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    slopes = slopes_for(alibi)
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g))
    ref = band_attention_bwd_plain(q, k, v, g, W, None, slopes)
    tup = None if slopes is None else tuple(float(s) for s in slopes)
    bq, bk, bv, bg = (to_bh(x.float().numpy(), n).astype(jnp.bfloat16) for x in (q, k, v, g))
    out, lse = _flash_window_forward(bq, bk, bv, W, None, n, H, tup, interpret=True)
    got = _flash_window_backward(bq, bk, bv, out, lse, bg, W, n, H, tup, interpret=True)
    for name, ours, theirs in zip(("dq", "dk", "dv"), ref, got):
        y = ours.float().numpy()
        x = from_bh(np.asarray(theirs, dtype=np.float32), 1, n)
        assert np.abs(x - y).max() <= 2e-2 * np.abs(y).max(), name
