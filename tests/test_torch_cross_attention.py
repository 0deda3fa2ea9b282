"""The dense cross attention and the Transformer mappers of the port against
the JAX package.

The same arrays, made from a numpy seed, go through both, in float32:

- ``MultiHeadCrossAttention`` (the case of ``tests/test_attention.py``: 20
  sources, 12 destinations, 16 channels, 4 heads; with and without the
  q/k/v bias): the output and the gradients of every weight and of both
  inputs (3e-5 forward, 1e-4 gradients, of the largest magnitude);
- ``TransformerForwardMapper`` and ``TransformerBackwardMapper`` alone,
  their weights carried by ``state_dict_from_jax`` and loaded strictly;
- ``AnemoiModelEncProcDec`` with both Transformer mappers and a
  GraphTransformer processor on o8 -> ico-1 (32 channels, 1 layer, 4
  heads): the forward and every parameter's gradient, and the zero output
  head of ``initialise_data_extractor_zero``.

The CUDA path (``scaled_dot_product_attention`` on its flash and
memory-efficient backends) is held against the plain version on the card by
``chip_smoke.py`` (phase 27).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.models.layers import mapper as jax_mapper
from anemoi_tpu.models.layers.attention import MultiHeadCrossAttention as JaxCrossAttention
from anemoi_tpu_torch.flagship import VARIABLES, flagship_config, flagship_indices
from anemoi_tpu_torch.flagship import flagship_recipe, flagship_statistics
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.layers.attention import MultiHeadCrossAttention, cross_attention
from anemoi_tpu_torch.models.layers.mapper import (
    TransformerBackwardMapper,
    TransformerForwardMapper,
)
from anemoi_tpu_torch.models.port import state_dict_from_jax
from test_torch_blocks import randomised
from test_torch_gnn import check_module, close
from test_torch_model import port_graph

KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["no_bias", "bias"])
def test_cross_attention_matches_jax(qkv_bias):
    rng = np.random.default_rng(0)
    src = rng.normal(size=(2, 20, 16)).astype(np.float32)
    dst = rng.normal(size=(2, 12, 16)).astype(np.float32)
    mod = JaxCrossAttention(num_heads=4, qkv_bias=qkv_bias)
    params = randomised(mod.init(KEY, jnp.asarray(src), jnp.asarray(dst)), rng)
    port = MultiHeadCrossAttention(16, 4, qkv_bias=qkv_bias)
    # the module's names inside a mapper: cross_attention/{q,k,v,out_proj}
    prefix = "model.encoder.data.proc.attention."
    state = state_dict_from_jax({"TransformerForwardMapper_0": {"cross_attention":
                                                                params["params"]}})
    port.load_state_dict({k[len(prefix):]: v for k, v in state.items()}, strict=True)
    cot = rng.normal(size=dst.shape).astype(np.float32)

    def loss(p, s, d):
        out = mod.apply(p, s, d)
        return jnp.sum(out * cot), out

    (_, ref), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(src), jnp.asarray(dst))
    s, d = torch.tensor(src, requires_grad=True), torch.tensor(dst, requires_grad=True)
    out = port(s, d)
    close(out, ref)
    (out * torch.from_numpy(cot)).sum().backward()
    want = state_dict_from_jax({"TransformerForwardMapper_0": {"cross_attention":
                                                               grads[0]["params"]}})
    top = max(float(g.abs().max()) for g in want.values())
    for name, p in port.named_parameters():
        if name == "lin_k.bias":  # 0 in truth (softmax is shift invariant): noise
            assert p.grad.abs().max() <= 1e-5 * top
            assert want[prefix + name].abs().max() <= 1e-5 * top
            continue
        close(p.grad, want[prefix + name].numpy(), 1e-4)
    close(s.grad, grads[1], 1e-4)
    close(d.grad, grads[2], 1e-4)


def test_plain_cross_attention_on_the_cpu_only():
    q = torch.randn(1, 3, 2, 4)
    kv = torch.randn(1, 5, 2, 4)
    ref = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, kv) / 2.0, -1)
    torch.testing.assert_close(cross_attention(q, kv, kv),
                               torch.einsum("bhnm,bmhd->bnhd", ref, kv))
    with pytest.raises(RuntimeError, match="no cross attention"):
        cross_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))


def test_transformer_mappers_match_jax():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(2, 20, 7)).astype(np.float32)
    xd = rng.normal(size=(2, 12, 5)).astype(np.float32)
    mod = jax_mapper.TransformerForwardMapper(hidden_dim=16, num_heads=4, mlp_hidden_ratio=2.0)
    port = TransformerForwardMapper(7, 5, 16, num_heads=4, mlp_hidden_ratio=2.0)
    check_module(mod, port, [xs, xd], lambda m, s, d: m((s, d)), rng,
                 name="TransformerForwardMapper_0", prefix="model.encoder.data.",
                 args=lambda s, d: ((s, d),))
    latent = rng.normal(size=(2, 12, 16)).astype(np.float32)
    mod = jax_mapper.TransformerBackwardMapper(hidden_dim=16, out_channels_dst=6, num_heads=4)
    port = TransformerBackwardMapper(5, 16, 6, num_heads=4)
    check_module(mod, port, [latent, rng.normal(size=(2, 20, 5)).astype(np.float32)],
                 lambda m, s, d: m((s, d)), rng, name="TransformerBackwardMapper_0",
                 prefix="model.decoder.data.", args=lambda s, d: ((s, d),))


def transformer_mapper_config(zero_head=False):
    cfg = flagship_config(num_channels=32, num_layers=1, num_heads=4, inference_precision="fp32")
    cfg["model"].update(
        graph_attention_backend="segment",
        encoder={"name": "TransformerForwardMapper", "num_heads": 4, "mlp_hidden_ratio": 2.0},
        decoder={"name": "TransformerBackwardMapper", "num_heads": 4,
                 "initialise_data_extractor_zero": zero_head})
    return cfg


def test_model_with_transformer_mappers_matches_jax():
    graph = JaxGraphCreator(flagship_recipe("o8", 1)).create()
    stats = flagship_statistics(seed=1)
    indices = {"data": JaxIndexCollection({n: i for i, n in enumerate(VARIABLES)},
                                          forcing=["cos_lat", "z"], diagnostic=["tp"])}
    cfg = transformer_mapper_config()
    iface = JaxInterface(config=cfg, graph=graph, data_indices=indices, statistics=stats)
    params = randomised(iface.init_params(), np.random.default_rng(2))
    port = AnemoiModelInterface(config=cfg, graph=port_graph(graph),
                                data_indices=flagship_indices(), statistics=stats, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    assert type(port.model.encoder["data"]).__name__ == "TransformerForwardMapper"
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 2, 1, graph["data"].num_nodes, 6)).astype(np.float32)
    cot = rng.normal(size=(2, 1, 1, graph["data"].num_nodes, 5)).astype(np.float32)

    def loss(p):
        out = iface.model.apply(p, {"data": jnp.asarray(x)}, iface.graph_inputs)["data"]
        return jnp.sum(out * cot), out

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out = port.run_model({"data": torch.from_numpy(x)})["data"]
    close(out, ref, 1e-4)
    (out * torch.from_numpy(cot)).sum().backward()
    want = state_dict_from_jax(ref_grads)
    got = dict(port.named_parameters())
    assert sorted(want) == sorted(got)
    assert "model.decoder.data.proc.attention.lin_q.weight" in got
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        if name.endswith("lin_key.bias"):  # 0 in truth (softmax is shift invariant): noise
            assert got[name].grad.abs().max() <= 1e-6 * top and g.abs().max() <= 1e-6 * top
            continue
        close(got[name].grad, g.numpy(), 1e-4)
    zero = AnemoiModelInterface(config=transformer_mapper_config(zero_head=True),
                                graph=port_graph(graph), data_indices=flagship_indices(),
                                statistics=stats, device="cpu")
    head = zero.model.decoder["data"].node_data_extractor[1]
    assert not head.weight.any() and not head.bias.any()
