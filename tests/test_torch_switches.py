"""The model switches of the port against the JAX package's flax modules.

Each case initialises the flax module, replaces every parameter with seeded
random numbers (the conditional norms' zero-initialised ``scale``/``bias``
Dense layers and the Ornstein weight included, or they would test nothing),
moves them with ``state_dict_from_jax`` (strict load), runs both on the same
numpy input and compares in float32 at rtol/atol 3e-5 (ROADMAP rule 3):

- ``ConditionalLayerNorm`` (and its dtype sequence in bf16), the RMS qk-norm
  in a processor block, each gated MLP variant (outputs and input
  gradients), conditional processor and mapper blocks;
- each bounding kind, ``NoResidualConnection`` and
  ``ScalarOrnsteinConnection`` with and without statistics and regressors;
- a ``scan_unroll = 2`` processor loaded through ``state_dict_from_jax``;
- the whole deterministic model with the switches set through its config
  (bounding, residuals, gated MLPs in the GT and the dense Transformer
  processors, ``qk_norm_type``, which both packages drop above the blocks,
  ``scan_unroll``), against the JAX interface's
  ``apply`` at rtol/atol 1e-4 (a whole forward).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.models.layers import bounding as jax_bounding
from anemoi_tpu.models.layers import graph_blocks as jax_blocks
from anemoi_tpu.models.layers import mlp as jax_mlp
from anemoi_tpu.models.layers import normalization as jax_norm
from anemoi_tpu.models.layers import processor as jax_processor
from anemoi_tpu.models.layers import residual as jax_residual
from anemoi_tpu_torch.flagship import VARIABLES, flagship_config, flagship_indices, flagship_recipe
from anemoi_tpu_torch.flagship import flagship_statistics, transformer_config
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.layers.bounding import build_boundings
from anemoi_tpu_torch.models.layers.graph_blocks import (
    GraphTransformerMapperBlock,
    GraphTransformerProcessorBlock,
)
from anemoi_tpu_torch.models.layers.mlp import MLP
from anemoi_tpu_torch.models.layers.normalization import ConditionalLayerNorm
from anemoi_tpu_torch.models.layers.processor import GraphTransformerProcessor
from anemoi_tpu_torch.models.layers.residual import build_residual
from anemoi_tpu_torch.models.port import state_dict_from_jax
from test_torch_blocks import random_graph, randomised
from test_torch_training import port_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=3e-5, atol=3e-5)
GATED = ["glu", "swiglu", "geglu", "reglu"]


def loaded(module, params, under, prefix):
    """``module`` with the flax ``params`` placed at ``under`` in a model's
    tree, loaded strictly with the port names' ``prefix`` stripped."""
    sd = state_dict_from_jax({"params": {under: params["params"]}})
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32), **tol)


def test_conditional_layer_norm():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 11, 16)) * 2 + 1).astype(np.float32)
    cond = rng.normal(size=(3, 11, 4)).astype(np.float32)
    mod = jax_norm.ConditionalLayerNorm()
    init = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cond))
    assert all(not np.asarray(v).any() for v in jax.tree_util.tree_leaves(init))  # zero init
    params = randomised(init, rng)
    ref = mod.apply(params, jnp.asarray(x), jnp.asarray(cond))
    port = loaded(ConditionalLayerNorm(16, 4), params, "layer_norm_attention",
                  "model.layer_norm_attention.")
    assert not ConditionalLayerNorm(16, 4).scale.weight.any()
    close(port(torch.from_numpy(x), torch.from_numpy(cond)), ref)

    # bf16: LN in float32, the Dense layers in the compute type, cast back
    p16 = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    ref16 = mod.apply(p16, jnp.asarray(x, jnp.bfloat16), jnp.asarray(cond, jnp.bfloat16))
    port16 = port.to(torch.bfloat16)(torch.from_numpy(x).bfloat16(),
                                      torch.from_numpy(cond).bfloat16())
    assert port16.dtype == torch.bfloat16 and ref16.dtype == jnp.bfloat16
    close(port16, np.asarray(ref16.astype(jnp.float32)), dict(rtol=1e-2, atol=1e-2))
    with pytest.raises(ValueError, match="needs the conditioning"):
        port(torch.from_numpy(x), None)


@pytest.mark.parametrize("implementation", GATED)
def test_gated_mlp(implementation):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(2, 9, 10)).astype(np.float32)
    mod = jax_mlp.MLP(hidden_dim=24, out_features=10, layer_norm=False,
                      implementation=implementation)
    params = randomised(jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = mod.apply(params, jnp.asarray(x))
    ref_dx = jax.grad(lambda v: jnp.sum(mod.apply(params, v) * w))(jnp.asarray(x))
    port = loaded(MLP(12, 24, 10, layer_norm=False, implementation=implementation), params,
                  "node_dst_mlp", "model.node_dst_mlp.")
    assert {"mlp.0.gate_proj.weight", "mlp.0.value_proj.weight"} <= set(port.state_dict())
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    close(out, ref)
    (out * torch.from_numpy(w)).sum().backward()
    close(xt.grad, ref_dx)


@pytest.mark.parametrize("qk_norm_type,mlp", [("rmsnorm", "mlp"), ("layernorm", "swiglu"),
                                              ("rmsnorm", "geglu")])
def test_processor_block_switches(qk_norm_type, mlp):
    rng = np.random.default_rng(2)
    n, c, heads = 25, 16, 2
    jax_edges, sub = random_graph(rng, n, n)
    x = rng.normal(size=(2, n, c)).astype(np.float32)
    mod = jax_blocks.GraphTransformerProcessorBlock(
        num_heads=heads, hidden_dim=2 * c, out_channels=c, qk_norm=True,
        qk_norm_type=qk_norm_type, mlp_implementation=mlp, backend="segment")
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.asarray(x), jax_edges)
    params = randomised(shapes, rng)
    ref, _ = mod.apply(params, jnp.asarray(x), jax_edges)
    port = loaded(GraphTransformerProcessorBlock(c, 2 * c, c, heads, edge_dim=3, qk_norm=True,
                                                 qk_norm_type=qk_norm_type,
                                                 mlp_implementation=mlp),
                  params, "blocks_0", "model.proc.0.")
    close(port(torch.from_numpy(x), sub, sub.edge_attr), ref)


def test_conditional_processor_block():
    rng = np.random.default_rng(3)
    n, c, heads = 25, 16, 4
    jax_edges, sub = random_graph(rng, n, n)
    x = rng.normal(size=(3, n, c)).astype(np.float32)
    cond = rng.normal(size=(3, n, 4)).astype(np.float32)
    mod = jax_blocks.GraphTransformerProcessorBlock(
        num_heads=heads, hidden_dim=2 * c, out_channels=c, conditional=True, backend="segment")
    init = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jax_edges, jnp.asarray(cond))
    params = randomised(init, rng)
    ref, _ = mod.apply(params, jnp.asarray(x), jax_edges, jnp.asarray(cond))
    port = loaded(GraphTransformerProcessorBlock(c, 2 * c, c, heads, edge_dim=3, cond_dim=4),
                  params, "blocks_0", "model.proc.0.")
    assert "layer_norm_mlp_dst.scale.weight" in port.state_dict()
    close(port(torch.from_numpy(x), sub, sub.edge_attr, torch.from_numpy(cond)), ref)


def test_conditional_mapper_block():
    rng = np.random.default_rng(4)
    n_src, n_dst, c, heads = 30, 17, 16, 4
    jax_edges, sub = random_graph(rng, n_src, n_dst)
    xs, xd = (rng.normal(size=(2, n, c)).astype(np.float32) for n in (n_src, n_dst))
    cs, cd = (rng.normal(size=(2, n, 4)).astype(np.float32) for n in (n_src, n_dst))
    mod = jax_blocks.GraphTransformerMapperBlock(
        num_heads=heads, hidden_dim=2 * c, out_channels=c, conditional=True,
        mlp_implementation="reglu", backend="segment")
    x_jax, c_jax = (jnp.asarray(xs), jnp.asarray(xd)), (jnp.asarray(cs), jnp.asarray(cd))
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x_jax, jax_edges, c_jax)
    params = randomised(shapes, rng)
    (_, ref), _ = mod.apply(params, x_jax, jax_edges, c_jax)
    port = loaded(GraphTransformerMapperBlock(c, 2 * c, c, heads, edge_dim=3, cond_dim=4,
                                              mlp_implementation="reglu"),
                  params, "GraphTransformerForwardMapper_0", "model.encoder.data.")
    _, out = port((torch.from_numpy(xs), torch.from_numpy(xd)), sub, sub.edge_attr,
                  (torch.from_numpy(cs), torch.from_numpy(cd)))
    close(out, ref)


BOUNDINGS = [
    {"name": "relu", "variables": ["a", "c"]},
    {"name": "leaky_relu", "variables": ["b"], "negative_slope": 0.2},
    {"name": "hardtanh", "variables": ["a", "d"], "min_val": -0.5, "max_val": 0.7},
    {"name": "leaky_hardtanh", "variables": ["c"], "min_val": -0.3, "max_val": 0.4, "slope": 0.05},
    {"name": "fraction", "variables": ["b"], "min_val": 0.0, "max_val": 1.0, "total_var": "d"},
    {"name": "leaky_fraction", "variables": ["a"], "min_val": 0.0, "max_val": 1.0,
     "total_var": "c", "slope": 0.1},
]


@pytest.mark.parametrize("cfg", BOUNDINGS, ids=[b["name"] for b in BOUNDINGS])
def test_bounding(cfg):
    names = {"a": 0, "b": 1, "c": 2, "d": 3}
    x = np.random.default_rng(5).normal(size=(2, 1, 3, 7, 4)).astype(np.float32)
    (ref,) = jax_bounding.build_boundings([cfg], names)
    (ours,) = build_boundings([cfg], names)
    close(ours(torch.from_numpy(x)), ref(jnp.asarray(x)), dict(rtol=0, atol=0))
    with pytest.raises(KeyError):
        build_boundings([{**cfg, "variables": ["zz"]}], names)


def _indices():
    return {"data": JaxIndexCollection({n: i for i, n in enumerate(VARIABLES)},
                                       forcing=["cos_lat", "z"], diagnostic=["tp"])}


def test_no_residual_connection():
    x = np.random.default_rng(6).normal(size=(2, 2, 3, 5, 6)).astype(np.float32)
    ref = jax_residual.build_residual({"name": "NoResidualConnection"})(jnp.asarray(x), 2)
    ours = build_residual({"name": "NoResidualConnection"})(torch.from_numpy(x), 2)
    assert tuple(ours.shape) == (2, 2, 3, 5, 6)
    close(ours, ref, dict(rtol=0, atol=0))


@pytest.mark.parametrize("stats,regressors", [(False, []), (True, []), (True, ["cos_lat", "z"])],
                         ids=["plain", "statistics", "statistics_regressors"])
def test_scalar_ornstein_connection(stats, regressors):
    rng = np.random.default_rng(7)
    jax_idx, idx = _indices()["data"], flagship_indices()["data"]
    statistics = None
    if stats:
        statistics = {"stdev": rng.uniform(0.5, 2.0, 7).astype(np.float32),
                      "stdev_tend": rng.uniform(0.1, 1.0, 7).astype(np.float32),
                      "mean": np.zeros(7, np.float32)}
    cfg = {"name": "ScalarOrnsteinConnection", "regressors": regressors, "theta_buff": 0.1}
    x = rng.normal(size=(2, 2, 3, 9, idx.num_model_input_vars)).astype(np.float32)
    mod = jax_residual.build_residual(cfg, data_indices=jax_idx, statistics=statistics,
                                      name="residual_data")
    init = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ours = build_residual(cfg, idx, statistics)
    np.testing.assert_allclose(ours.weight.detach().numpy(), np.asarray(init["params"]["weight"]),
                               rtol=1e-6)
    params = {"params": {"weight": init["params"]["weight"]
                         + 0.3 * rng.normal(size=init["params"]["weight"].shape)}}
    ref = mod.apply(params, jnp.asarray(x), 1)
    sd = state_dict_from_jax({"params": {"residual_data": params["params"]}})
    assert list(sd) == ["model.residual.data.weight"]
    ours.load_state_dict({"weight": sd["model.residual.data.weight"]}, strict=True)
    close(ours(torch.from_numpy(x), 1), ref)


def test_scan_unroll_processor_loads():
    rng = np.random.default_rng(8)
    n, c, heads, layers = 25, 16, 2, 4
    jax_edges, sub = random_graph(rng, n, n)
    x = rng.normal(size=(2, n, c)).astype(np.float32)
    mod = jax_processor.GraphTransformerProcessor(
        num_layers=layers, num_channels=c, num_heads=heads, mlp_hidden_ratio=2.0,
        scan_unroll=2, gradient_checkpointing=False, backend="segment")
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.asarray(x), jax_edges)
    params = randomised(shapes, rng)
    assert sorted(params["params"]["blocks"]) == ["block_0", "block_1"]
    ref = mod.apply(params, jnp.asarray(x), jax_edges)
    port = GraphTransformerProcessor(layers, c, heads, edge_dim=3, mlp_hidden_ratio=2.0,
                                     scan_unroll=2, gradient_checkpointing=False)
    loaded(port, params, "GraphTransformerProcessor_0", "model.processor.")
    close(port(torch.from_numpy(x), sub, sub.edge_attr), ref)
    with pytest.raises(ValueError, match="scan_unroll 3 must divide"):
        GraphTransformerProcessor(layers, c, heads, edge_dim=3, scan_unroll=3)


@pytest.fixture(scope="module")
def graphs():
    g = JaxGraphCreator(flagship_recipe("o16", 1)).create()
    return g, port_graph(g)


MODEL_SWITCHES = {
    "bounding": {"bounding": [{"name": "relu", "variables": ["tp"]},
                              {"name": "hardtanh", "variables": ["q"], "min_val": -1.0,
                               "max_val": 1.0}]},
    "no_residual": {"residual": {"name": "NoResidualConnection"}},
    "ornstein": {"residual": {"name": "ScalarOrnsteinConnection", "regressors": ["z"]}},
    # qk_norm_type is a field of the JAX blocks, not of its mappers or
    # processors: both packages drop it from the config (the LayerNorm stays)
    "gated_qk_norm_type": {"processor": {"mlp_implementation": "swiglu", "qk_norm": True,
                                         "qk_norm_type": "rmsnorm"},
                           "encoder": {"mlp_implementation": "glu", "qk_norm": True,
                                       "qk_norm_type": "rmsnorm"}},
    "scan_unroll": {"processor": {"scan_unroll": 2, "num_layers": 4}},
    "transformer_geglu": {"processor": {"mlp_implementation": "geglu"}},
}


@pytest.mark.parametrize("case", sorted(MODEL_SWITCHES))
def test_model_switches_match_jax(graphs, case):
    jax_graph, graph = graphs
    if case.startswith("transformer"):  # the dense processor's own switches
        cfg = transformer_config(num_channels=16, num_layers=2, num_heads=2, window_size=8,
                                 inference_precision="fp32")
    else:
        cfg = flagship_config(num_channels=16, num_layers=2, num_heads=2,
                              inference_precision="fp32")
    cfg["model"]["graph_attention_backend"] = "segment"
    for key, value in MODEL_SWITCHES[case].items():
        if isinstance(value, dict) and key in cfg["model"]:
            cfg["model"][key].update(value)
        else:
            cfg["model"][key] = value
    stats = flagship_statistics(seed=1)
    stats["data"]["stdev_tend"] = 0.3 * stats["data"]["stdev"]
    iface = JaxInterface(config=cfg, graph=jax_graph, data_indices=_indices(), statistics=stats)
    rng = np.random.default_rng(9)
    params = randomised(jax.eval_shape(iface.init_params), rng)
    port = AnemoiModelInterface(config=cfg, graph=graph, data_indices=flagship_indices(),
                                statistics=stats, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    n = jax_graph["data"].num_nodes
    x = rng.normal(size=(2, 2, 1, n, flagship_indices()["data"].num_model_input_vars))
    x = x.astype(np.float32)
    ref = iface.apply(params, {"data": jnp.asarray(x)})["data"]
    with torch.no_grad():
        ours = port.apply({"data": torch.from_numpy(x)})["data"]
    close(ours, ref, dict(rtol=1e-4, atol=1e-4))
