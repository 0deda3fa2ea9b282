"""The Transformer-family slice of the port as a whole, against the JAX package.

A tiny ``transformer`` preset (``transformer_config``: GraphTransformer
encoder and decoder with edge attributes [edge_length, edge_dirs], a dense
``TransformerProcessor`` of 2 layers, 32 channels, 4 heads, window 16 over the
162 SFC-sorted nodes of the o16 -> ico-2 graph, the default
``attention_impl: xla``, so
both packages take the band): the JAX parameters are initialised, replaced by
seeded random numbers, moved with ``state_dict_from_jax`` into the port
(strict load); then

- a 2-step forecast through each package's ``make_forecast_fn``: float32
  rtol/atol 1e-4; bf16 serving relative L2 <= 2e-2 (tests/test_torch_model.py);
- the step-1 gradients of ``make_step_fns`` (area-weighted MSE, rollout 1,
  float32): loss and ``grad_norm`` rtol 5e-4, every gradient rtol 5e-4 and
  atol 5e-4 of its largest magnitude (tests/test_torch_training.py).

The JAX package's Pallas route cannot run here (its wrapper fixes
``interpret=False``); the band it computes is tests/test_torch_window_attention.py's
subject.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.inference import make_forecast_fn as jax_forecast_fn
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.models.port import flax_to_reference
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu_torch.flagship import (
    VARIABLES,
    flagship_indices,
    flagship_recipe,
    flagship_statistics,
    transformer_config,
)
from anemoi_tpu_torch.graphs.graph import EdgeSet, Graph, NodeSet
from anemoi_tpu_torch.inference import make_forecast_fn
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.layers.processor import TransformerProcessor
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState, make_step_fns
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCALERS = {"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                    "attribute_name": "area_weight"}}
LOSS = {"name": "WeightedMSELoss", "scalers": ["area"]}


def port_graph(g):
    out = Graph()
    for name, ns in g.nodes.items():
        out[name] = NodeSet(ns.coords, dict(ns.attributes))
    for key, es in g.edges.items():
        out[key] = EdgeSet(es.edge_index, dict(es.attributes), es.dst_ptr)
    return out


def config(precision="fp32"):
    cfg = transformer_config(num_channels=32, num_layers=2, num_heads=4, window_size=16,
                             inference_precision=precision)
    cfg["model"]["graph_attention_backend"] = "segment"
    return cfg


@pytest.fixture(scope="module")
def tiny():
    graph = JaxGraphCreator(flagship_recipe("o16", 2)).create()
    assert 2 * 16 + 1 < graph["hidden"].num_nodes  # the band, on both paths
    stats = flagship_statistics(seed=1)
    indices = {"data": JaxIndexCollection({n: i for i, n in enumerate(VARIABLES)},
                                          forcing=["cos_lat", "z"], diagnostic=["tp"])}
    iface = JaxInterface(config=config(), graph=graph, data_indices=indices, statistics=stats)
    rng = np.random.default_rng(0)
    flat = flax.traverse_util.flatten_dict(jax.eval_shape(iface.init_params)["params"])
    params = {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()}
    )}
    mean, std = stats["data"]["mean"], stats["data"]["stdev"]
    batch = (mean + std * rng.normal(size=(1, 4, 1, graph["data"].num_nodes,
                                           len(VARIABLES)))).astype(np.float32)
    return {"graph": graph, "port_graph": port_graph(graph), "stats": stats,
            "indices": indices, "iface": iface, "params": params, "batch": batch}


def port_interface(tiny, precision="fp32", training=False):
    iface = AnemoiModelInterface(
        config=config(precision), graph=tiny["port_graph"], data_indices=flagship_indices(),
        statistics=tiny["stats"], device="cpu", training=training,
    )
    iface.load_state_dict(state_dict_from_jax(tiny["params"]), strict=True)
    return iface


def test_state_dict_matches_flax_to_reference(tiny):
    """The JAX export's names and tensors, with its fused qkv split into
    anemoi-core's lin_q, lin_k, lin_v; a strict load into the port."""
    ours = state_dict_from_jax(tiny["params"])
    ref = flax_to_reference(tiny["params"])
    for name in [n for n in ref if n.endswith(".qkv.weight")]:
        for part, w in zip("qkv", np.split(ref.pop(name), 3, axis=0)):
            ref[name.replace(".qkv.", f".lin_{part}.")] = w
    assert sorted(ours) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_array_equal(ours[name].numpy(), value, err_msg=name)
    port = port_interface(tiny)
    assert isinstance(port.model.processor, TransformerProcessor)
    assert "model.processor.proc.1.attention.lin_v.weight" in port.state_dict()
    assert "model.processor.proc.0.layer_norm_mlp.weight" in port.state_dict()


def test_forecast_fp32_matches_jax(tiny):
    ref = np.asarray(jax_forecast_fn(tiny["iface"], steps=2)(
        tiny["params"], {"data": jnp.asarray(tiny["batch"])})["data"])
    out = make_forecast_fn(port_interface(tiny), steps=2)(
        {"data": torch.from_numpy(tiny["batch"])})["data"]
    assert out.dtype == torch.float32 and out.shape == ref.shape == (1, 2, 1, 1600, 5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_forecast_bf16_matches_jax(tiny):
    jax_iface = JaxInterface(config=config("bf16"), graph=tiny["graph"],
                             data_indices=tiny["indices"], statistics=tiny["stats"])
    ref = np.asarray(jax_forecast_fn(jax_iface, steps=2)(
        tiny["params"], {"data": jnp.asarray(tiny["batch"])})["data"])
    port = port_interface(tiny, "bf16")
    assert next(port.model.parameters()).dtype == torch.bfloat16
    out = make_forecast_fn(port, steps=2)({"data": torch.from_numpy(tiny["batch"])})["data"]
    rel_l2 = np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref)
    assert rel_l2 <= 2e-2, rel_l2


def grad_store():
    """An optax transformation that keeps the gradients it is given."""
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def test_fp32_step_gradients_match_jax(tiny):
    batch = tiny["batch"][:, :3]
    jax_losses = {"data": jax_get_loss_function(
        LOSS, jax_create_scalers(SCALERS, graph=tiny["graph"], data_indices=tiny["indices"]["data"]))}
    train_step, _ = jax_make_step_fns(tiny["iface"], jax_losses, rollout=1, remat_rollout=False)
    state, metrics = train_step(JaxTrainState.create(tiny["params"], grad_store()),
                                {"data": jnp.asarray(batch)})
    ref = state_dict_from_jax(state.opt_state)

    iface = port_interface(tiny, training=True)
    losses = {"data": get_loss_function(LOSS, create_scalers(SCALERS, graph=tiny["port_graph"]))}
    p_train, _ = make_step_fns(iface, losses, rollout=1)
    pstate = TrainState.create(iface, build_optimizer({"lr": {"rate": 1e-3}}))
    loss = p_train.compute_gradients(pstate, {"data": torch.from_numpy(batch)})
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=5e-4)
    grads = {n: p.grad for n, p in iface.named_parameters()}
    assert sorted(grads) == sorted(ref)
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, want in ref.items():
        want, got = want.numpy(), grads[name].numpy()
        if name.endswith("lin_key.bias"):  # exactly 0 by softmax shift invariance
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-6 * top, name
            continue
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4 * float(np.abs(want).max()),
                                   err_msg=name)
    _, ours = p_train(pstate, {"data": torch.from_numpy(batch)})
    np.testing.assert_allclose(float(ours["grad_norm"]), float(metrics["grad_norm"]), rtol=5e-4)


def test_not_ported_transformer_options_raise(tiny):
    """A conditional processor needs an ensemble model's noise conditioning.
    Ulysses head sharding is ported (tests/test_torch_parallel_heads.py): on
    one rank the processor's ``shard_strategy: heads`` leaves it the plain
    processor, as in the JAX package.  The gated MLPs are ported
    (tests/test_torch_switches.py), and ``qk_norm_type``, which the JAX
    ``TransformerProcessor`` has no field for, is dropped as it drops it."""
    cfg = config()
    cfg["model"]["processor"]["conditional"] = True
    with pytest.raises(ValueError):
        AnemoiModelInterface(config=cfg, graph=tiny["port_graph"],
                             data_indices=flagship_indices(), statistics=tiny["stats"],
                             device="cpu")
    cfg = config()
    cfg["model"]["processor"]["shard_strategy"] = "heads"
    heads = AnemoiModelInterface(config=cfg, graph=tiny["port_graph"],
                                 data_indices=flagship_indices(), statistics=tiny["stats"],
                                 device="cpu")
    assert heads.model.halo is None
    cfg = config()
    cfg["model"]["processor"].update(mlp_implementation="swiglu", qk_norm_type="rmsnorm")
    iface = AnemoiModelInterface(config=cfg, graph=tiny["port_graph"],
                                 data_indices=flagship_indices(), statistics=tiny["stats"],
                                 device="cpu")
    assert "model.processor.proc.0.mlp.mlp.0.gate_proj.weight" in iface.state_dict()
