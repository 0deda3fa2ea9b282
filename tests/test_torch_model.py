"""The PyTorch port's serving slice as a whole, against the JAX package.

A tiny model of the flagship's shape (o16 -> ico-2, 32 channels, 2
processor layers, 4 heads, trainable node attributes {data: 8, hidden: 8},
edge attributes [edge_dirs, edge_length]): the JAX parameters are
initialised, replaced by seeded random numbers, moved with
``state_dict_from_jax`` into the port (strict load), and a 2-step forecast
through each package's ``make_forecast_fn`` is compared.  Both packages get
the same graph (the JAX builder's, copied into the port's container):
graph-builder parity, tie-breaking included, is tests/test_torch_graphs.py's
subject.  The JAX side runs its ``segment`` backend.

Tolerances: float32 rtol/atol 1e-4 (two chained steps, matmul and LayerNorm
sums taken in another order).  bf16 serving: relative L2 <= 2e-2 -- both
packages round activations and weights to bf16 (8 bits of mantissa, ~4e-3
per rounding) at different places; the observed difference is ~4e-3.
"""

import json
import os

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
from anemoi_tpu.training.checkpoint import load_inference_checkpoint
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.flagship import (
    VARIABLES,
    flagship_config,
    flagship_indices,
    flagship_recipe,
    flagship_statistics,
)
from anemoi_tpu_torch.graphs.create import GraphCreator
from anemoi_tpu_torch.graphs.graph import EdgeSet, Graph, NodeSet
from anemoi_tpu_torch.inference import make_forecast_fn
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.port import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "inference_ckpt_r2")


def port_graph(g):
    """The same graph in the port's container."""
    out = Graph()
    for name, ns in g.nodes.items():
        out[name] = NodeSet(ns.coords, dict(ns.attributes))
    for key, es in g.edges.items():
        out[key] = EdgeSet(es.edge_index, dict(es.attributes), es.dst_ptr)
    return out


def jax_config(precision):
    cfg = flagship_config(num_channels=32, num_layers=2, num_heads=4,
                          inference_precision=precision)
    cfg["model"]["graph_attention_backend"] = "segment"
    return cfg


@pytest.fixture(scope="module")
def tiny():
    graph = JaxGraphCreator(flagship_recipe("o16", 2)).create()
    stats = flagship_statistics(seed=1)
    indices = {"data": JaxIndexCollection({n: i for i, n in enumerate(VARIABLES)},
                                          forcing=["cos_lat", "z"], diagnostic=["tp"])}
    iface = JaxInterface(config=jax_config("fp32"), graph=graph, data_indices=indices,
                         statistics=stats)
    rng = np.random.default_rng(0)
    flat = flax.traverse_util.flatten_dict(jax.eval_shape(iface.init_params)["params"])
    params = {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()}
    )}
    batch = rng.normal(size=(1, 4, 1, graph["data"].num_nodes, len(VARIABLES))).astype(np.float32)
    return {"graph": graph, "stats": stats, "indices": indices, "iface": iface,
            "params": params, "batch": batch}


def port_interface(tiny, precision):
    iface = AnemoiModelInterface(
        config=jax_config(precision), graph=port_graph(tiny["graph"]),
        data_indices=flagship_indices(), statistics=tiny["stats"], device="cpu",
    )
    iface.load_state_dict(state_dict_from_jax(tiny["params"]), strict=True)
    return iface


def test_state_dict_matches_flax_to_reference(tiny):
    """state_dict_from_jax gives the names and tensors of the JAX package's
    anemoi-core export, and they load strictly into the port."""
    ours = state_dict_from_jax(tiny["params"])
    ref = flax_to_reference(tiny["params"])
    assert sorted(ours) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_array_equal(ours[name].numpy(), value, err_msg=name)
    port = port_interface(tiny, "fp32")
    assert sorted(port.state_dict()) == sorted(ref)


def test_forecast_fp32_matches_jax(tiny):
    ref = np.asarray(jax_forecast_fn(tiny["iface"], steps=2)(
        tiny["params"], {"data": jnp.asarray(tiny["batch"])})["data"])
    out = make_forecast_fn(port_interface(tiny, "fp32"), steps=2)(
        {"data": torch.from_numpy(tiny["batch"])})["data"]
    assert out.dtype == torch.float32 and out.shape == ref.shape == (1, 2, 1, 1600, 5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_forecast_bf16_matches_jax(tiny):
    jax_iface = JaxInterface(config=jax_config("bf16"), graph=tiny["graph"],
                             data_indices=tiny["indices"], statistics=tiny["stats"])
    ref = np.asarray(jax_forecast_fn(jax_iface, steps=2)(
        tiny["params"], {"data": jnp.asarray(tiny["batch"])})["data"])
    port = port_interface(tiny, "bf16")
    assert next(port.model.parameters()).dtype == torch.bfloat16
    out = make_forecast_fn(port, steps=2)({"data": torch.from_numpy(tiny["batch"])})["data"]
    assert out.dtype == torch.float32
    rel_l2 = np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref)
    assert rel_l2 <= 2e-2, rel_l2


def test_frozen_fixture_predict_step_matches_jax():
    """The frozen inference bundle: its graph rebuilt by the port from the
    recipe in checkpoint.json, its weights through state_dict_from_jax;
    predict_step in float32 on both sides."""
    jax_iface, params = load_inference_checkpoint(FIXTURE)
    jax_iface.config["model"]["inference_precision"] = "fp32"
    with open(os.path.join(FIXTURE, "checkpoint.json")) as f:
        bundle = json.load(f)
    config = bundle["config"]
    config["model"]["inference_precision"] = "fp32"
    indices = {
        ds: IndexCollection({k: int(v) for k, v in di["name_to_index"].items()},
                            forcing=di.get("forcing"), diagnostic=di.get("diagnostic"),
                            target=di.get("target"))
        for ds, di in bundle["data_indices"].items()
    }
    stats_flat = np.load(os.path.join(FIXTURE, "statistics.npz"))
    stats = {}
    for key in stats_flat.files:
        ds, stat = key.split("|")
        stats.setdefault(ds, {})[stat] = stats_flat[key]
    port = AnemoiModelInterface(
        config=config, graph=GraphCreator(config["graph"]["recipe"]).create(),
        data_indices=indices, statistics=stats, device="cpu",
    )
    port.load_state_dict(state_dict_from_jax(jax.device_get(params)), strict=True)

    rng = np.random.default_rng(7)
    n_grid = port.model_graph.num_nodes["data"]
    mean, std = stats["data"]["mean"], stats["data"]["stdev"]
    batch = (mean + std * rng.normal(size=(2, 2, 1, n_grid, len(mean)))).astype(np.float32)
    ref = np.asarray(jax_iface.predict_step(params, {"data": jnp.asarray(batch)})["data"])
    out = port.predict_step({"data": torch.from_numpy(batch)})["data"].numpy()
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, rtol=1e-4, atol=1e-4)
