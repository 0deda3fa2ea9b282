"""The hierarchical V-cycle family of the port against the JAX package.

On the graph of ``tests/test_hierarchical.py`` (o8 -> ico-2 -> ico-1, the
JAX attention on its ``segment`` backend), 16 channels and one processor
layer a level: the JAX model's parameters are randomised, carried into the
port by ``state_dict_from_jax`` and loaded strictly; both run the same
seeded numpy input in float32.  Forwards agree within 3e-5 and the
gradients of a random linear function of the output, with respect to every
parameter, within 1e-4 (of each tensor's largest magnitude, or of 1e-3 of
the model's largest gradient where that is more):

- with GraphTransformer mappers (trainable edge features on every edge
  set) and with GNN mappers at ``level_channel_ratio`` 1, and with the GT
  mappers at ratio 2 (the down, up and ``hidden_2`` sets at 32 channels);
- the switches, forward only: ``level_process`` false (no processor at
  all); ``level_process_num_layers`` with an ``up_mapper`` of its own,
  ``hidden_names`` inferred from the graph, ``enable_hierarchical_level_
  processing`` taking precedence over ``level_process`` and no latent skip;
- the refusals both packages share: a learnable Ornstein residual (the
  residual is built without data indices) and a GNN up mapper at ratio 2;
- ``hierarchical.yaml`` and ``hierarchical_autoencoder.yaml`` trained two
  steps by both trainers (the cuts of ``tests/test_torch_presets_tasks.py``
  and the hierarchy's meshes cut to ico-2 and ico-1), every record within
  1e-4; the JAX trainer's bundle served by the port's ``cli predict``,
  equal to ``make_forecast_fn`` bit for bit and to the JAX ``predict``
  within 1e-4.

Each case jits its JAX function once (the forward and the gradients in one
``value_and_grad``).
"""

import argparse
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.inference import run_forecast_cli as jax_run_forecast_cli
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.models.port import flax_to_reference
from anemoi_tpu_torch.data.dataset import open_dataset
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.inference import make_forecast_fn
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training import cli
from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint
from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR
from test_torch_blocks import randomised
from test_torch_model import port_graph
from test_torch_presets_tasks import (
    LR_ONLY,
    _SMALL_DATA,
    assert_records_equal,
    composed,
    train_both,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL, GRAD_TOL = 3e-5, 1e-4
NAMES = {"q": 0, "t": 1, "u": 2, "z": 3, "tp": 4, "cos_lat": 5}
ROLES = {"forcing": ["cos_lat", "z"], "diagnostic": ["tp"]}
STATS = {"mean": np.zeros(6, np.float32), "stdev": np.ones(6, np.float32),
         "minimum": -np.ones(6, np.float32), "maximum": np.ones(6, np.float32)}
_ATTRS = {"edge_length": {"name": "EdgeLength"}, "edge_dirs": {"name": "EdgeDirection"}}
RECIPE = {
    "nodes": {
        "data": {"node_builder": {"name": "ReducedGaussianGridNodes", "grid": "o8"}},
        "hidden_1": {"node_builder": {"name": "TriNodes", "resolution": 2}},
        "hidden_2": {"node_builder": {"name": "TriNodes", "resolution": 1}},
    },
    "edges": [
        {"source_name": src, "target_name": dst, "edge_builder": builder, "attributes": _ATTRS}
        for src, dst, builder in (
            ("data", "hidden_1", {"name": "CutOffEdges", "cutoff_factor": 0.9}),
            ("hidden_1", "hidden_1", {"name": "MultiScaleEdges", "x_hops": 1}),
            ("hidden_2", "hidden_2", {"name": "MultiScaleEdges", "x_hops": 1}),
            ("hidden_1", "hidden_2", {"name": "KNNEdges", "num_nearest_neighbours": 3}),
            ("hidden_2", "hidden_1", {"name": "KNNEdges", "num_nearest_neighbours": 3}),
            ("hidden_1", "data", {"name": "KNNEdges", "num_nearest_neighbours": 3}),
        )
    ],
}
EDGE_ATTRS = ["edge_length", "edge_dirs"]


def gt(name, **extra):
    return {"name": name, "num_heads": 4, "mlp_hidden_ratio": 2.0,
            "sub_graph_edge_attributes": EDGE_ATTRS, **extra}


def model_config(mapper="GT", **extra):
    trainable = {"trainable_size": 2} if mapper == "GT" else {}
    enc, dec = (("GraphTransformerForwardMapper", "GraphTransformerBackwardMapper")
                if mapper == "GT" else ("GNNForwardMapper", "GNNBackwardMapper"))
    cfg = {
        "name": "AnemoiModelEncProcDecHierarchical", "num_channels": 16,
        "n_step_input": 2, "n_step_output": 1, "hidden_names": ["hidden_1", "hidden_2"],
        "level_process": True, "graph_attention_backend": "segment",
        "trainable_parameters": {"data": 2, "hidden_1": 2, "hidden_2": 2},
        "encoder": gt(enc, **trainable) if mapper == "GT" else {
            "name": enc, "sub_graph_edge_attributes": EDGE_ATTRS},
        "processor": gt("GraphTransformerProcessor", num_layers=1, **trainable),
        "decoder": gt(dec, **trainable) if mapper == "GT" else {
            "name": dec, "sub_graph_edge_attributes": EDGE_ATTRS},
    }
    cfg.update(extra)
    return cfg


GRADIENT_CASES = {
    "gt": model_config("GT"),
    "gt_ratio_2": model_config("GT", level_channel_ratio=2),
    "gnn": model_config("GNN"),
}
_SWITCHES = copy.deepcopy(model_config("GT"))
del _SWITCHES["hidden_names"]
_SWITCHES.update(level_process_num_layers=2, latent_skip=False, level_process=False,
                 enable_hierarchical_level_processing=True,
                 up_mapper=gt("GraphTransformerBackwardMapper", num_heads=2,
                              mlp_hidden_ratio=1.0))
FORWARD_CASES = {
    "no_level_process": model_config("GT", level_process=False),
    "layers_up_mapper_inferred_levels": _SWITCHES,
}


@pytest.fixture(scope="module")
def graphs():
    graph = JaxGraphCreator(RECIPE).create()
    return graph, port_graph(graph)


def interfaces(graphs, cfg):
    jax_graph, graph = graphs
    config = {"model": cfg, "data": {"processors": []}}
    ref = JaxInterface(config=config, graph=jax_graph,
                       data_indices={"data": JaxIndexCollection(NAMES, **ROLES)},
                       statistics={"data": STATS})
    ours = AnemoiModelInterface(config=copy.deepcopy(config), graph=graph,
                                data_indices={"data": IndexCollection(NAMES, **ROLES)},
                                statistics={"data": STATS}, device="cpu", training=True)
    return ref, ours


def close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(ours.detach().float().numpy(), ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))


def setup(graphs, cfg, seed):
    ref, ours = interfaces(graphs, cfg)
    rng = np.random.default_rng(seed)
    params = randomised(jax.eval_shape(ref.init_params, jax.random.PRNGKey(0)), rng)
    ours.load_state_dict(state_dict_from_jax(params), strict=True)
    n_grid = graphs[0]["data"].num_nodes
    x = rng.normal(size=(1, 2, 1, n_grid, 5)).astype(np.float32)
    return ref, ours, params, x, rng


@pytest.mark.parametrize("case", sorted(GRADIENT_CASES))
def test_forward_and_gradients_match_jax(graphs, case):
    ref, ours, params, x, rng = setup(graphs, GRADIENT_CASES[case], 1)
    cot = rng.normal(size=(1, 1, 1, x.shape[3], 4)).astype(np.float32)

    def loss(p):
        out = ref.model.apply(p, {"data": jnp.asarray(x)}, ref.graph_inputs)["data"]
        return jnp.sum(out * cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out = ours.run_model({"data": torch.from_numpy(x)})["data"]
    assert out.shape == want.shape == (1, 1, 1, x.shape[3], 4)
    close(out, want, TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    got = dict(ours.named_parameters())
    want_grads = state_dict_from_jax(grads)
    assert sorted(want_grads) == sorted(got)
    # a tensor whose gradient vanishes (lin_key.bias: a destination's softmax
    # does not see a shift of all its keys) holds rounding noise: its scale
    # is at least 1e-3 of the largest gradient of the model
    floor = 1e-3 * max(float(g.abs().max()) for g in want_grads.values())
    for name, g in want_grads.items():
        want_g = g.numpy()
        np.testing.assert_allclose(
            got[name].grad.numpy(), want_g, rtol=GRAD_TOL,
            atol=GRAD_TOL * max(float(np.abs(want_g).max()), floor), err_msg=name)
    model = ours.model
    assert list(model.downscale) == ["hidden_1"] and list(model.upscale) == ["hidden_2"]
    assert model.dims == ([16, 32] if case == "gt_ratio_2" else [16, 16])
    if case == "gt":
        # anemoi-core's names and tensors, as the JAX package exports them (its
        # export names a trainable edge tensor ``<provider>.trainable.trainable``)
        export = {k.replace(".trainable.trainable", ".trainable"): v
                  for k, v in flax_to_reference(params).items()}
        ported = state_dict_from_jax(params)
        assert sorted(ported) == sorted(export)
        for name, value in export.items():
            np.testing.assert_array_equal(ported[name].numpy(), value, err_msg=name)
        assert {"downscale_graph_providers.hidden_1.trainable",
                "down_level_processor_graph_providers.hidden_1.trainable",
                "up_level_processor_graph_providers.hidden_1.trainable",
                "processor_graph_provider.trainable",
                "upscale_graph_providers.hidden_2.trainable"} <= {
                    n[len("model."):] for n in got}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_switches_match_jax(graphs, case):
    ref, ours, params, x, _ = setup(graphs, FORWARD_CASES[case], 2)
    want = jax.jit(ref.model.apply)(params, {"data": jnp.asarray(x)}, ref.graph_inputs)["data"]
    with torch.no_grad():
        close(ours.run_model({"data": torch.from_numpy(x)})["data"], want, TOL)
    model = ours.model
    if case == "no_level_process":
        assert not hasattr(model, "processor") and not len(model.down_level_processor)
    else:
        assert model.hidden_names == ["hidden_1", "hidden_2"]
        assert len(model.down_level_processor["hidden_1"].proc) == 2
        assert len(model.processor.proc) == 1
        assert model.upscale["hidden_2"].proc.num_heads == 2


@pytest.mark.parametrize("case", ["scalar_ornstein", "spectral_ornstein", "gnn_up_ratio_2"])
def test_both_packages_refuse(graphs, case):
    if case == "gnn_up_ratio_2":
        cfg, error, match = model_config("GNN", level_channel_ratio=2), TypeError, "up mapper"
    else:
        residual = {"scalar_ornstein": {"name": "ScalarOrnsteinConnection"},
                    "spectral_ornstein": {"name": "SpectralOrnsteinConnection", "gaussian_n": 8,
                                          "grid_kind": "octahedral"}}[case]
        cfg, error, match = model_config("GT", residual=residual), AssertionError, "data indices"
    config = {"model": cfg, "data": {"processors": []}}
    with pytest.raises(ValueError, match=match):
        AnemoiModelInterface(config=copy.deepcopy(config), graph=graphs[1],
                             data_indices={"data": IndexCollection(NAMES, **ROLES)},
                             statistics={"data": STATS}, device="cpu", training=True)
    ref = JaxInterface(config=config, graph=graphs[0],
                       data_indices={"data": JaxIndexCollection(NAMES, **ROLES)},
                       statistics={"data": STATS})
    with pytest.raises(error):
        ref.init_params(jax.random.PRNGKey(0))


_SMALL_LEVELS = ["graph.recipe.nodes.hidden_1.node_builder.resolution=2",
                 "graph.recipe.nodes.hidden_2.node_builder.resolution=1",
                 "model.processor.num_layers=1"]
PRESETS = {"hierarchical": "AnemoiModelEncProcDecHierarchical",
           "hierarchical_autoencoder": "AnemoiModelHierarchicalAutoEncoder"}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_trains_as_jax_trains_it_and_its_bundle_serves(tmp_path, preset):
    path = os.path.join(PACKAGED_CONFIG_DIR, f"{preset}.yaml")
    overrides = _SMALL_DATA + _SMALL_LEVELS + [LR_ONLY]
    ref, ours, trainer = train_both(
        tmp_path, lambda name: composed(path, PACKAGED_CONFIG_DIR, overrides, tmp_path, name))
    model = trainer.interface.model
    assert type(model).__name__ == PRESETS[preset]
    assert model.hidden_names == ["hidden_1", "hidden_2"]
    assert_records_equal(ref, ours)
    if preset != "hierarchical":
        return

    # the JAX trainer's bundle, served by the port's cli predict
    bundle = str(tmp_path / "jax" / "inference")
    out = tmp_path / "port.npz"
    assert cli.main(["predict", bundle, "--steps", "2", "--platform", "cpu",
                     "--output", str(out)]) == 0
    forecast = np.load(out)["data|forecast"]
    iface = load_inference_checkpoint(bundle, device="cpu")
    dataset = open_dataset(dict(iface.config["data"]["datasets"]["data"]))
    window = torch.from_numpy(dataset.get_window(0, iface.model.n_step_input + 2)[None])
    in_process = make_forecast_fn(iface, steps=2)({"data": window})["data"].numpy()
    assert forecast.shape == (1, 2, 1, dataset.num_grid_points, in_process.shape[-1])
    np.testing.assert_array_equal(forecast, in_process)
    jax_run_forecast_cli(argparse.Namespace(
        checkpoint=bundle, config=None, steps=2, start_index=0, seed=0, aot_cache=None,
        output=str(tmp_path / "jax.npz"), platform=None))
    want = np.load(tmp_path / "jax.npz")["data|forecast"]
    np.testing.assert_allclose(forecast, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
