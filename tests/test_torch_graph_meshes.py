"""The hex, HEALPix and ICON processor meshes in the port against the JAX
package: the full-size graphs that ``chip_smoke.py`` phases 28-30 train on,
a tiny GraphTransformer on each mesh, and the graphs CLI.

- Full size (o96 -> ``HexNodes`` r5 with ``MultiScaleEdges`` x_hops 2; the
  same recipe with ``HEALPixNodes`` r5 and ``HEALPixMultiScaleEdges``; an r6
  synthetic ICON grid at ``max_level`` 5): coordinates equal, attributes
  within 1e-6, edge sets equal per destination except at true ties, within
  tie budgets measured on these graphs (the KNN-3 decoders of the hex and
  HEALPix graphs; ``tests/torch_graph_compare.py``).
- A tiny GraphTransformer (32 channels, 2 processor layers, 4 heads) on hex
  r2, HEALPix r2 and ICON r3 / level-2 graphs, seeded random JAX parameters
  moved with ``state_dict_from_jax``: a forecast step and the step-1
  gradients of the area-weighted MSE against the JAX package's (``segment``
  backend), float32, rtol 3e-5 and atol 3e-5 of each tensor's largest
  magnitude.  Both get the JAX builder's graph.
- ``anemoi-tpu-torch-graphs`` ``create``, ``describe``, ``inspect`` and
  ``export_to_sparse`` against ``anemoi-tpu-graphs``; ``plot`` and
  ``inspect --plot`` return 2.
"""

import copy
import json
import os

import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import flax
import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.cli import main as jax_graphs_main
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.inference import make_forecast_fn as jax_forecast_fn
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu_torch.flagship import (
    VARIABLES,
    flagship_config,
    flagship_indices,
    flagship_statistics,
)
from anemoi_tpu_torch.graphs.cli import main as graphs_main
from anemoi_tpu_torch.graphs.create import GraphCreator
from anemoi_tpu_torch.graphs.generate.icon import write_synthetic_icon_grid
from anemoi_tpu_torch.graphs.graph import EdgeSet, Graph, NodeSet
from anemoi_tpu_torch.inference import make_forecast_fn
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState, make_step_fns
from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config
from tests.torch_graph_compare import compare_graphs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 3e-5


def packaged_recipe(name: str) -> dict:
    return load_config(os.path.join(PACKAGED_CONFIG_DIR, "graph", f"{name}.yaml"))["recipe"]


def hex_recipe(grid: str, resolution: int) -> dict:
    recipe = copy.deepcopy(packaged_recipe("hex_mesh"))
    recipe["nodes"]["data"]["node_builder"]["grid"] = grid
    recipe["nodes"]["hidden"]["node_builder"]["resolution"] = resolution
    return recipe


def healpix_recipe(grid: str, resolution: int) -> dict:
    recipe = hex_recipe(grid, resolution)
    recipe["nodes"]["hidden"]["node_builder"] = {"name": "HEALPixNodes",
                                                 "resolution": resolution}
    recipe["edges"][1]["edge_builder"] = {"name": "HEALPixMultiScaleEdges"}
    return recipe


def icon_recipe(grid_file: str, max_level: int) -> dict:
    recipe = copy.deepcopy(packaged_recipe("icon_mesh"))

    def set_grid(node):
        if isinstance(node, dict):
            for key in node:
                if key == "grid_filename":
                    node[key] = grid_file
                elif key == "max_level":
                    node[key] = max_level
                else:
                    set_grid(node[key])
        elif isinstance(node, list):
            for value in node:
                set_grid(value)

    set_grid(recipe)
    return recipe


@pytest.fixture(scope="module")
def icon_grids(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("icon")
    out = {}
    for r in (3, 6):
        out[r] = str(tmp / f"icon_r{r}.nc")
        write_synthetic_icon_grid(out[r], r)
    return out


# --- the chip phases' graphs at full size ---------------------------------------
# label -> (recipe, node and edge counts (data, hidden, data->hidden,
# hidden->hidden, hidden->data), tied destinations measured on the decoder)
FULL_SIZE = {
    "hex_r5": (lambda g: hex_recipe("o96", 5), (40320, 20480, 41704, 245700, 120960), 48),
    "healpix_r5": (lambda g: healpix_recipe("o96", 5),
                   (40320, 12288, 48880, 130568, 120960), 58),
    "icon_r6_l5": (lambda g: icon_recipe(g[6], 5), (81920, 10242, 245760, 81900, 245760), 0),
}


@pytest.mark.parametrize("label", list(FULL_SIZE))
def test_full_size_mesh_graph_matches_jax(icon_grids, label):
    make, counts, max_ties = FULL_SIZE[label]
    recipe = make(icon_grids)
    g_port = GraphCreator(recipe).create()
    ties = compare_graphs(JaxGraphCreator(recipe).create(), g_port)
    print(f"{label}: destinations with a tie broken differently: {ties}")
    got = (g_port["data"].num_nodes, g_port["hidden"].num_nodes,
           *(g_port[k].num_edges for k in (("data", "hidden"), ("hidden", "hidden"),
                                          ("hidden", "data"))))
    assert got == counts
    assert ties[("data", "hidden")] == ties[("hidden", "hidden")] == 0
    assert ties[("hidden", "data")] == max_ties


# --- a tiny GraphTransformer on each mesh -----------------------------------------
SCALERS = {"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                    "attribute_name": "area_weight"}}
LOSS = {"name": "WeightedMSELoss", "scalers": ["area"]}
OPT = {"lr": {"rate": 1e-3, "warmup": 2, "iterations": 20},
       "gradient_clip": {"val": 32.0, "algorithm": "value"}}
TINY = {"hex_r2": lambda g: hex_recipe("o16", 2),
        "healpix_r2": lambda g: healpix_recipe("o16", 2),
        "icon_r3_l2": lambda g: icon_recipe(g[3], 2)}


def port_graph(g):
    out = Graph()
    for name, ns in g.nodes.items():
        out[name] = NodeSet(ns.coords, dict(ns.attributes))
    for key, es in g.edges.items():
        out[key] = EdgeSet(es.edge_index, dict(es.attributes), es.dst_ptr)
    return out


def model_config():
    cfg = flagship_config(num_channels=32, num_layers=2, num_heads=4, inference_precision="fp32")
    cfg["model"]["graph_attention_backend"] = "segment"
    return cfg


def grad_store():
    """An optax transformation that keeps the gradients it is given."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def assert_close(got, want, label):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=label)


@pytest.mark.parametrize("label", list(TINY))
def test_tiny_graph_transformer_matches_jax(icon_grids, label):
    graph = JaxGraphCreator(TINY[label](icon_grids)).create()
    stats = flagship_statistics(seed=1)
    indices = {"data": JaxIndexCollection({n: i for i, n in enumerate(VARIABLES)},
                                          forcing=["cos_lat", "z"], diagnostic=["tp"])}
    jax_iface = JaxInterface(config=model_config(), graph=graph, data_indices=indices,
                             statistics=stats)
    rng = np.random.default_rng(0)
    flat = flax.traverse_util.flatten_dict(jax.eval_shape(jax_iface.init_params)["params"])
    params = {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()})}
    mean, std = stats["data"]["mean"], stats["data"]["stdev"]
    batch = (mean + std * rng.normal(size=(1, 3, 1, graph["data"].num_nodes, len(VARIABLES)))
             ).astype(np.float32)

    pgraph = port_graph(graph)
    iface = AnemoiModelInterface(config=model_config(), graph=pgraph,
                                 data_indices=flagship_indices(), statistics=stats,
                                 device="cpu", training=True)
    iface.load_state_dict(state_dict_from_jax(params), strict=True)

    # forward: one forecast step
    ref = np.asarray(jax_forecast_fn(jax_iface, steps=1)(
        params, {"data": jnp.asarray(batch[:, :2])})["data"])
    with torch.no_grad():
        out = make_forecast_fn(iface, steps=1)({"data": torch.from_numpy(batch[:, :2])})["data"]
    assert out.shape == ref.shape == (1, 1, 1, graph["data"].num_nodes, 5)
    assert_close(out.numpy(), ref, f"{label} forecast")

    # step-1 gradients of the area-weighted MSE
    jax_losses = {"data": jax_get_loss_function(
        LOSS, jax_create_scalers(SCALERS, graph=graph, data_indices=indices["data"]))}
    jax_step, _ = jax_make_step_fns(jax_iface, jax_losses, rollout=1, remat_rollout=False)
    state, metrics = jax_step(JaxTrainState.create(params, grad_store()),
                              {"data": jnp.asarray(batch)})
    ref_grads = state_dict_from_jax(state.opt_state)
    losses = {"data": get_loss_function(LOSS, create_scalers(SCALERS, graph=pgraph))}
    train_step, _ = make_step_fns(iface, losses, rollout=1)
    pstate = TrainState.create(iface, build_optimizer(OPT))
    loss = train_step.compute_gradients(pstate, {"data": torch.from_numpy(batch)})
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=TOL)
    grads = {n: p.grad for n, p in iface.named_parameters()}
    assert sorted(grads) == sorted(ref_grads)
    top = max(float(np.abs(g.numpy()).max()) for g in ref_grads.values())
    for name, want in ref_grads.items():
        if name.endswith("lin_key.bias"):  # true gradient 0: both give float noise
            for g in (grads[name].numpy(), want.numpy()):
                assert np.abs(g).max() <= 1e-6 * top, name
            continue
        assert_close(grads[name].numpy(), want.numpy(), f"{label} grad {name}")


# --- the graphs CLI ---------------------------------------------------------------
RECIPE_YAML = """nodes:
  data:
    node_builder: {name: ReducedGaussianGridNodes, grid: o8}
    attributes:
      area_weight: {name: IsolatitudeAreaWeights, norm: unit-max}
  hidden:
    node_builder: {name: HEALPixNodes, resolution: 1}
edges:
  - source_name: data
    target_name: hidden
    edge_builder: {name: CutOffEdges, cutoff_factor: 0.6}
    attributes:
      edge_length: {name: EdgeLength}
  - source_name: hidden
    target_name: hidden
    edge_builder: {name: HEALPixMultiScaleEdges}
    attributes:
      edge_length: {name: EdgeLength}
      harmonics: {name: DirectionalHarmonics}
post_processors:
  - {name: SortNodesByIncomingDegree, nodes_name: hidden}
"""


def test_graphs_cli_matches_jax(tmp_path, capsys):
    recipe = tmp_path / "recipe.yaml"
    recipe.write_text(RECIPE_YAML)
    outputs = {}
    for label, main in (("jax", jax_graphs_main), ("port", graphs_main)):
        d = tmp_path / label
        d.mkdir()
        graph_file = str(d / "graph.npz")
        assert main(["create", str(recipe), graph_file]) == 0
        created = capsys.readouterr().out
        assert main(["describe", graph_file]) == 0
        described = capsys.readouterr().out
        assert main(["inspect", graph_file]) == 0
        stats = json.loads(capsys.readouterr().out)
        assert main(["export_to_sparse", graph_file, str(d / "sparse")]) == 0
        exported = capsys.readouterr().out.replace(str(d), "<dir>")
        outputs[label] = (graph_file, created.replace(str(d), "<dir>"), described, stats,
                          exported, d / "sparse")
    jax_out, port_out = outputs["jax"], outputs["port"]
    assert port_out[1:5] == jax_out[1:5]
    compare_graphs(Graph.load(jax_out[0]), Graph.load(port_out[0]))
    names = sorted(os.listdir(jax_out[5]))
    assert names == sorted(os.listdir(port_out[5])) and len(names) == 2
    for name in names:
        want = sp.load_npz(jax_out[5] / name)
        got = sp.load_npz(port_out[5] / name)
        assert (got != want).nnz == 0 and got.shape == want.shape

    # plot and inspect --plot: the same figure files, written by both
    plotted = {}
    for label, main in (("jax", jax_graphs_main), ("port", graphs_main)):
        d = tmp_path / label
        assert main(["plot", port_out[0], str(d / "plots"), "--max-edges", "500"]) == 0
        listed = capsys.readouterr().out.replace(str(d), "<dir>")
        assert main(["inspect", port_out[0], "--plot", str(d / "p.png")]) == 0
        inspected = capsys.readouterr().out.replace(str(d), "<dir>")
        files = sorted(os.listdir(d / "plots"))
        assert all(os.path.getsize(d / "plots" / f) > 0 for f in files)
        assert os.path.getsize(d / "p.png") > 0
        plotted[label] = (listed, inspected, files)
    assert plotted["port"] == plotted["jax"]
    assert len(plotted["port"][2]) == 2 + 2 + 3  # node sets, edge sets, the three summaries
