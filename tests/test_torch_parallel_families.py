"""The ensemble axis, the transport task and the hierarchical V-cycle of the
port on CPU ranks (gloo), against the JAX package and the port's one
process.

Each model is held to the JAX package run single-device in this process
(``tests/test_model_parallel.py`` holds its sharded runs to the same):
losses of two steps at rtol 5e-5, atol 1e-6; every parameter's step-1
gradient within 1e-5 relative L2 of the port's one process.  The random
draws -- the ensemble's noise, the transport step's sigma and noise -- are
the same arrays in both packages: the JAX ``jax.random.normal`` and the
port's ``standard_normal`` return one seeded array per shape, the global
batch's over the whole grid (``tests/torch_parallel_worker.py:FixedDraws``;
the JAX step, jitted, draws once), which each rank cuts to its block.

- Four ranks (one spawn): ``AnemoiEnsModelEncProcDec`` (o8 -> ico-1, 16
  channels, ``NoiseConditioning`` into a conditional processor) with 4
  members of ``KernelCRPS`` on ensemble 2 x model 2 (``edges``): two steps
  against JAX's 4-member losses (JAX ``test_ensemble_parallel_crps_parity``
  runs ensemble 4 x model 2), gradients against one process, and
  ``predict_step`` of the tiled window (every member, on every rank)
  against one process.
- Two ranks (one spawn): ``AnemoiTransportModelEncProcDec`` (JAX
  ``test_transport_shard_parity``'s model) trained by the EDM step under
  ``edges`` and ``heads`` on a model group of 2 and on data 2, against
  JAX's losses and one process's gradients; after the ``edges`` run, one
  generative forecast step (4 EDM-Heun sampling steps, a generator seeded
  7, the port's own draws) against one process's.  The hierarchical
  V-cycle of JAX ``test_hierarchical_mesh_parity`` (o8 -> ico-2 -> ico-1,
  one-layer level processors) under ``edges`` on a model group of 2.
- What item 9's fifth part once refused (a GNN, the ``halo_mappers``
  switch, a row-mixing residual, ``DynamicKNN``, a processor strategy of
  its own, the V-cycle under ``heads``, a loss that is no grid sum, the
  transport task on an ensemble group) now builds its route.
"""

import copy
from contextlib import contextmanager

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu.training.transport_step import make_transport_step_fns as jax_transport_fns
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.parallel.distributed import spawn
from tests import torch_parallel_worker as worker
from tests.test_model_parallel import _recipe
from tests.test_torch_parallel_heads import assert_grads_close
from tests.test_torch_parallel_training import INDICES, OPT, SCALERS, VARIABLES
from tests.test_torch_training import port_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GT = {"num_heads": 4, "mlp_hidden_ratio": 2.0,
      "sub_graph_edge_attributes": ["edge_dirs", "edge_length"]}
CRPS = {"name": "KernelCRPS", "scalers": ["area"]}
MSE = {"name": "WeightedMSELoss", "scalers": ["area"]}
MEMBERS = 4


def model_config(kind):
    proc = {"name": "GraphTransformerProcessor", "num_layers": 2,
            "gradient_checkpointing": True, **GT}
    cfg = {"num_channels": 16, "n_step_input": 2, "n_step_output": 1,
           "graph_attention_backend": "segment", "inference_precision": "fp32",
           "encoder": {"name": "GraphTransformerForwardMapper", **GT}, "processor": proc,
           "decoder": {"name": "GraphTransformerBackwardMapper", **GT}}
    if kind == "ensemble":
        cfg.update(name="AnemoiEnsModelEncProcDec",
                   noise_injector={"name": "NoiseConditioning", "noise_std": 1.0,
                                   "noise_channels_dim": 4, "noise_mlp_hidden_dim": 8})
        proc["conditional"] = True
    elif kind == "transport":
        cfg.update(name="AnemoiTransportModelEncProcDec", noise_embed_dim=8)
        proc["conditional"] = True
    else:
        cfg.update(name="AnemoiModelEncProcDecHierarchical",
                   hidden_names=["hidden_1", "hidden_2"], level_process=True)
        proc["num_layers"] = 1
    return {"model": cfg,
            "data": {"processors": [{"name": "InputNormalizer", "default": "mean-std"}]}}


def hierarchical_recipe():
    """JAX ``test_hierarchical_mesh_parity``'s graph, with the data nodes'
    area weights."""
    attrs = {"attributes": {"edge_length": {"name": "EdgeLength"},
                            "edge_dirs": {"name": "EdgeDirection"}}}

    def edges(src, dst, builder):
        return {"source_name": src, "target_name": dst, "edge_builder": builder, **attrs}

    knn = {"name": "KNNEdges", "num_nearest_neighbours": 3}
    return {
        "nodes": {
            "data": {"node_builder": {"name": "ReducedGaussianGridNodes", "grid": "o8"},
                     "attributes": {"area_weight": {"name": "CosineLatWeightedAttribute",
                                                    "norm": "unit-max"}}},
            "hidden_1": {"node_builder": {"name": "TriNodes", "resolution": 2}},
            "hidden_2": {"node_builder": {"name": "TriNodes", "resolution": 1}},
        },
        "edges": [edges("data", "hidden_1", {"name": "CutOffEdges", "cutoff_factor": 0.9}),
                  edges("hidden_1", "hidden_1", {"name": "MultiScaleEdges", "x_hops": 1}),
                  edges("hidden_2", "hidden_2", {"name": "MultiScaleEdges", "x_hops": 1}),
                  edges("hidden_1", "hidden_2", knn), edges("hidden_2", "hidden_1", knn),
                  edges("hidden_1", "data", knn)],
    }


@contextmanager
def fixed_jax_draws(draws):
    """``jax.random.normal`` returning ``draws[shape]``."""
    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(draws[tuple(int(s) for s in shape)], dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        yield


def build(kind, batch_rows, seed):
    """(setup, JAX's two losses, the port's one process) of one model."""
    graph = JaxGraphCreator(hierarchical_recipe() if kind == "hierarchical"
                            else _recipe()).create()
    rng = np.random.default_rng(seed)
    nv = len(VARIABLES)
    stats = {"data": {"mean": rng.normal(size=nv).astype(np.float32),
                      "stdev": (0.5 + rng.random(nv)).astype(np.float32),
                      "minimum": -np.ones(nv, np.float32), "maximum": np.ones(nv, np.float32)}}
    jidx = {"data": JaxIndexCollection(INDICES["data"]["name_to_index"], forcing=["cos_lat"])}
    config = model_config(kind)
    iface = JaxInterface(config=config, graph=graph, data_indices=jidx, statistics=stats)
    flat = flax.traverse_util.flatten_dict(jax.eval_shape(iface.init_params)["params"])
    params = {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()})}
    n_grid, n_hidden = graph["data"].num_nodes, graph[graph.node_names()[1]].num_nodes
    batch = (stats["data"]["mean"] + stats["data"]["stdev"]
             * rng.normal(size=(batch_rows, 3, 1, n_grid, nv))).astype(np.float32)
    loss = CRPS if kind == "ensemble" else MSE
    draws = {}
    if kind == "ensemble":
        noise = rng.normal(size=(batch_rows * MEMBERS, n_hidden, 4)).astype(np.float32)
        draws[noise.shape] = noise
        # on a mesh the port draws the same field as [B, 1, M, N, C]
        draws[(batch_rows, 1, MEMBERS, n_hidden, 4)] = noise.reshape(
            batch_rows, 1, MEMBERS, n_hidden, 4)
    elif kind == "transport":
        for shape in ((batch_rows, 1, 1, 1, 1), (batch_rows, 1, 1, n_grid, nv - 1)):
            draws[shape] = rng.normal(size=shape).astype(np.float32)
    setup = {"graph": port_graph(graph), "config": config, "indices": INDICES,
             "statistics": stats, "state_dict": {k: v.numpy() for k, v in
                                                 state_dict_from_jax(params).items()},
             "batch": batch, "loss": loss, "scalers": SCALERS, "optimizer": OPT}
    losses = {"data": jax_get_loss_function(loss, jax_create_scalers(
        SCALERS, graph=graph, data_indices=iface.data_indices["data"]))}
    with fixed_jax_draws(draws):
        if kind == "transport":
            train_step, _ = jax_transport_fns(iface, losses, objective="edm",
                                              base_rng=jax.random.PRNGKey(11))
        else:
            train_step, _ = jax_make_step_fns(iface, losses, rollout=1, remat_rollout=False,
                                              ensemble_size=MEMBERS if kind == "ensemble" else 1)
        state, ref = JaxTrainState.create(params, jax_build_optimizer(OPT)), []
        for _ in range(2):
            state, metrics = train_step(state, {"data": jnp.asarray(batch)})
            ref.append(float(metrics["loss"]))
    return setup, draws, ref


def run_of(kind, draws, **kw):
    run = {"data": 1, "steps": 2, "draws": draws, **kw}
    if kind == "ensemble":
        run.update(ensemble_size=MEMBERS)
    if kind == "transport":
        run["task"] = "transport"
    return run


@pytest.fixture(scope="module")
def models():
    """Per model: its setup, fixed draws, JAX's losses and one process's run
    (the port on this process, as the ranks run it)."""
    out = {}
    for kind, rows, seed, extra in (("ensemble", 1, 11, {"predict": True}),
                                    ("transport", 2, 5, {"sample": 4}),
                                    ("hierarchical", 2, 9, {})):
        setup, draws, ref = build(kind, rows, seed)
        one = worker.train_runs(setup, [run_of(kind, draws, **extra)])[0]
        out[kind] = {"setup": setup, "draws": draws, "jax": ref, "one": one}
    return out


EDGES, HEADS = {"shard_strategy": "edges"}, {"shard_strategy": "heads"}
TWO_RANK_RUNS = {  # name -> (model, run)
    "transport_edges_model2": ("transport", {"model": EDGES, "sample": 4}),
    "transport_heads_model2": ("transport", {"model": HEADS}),
    "transport_data2": ("transport", {"data": 2}),
    "hierarchical_edges_model2": ("hierarchical", {"model": EDGES}),
}


@pytest.fixture(scope="module")
def four_ranks(models):
    m = models["ensemble"]
    run = run_of("ensemble", m["draws"], ensemble=2, model=EDGES, predict=True)
    return spawn(worker.train_runs, 4, args=(m["setup"], [run]), platform="cpu", threads=1)


@pytest.fixture(scope="module")
def two_ranks(models):
    calls = [(worker.train_runs, (models[kind]["setup"],
                                  [run_of(kind, models[kind]["draws"], **kw)]))
             for kind, kw in TWO_RANK_RUNS.values()]
    return spawn(worker.sequence, 2, args=(calls,), platform="cpu", threads=1)


def check(run, model, halo=True):
    assert run["halo"] is halo
    np.testing.assert_allclose(run["losses"], model["jax"], rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(model["one"]["losses"], model["jax"], rtol=5e-5, atol=1e-6)
    assert_grads_close(run["grads"], model["one"]["grads"])


def test_ensemble_axis_matches_jax_and_one_process(models, four_ranks):
    m = models["ensemble"]
    coords = sorted(r[0]["coords"] for r in four_ranks)
    assert coords == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]  # model 2 x ensemble 2
    for rank in four_ranks:
        check(rank[0], m)
        got, want = rank[0]["predict"]["data"], m["one"]["predict"]["data"]
        assert got.shape == want.shape and got.shape[2] == MEMBERS
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(TWO_RANK_RUNS))
def test_family_on_two_ranks_matches_jax_and_one_process(models, two_ranks, name):
    kind, kw = TWO_RANK_RUNS[name]
    for rank in two_ranks:
        check(rank[list(TWO_RANK_RUNS).index(name)][0], models[kind], halo="model" in kw)


def test_transport_sample_on_a_model_group_matches_one_process(models, two_ranks):
    want = models["transport"]["one"]["sample"]
    for rank in two_ranks:
        got = rank[0][0]["sample"]
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def tiny(update, graph=None):
    from tests.test_torch_parallel import tiny_interface

    return tiny_interface(update, graph or JaxGraphCreator(_recipe()).create())


@pytest.mark.parametrize("update,want", [
    ({"shard_strategy": "edges", "num_model_shards": 2,
      "processor": {"name": "GNNProcessor", "num_layers": 1}}, {"processor": "HaloShard"}),
    ({"shard_strategy": "heads", "num_model_shards": 2,
      "encoder": {"name": "GNNForwardMapper"}},
     {"encoder/data": "HaloShard", "processor": "HeadsShard"}),
    ({"shard_strategy": "edges", "num_model_shards": 2, "halo_mappers": False},
     {"encoder/data": "HaloShard"}),
    ({"shard_strategy": "edges", "num_model_shards": 2,
      "residual": {"name": "TruncatedConnection"}},
     {"encoder/data": "HaloShard", "residual": "TruncatedConnection"}),
    ({"shard_strategy": "edges", "num_model_shards": 2,
      "encoder": {"name": "GraphTransformerForwardMapper", "num_heads": 4,
                  "edge_provider": {"name": "DynamicKNN"}}},
     {"encoder/data": "BlockShard", "decoder/data": "HaloShard"}),
    ({"shard_strategy": "edges", "num_model_shards": 2,
      "processor": {"name": "GraphTransformerProcessor", "num_layers": 1, "num_heads": 4,
                    "shard_strategy": "heads"}},
     {"processor": "HeadsShard", "encoder/data": "HaloShard"}),
], ids=["gnn_processor", "gnn_mapper_under_heads", "no_halo_mappers", "row_mixing_residual",
        "dynamic_knn", "processor_strategy_not_the_models"])
def test_item_9_fifth_part_still_refuses(update, want):
    """Once refused naming ROADMAP item 9 (item 9's fifth part); each now
    builds its route on a model group of 2 (the runs:
    ``tests/test_torch_parallel_routes.py``)."""
    from tests.test_torch_parallel_routes import truncation_recipe

    graph = JaxGraphCreator(truncation_recipe()).create() if "residual" in update else None
    model = tiny(update, graph).model
    routes = {**worker.routes(model), "residual": type(model.residual["data"]).__name__}
    assert {k: routes[k] for k in want} == want


def test_hierarchical_under_heads_names_item_9(models):
    """Once refused naming ROADMAP item 9 (the JAX package holds no sharded
    run of the V-cycle under ``heads``): every level processor now takes a
    ``HeadsShard`` of its level's mesh, the mappers their halo."""
    from anemoi_tpu_torch.parallel.mesh import Mesh, MeshSpec

    setup = models["hierarchical"]["setup"]
    config = copy.deepcopy(setup["config"])
    config["model"].update(shard_strategy="heads", num_model_shards=2)
    iface = AnemoiModelInterface(
        config=config, graph=setup["graph"],
        data_indices={ds: IndexCollection(**kw) for ds, kw in setup["indices"].items()},
        statistics=setup["statistics"], device="cpu", training=True,
        mesh=Mesh(MeshSpec(model=2)))
    routes = worker.routes(iface.model)
    assert routes["level/hidden_1"] == routes["level/hidden_2"] == "HeadsShard"
    assert routes["down/hidden_1"] == routes["up/hidden_2"] == "HaloShard"


def test_grid_sharded_refuses_losses_that_are_no_grid_sum():
    """Once refused naming ROADMAP item 9: a loss that is no sum over grid
    rows now takes its route (the values: ``tests/test_torch_parallel_routes.py``)."""
    from anemoi_tpu_torch.training.losses import get_loss_function
    from anemoi_tpu_torch.training.losses.base import WholeGridLoss, grid_sharded

    rmse = grid_sharded(get_loss_function({"name": "WeightedRMSELoss"}), slice(0, 4), 8, None)
    assert rmse.grid_route == "reduce"
    spectral = grid_sharded(get_loss_function({"name": "LogFFT2Distance", "x_dim": 2,
                                               "y_dim": 4}), slice(0, 4), 8, None)
    assert isinstance(spectral, WholeGridLoss) and spectral.grid_route == "whole"


def test_members_must_divide_over_the_ensemble_group():
    from anemoi_tpu_torch.parallel.mesh import member_block

    assert member_block(4, 2, 1) == slice(2, 4)
    with pytest.raises(ValueError, match="does not split"):
        member_block(3, 2, 0)


def test_transport_on_an_ensemble_group_names_item_9(tmp_path):
    """Once refused naming ROADMAP item 9: the ranks of an ensemble group
    now train a transport model as replicas (the run:
    ``tests/test_torch_parallel_routes.py``); the trainer takes the config
    and asks for a mesh of two ranks, the step builds on an ensemble mesh."""
    from anemoi_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from anemoi_tpu_torch.training.losses import get_loss_function
    from anemoi_tpu_torch.training.trainer import AnemoiTrainer
    from anemoi_tpu_torch.training.transport_step import make_transport_step_fns

    config = {"task": {"name": "transport"},
              "hardware": {"platform": "cpu", "num_devices_per_ensemble": 2}}
    with pytest.raises(AssertionError, match="not divisible by model"):
        AnemoiTrainer(config, output_dir=str(tmp_path))  # one process: no mesh of 2
    setup = build("transport", 1, 5)[0]
    iface = AnemoiModelInterface(
        config=setup["config"], graph=setup["graph"],
        data_indices={ds: IndexCollection(**kw) for ds, kw in setup["indices"].items()},
        statistics=setup["statistics"], device="cpu", training=True,
        mesh=Mesh(MeshSpec(ensemble=2)))
    train_step, eval_step = make_transport_step_fns(
        iface, {"data": get_loss_function({"name": "WeightedMSELoss"})})
    assert callable(train_step.compute_gradients) and callable(eval_step)


def test_sharded_normal_cuts_the_whole_draw():
    """A rank's block (batch rows, members, grid rows) of the one-process
    draw, as the ensemble noise and the transport draws take it."""
    from anemoi_tpu_torch.models.transport.random_fields import DrawShard, sharded_normal

    whole = torch.randn((4, 1, 6, 10, 3), generator=torch.Generator().manual_seed(3))
    shard = DrawShard(1, 2, (6, 4), 1, member_index=2, member_shards=3)
    got = sharded_normal(torch.Generator().manual_seed(3), (2, 1, 2, 4, 3), shard=shard)
    torch.testing.assert_close(got, whole[2:4, :, 4:6, 6:10], rtol=0, atol=0)
