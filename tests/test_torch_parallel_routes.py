"""The rest of the port's model parallelism on CPU ranks (gloo), against the
JAX package and the port's one process: the losses and residuals that need
the whole grid, the GNN, point-wise and Transformer components, dynamic
edges, mixed processor strategies, transport on an ensemble group and the
V-cycle under ``heads``.

Each model (o8 -> ico-1 or a variant of it, 16 channels, one layer) is
trained two steps by the JAX package single-device on the same weights
(``state_dict_from_jax``) and batch, by the port in this process and by the
port on a model group of 2 ranks (one spawn, ``worker.sequence``).  Gates:
the ranks' reported losses against JAX's at rtol 5e-5, atol 1e-6 and
against one process's at rtol 1e-6 (a loss counted ``S`` times fails it);
every parameter's step-1 gradient within 1e-5 relative L2 of one process's;
the float32 2-step forecast within 1e-6 of one process's.

- ``spectral``: ``CombinedLoss`` of an RMSE and ``SpectralAMSELoss`` (O8)
  with ``SpectralOrnsteinConnection``, under ``gspmd`` with
  ``gspmd_paged_upgrade: false``;
- ``projections``: ``TruncatedConnection`` and ``MultiscaleLossWrapper``
  (o4 truncation set);
- ``gnn``: the GNN mappers and processor (trainable processor edges);
- ``point_wise``: GraphTransformer mappers and the point-wise processor
  under ``none`` (GSPMD in JAX) with ``halo_mappers: false``;
  ``point_wise_mappers``: the point-wise mappers on a mesh of the grid's
  size, whose data and hidden rows the rank's blocks share;
- ``transformer``: the Transformer mappers and the Transformer processor
  (band halo, window 4 over 42 rows, rotary embeddings and ALiBi);
- ``dynamic``: ``DynamicKNN`` on both GraphTransformer mappers (jittered
  nodes: no tied neighbours), the processor under ``heads`` in a model
  under ``edges``;
- ``hierarchical_heads``: the V-cycle (o8 -> ico-2 -> ico-1) under
  ``heads`` with a GNN up mapper;
- ``transport_ensemble``: the EDM transport step on an ensemble group of
  2: the replicas' parameters bit-equal after two steps, the gradient one
  process's.

Besides: each loss route against the whole grid's loss and gradient, and
the band halo's attention at windows within, beyond and over a block.
"""

import copy

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
from anemoi_tpu.training.losses.multiscale import MultiscaleLossWrapper as JaxMultiscale
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu.training.transport_step import make_transport_step_fns as jax_transport_fns
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.parallel.distributed import spawn
from tests import torch_parallel_worker as worker
from tests.test_model_parallel import _recipe
from tests.test_torch_parallel_families import fixed_jax_draws, hierarchical_recipe
from tests.test_torch_parallel_heads import assert_grads_close
from tests.test_torch_parallel_training import INDICES, OPT, SCALERS, VARIABLES
from tests.test_torch_training import port_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATTRS = ["edge_dirs", "edge_length"]
GT = {"num_heads": 4, "mlp_hidden_ratio": 2.0, "sub_graph_edge_attributes": ATTRS}
GNN = {"mlp_extra_layers": 0, "sub_graph_edge_attributes": ATTRS}
MSE = {"name": "WeightedMSELoss", "scalers": ["area"]}
SHT = {"transform": "octahedral_sht", "gaussian_n": 8, "scalers": []}
DYNAMIC = {"name": "DynamicKNN", "num_nearest_neighbours": 3, "max_out_degree": 64}


def gt(name, **kw):
    return {"name": name, **GT, **kw}


def model(encoder, processor, decoder, **extra):
    return {"name": "AnemoiModelEncProcDec", "num_channels": 16, "n_step_input": 2,
            "n_step_output": 1, "graph_attention_backend": "segment",
            "inference_precision": "fp32", "encoder": encoder, "processor": processor,
            "decoder": decoder, **extra}


GT_MAPPERS = (gt("GraphTransformerForwardMapper"), gt("GraphTransformerBackwardMapper"))


def gt_model(processor, **extra):
    return model(GT_MAPPERS[0], processor, GT_MAPPERS[1], **extra)


GT_PROC = gt("GraphTransformerProcessor", num_layers=1)


def truncation_recipe():
    recipe = _recipe()
    recipe["nodes"]["truncation"] = {
        "node_builder": {"name": "ReducedGaussianGridNodes", "grid": "o4"}}
    recipe["edges"] += [{"source_name": s, "target_name": t,
                         "edge_builder": {"name": "KNNEdges", "num_nearest_neighbours": 3},
                         "attributes": {"gauss_weight": {"name": "GaussianDistanceWeights",
                                                         "sigma": 0.5, "norm": "l1"}}}
                        for s, t in (("data", "truncation"), ("truncation", "data"))]
    return recipe


def grid_mesh_recipe():
    """o8 data and an o8 mesh (the point-wise mappers' equal node sets)."""
    recipe = _recipe()
    recipe["nodes"]["hidden"] = {"node_builder": {"name": "ReducedGaussianGridNodes",
                                                  "grid": "o8"}}
    knn = {"name": "KNNEdges", "num_nearest_neighbours": 1}
    recipe["edges"] = [{**e, "edge_builder": knn} for e in recipe["edges"]
                       if e["source_name"] != e["target_name"]]
    return recipe


def jittered(recipe, seed=8):
    """The graph of ``recipe`` with every node moved by ~1e-3 rad: no tied
    neighbours for the runtime kNN (``torch.topk`` and ``lax.top_k`` order
    ties differently, ROADMAP Queue 3)."""
    from anemoi_tpu.graphs.graph import Graph as JaxGraph

    graph = JaxGraphCreator({"nodes": recipe["nodes"]}).update_graph(JaxGraph())
    rng = np.random.default_rng(seed)
    for name in graph.node_names():
        graph[name].coords = graph[name].coords + rng.normal(scale=1e-3,
                                                             size=graph[name].coords.shape)
    creator = JaxGraphCreator({"edges": recipe["edges"]})
    return creator.post_process(creator.update_graph(graph))


EDGES, HEADS = {"shard_strategy": "edges"}, {"shard_strategy": "heads"}
# name -> (model config, graph, loss, the run on the model group of 2, the
# routes it must take)
CASES = {
    "spectral": (
        gt_model(GT_PROC, residual={"name": "SpectralOrnsteinConnection", "gaussian_n": 8,
                                    "grid_kind": "octahedral", "theta_init": 0.3}),
        _recipe,
        {"name": "CombinedLoss", "loss_weights": [1.0, 0.5],
         "losses": [{"name": "WeightedRMSELoss", "scalers": ["area"]},
                    {"name": "SpectralAMSELoss", **SHT}]},
        {"model": {"shard_strategy": "gspmd", "gspmd_paged_upgrade": False}},
        {"processor": "HaloShard", "encoder/data": "HaloShard"}),
    "projections": (
        gt_model(GT_PROC, residual={"name": "TruncatedConnection"}), truncation_recipe,
        {"name": "MultiscaleLossWrapper", "native_weight": 1.0, "loss": MSE,
         "scales": [{"nodes": "truncation", "weight": 0.5}]},
        {"model": EDGES}, {"processor": "HaloShard"}),
    "gnn": (
        model({"name": "GNNForwardMapper", **GNN},
              {"name": "GNNProcessor", "num_layers": 1, "trainable_size": 2, **GNN},
              {"name": "GNNBackwardMapper", **GNN}),
        _recipe, MSE, {"model": EDGES},
        {"encoder/data": "HaloShard", "processor": "HaloShard", "decoder/data": "HaloShard"}),
    "point_wise": (
        gt_model({"name": "PointWiseMLPProcessor", "num_layers": 1}, halo_mappers=False),
        _recipe, MSE, {"model": {"shard_strategy": "none"}},
        {"encoder/data": "HaloShard", "processor": "BlockShard"}),
    "point_wise_mappers": (
        model({"name": "PointWiseForwardMapper"}, {"name": "PointWiseMLPProcessor",
                                                   "num_layers": 1},
              {"name": "PointWiseBackwardMapper"}),
        grid_mesh_recipe, MSE, {"model": {"shard_strategy": "gspmd"}},
        {"encoder/data": "BlockShard", "processor": "BlockShard", "decoder/data": "BlockShard"}),
    "transformer": (
        model({"name": "TransformerForwardMapper", "num_heads": 4},
              {"name": "TransformerProcessor", "num_layers": 1, "num_heads": 4, "window_size": 4,
               "use_rotary_embeddings": True, "use_alibi_slopes": True},
              {"name": "TransformerBackwardMapper", "num_heads": 4}),
        _recipe, MSE, {"model": EDGES},
        {"encoder/data": "BlockShard", "processor": "BandShard", "decoder/data": "BlockShard"}),
    "dynamic": (
        model({**GT_MAPPERS[0], "edge_provider": DYNAMIC}, {**GT_PROC, "shard_strategy": "heads"},
              {**GT_MAPPERS[1], "edge_provider": DYNAMIC, "trainable_size": 2}),
        lambda: jittered(_recipe()), MSE, {"model": EDGES},
        {"encoder/data": "BlockShard", "processor": "HeadsShard", "decoder/data": "BlockShard"}),
    "hierarchical_heads": (
        {**gt_model(GT_PROC), "name": "AnemoiModelEncProcDecHierarchical",
         "hidden_names": ["hidden_1", "hidden_2"], "level_process": True,
         "up_mapper": {"name": "GNNBackwardMapper", **GNN}},
        hierarchical_recipe, MSE, {"model": HEADS},
        {"level/hidden_1": "HeadsShard", "up/hidden_2": "HaloShard",
         "down/hidden_1": "HaloShard"}),
    "transport_ensemble": (
        {**gt_model({**GT_PROC, "conditional": True}), "name": "AnemoiTransportModelEncProcDec",
         "noise_embed_dim": 8},
        _recipe, MSE, {"ensemble": 2, "task": "transport", "params": True}, {}),
}
NV = len(VARIABLES)


def build(name, seed=5):
    """(setup, fixed draws, JAX's two losses) of one case."""
    model_cfg, recipe, loss, _, _ = CASES[name]
    made = recipe()
    graph = made if not isinstance(made, dict) else JaxGraphCreator(made).create()
    rng = np.random.default_rng(seed)
    stats = {"data": {"mean": rng.normal(size=NV).astype(np.float32),
                      "stdev": (0.5 + rng.random(NV)).astype(np.float32),
                      "minimum": -np.ones(NV, np.float32), "maximum": np.ones(NV, np.float32)}}
    jidx = {"data": JaxIndexCollection(INDICES["data"]["name_to_index"], forcing=["cos_lat"])}
    config = {"model": copy.deepcopy(model_cfg),
              "data": {"processors": [{"name": "InputNormalizer", "default": "mean-std"}]}}
    iface = JaxInterface(config=config, graph=graph, data_indices=jidx, statistics=stats)
    flat = flax.traverse_util.flatten_dict(jax.eval_shape(iface.init_params)["params"])
    params = {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()})}
    n_grid = graph["data"].num_nodes
    rows = 1 if name == "transport_ensemble" else 2
    batch = (stats["data"]["mean"] + stats["data"]["stdev"]
             * rng.normal(size=(rows, 3, 1, n_grid, NV))).astype(np.float32)
    window = (stats["data"]["mean"] + stats["data"]["stdev"]
              * rng.normal(size=(1, 4, 1, n_grid, NV))).astype(np.float32)
    draws = {}
    if name == "transport_ensemble":
        for shape in ((rows, 1, 1, 1, 1), (rows, 1, 1, n_grid, NV - 1)):
            draws[shape] = rng.normal(size=shape).astype(np.float32)
    setup = {"graph": port_graph(graph), "config": config, "indices": INDICES,
             "statistics": stats, "state_dict": {k: v.numpy() for k, v in
                                                 state_dict_from_jax(params).items()},
             "batch": batch, "window": window, "loss": loss, "scalers": SCALERS,
             "optimizer": OPT}
    losses = {"data": jax_get_loss_function(loss, jax_create_scalers(
        SCALERS, graph=graph, data_indices=iface.data_indices["data"]), graph=graph)}
    with fixed_jax_draws(draws), pytest.MonkeyPatch.context() as mp:
        # the JAX step passes mask= that its multiscale wrapper does not take
        # (ROADMAP Queue 3); without an imputer the mask is None
        call = JaxMultiscale.__call__
        mp.setattr(JaxMultiscale, "__call__",
                   lambda self, pred, target, mask=None, **kw: call(self, pred, target, **kw))
        if name == "transport_ensemble":
            train_step, _ = jax_transport_fns(iface, losses, objective="edm",
                                              base_rng=jax.random.PRNGKey(11))
        else:
            train_step, _ = jax_make_step_fns(iface, losses, rollout=1, remat_rollout=False)
        state, ref = JaxTrainState.create(params, jax_build_optimizer(OPT)), []
        for _ in range(2):
            state, metrics = train_step(state, {"data": jnp.asarray(batch)})
            ref.append(float(metrics["loss"]))
    return setup, draws, ref


def run_of(name, draws, model_group=False):
    run = {"data": 1, "steps": 2, "draws": draws}
    if CASES[name][3].get("task") != "transport":
        run["forecast"] = 2
    if model_group:
        run.update(copy.deepcopy(CASES[name][3]), routes=True)
    elif CASES[name][3].get("task"):
        run.update(task=CASES[name][3]["task"], params=True)
    return run


@pytest.fixture(scope="module")
def cases():
    """Per case: its setup, draws, JAX's losses and one process's run."""
    out = {}
    for name in CASES:
        setup, draws, ref = build(name)
        one = worker.train_runs(setup, [run_of(name, draws)])[0]
        out[name] = {"setup": setup, "draws": draws, "jax": ref, "one": one}
    return out


# --- losses and the band halo alone ----------------------------------------
LOSS_CASES = {
    "rmse": {"name": "WeightedRMSELoss", "scalers": ["area"]},
    "mse": MSE,
    "spectral_amse": {"name": "SpectralAMSELoss", **SHT},
    "power_spectrum": {"name": "PowerSpectrumLoss", **SHT},
    "log_spectral_distance": {"name": "LogSpectralDistance", **SHT},
    "spectral_crps": {"name": "SpectralCRPSLoss", **SHT},
    "spherical_spectral": {"name": "SphericalSpectralLoss", "gaussian_n": 8, "scalers": [],
                           "grid_kind": "octahedral"},
    "multiscale_rmse": {"name": "MultiscaleLossWrapper", "native_weight": 1.0,
                        "loss": {"name": "WeightedRMSELoss", "scalers": ["area"]},
                        "scales": [{"nodes": "truncation", "weight": 0.5}]},
    "variable_mapper_rmse": {"name": "LossVariableMapper", "predicted_variables": ["q", "t"],
                             "loss": {"name": "WeightedRMSELoss", "scalers": ["area"]}},
    "time_aggregate_spectral": {"name": "TimeAggregateLossWrapper",
                                "time_aggregation_types": ["diff", "mean"],
                                "loss": {"name": "SpectralAMSELoss", **SHT}},
    "combined": {"name": "CombinedLoss", "losses": [MSE, {"name": "WeightedRMSELoss"}],
                 "loss_weights": [1.0, 2.0]},
}
LOSS_ROUTES = {"rmse": "reduce", "mse": "WeightedMSELoss", "spectral_amse": "whole",
               "power_spectrum": "whole", "log_spectral_distance": "whole",
               "spectral_crps": "whole", "spherical_spectral": "whole",
               "multiscale_rmse": "whole", "variable_mapper_rmse": "LossVariableMapper",
               "time_aggregate_spectral": "TimeAggregateLossWrapper", "combined": "CombinedLoss"}


def loss_inputs():
    """The loss cases' inputs on the o8 grid with its o4 truncation set."""
    from anemoi_tpu_torch.training.losses.scalers import create_scalers

    graph = port_graph(JaxGraphCreator(truncation_recipe()).create())
    n = graph["data"].num_nodes
    rng = np.random.default_rng(3)
    indices = IndexCollection(**INDICES["data"])
    scalers = create_scalers(SCALERS, graph=graph)
    out = []
    for name, cfg in LOSS_CASES.items():
        members = 4 if name == "spectral_crps" else 1
        pred = rng.normal(size=(2, 2, members, n, NV - 1)).astype(np.float32)
        target = rng.normal(size=(2, 2, 1, n, NV - 1)).astype(np.float32)
        target[0, 0, 0, :5, 1] = np.nan
        out.append({"name": name, "loss": cfg, "scalers": scalers, "pred": pred,
                    "target": target, "graph": graph, "indices": indices})
    return out


def band_inputs():
    rng = np.random.default_rng(4)
    cases = []
    for n, window, impl, softcap, alibi, rotary in (
            (42, 4, "xla", None, True, True),  # the band, within a block of 24
            (42, 30, "pallas", 20.0, False, True),  # beyond the block: both ends
            (42, 25, "xla", None, True, False),  # 2 w + 1 >= N: full attention
            (42, None, "xla", None, False, True)):  # no window: full
        q, k, v, cot = (rng.normal(size=(2, n, 4, 8)).astype(np.float32) for _ in range(4))
        cases.append({"q": q, "k": k, "v": v, "cotangent": cot, "window": window, "impl": impl,
                      "softcap": softcap, "alibi": alibi, "rotary": rotary})
    return cases


@pytest.fixture(scope="module")
def ranks(cases):
    """One spawn of 2 ranks: every case's run on the model group of 2, the
    loss routes and the band halo's attention."""
    calls = [(worker.train_runs, (cases[name]["setup"],
                                  [run_of(name, cases[name]["draws"], model_group=True)]))
             for name in CASES]
    loss_cases = loss_inputs()
    calls += [(worker.loss_shards, (loss_cases,)), (worker.band_attention_cases, (band_inputs(),))]
    out = spawn(worker.sequence, 2, args=(calls,), platform="cpu", threads=1)
    return {"runs": [[r[i][0] for r in out] for i in range(len(CASES))],
            "losses": [r[len(CASES)] for r in out], "loss_cases": loss_cases,
            "band": [r[len(CASES) + 1] for r in out]}


@pytest.mark.parametrize("name", list(CASES))
def test_route_matches_jax_and_one_process(cases, ranks, name):
    case, runs = cases[name], ranks["runs"][list(CASES).index(name)]
    np.testing.assert_allclose(case["one"]["losses"], case["jax"], rtol=5e-5, atol=1e-6)
    for run in runs:
        np.testing.assert_allclose(run["losses"], case["jax"], rtol=5e-5, atol=1e-6)
        # the reported loss is one process's (a loss counted S times is not)
        np.testing.assert_allclose(run["losses"], case["one"]["losses"], rtol=1e-6, atol=1e-7)
        assert_grads_close(run["grads"], case["one"]["grads"])
        if "forecast" in run:
            got, want = run["forecast"], case["one"]["forecast"]
            assert got.shape == want.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for component, kind in CASES[name][4].items():
            assert run["routes"][component] == kind, (component, run["routes"])


def test_transport_replicas_stay_equal_on_an_ensemble_group(cases, ranks):
    """A transport model has no members: the ranks of an ensemble group are
    replicas, their parameters bit-equal after two steps, their gradient one
    process's (not E times it, which summing over the group would give)."""
    runs = ranks["runs"][list(CASES).index("transport_ensemble")]
    assert [r["coords"] for r in runs] == [(0, 0, 0), (0, 0, 1)]
    assert runs[0]["halo"] is False
    for name, value in runs[0]["params"].items():
        assert np.array_equal(value, runs[1]["params"][name]), name
    one = cases["transport_ensemble"]["one"]
    for name, value in one["params"].items():
        np.testing.assert_allclose(runs[0]["params"][name], value, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("index", range(len(LOSS_CASES)), ids=list(LOSS_CASES))
def test_loss_routes_sum_to_the_whole_grid(ranks, index):
    """Each loss on a rank's grid rows: the model group's values add up to
    the whole grid's loss, and each rank's gradient is its rows' share of
    the whole grid's gradient."""
    from anemoi_tpu_torch.training.losses import get_loss_function

    case = ranks["loss_cases"][index]
    loss = get_loss_function(case["loss"], case["scalers"], graph=case["graph"],
                             data_indices=case["indices"])
    pred = torch.tensor(case["pred"], requires_grad=True)
    want = loss(pred, torch.as_tensor(case["target"]))
    want.backward()
    for rank in ranks["losses"]:
        got = rank[index]
        assert got["route"] == LOSS_ROUTES[case["name"]]
        np.testing.assert_allclose(got["total"], float(want), rtol=1e-5)
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["grad"], pred.grad[:, :, :, lo:hi].numpy(), rtol=1e-4,
                                   atol=1e-7)
    total = sum(rank[index]["value"] for rank in ranks["losses"])
    np.testing.assert_allclose(total, float(want), rtol=1e-5)


@pytest.mark.parametrize("index", range(4), ids=["band", "beyond_block", "full", "no_window"])
def test_band_halo_matches_one_process(ranks, index):
    """The band halo's attention on each rank's rows: the one-process
    attention's rows and gradients (the rule full or band on N)."""
    from anemoi_tpu_torch.models.layers.attention import (
        apply_rotary_embeddings,
        get_alibi_slopes,
        self_attention,
    )

    case = band_inputs()[index]
    leaves = [torch.tensor(case[k], requires_grad=True) for k in ("q", "k", "v")]
    q, k, v = leaves
    if case["rotary"]:
        q, k = apply_rotary_embeddings(q, k)
    slopes = get_alibi_slopes(q.shape[2]) if case["alibi"] else None
    want = self_attention(q, k, v, case["window"], case["softcap"], slopes, case["impl"],
                          plain=True)
    (want * torch.as_tensor(case["cotangent"])).sum().backward()
    for rank in ranks["band"]:
        got = rank[index]
        lo, hi = got["rows"]
        assert got["full"] == (index >= 2)
        np.testing.assert_allclose(got["out"], want[:, lo:hi].detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        for name, leaf in zip("qkv", leaves):
            np.testing.assert_allclose(got[f"d{name}"], leaf.grad[:, lo:hi].numpy(), rtol=1e-5,
                                       atol=1e-6)
    if index == 1:  # a window wider than the block fetches the whole peer block
        assert [r[index]["ext"] for r in ranks["band"]] == [(0, 42), (0, 42)]
