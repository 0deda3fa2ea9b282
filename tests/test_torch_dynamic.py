"""Dynamic kNN edges built on the device, in the port against the JAX package.

The same arrays, made from a numpy seed, go through both, in float32:

- ``runtime_knn`` and ``runtime_edge_attributes`` on random sphere points
  (40 sources, 90 destinations, k 3; no ties): the edge set equal to the
  JAX ``runtime_knn_tables``' (slot ``dst * k + j``) and to the host
  ``KNNEdges``; the attributes within 1e-5 of the JAX runtime ones and of
  the host ``EdgeDirection`` / ``EdgeLength``;
- the device ``SourceOrder`` (``SourceOrder.on_device``) equal to the host
  one (``SourceOrder.of``) on the runtime set and on a static set with
  edgeless sources;
- ``AnemoiModelEncProcDec`` on o8 -> ico-1 (32 channels, 1 layer, 4 heads)
  with ``DynamicKNN`` on the encoder and the decoder (trainable edge
  features on the decoder's runtime set), against the JAX dynamic model:
  the forward (1e-4) and every parameter's gradient (1e-4).  The nodes are
  moved by 1e-3 rad first: on the symmetric grids many sources tie, and
  ``torch.topk`` and ``lax.top_k`` order (and pick) tied sources
  differently (ROADMAP Queue 3);
- the dynamic model against the static one on the same edges, as
  ``tests/test_dynamic_graph.py`` (rtol 1e-3 / atol 1e-4): the runtime sets
  equal the host ``KNNEdges`` sets of the same nodes except at ties, so the
  static graph takes the runtime edge order, with its attributes from the
  host builders.  The decoder's set holds edges from the ico-1 pole vertex,
  which its data nodes see on the local frame's ``lon = +-pi`` cut: the
  port's runtime ``edge_dirs`` keep the host builders' sign there (JAX's
  runtime ones flip it, ROADMAP Queue 3);
- ``k_out``: the JAX transpose table drops the gradient of a source's
  out-edges beyond ``k_out``; the port's exact source order does not
  (ROADMAP Queue 3).  At JAX's default ``k_out`` the out-degree fits and
  both agree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.ops import dynamic as jax_dynamic
from anemoi_tpu.ops.padded import padded_gt_attention_flat
from anemoi_tpu_torch.flagship import VARIABLES, flagship_config, flagship_indices
from anemoi_tpu_torch.flagship import flagship_recipe, flagship_statistics
from anemoi_tpu_torch.graphs.edges import edge_direction, edge_length, knn_edges
from anemoi_tpu_torch.graphs.graph import EdgeSet, Graph, NodeSet
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.layers.embed import sincos_coordinates
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.ops import dynamic
from anemoi_tpu_torch.ops.gt_attention import SourceOrder, gt_attention
from test_torch_blocks import randomised
from test_torch_gnn import close
from test_torch_model import port_graph

K = 3


def random_graph(rng, ns=40, nd=90):
    g = Graph()
    for name, n in (("src", ns), ("dst", nd)):
        g[name] = NodeSet(coords=np.stack([np.arcsin(rng.uniform(-1, 1, n)),
                                           rng.uniform(-np.pi, np.pi, n)], axis=-1))
    return g


def features(g, name):
    return sincos_coordinates(g[name].coords)


def test_runtime_tables_and_attributes_match_jax_and_the_host():
    g = random_graph(np.random.default_rng(0))
    src, dst = features(g, "src"), features(g, "dst")
    edges = dynamic.runtime_knn(torch.from_numpy(src), torch.from_numpy(dst), K)
    tables = jax_dynamic.runtime_knn_tables(jnp.asarray(src), jnp.asarray(dst), K, 16)
    ei = edges.edge_index.numpy()
    np.testing.assert_array_equal(ei, np.stack([tables.edge_src, tables.edge_dst]))
    np.testing.assert_array_equal(ei, knn_edges(g, "src", "dst", K))
    np.testing.assert_array_equal(edges.dst_ptr.numpy(), np.arange(91) * K)
    attr = dynamic.runtime_edge_attributes(torch.from_numpy(src), torch.from_numpy(dst),
                                           edges.edge_index)
    ref = jax_dynamic.runtime_edge_attributes(jnp.asarray(src), jnp.asarray(dst), tables)
    np.testing.assert_allclose(attr.numpy(), ref, rtol=1e-5, atol=1e-5)
    host = np.concatenate([edge_direction(g, "src", "dst", ei), edge_length(g, "src", "dst", ei)],
                          axis=-1)
    np.testing.assert_allclose(attr.numpy(), host, rtol=1e-5, atol=1e-5)
    length = dynamic.runtime_edge_attributes(torch.from_numpy(src), torch.from_numpy(dst),
                                             edges.edge_index, ("edge_length",))
    assert tuple(length.shape) == (270, 1) and float(length.max()) == 1.0
    with pytest.raises(ValueError, match="unsupported"):
        dynamic.runtime_edge_attributes(torch.from_numpy(src), torch.from_numpy(dst),
                                        edges.edge_index, ("azimuth",))


def test_device_source_order_equals_the_host_one():
    g = random_graph(np.random.default_rng(1))
    edges = dynamic.runtime_knn(torch.from_numpy(features(g, "src")),
                                torch.from_numpy(features(g, "dst")), K)
    rng = np.random.default_rng(2)
    dst = np.repeat(np.arange(30), rng.integers(0, 5, size=30))
    static = torch.as_tensor(np.stack([rng.integers(0, 50, size=dst.size) * 2, dst]),
                             dtype=torch.int32)  # odd sources have no edge
    for ei, ns in ((edges.edge_index, 40), (static, 101)):
        dev, host = SourceOrder.on_device(ei, ns), SourceOrder.of(ei, ns)
        for a, b in zip(dev, host):
            assert a.dtype == b.dtype == torch.int32
            assert torch.equal(a, b)
    assert dynamic.check_out_degree(edges) == int(np.bincount(edges.edge_index[0]).max())


def dynamic_config(dynamic_mappers=("encoder", "decoder"), trainable=0):
    cfg = flagship_config(num_channels=32, num_layers=1, num_heads=4, inference_precision="fp32")
    model = cfg["model"]
    model["graph_attention_backend"] = "segment"
    for part in dynamic_mappers:
        model[part] = {**model[part], "edge_provider": {
            "name": "DynamicKNN", "num_nearest_neighbours": K, "max_out_degree": 64}}
    if trainable:
        model["decoder"]["trainable_size"] = trainable
    return cfg


def jax_indices():
    return {"data": JaxIndexCollection({n: i for i, n in enumerate(VARIABLES)},
                                       forcing=["cos_lat", "z"], diagnostic=["tp"])}


def jittered_graph(seed=8):
    """o8 -> ico-1 with every node moved by ~1e-3 rad (no tied neighbours)."""
    from anemoi_tpu.graphs.graph import Graph as JaxGraph

    recipe = flagship_recipe("o8", 1)
    graph = JaxGraphCreator({"nodes": recipe["nodes"]}).update_graph(JaxGraph())
    rng = np.random.default_rng(seed)
    for name in ("data", "hidden"):
        graph[name].coords = graph[name].coords + rng.normal(scale=1e-3,
                                                             size=graph[name].coords.shape)
    creator = JaxGraphCreator({"edges": recipe["edges"],
                               "post_processors": recipe.get("post_processors", [])})
    return creator.post_process(creator.update_graph(graph))


def test_dynamic_model_matches_jax():
    graph = jittered_graph()
    stats = flagship_statistics(seed=1)
    cfg = dynamic_config(trainable=2)
    iface = JaxInterface(config=cfg, graph=graph, data_indices=jax_indices(), statistics=stats)
    params = randomised(iface.init_params(), np.random.default_rng(3))
    port = AnemoiModelInterface(config=cfg, graph=port_graph(graph),
                                data_indices=flagship_indices(), statistics=stats, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    n_grid, n_hidden = graph["data"].num_nodes, graph["hidden"].num_nodes
    assert port.model.decoder_graph_provider["data"].trainable.shape == (n_grid * K, 2)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 2, 1, n_grid, 6)).astype(np.float32)
    cot = rng.normal(size=(2, 1, 1, n_grid, 5)).astype(np.float32)

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
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        if name.endswith("lin_key.bias"):  # 0 in truth (softmax is shift invariant): noise
            assert got[name].grad.abs().max() <= 1e-6 * top and g.abs().max() <= 1e-6 * top
            continue
        close(got[name].grad, g.numpy(), 1e-4)
    # the runtime encoder set: each hidden node's 3 nearest data nodes
    sub = port.model._mapper_edges("encoder", "data", "hidden", port.model_graph.encoder["data"])
    assert sub.num_edges == n_hidden * K and sub.edge_dim == 3


def runtime_static_graph(graph, sets):
    """``graph`` with each mapper's KNN-3 set replaced by the runtime set of
    the same nodes (edges in slot order, attributes from the host
    builders); the runtime sets must equal the host ``KNNEdges`` sets up to
    ties."""
    from anemoi_tpu_torch.graphs.transforms import great_circle_distance

    out = port_graph(graph)
    for src, dst in sets:
        ei = dynamic.runtime_knn(torch.from_numpy(features(out, src)),
                                 torch.from_numpy(features(out, dst)), K).edge_index.numpy()
        ei = ei.astype(np.int64)
        host = knn_edges(out, src, dst, K)
        dist = [np.sort(great_circle_distance(out[src].coords[e[0]], out[dst].coords[e[1]])
                        .reshape(-1, K), 1) for e in (ei, host)]
        np.testing.assert_allclose(dist[0], dist[1], rtol=0, atol=1e-6)  # ties only
        attrs = {"edge_length": edge_length(out, src, dst, ei),
                 "edge_dirs": edge_direction(out, src, dst, ei)}
        out[(src, dst)] = EdgeSet(ei, attrs).sort_by_dst(out[dst].num_nodes)
    return out


def test_dynamic_model_against_static():
    recipe = flagship_recipe("o8", 1)
    recipe["edges"][0]["edge_builder"] = {"name": "KNNEdges", "num_nearest_neighbours": K}
    graph = JaxGraphCreator(recipe).create()
    stats = flagship_statistics(seed=1)
    static_graph = runtime_static_graph(graph, [("data", "hidden"), ("hidden", "data")])
    torch.manual_seed(0)
    models = {}
    for kind, cfg, g in (("dynamic", dynamic_config(), port_graph(graph)),
                         ("static", dynamic_config(()), static_graph)):
        models[kind] = AnemoiModelInterface(config=cfg, graph=g, data_indices=flagship_indices(),
                                            statistics=stats, device="cpu")
    models["static"].load_state_dict(models["dynamic"].state_dict(), strict=True)
    rng = np.random.default_rng(5)
    x = {"data": torch.from_numpy(
        rng.normal(size=(1, 2, 1, graph["data"].num_nodes, 6)).astype(np.float32))}
    out = {kind: m.run_model(x)["data"] for kind, m in models.items()}
    np.testing.assert_allclose(out["dynamic"].detach().numpy(), out["static"].detach().numpy(),
                               rtol=1e-3, atol=1e-4)
    for m, o in zip(models.values(), out.values()):
        o.square().sum().backward()
    for (name, a), b in zip(models["dynamic"].named_parameters(),
                            models["static"].parameters()):
        if name.endswith("lin_key.bias"):  # 0 in truth (softmax is shift invariant): noise
            continue
        scale = float(b.grad.abs().max()) + 1e-30
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)


def test_k_out_drops_gradient_in_jax_only():
    g = random_graph(np.random.default_rng(6), ns=10, nd=90)
    src, dst = features(g, "src"), features(g, "dst")
    h, hd = 2, 16
    rng = np.random.default_rng(7)
    q = rng.normal(size=(90, hd)).astype(np.float32)
    kv = rng.normal(size=(10, hd)).astype(np.float32)
    edges = dynamic.runtime_knn(torch.from_numpy(src), torch.from_numpy(dst), K)
    k_default = 4 * K * -(-90 // 10)

    def jax_grad(k_out):
        tables = jax_dynamic.runtime_knn_tables(jnp.asarray(src), jnp.asarray(dst), K, k_out)
        assert int(jax_dynamic.check_out_degree(tables, k_out)) <= k_out
        return jax.grad(lambda kv_: jnp.sum(padded_gt_attention_flat(
            jnp.asarray(q), kv_, kv_, None, h, tables) ** 2))(jnp.asarray(kv))

    kv_t = torch.tensor(kv, requires_grad=True)
    none = torch.zeros(edges.edge_index.shape[1], hd)  # no edge features
    out, _ = gt_attention(torch.from_numpy(q), kv_t, kv_t, none, edges.edge_index,
                          edges.dst_ptr, h, source=edges.source)
    out.square().sum().backward()
    assert dynamic.check_out_degree(edges) <= k_default  # JAX's default: nothing dropped
    close(kv_t.grad, jax_grad(k_default), 1e-4)
    assert dynamic.check_out_degree(edges) > 4
    dropped = np.asarray(jax_grad(4))
    assert np.abs(dropped - kv_t.grad.numpy()).max() > 1e-2 * np.abs(dropped).max()
