"""The GNN and point-wise families of the port against the JAX package.

Each module test initialises the flax module, replaces every parameter with
seeded random numbers, moves them into the port with ``state_dict_from_jax``
(strict load), runs both on the same numpy inputs and compares in float32
at rtol/atol 3e-5: the forward, and the gradients of a random linear
function of the outputs with respect to every parameter and input
(``jax.grad`` against autograd).  The JAX blocks run their ``segment``
backend; the port's sums are float32 ``index_add_`` on the CPU.

- ``GraphConv`` in its decomposed branch (``mlp``: the first layer split
  into dst, src and edge parts) and its concatenating branch (a gated
  MLP); the processor block on its first layer (raw edges embedded) and
  after; the mapper block with and without ``update_src_nodes``;
- both GNN mappers, ``GNNProcessor`` at 3 layers (layer 0 and a scanned
  stack of 2) with trainable edge features, and its remat variants equal
  to no remat bit for bit;
- the point-wise block (with and without its output Linear), processor and
  both mappers;
- whole models on o8 -> ico-1 at 32 channels: the GNN
  ``AnemoiModelEncProcDec`` (``state_dict_from_jax`` equal to the JAX
  package's anemoi-core export) and a GT-mapper + point-wise model on a
  graph with no processor edges, whose ``build_model_graph`` equals the JAX
  package's.
"""

import logging

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.models.graph import build_model_graph as jax_build_model_graph
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.models.layers import graph_blocks as jax_blocks
from anemoi_tpu.models.layers import mapper as jax_mapper
from anemoi_tpu.models.layers import processor as jax_processor
from anemoi_tpu.models.port import flax_to_reference
from anemoi_tpu_torch.flagship import VARIABLES, flagship_config, flagship_indices
from anemoi_tpu_torch.flagship import flagship_recipe, flagship_statistics
from anemoi_tpu_torch.models.graph import build_model_graph
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.layers.graph_blocks import (
    GraphConv,
    GraphConvMapperBlock,
    GraphConvProcessorBlock,
    PointWiseMLPBlock,
)
from anemoi_tpu_torch.models.layers.mapper import (
    GNNBackwardMapper,
    GNNForwardMapper,
    PointWiseBackwardMapper,
    PointWiseForwardMapper,
    TrainableEdgeFeatures,
)
from anemoi_tpu_torch.models.layers.processor import GNNProcessor, PointWiseMLPProcessor
from anemoi_tpu_torch.models.port import state_dict_from_jax
from test_torch_blocks import random_graph, randomised
from test_torch_model import port_graph

TOL = 3e-5
KEY = jax.random.PRNGKey(0)


def port_state(params, name=None, prefix="model."):
    """``state_dict_from_jax`` of ``params`` (under the flax module ``name``
    when given), the port's ``prefix`` stripped."""
    tree = {name: params["params"]} if name else params["params"]
    return {k[len(prefix):]: v for k, v in state_dict_from_jax(tree).items()
            if k.startswith(prefix)}


def close(ours, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours.detach().float().numpy(), ref, rtol=tol, atol=tol * scale)


def leaves(out):
    """The tensors of a nested tuple, in order."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in leaves(o)]
    return [out]


def check_module(jax_mod, port_mod, inputs, port_call, rng, name=None, prefix="model.",
                 args=lambda *a: a):
    """Forward and gradients of ``jax_mod`` applied to ``args(*inputs)``
    against ``port_call(port_mod, *inputs)``: the outputs (flattened), and
    the gradients of ``sum(out_i * cot_i)`` with respect to the parameters
    and the float inputs."""
    jin = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in inputs]
    params = randomised(jax_mod.init(KEY, *args(*jin)), rng)
    port_mod.load_state_dict(port_state(params, name, prefix), strict=True)

    def call(p, *xs):
        return jax.tree_util.tree_leaves(jax_mod.apply(p, *args(*xs)))

    ref = call(params, *jin)
    cots = [rng.normal(size=r.shape).astype(np.float32) for r in ref]
    floats = [i for i, a in enumerate(inputs) if isinstance(a, np.ndarray)]

    def loss(p, *xs):
        full = list(jin)
        for i, x in zip(floats, xs):
            full[i] = x
        return sum(jnp.sum(o * c) for o, c in zip(call(p, *full), cots))

    ref_grads = jax.jit(jax.grad(loss, argnums=tuple(range(1 + len(floats)))))(
        params, *[jin[i] for i in floats])
    tin = [torch.tensor(a, requires_grad=True) if isinstance(a, np.ndarray) else a
           for a in inputs]
    outs = leaves(port_call(port_mod, *tin))
    assert len(outs) == len(ref)
    for o, r in zip(outs, ref):
        assert tuple(o.shape) == r.shape
        close(o, r)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    grads = port_state(ref_grads[0], name, prefix)
    got = dict(port_mod.named_parameters())
    assert sorted(grads) == sorted(got)
    for key, want in grads.items():
        close(got[key].grad, want.numpy(), 1e-4)
    for i, g in zip(floats, ref_grads[1:]):
        close(tin[i].grad, g, 1e-4)


def edges_and_nodes(rng, n_src, n_dst, c, f=3, batch=2):
    jax_edges, sub = random_graph(rng, n_src, n_dst, f)
    xs = rng.normal(size=(batch, n_src, c)).astype(np.float32)
    xd = rng.normal(size=(batch, n_dst, c)).astype(np.float32)
    return jax_edges, sub, xs, xd


@pytest.mark.parametrize("implementation", ["mlp", "swiglu"], ids=["decomposed", "gated"])
def test_graph_conv(implementation):
    rng = np.random.default_rng(0)
    c = 16
    jax_edges, sub, xs, xd = edges_and_nodes(rng, 23, 17, c)
    e = rng.normal(size=(2, sub.num_edges, c)).astype(np.float32)
    mod = jax_blocks.GraphConv(out_channels=c, mlp_extra_layers=1,
                               mlp_implementation=implementation, backend="segment")
    port = GraphConv(c, c, c, c, mlp_extra_layers=1, mlp_implementation=implementation)
    assert port.decomposed == (implementation == "mlp")
    check_module(mod, port, [xs, xd, e, jax_edges], lambda m, s, d, e_, _: m(s, d, e_, sub),
                 rng)


@pytest.mark.parametrize("first", [True, False], ids=["first_layer", "later_layer"])
def test_processor_block(first):
    rng = np.random.default_rng(1)
    c = 16
    jax_edges, sub, x, _ = edges_and_nodes(rng, 19, 19, c)
    e = (np.asarray(jax_edges.edge_attr) if first
         else rng.normal(size=(2, sub.num_edges, c)).astype(np.float32))
    mod = jax_blocks.GraphConvProcessorBlock(
        out_channels=c, mlp_hidden_ratio=2.0, edge_dim=3 if first else None, backend="segment")
    port = GraphConvProcessorBlock(c, mlp_hidden_ratio=2.0, edge_dim=3 if first else None)
    check_module(mod, port, [x, e, jax_edges], lambda m, x_, e_, _: m(x_, e_, sub), rng)


@pytest.mark.parametrize("update_src", [True, False], ids=["update_src", "dst_only"])
def test_mapper_block(update_src):
    rng = np.random.default_rng(2)
    c = 16
    jax_edges, sub, xs, xd = edges_and_nodes(rng, 29, 13, c)
    e = rng.normal(size=(2, sub.num_edges, c)).astype(np.float32)
    mod = jax_blocks.GraphConvMapperBlock(out_channels=c, update_src_nodes=update_src,
                                          backend="segment")
    port = GraphConvMapperBlock(c, update_src_nodes=update_src)
    check_module(mod, port, [xs, xd, e, jax_edges], lambda m, s, d, e_, _: m((s, d), e_, sub),
                 rng, args=lambda s, d, e_, edges: ((s, d), e_, edges))


def test_gnn_forward_mapper():
    rng = np.random.default_rng(3)
    c = 16
    jax_edges, sub, _, _ = edges_and_nodes(rng, 31, 11, c)
    xs = rng.normal(size=(2, 31, 7)).astype(np.float32)
    xd = rng.normal(size=(2, 11, 5)).astype(np.float32)
    mod = jax_mapper.GNNForwardMapper(hidden_dim=c, backend="segment")
    port = GNNForwardMapper(7, 5, c, edge_dim=3)
    check_module(mod, port, [xs, xd, jax_edges], lambda m, s, d, _: m((s, d), sub, sub.edge_attr),
                 rng, name="GNNForwardMapper_0", prefix="model.encoder.data.",
                 args=lambda s, d, edges: ((s, d), edges))


def test_gnn_backward_mapper():
    rng = np.random.default_rng(4)
    c = 16
    jax_edges, sub, xs, xd = edges_and_nodes(rng, 11, 31, c)
    mod = jax_mapper.GNNBackwardMapper(hidden_dim=c, out_channels_dst=6, mlp_extra_layers=1,
                                       backend="segment")
    port = GNNBackwardMapper(c, c, 6, edge_dim=3, mlp_extra_layers=1)
    check_module(mod, port, [xs, xd, jax_edges], lambda m, s, d, _: m((s, d), sub, sub.edge_attr),
                 rng, name="GNNBackwardMapper_0", prefix="model.decoder.data.",
                 args=lambda s, d, edges: ((s, d), edges))


class GNNWithTrainableEdges(torch.nn.Module):
    """The port's GNN processor behind its graph provider's trainable edges."""

    def __init__(self, num_edges, **kw):
        super().__init__()
        self.processor_graph_provider = TrainableEdgeFeatures(num_edges, 2)
        self.processor = GNNProcessor(**kw)

    def forward(self, x, sub):
        return self.processor(x, sub, self.processor_graph_provider(sub.edge_attr))


def test_gnn_processor():
    """3 layers: the JAX package's standalone ``blocks_0`` and a scanned
    stack of 2 (``proc.1``, ``proc.2``), trainable edge features, the
    default remat on both sides."""
    rng = np.random.default_rng(5)
    c = 16
    jax_edges, sub, x, _ = edges_and_nodes(rng, 21, 21, c)
    mod = jax_processor.GNNProcessor(num_layers=3, num_channels=c, edge_trainable_size=2,
                                     backend="segment")
    port = GNNWithTrainableEdges(sub.num_edges, num_layers=3, num_channels=c, edge_dim=5)
    check_module(mod, port, [x, jax_edges], lambda m, x_, _: m(x_, sub), rng,
                 name="GNNProcessor_0")
    assert len(port.processor.proc) == 3 and port.processor.proc[0].emb_edges is not None


@pytest.mark.parametrize("policy", [None, "save_attention", "save_attention_mlp", "dots"])
def test_gnn_processor_remat_is_bitwise(policy):
    rng = np.random.default_rng(6)
    c = 16
    _, sub, x, _ = edges_and_nodes(rng, 21, 21, c)
    torch.manual_seed(0)
    plain = GNNProcessor(3, c, edge_dim=3, gradient_checkpointing=False)
    remat = GNNProcessor(3, c, edge_dim=3, gradient_checkpointing=True, remat_policy=policy)
    remat.load_state_dict(plain.state_dict())
    cot = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    grads = []
    for proc in (plain, remat):
        xt = torch.from_numpy(x).requires_grad_()
        out = proc(xt, sub, sub.edge_attr)
        (out * cot).sum().backward()
        grads.append([xt.grad] + [p.grad for p in proc.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("hidden", [32, 16], ids=["linear_out", "no_linear_out"])
def test_point_wise_block(hidden):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    mod = jax_blocks.PointWiseMLPBlock(num_channels=16, hidden_dim=hidden, activation="silu")
    port = PointWiseMLPBlock(16, hidden, activation="silu")
    check_module(mod, port, [x], lambda m, x_: m(x_), rng, name="blocks_0",
                 prefix="model.proc.0.")
    assert (port.linear_out is None) == (hidden == 16)


def test_point_wise_processor():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    mod = jax_processor.PointWiseMLPProcessor(num_layers=3, num_channels=16,
                                              mlp_hidden_ratio=2.0)
    port = PointWiseMLPProcessor(3, 16, mlp_hidden_ratio=2.0)
    check_module(mod, port, [x], lambda m, x_: m(x_), rng, name="PointWiseMLPProcessor_0",
                 prefix="model.processor.")


def test_point_wise_mappers():
    rng = np.random.default_rng(9)
    xs = rng.normal(size=(2, 9, 7)).astype(np.float32)
    xd = rng.normal(size=(2, 9, 5)).astype(np.float32)
    mod = jax_mapper.PointWiseForwardMapper(hidden_dim=16, mlp_hidden_ratio=2.0)
    port = PointWiseForwardMapper(7, 5, 16, mlp_hidden_ratio=2.0)
    check_module(mod, port, [xs, xd], lambda m, s, d: m((s, d)), rng,
                 name="PointWiseForwardMapper_0", prefix="model.encoder.data.",
                 args=lambda s, d: ((s, d),))
    latent = rng.normal(size=(2, 9, 16)).astype(np.float32)
    mod = jax_mapper.PointWiseBackwardMapper(hidden_dim=16, out_channels_dst=4)
    port = PointWiseBackwardMapper(5, 16, 4)
    check_module(mod, port, [latent, xd], lambda m, s, d: m((s, d)), rng,
                 name="PointWiseBackwardMapper_0", prefix="model.decoder.data.",
                 args=lambda s, d: ((s, d),))
    with pytest.raises(ValueError, match="matching src/dst"):
        port((torch.zeros(1, 3, 16), torch.zeros(1, 4, 5)))


# --- whole models -------------------------------------------------------

def gnn_config():
    cfg = flagship_config(num_channels=32, num_layers=3, inference_precision="fp32")
    gnn = {"mlp_extra_layers": 0, "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]}
    cfg["model"].update(
        graph_attention_backend="segment",
        encoder={"name": "GNNForwardMapper", **gnn, "trainable_size": 2},
        processor={"name": "GNNProcessor", "num_layers": 3, **gnn, "trainable_size": 2},
        decoder={"name": "GNNBackwardMapper", **gnn})
    return cfg


def point_wise_config():
    cfg = flagship_config(num_channels=32, num_layers=2, num_heads=4, inference_precision="fp32")
    cfg["model"].update(graph_attention_backend="segment",
                        processor={"name": "PointWiseMLPProcessor", "num_layers": 2,
                                   "mlp_hidden_ratio": 4.0})
    return cfg


def encoder_decoder_only(recipe):
    recipe = dict(recipe)
    recipe["edges"] = [e for e in recipe["edges"] if e["source_name"] != e["target_name"]]
    recipe["post_processors"] = []  # encoder_decoder_only.yaml sorts no nodes
    return recipe


def model_case(kind):
    recipe = flagship_recipe("o8", 1)
    if kind == "point_wise":
        recipe = encoder_decoder_only(recipe)
    graph = JaxGraphCreator(recipe).create()
    stats = flagship_statistics(seed=1)
    cfg = gnn_config() if kind == "gnn" else point_wise_config()
    indices = {"data": JaxIndexCollection({n: i for i, n in enumerate(VARIABLES)},
                                          forcing=["cos_lat", "z"], diagnostic=["tp"])}
    iface = JaxInterface(config=cfg, graph=graph, data_indices=indices, statistics=stats)
    params = randomised(iface.init_params(), np.random.default_rng(10))
    port = AnemoiModelInterface(config=cfg, graph=port_graph(graph),
                                data_indices=flagship_indices(), statistics=stats, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return graph, iface, params, port


@pytest.mark.parametrize("kind", ["gnn", "point_wise"])
def test_model_forward_and_gradient(kind):
    graph, iface, params, port = model_case(kind)
    rng = np.random.default_rng(11)
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
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        if name.endswith("lin_key.bias"):  # 0 in truth (softmax is shift invariant): noise
            assert got[name].grad.abs().max() <= 1e-6 * top and g.abs().max() <= 1e-6 * top
            continue
        close(got[name].grad, g.numpy(), 1e-4)
    if kind == "gnn":
        # anemoi-core's names, as the JAX package exports them; the port's
        # graph providers hold the trainable edge tensor itself, where the
        # export names a TrainableTensor module's (``trainable.trainable``)
        ref_sd = {k.replace(".trainable.trainable", ".trainable"): v
                  for k, v in flax_to_reference(params).items()}
        assert sorted(ref_sd) == sorted(port.state_dict())
        assert "model.processor.proc.2.conv.edge_mlp.mlp.4.weight" in ref_sd
        assert "model.processor_graph_provider.trainable" in ref_sd
    else:
        assert port.model.graph.processor.num_edges == 0
        assert "model.processor.proc.1.linear_out.weight" in port.state_dict()


def test_graph_without_processor_edges():
    graph = JaxGraphCreator(encoder_decoder_only(flagship_recipe("o8", 1))).create()
    attrs = ["edge_length", "edge_dirs"]
    for proc_attrs in (attrs, None):
        ref = jax_build_model_graph(graph, ["data"], processor_edge_attributes=proc_attrs,
                                    encoder_edge_attributes=attrs, decoder_edge_attributes=attrs)
        ours = build_model_graph(port_graph(graph), ["data"], torch.device("cpu"),
                                 processor_edge_attributes=proc_attrs,
                                 encoder_edge_attributes=attrs, decoder_edge_attributes=attrs)
        for part in ("encoder", "decoder"):
            a, b = getattr(ref, part)["data"], getattr(ours, part)["data"]
            np.testing.assert_array_equal(b.edge_index.numpy(), a.edge_index)
            np.testing.assert_array_equal(b.dst_ptr.numpy(), a.dst_ptr)
            np.testing.assert_allclose(b.edge_attr.numpy(), a.edge_attr, rtol=1e-6)
        a, b = ref.processor, ours.processor
        assert (b.num_src, b.num_dst) == (a.num_src, a.num_dst) == (42, 42)
        assert tuple(b.edge_index.shape) == a.edge_index.shape == (2, 0)
        assert tuple(b.edge_attr.shape) == a.edge_attr.shape
        np.testing.assert_array_equal(b.dst_ptr.numpy(), a.dst_ptr)
        # the source-ordered view of zero edges
        assert b.src_ptr.tolist() == [0] * 43 and b.src_perm.numel() == 0


def test_component_keys_dropped_as_jax_drops_them(caplog):
    """Keys another family left behind are dropped with a warning, also when
    the encoder is switched to a Transformer mapper (ported:
    tests/test_torch_cross_attention.py), whose JAX module has no
    ``mlp_extra_layers``."""
    cfg = gnn_config()
    cfg["model"]["processor"].update(num_heads=4, qk_norm_type="rmsnorm")
    graph = JaxGraphCreator(flagship_recipe("o8", 1)).create()
    with caplog.at_level(logging.WARNING):
        AnemoiModelInterface(config=cfg, graph=port_graph(graph),
                             data_indices=flagship_indices(),
                             statistics=flagship_statistics(seed=1), device="cpu")
    assert "['num_heads', 'qk_norm_type']" in caplog.text
    cfg["model"]["encoder"].update(name="TransformerForwardMapper", num_heads=4)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        iface = AnemoiModelInterface(config=cfg, graph=port_graph(graph),
                                     data_indices=flagship_indices(),
                                     statistics=flagship_statistics(seed=1), device="cpu")
    assert "TransformerForwardMapper: ignoring config keys ['mlp_extra_layers']" in caplog.text
    assert type(iface.model.encoder["data"]).__name__ == "TransformerForwardMapper"


def test_gnn_bf16_step_tracks_float32():
    """bf16 compute over float32 masters (the card's training type): the
    processor's raw edge attributes enter its first block in the compute
    type, and the step's loss and gradient stay near the float32 step's."""
    from anemoi_tpu_torch.training.losses import get_loss_function
    from anemoi_tpu_torch.training.optimizers import build_optimizer
    from anemoi_tpu_torch.training.step import TrainState, make_step_fns

    graph = port_graph(JaxGraphCreator(flagship_recipe("o8", 1)).create())
    stats = flagship_statistics(seed=1)
    iface = AnemoiModelInterface(config=gnn_config(), graph=graph,
                                 data_indices=flagship_indices(), statistics=stats,
                                 device="cpu", training=True)
    rng = np.random.default_rng(12)
    batch = {"data": torch.from_numpy((stats["data"]["mean"] + stats["data"]["stdev"] * rng.normal(
        size=(1, 3, 1, graph["data"].num_nodes, 7))).astype(np.float32))}
    losses = {"data": get_loss_function({"name": "WeightedMSELoss", "scalers": []}, {})}
    state = TrainState.create(iface, build_optimizer({"lr": {"rate": 1e-3}}))
    out = {}
    for precision in ("fp32", "bf16"):
        train_step, _ = make_step_fns(iface, losses, rollout=1, precision=precision)
        loss = train_step.compute_gradients(state, batch)
        out[precision] = (float(loss), torch.cat([p.grad.flatten() for p in iface.parameters()]))
    (l32, g32), (l16, g16) = out["fp32"], out["bf16"]
    assert np.isfinite(l16) and abs(l16 - l32) <= 2e-2 * abs(l32)
    assert float((g16 - g32).norm() / g32.norm()) <= 5e-2
