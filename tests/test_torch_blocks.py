"""Layers of the PyTorch port against the flax modules of the JAX package.

Each test initialises the flax module, replaces every parameter with seeded
random numbers (so zero-initialised ones take part), moves them into the
port with ``state_dict_from_jax`` (strict load), runs both on the same numpy
input and compares in float32 at rtol/atol 1e-5.  The JAX graph blocks run
their ``segment`` backend; the port's attention runs its plain PyTorch
version (CPU tensors).
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from anemoi_tpu.models.graph import EdgeData
from anemoi_tpu.models.layers import embed as jax_embed
from anemoi_tpu.models.layers import graph_blocks as jax_blocks
from anemoi_tpu.models.layers import mlp as jax_mlp
from anemoi_tpu.models.layers import normalization as jax_norm
from anemoi_tpu_torch.models.graph import SubGraphArrays
from anemoi_tpu_torch.models.layers.embed import TrainableNodeAttributes
from anemoi_tpu_torch.models.layers.graph_blocks import (
    GraphTransformerMapperBlock,
    GraphTransformerProcessorBlock,
)
from anemoi_tpu_torch.models.layers.mlp import MLP
from anemoi_tpu_torch.models.layers.normalization import LayerNorm
from anemoi_tpu_torch.models.port import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def randomised(params, rng):
    """Same tree, every leaf replaced: scales near 1, the rest small normals."""
    flat = flax.traverse_util.flatten_dict(params["params"])
    new = {
        k: (1.0 + 0.1 * rng.normal(size=v.shape) if k[-1] == "scale"
            else 0.3 * rng.normal(size=v.shape)).astype(np.float32)
        for k, v in flat.items()
    }
    return {"params": flax.traverse_util.unflatten_dict(new)}


def load(module, params, under=None):
    """state_dict_from_jax, with the module's own prefix stripped."""
    tree = {"params": {under: params["params"]}} if under else params
    prefix = "model." + (f"{under}." if under == "node_dst_mlp" else "")
    sd = {k[len(prefix):]: v for k, v in state_dict_from_jax(tree).items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def random_graph(rng, num_src, num_dst, f=3):
    src, dst = [], []
    for d in range(num_dst):
        k = int(rng.integers(1, 9))
        src.append(rng.choice(num_src, size=k, replace=False))
        dst.append(np.full(k, d))
    ei = np.stack([np.concatenate(src), np.concatenate(dst)]).astype(np.int64)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(ei[1], minlength=num_dst))])
    attr = rng.normal(size=(ei.shape[1], f)).astype(np.float32)
    jax_edges = EdgeData(edge_attr=jnp.asarray(attr), edge_index=jnp.asarray(ei))
    sub = SubGraphArrays(
        edge_index=torch.from_numpy(ei.astype(np.int32)),
        dst_ptr=torch.from_numpy(ptr.astype(np.int32)),
        edge_attr=torch.from_numpy(attr), num_src=num_src, num_dst=num_dst,
    )
    return jax_edges, sub


def test_layer_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32) * 3 + 1
    mod = jax_norm.LayerNorm()
    params = randomised(jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(mod.apply(params, jnp.asarray(x)))
    port = LayerNorm(16)
    sd = state_dict_from_jax({"params": {"layer_norm_attention": params["params"]}})
    port.load_state_dict({k.split(".")[-1]: v for k, v in sd.items()}, strict=True)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), ref, **TOL)


@pytest.mark.parametrize("layer_norm", [False, True])
def test_mlp(layer_norm):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    mod = jax_mlp.MLP(hidden_dim=48, out_features=10, layer_norm=layer_norm)
    params = randomised(jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(mod.apply(params, jnp.asarray(x)))
    port = load(MLP(12, 48, 10, layer_norm=layer_norm), params, under="node_dst_mlp")
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), ref, **TOL)


def test_trainable_node_attributes():
    rng = np.random.default_rng(2)
    static = rng.normal(size=(11, 4)).astype(np.float32)
    mod = jax_embed.TrainableNodeAttributes(num_nodes=11, trainable_size=8)
    params = randomised(jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.asarray(static)), rng)
    ref = np.asarray(mod.apply(params, jnp.asarray(static)))
    sd = state_dict_from_jax({"params": {"node_attributes_data": params["params"]}})
    assert list(sd) == ["model.node_attributes.trainable_tensors.data.trainable"]
    port = TrainableNodeAttributes(11, 8)
    port.load_state_dict({"trainable": sd["model.node_attributes.trainable_tensors.data.trainable"]})
    np.testing.assert_allclose(port(torch.from_numpy(static)).detach().numpy(), ref, **TOL)


def test_mapper_block():
    rng = np.random.default_rng(3)
    n_src, n_dst, c, heads = 30, 17, 16, 4
    jax_edges, sub = random_graph(rng, n_src, n_dst)
    xs = rng.normal(size=(2, n_src, c)).astype(np.float32)
    xd = rng.normal(size=(2, n_dst, c)).astype(np.float32)
    mod = jax_blocks.GraphTransformerMapperBlock(
        num_heads=heads, hidden_dim=4 * c, out_channels=c, backend="segment"
    )
    x_jax = (jnp.asarray(xs), jnp.asarray(xd))
    params = randomised(jax.eval_shape(mod.init, jax.random.PRNGKey(0), x_jax, jax_edges), rng)
    (ref_src, ref_dst), _ = mod.apply(params, x_jax, jax_edges)
    port = load(GraphTransformerMapperBlock(c, 4 * c, c, heads, edge_dim=3), params)
    out_src, out_dst = port((torch.from_numpy(xs), torch.from_numpy(xd)), sub, sub.edge_attr)
    np.testing.assert_allclose(out_dst.detach().numpy(), np.asarray(ref_dst), **TOL)
    np.testing.assert_allclose(out_src.numpy(), np.asarray(ref_src), **TOL)


@pytest.mark.parametrize(
    "qk_norm,edge_pre_mlp", [(False, False), (True, False), (False, True)],
    ids=["plain", "qk_norm", "edge_pre_mlp"],
)
def test_processor_block(qk_norm, edge_pre_mlp):
    """Without edge_pre_mlp the port fuses lin_edge into the attention (K1's
    route); with it, lin_edge runs first (K2's route)."""
    rng = np.random.default_rng(4)
    n, c, heads = 25, 16, 2
    jax_edges, sub = random_graph(rng, n, n)
    x = rng.normal(size=(2, n, c)).astype(np.float32)
    mod = jax_blocks.GraphTransformerProcessorBlock(
        num_heads=heads, hidden_dim=4 * c, out_channels=c, qk_norm=qk_norm,
        edge_pre_mlp=edge_pre_mlp, backend="segment",
    )
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.asarray(x), jax_edges)
    params = randomised(shapes, rng)
    ref, _ = mod.apply(params, jnp.asarray(x), jax_edges)
    port = load(
        GraphTransformerProcessorBlock(
            c, 4 * c, c, heads, edge_dim=3, qk_norm=qk_norm, edge_pre_mlp=edge_pre_mlp
        ),
        params,
    )
    out = port(torch.from_numpy(x), sub, sub.edge_attr)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
