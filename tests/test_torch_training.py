"""The PyTorch port's training slice against the JAX package.

A tiny model of the flagship's shape (o16 -> ico-2, 32 channels, 2
processor layers, 4 heads; the graph and the seeded random weights of
tests/test_torch_model.py) trains with the flagship's step: area-weighted
``WeightedMSELoss`` through ``GraphNodeAttributeScaler``, AdamW with a
warmup-cosine rate and value clipping at 32, rollout 1.  The port's
``make_step_fns`` is compared with the JAX package's ``make_step_fns``
(``segment`` backend) on the same batch:

- float32: the loss, ``grad_norm`` and every parameter's gradient at step 1
  (JAX's gradients taken from inside its step by an optax transformation
  that stores them, and mapped with ``state_dict_from_jax``), then a 10-step
  loss trajectory and the parameters after it.  rtol 5e-4; gradients and
  parameters also atol 5e-4 of each tensor's largest magnitude (summation
  order differs in matmuls, LayerNorm and the attention's index_add_).
- bf16 compute over float32 masters: the losses of 4 steps within 2e-2 of
  JAX's bf16 run (tests/test_training.py:407-411), with and without
  ``fp32_head``.
- rollout 2 through ``eval_step`` (``advance_input``) and the helpers:
  ``_index_arrays``, ``advance_input``, ``WeightedMSELoss`` with NaN
  targets and an imputer mask, the learning-rate schedule.
"""

import numpy as np
import optax
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.optimizers import build_lr_schedule as jax_build_lr_schedule
from anemoi_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import _index_arrays as jax_index_arrays
from anemoi_tpu.training.step import advance_input as jax_advance_input
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu_torch.flagship import (
    VARIABLES,
    flagship_config,
    flagship_indices,
    flagship_recipe,
    flagship_statistics,
)
from anemoi_tpu_torch.graphs.graph import EdgeSet, Graph, NodeSet
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_lr_schedule, build_optimizer
from anemoi_tpu_torch.training.step import TrainState, _index_arrays, advance_input, make_step_fns
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCALERS = {"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                    "attribute_name": "area_weight"}}
LOSS = {"name": "WeightedMSELoss", "scalers": ["area"]}
# the flagship's optimizer settings, with a rate that moves a 10-step run
OPT = {"lr": {"rate": 1e-3, "warmup": 2, "iterations": 20},
       "gradient_clip": {"val": 32.0, "algorithm": "value"}}


def port_graph(g):
    out = Graph()
    for name, ns in g.nodes.items():
        out[name] = NodeSet(ns.coords, dict(ns.attributes))
    for key, es in g.edges.items():
        out[key] = EdgeSet(es.edge_index, dict(es.attributes), es.dst_ptr)
    return out


def config(precision="fp32"):
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
    iface = JaxInterface(config=config(), graph=graph, data_indices=indices, statistics=stats)
    rng = np.random.default_rng(0)
    flat = flax.traverse_util.flatten_dict(jax.eval_shape(iface.init_params)["params"])
    params = {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()}
    )}
    mean, std = stats["data"]["mean"], stats["data"]["stdev"]
    n_grid = graph["data"].num_nodes
    batch = (mean + std * rng.normal(size=(1, 4, 1, n_grid, len(VARIABLES)))).astype(np.float32)
    jax_losses = {"data": jax_get_loss_function(
        LOSS, jax_create_scalers(SCALERS, graph=graph, data_indices=indices["data"]))}
    return {"graph": graph, "port_graph": port_graph(graph), "stats": stats, "iface": iface,
            "params": params, "batch": batch, "jax_losses": jax_losses}


def port_setup(tiny, **step_kw):
    iface = AnemoiModelInterface(
        config=config(), graph=tiny["port_graph"], data_indices=flagship_indices(),
        statistics=tiny["stats"], device="cpu", training=True,
    )
    iface.load_state_dict(state_dict_from_jax(tiny["params"]), strict=True)
    losses = {"data": get_loss_function(
        LOSS, create_scalers(SCALERS, graph=tiny["port_graph"]))}
    train_step, eval_step = make_step_fns(iface, losses, **{"rollout": 1, **step_kw})
    return iface, TrainState.create(iface, build_optimizer(OPT)), train_step, eval_step


def jax_steps(tiny, tx, **step_kw):
    train_step, eval_step = jax_make_step_fns(
        tiny["iface"], tiny["jax_losses"], **{"rollout": 1, "remat_rollout": False, **step_kw})
    return JaxTrainState.create(tiny["params"], tx), train_step, eval_step


def grad_store():
    """An optax transformation that leaves the parameters alone and keeps
    the gradients it is given as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def assert_tensors_close(ours, ref, label):
    for name, want in ref.items():
        want = want.numpy()
        got = ours[name].detach().numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4 * scale,
                                   err_msg=f"{label} {name}")


def assert_grads_close(ours, ref):
    """As assert_tensors_close, except for the key biases: adding a constant
    to every key of a destination shifts all its logits alike, so their true
    gradient is exactly 0 and both packages return float noise (~1e-11)."""
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    noise = {n for n in ref if n.endswith("lin_key.bias")}
    for name in noise:
        for g in (ours[name].numpy(), ref[name].numpy()):
            assert np.abs(g).max() <= 1e-6 * top, name
    assert_tensors_close(ours, {n: g for n, g in ref.items() if n not in noise}, "grad")


def test_fp32_step_gradients_match_jax(tiny):
    batch = {"data": jnp.asarray(tiny["batch"][:, :3])}
    state, train_step, _ = jax_steps(tiny, grad_store())
    state, metrics = train_step(state, batch)
    ref_grads = state_dict_from_jax(state.opt_state)

    iface, pstate, p_train, _ = port_setup(tiny)
    loss = p_train.compute_gradients(pstate, {"data": torch.from_numpy(tiny["batch"][:, :3])})
    grads = {n: p.grad for n, p in iface.named_parameters()}
    assert sorted(grads) == sorted(ref_grads)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=5e-4)
    assert_grads_close(grads, ref_grads)

    _, ours = p_train(pstate, {"data": torch.from_numpy(tiny["batch"][:, :3])})
    np.testing.assert_allclose(float(ours["grad_norm"]), float(metrics["grad_norm"]), rtol=5e-4)
    assert pstate.step == 1 and pstate.optimizer.count == 1


def test_fp32_trajectory_matches_jax(tiny):
    batch = tiny["batch"][:, :3]
    state, train_step, _ = jax_steps(tiny, jax_build_optimizer(OPT))
    ref_losses = []
    for _ in range(10):
        state, metrics = train_step(state, {"data": jnp.asarray(batch)})
        ref_losses.append(float(metrics["loss"]))

    iface, pstate, p_train, _ = port_setup(tiny)
    losses = []
    for _ in range(10):
        pstate, metrics = p_train(pstate, {"data": torch.from_numpy(batch)})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-4)
    assert losses[-1] < losses[0]
    ref_params = state_dict_from_jax(jax.device_get(state.params))
    assert_tensors_close(dict(iface.named_parameters()), ref_params, "param")


@pytest.mark.parametrize("fp32_head", [False, True], ids=["bf16", "bf16_fp32_head"])
def test_bf16_losses_track_jax(tiny, fp32_head):
    batch = tiny["batch"][:, :3]
    state, train_step, _ = jax_steps(tiny, jax_build_optimizer(OPT), precision="bf16",
                                     fp32_head=fp32_head)
    iface, pstate, p_train, _ = port_setup(tiny, precision="bf16", fp32_head=fp32_head)
    assert all(p.dtype == torch.float32 for p in iface.parameters())
    for _ in range(4):
        state, ref = train_step(state, {"data": jnp.asarray(batch)})
        pstate, ours = p_train(pstate, {"data": torch.from_numpy(batch)})
        l16, l_ref = float(ours["loss"]), float(ref["loss"])
        assert np.isfinite(l16) and np.isfinite(float(ours["grad_norm"]))
        assert abs(l16 - l_ref) / abs(l_ref) < 2e-2, (l16, l_ref)
    assert all(p.dtype == torch.float32 for p in iface.parameters())


def test_rollout2_eval_step_matches_jax(tiny):
    batch = tiny["batch"]  # m + 2 steps
    state, _, eval_step = jax_steps(tiny, jax_build_optimizer(OPT), rollout=2)
    ref = {k: float(v) for k, v in eval_step(state, {"data": jnp.asarray(batch)}).items()}
    _, pstate, _, p_eval = port_setup(tiny, rollout=2)
    ours = {k: float(v) for k, v in p_eval(pstate, {"data": torch.from_numpy(batch)}).items()}
    assert sorted(ours) == sorted(ref) and "rmse/data/sfc/2" in ours
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=5e-4, err_msg=k)


def test_index_arrays_and_advance_input(tiny):
    idx = flagship_indices()["data"]
    ref_ia = jax_index_arrays(tiny["iface"].data_indices["data"])
    ia = _index_arrays(idx)
    assert sorted(ia) == sorted(ref_ia)
    for k in ia:
        np.testing.assert_array_equal(ia[k], ref_ia[k], err_msg=k)
    rng = np.random.default_rng(3)
    g = 11
    x = rng.normal(size=(2, 2, 1, g, idx.num_model_input_vars)).astype(np.float32)
    y = rng.normal(size=(2, 1, 1, g, idx.num_model_output_vars)).astype(np.float32)
    bn = rng.normal(size=(2, 4, 1, g, idx.num_data_vars)).astype(np.float32)
    ref = jax_advance_input(jnp.asarray(x), jnp.asarray(y), jnp.asarray(bn), 2, ref_ia)
    ours = advance_input(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(bn), 2,
                         {k: torch.as_tensor(v) for k, v in ia.items()})
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_weighted_mse_with_nans_and_mask(tiny):
    scalers = create_scalers(SCALERS, graph=tiny["port_graph"])
    loss = get_loss_function(LOSS, scalers)
    jax_loss = tiny["jax_losses"]["data"]
    rng = np.random.default_rng(4)
    g = tiny["graph"]["data"].num_nodes
    pred = rng.normal(size=(2, 1, 1, g, 5)).astype(np.float32)
    target = rng.normal(size=(2, 1, 1, g, 5)).astype(np.float32)
    target[rng.random(target.shape) < 0.1] = np.nan
    mask = (rng.random((2, g, 5)) > 0.2).astype(np.float32)
    for kw in ({}, {"mask": mask}, {"squash": False}, {"mask": mask, "squash": False}):
        ref = np.asarray(jax_loss(jnp.asarray(pred), jnp.asarray(target),
                                  **{k: jnp.asarray(v) if k == "mask" else v
                                     for k, v in kw.items()}))
        p = torch.tensor(pred, requires_grad=True)
        ours = loss(p, torch.from_numpy(target),
                    **{k: torch.from_numpy(v) if k == "mask" else v for k, v in kw.items()})
        np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=1e-5, err_msg=str(kw))
        ours.sum().backward()
        assert torch.isfinite(p.grad).all()


def test_lr_schedule_matches_optax():
    for cfg in ({"rate": 1e-4, "warmup": 10, "iterations": 1000},
                {"rate": 1e-3, "min": 1e-5, "warmup": 0, "iterations": 40}):
        ours, ref = build_lr_schedule(cfg), jax_build_lr_schedule(cfg)
        for step in list(range(0, 60)) + [999, 1000, 1500]:
            # optax evaluates in float32, the port in float64
            np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5, atol=1e-12,
                                       err_msg=f"{cfg} step {step}")
    assert build_lr_schedule({"rate": 1e-4, "warmup": 10})(0) == 0.0


def test_fused_backward_choice():
    """The JAX package's choice of attention backward per edge set
    (encoder_processor_decoder.py:284-315): the config keys, and the 2 GB
    transient estimate E * 1.7 * 3 * C * 2 for mappers without a mapper key."""
    from anemoi_tpu_torch.models.encoder_processor_decoder import fused_backward

    o96 = {"encoder": 62980, "processor": 81900, "decoder": 120960}
    for part, n_e in o96.items():  # the flagship: never fused at 512 channels
        assert not fused_backward({}, part, n_e, 512)
        assert fused_backward({"paged_fused_bwd": True}, part, n_e, 512)
    assert not fused_backward({"paged_fused_bwd": True, "paged_mapper_fused_bwd": False},
                              "decoder", 120960, 512)
    assert fused_backward({"paged_mapper_fused_bwd": True}, "encoder", 62980, 512)
    assert not fused_backward({"paged_mapper_fused_bwd": True}, "processor", 81900, 512)
    big = 400_000  # 400k edges * 1.7 * 3 * 512 * 2 bytes = 2.09 GB
    assert fused_backward({}, "decoder", big, 512)
    assert not fused_backward({}, "processor", big, 512)
    assert not fused_backward({"paged_mapper_block": [256, 256, 128]}, "decoder", big, 512)
    assert not fused_backward({"paged_mapper_fused_bwd": False}, "decoder", big, 512)


def test_not_ported_pieces_raise(tiny):
    # Ulysses head sharding is ported (tests/test_torch_parallel_heads.py):
    # asked for by the processor on one rank it is the plain processor, and
    # by the model over 2 shards it needs a mesh of 2 model ranks (so do
    # the halo strategy, the multiscale loss, the Transformer mappers and
    # the dynamic edge providers: tests/test_torch_parallel*.py,
    # tests/test_torch_projection.py, tests/test_torch_cross_attention.py,
    # tests/test_torch_dynamic.py)
    heads = config()
    heads["model"]["processor"] = {**heads["model"]["processor"], "shard_strategy": "heads"}
    model_heads = config()
    model_heads["model"].update(shard_strategy="heads", num_model_shards=2)

    def build(cfg):
        return AnemoiModelInterface(config=cfg, graph=tiny["port_graph"],
                                    data_indices=flagship_indices(), statistics=tiny["stats"],
                                    device="cpu", training=True)

    assert build(heads).model.halo is None
    with pytest.raises(ValueError, match="needs a mesh whose model group has 2 ranks"):
        build(model_heads)
    iface, _, _, _ = port_setup(tiny)
    losses = {"data": get_loss_function(LOSS, {})}
    make_step_fns(iface, losses, rollout=1, ensemble_size=2)  # ported: tests/test_torch_ensemble.py
    serving = AnemoiModelInterface(  # bf16 serving weights cannot be master weights
        config=config("bf16"), graph=tiny["port_graph"], data_indices=flagship_indices(),
        statistics=tiny["stats"], device="cpu",
    )
    with pytest.raises(ValueError, match="training=True"):
        make_step_fns(serving, losses, rollout=1)
