"""The autoencoder and temporal-downscaler tasks of the port's training step
against the JAX package's.

Tiny models on o8 -> ico-1 at 32 channels with the JAX package's
initialised parameters replaced by seeded random numbers and moved with
``state_dict_from_jax``; the JAX side's gradients come from inside its step
(``tests/test_torch_training.py``'s ``grad_store``).  An ensemble's noise:
the JAX side's ``jax.random.normal`` and the port's draw return the same
seeded arrays (``tests/test_torch_ensemble.py``'s ``SameNoise``).  Loss in
float32 at 3e-5, gradients at 1e-4 of each tensor's largest magnitude:

- ``make_step_fns(task="autoencoder")``: ``AnemoiModelAutoEncoder`` (GT
  mappers, a point-wise processor, ``NoResidualConnection``, one input
  step) on a graph with no processor edges, its target the input step; at
  2 members an ensemble model with ``NoiseInjector``;
- ``make_step_fns(task="temporal_downscaler")``: the GT model with 2 output
  steps, inputs the window's endpoints, targets the interior; at 2 members
  ``NoiseConditioning`` with a conditional processor; asked for rollout 2
  with rollout remat, both tasks run one step with no remat, and the eval
  step's records equal the JAX one's;
- the tasks' targets: the autoencoder reads its input step, the
  downscaler nothing past its window.

The trainers of the four presets these tasks and families unlock, and of
the GNN model, are compared in ``tests/test_torch_presets_tasks.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu_torch.flagship import flagship_config, flagship_indices, flagship_recipe
from anemoi_tpu_torch.flagship import flagship_statistics
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState, make_step_fns
from test_torch_ensemble import SameNoise, assert_grads_close, noise_arrays, randomised
from test_torch_gnn import encoder_decoder_only
from test_torch_switches import _indices
from test_torch_training import grad_store, port_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCALERS = {"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                    "attribute_name": "area_weight"}}
NOISE = {"noise_std": 1.3, "noise_channels_dim": 4, "noise_mlp_hidden_dim": 8}
M = 2  # members of the ensemble cases


def task_config(task, members):
    cfg = flagship_config(num_channels=32, num_layers=1, num_heads=4, inference_precision="fp32")
    model = cfg["model"]
    model["graph_attention_backend"] = "segment"
    if task == "autoencoder":
        model.update(name="AnemoiModelAutoEncoder", n_step_input=1,
                     residual={"name": "NoResidualConnection"},
                     processor={"name": "PointWiseMLPProcessor", "num_layers": 2,
                                "mlp_hidden_ratio": 2.0})
        if members > 1:  # the point-wise processor takes no conditioning
            model.update(name="AnemoiEnsModelEncProcDec",
                         noise_injector={"name": "NoiseInjector", **NOISE})
    else:
        model["n_step_output"] = 2
        if members > 1:
            model.update(name="AnemoiEnsModelEncProcDec",
                         noise_injector={"name": "NoiseConditioning", **NOISE})
            model["processor"]["conditional"] = True
    return cfg


@pytest.fixture(scope="module")
def graphs():
    full = JaxGraphCreator(flagship_recipe("o8", 1)).create()
    return {"temporal_downscaler": full,
            "autoencoder": JaxGraphCreator(encoder_decoder_only(flagship_recipe("o8", 1))).create()}


def setups(graphs, task, members, rollout, remat):
    graph = graphs[task]
    stats = flagship_statistics(seed=1)
    cfg = task_config(task, members)
    loss_cfg = ({"name": "KernelCRPS", "scalers": ["area"]} if members > 1
                else {"name": "WeightedMSELoss", "scalers": ["area"]})
    jax_iface = JaxInterface(config=cfg, graph=graph, data_indices=_indices(), statistics=stats)
    params = randomised(jax.eval_shape(jax_iface.init_params), np.random.default_rng(0))
    jax_losses = {"data": jax_get_loss_function(
        loss_cfg, jax_create_scalers(SCALERS, graph=graph, data_indices=_indices()["data"]))}
    jax_train, jax_eval = jax_make_step_fns(jax_iface, jax_losses, rollout=rollout,
                                            remat_rollout=remat, ensemble_size=members, task=task)
    pgraph = port_graph(graph)
    iface = AnemoiModelInterface(config=cfg, graph=pgraph, data_indices=flagship_indices(),
                                 statistics=stats, device="cpu", training=True)
    iface.load_state_dict(state_dict_from_jax(params), strict=True)
    losses = {"data": get_loss_function(loss_cfg, create_scalers(SCALERS, graph=pgraph))}
    train, evaluate = make_step_fns(iface, losses, rollout=rollout, remat_rollout=remat,
                                    ensemble_size=members, task=task)
    state = TrainState.create(iface, build_optimizer({"lr": {"rate": 1e-3}}))
    m, n_out = iface.model.n_step_input, iface.model.n_step_output
    mean, std = stats["data"]["mean"], stats["data"]["stdev"]
    rng = np.random.default_rng(1)
    batch = (mean + std * rng.normal(size=(1, m + rollout * n_out, 1, graph["data"].num_nodes,
                                           7))).astype(np.float32)
    return (params, jax_train, jax_eval), (iface, state, train, evaluate), batch


@pytest.mark.parametrize("task,members,rollout", [
    ("autoencoder", 1, 1), ("autoencoder", M, 1), ("temporal_downscaler", 1, 2),
    ("temporal_downscaler", M, 1)],
    ids=["autoencoder", "autoencoder_ens", "downscaler_rollout2", "downscaler_ens"])
def test_task_step_matches_jax(graphs, monkeypatch, task, members, rollout):
    (params, jax_train, jax_eval), (iface, state, train, evaluate), batch = setups(
        graphs, task, members, rollout, remat=rollout > 1)
    n_hidden = graphs[task]["hidden"].num_nodes
    if members > 1:  # one draw: the tasks run one model step
        SameNoise(monkeypatch, noise_arrays(3, 1, (members, n_hidden, NOISE["noise_channels_dim"])))
    jstate, metrics = jax_train(JaxTrainState.create(params, grad_store()),
                                {"data": jnp.asarray(batch)})
    loss = train.compute_gradients(state, {"data": torch.from_numpy(batch)})
    scale = abs(float(metrics["loss"]))
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=3e-5, atol=3e-5 * scale)
    grads = {n: p.grad for n, p in iface.named_parameters()}
    assert_grads_close(grads, state_dict_from_jax(jstate.opt_state))
    if members == 1:
        ref = jax_eval(jstate, {"data": jnp.asarray(batch)})
        with torch.no_grad():
            ours = evaluate(state, {"data": torch.from_numpy(batch)})
        assert sorted(ours) == sorted(ref) and "rmse/data/sfc/1" in ours
        for key, value in ref.items():
            np.testing.assert_allclose(float(ours[key]), float(value), rtol=1e-4, err_msg=key)


def test_task_targets(graphs):
    """The autoencoder's target is its input step (0): the window's step 1,
    which the forecaster would target, moves nothing.  The downscaler reads
    steps 0 to 3 of a longer window and not step 4.  It refuses a model
    with other than 2 input steps."""
    for task, unused in (("autoencoder", 1), ("temporal_downscaler", 4)):
        _, (iface, state, train, _), batch = setups(graphs, task, 1, 1, False)
        if task == "temporal_downscaler":
            batch = np.concatenate([batch, batch[:, :1]], axis=1)
        losses = []
        for t in (None, 0, unused):
            changed = batch.copy()
            if t is not None:
                changed[:, t] += 1.0
            losses.append(float(train.compute_gradients(state, {"data": torch.from_numpy(
                changed)})))
        assert losses[1] != losses[0] and losses[2] == losses[0], (task, losses)
    cfg = task_config("temporal_downscaler", 1)
    cfg["model"]["n_step_input"] = 3
    three = AnemoiModelInterface(config=cfg, graph=port_graph(graphs["temporal_downscaler"]),
                                 data_indices=flagship_indices(),
                                 statistics=flagship_statistics(seed=1), device="cpu",
                                 training=True)
    with pytest.raises(ValueError, match="n_step_input=2"):
        make_step_fns(three, {}, rollout=1, task="temporal_downscaler")
