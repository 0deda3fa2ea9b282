"""The last fields of the JAX package's modules in the port, against the JAX
package on the CPU, float32, at rtol / atol 3e-5 (``close``: atol relative
to the largest value):

- ``MLP`` with every ``ACTIVATIONS`` name, with and without
  ``final_activation`` and the trailing LayerNorm (one extra hidden layer):
  the output, the input's and every weight's gradient;
- ``MultiHeadCrossAttention`` with ``qk_norm`` of both types, and
  ``MultiHeadSelfAttention`` with ``qk_norm_type="rmsnorm"``: the same;
- ``variable_scaling_summary`` of the losses the trainers build for the
  packaged example cut to an o8 grid, and the trainer's log line;
- ``cli train`` refusing a config with a bad ``training.rollout`` before
  anything is written, where the JAX CLI raises, and training it with
  ``config_validation: false``.

Weights made by flax from a numpy seed go into the port through
``state_dict_from_jax`` and load strictly.
"""

import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.models.layers import mlp as jax_mlp
from anemoi_tpu.models.layers.attention import MultiHeadCrossAttention as JaxCrossAttention
from anemoi_tpu.models.layers.attention import MultiHeadSelfAttention as JaxSelfAttention
from anemoi_tpu.training.cli import main as jax_main
from anemoi_tpu.training.losses.base import variable_scaling_summary as jax_summary
from anemoi_tpu.training.trainer import AnemoiTrainer as JaxTrainer
from anemoi_tpu_torch.flagship import example_o96_gt_config
from anemoi_tpu_torch.models.layers.attention import (
    MultiHeadCrossAttention,
    MultiHeadSelfAttention,
)
from anemoi_tpu_torch.models.layers.mlp import ACTIVATIONS, MLP
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training.cli import main
from anemoi_tpu_torch.training.losses.base import variable_scaling_summary
from anemoi_tpu_torch.training.trainer import AnemoiTrainer
from test_torch_blocks import randomised
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 3e-5
KEY = jax.random.PRNGKey(0)
C = 32


def close(ours, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(ours.detach().float().numpy(), ref, rtol=TOL,
                               atol=TOL * float(np.abs(ref).max()))


def check(jax_mod, port, inputs, tree, prefix, rng):
    """Output, input gradients and weight gradients of ``jax_mod`` and
    ``port`` on ``inputs``; ``tree(params)`` places the flax params where
    ``state_dict_from_jax`` names them with ``prefix``."""
    jin = [jnp.asarray(x) for x in inputs]
    params = randomised(jax.eval_shape(jax_mod.init, KEY, *jin), rng)

    def port_state(p):
        return {k[len(prefix):]: v for k, v in state_dict_from_jax(tree(p["params"])).items()}

    port.load_state_dict(port_state(params), strict=True)
    ref = jax_mod.apply(params, *jin)
    cot = rng.normal(size=ref.shape).astype(np.float32)
    grads = jax.grad(lambda p, *xs: jnp.sum(jax_mod.apply(p, *xs) * cot),
                     argnums=tuple(range(1 + len(jin))))(params, *jin)
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = port(*tin)
    close(out, ref)
    (out * torch.from_numpy(cot)).sum().backward()
    want = port_state(grads[0])
    got = dict(port.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        close(got[name].grad, g.numpy())
    for x, g in zip(tin, grads[1:]):
        close(x.grad, g)


@pytest.mark.parametrize("layer_norm", [False, True], ids=["no_norm", "norm"])
@pytest.mark.parametrize("final_activation", [False, True], ids=["hidden", "final"])
@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
def test_mlp_activation_fields_match_jax(activation, final_activation, layer_norm):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, C)).astype(np.float32)
    mod = jax_mlp.MLP(hidden_dim=2 * C, out_features=C, n_extra_layers=1,
                      activation=activation, final_activation=final_activation,
                      layer_norm=layer_norm)
    port = MLP(C, 2 * C, C, layer_norm=layer_norm, n_extra_layers=1, activation=activation,
               final_activation=final_activation)
    check(mod, port, [x], lambda p: {"node_dst_mlp": p}, "model.node_dst_mlp.", rng)


def test_gated_mlp_final_activation_matches_jax():
    """A gated hidden layer keeps its gate's activation; ``activation``
    still names the final one."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, C)).astype(np.float32)
    mod = jax_mlp.MLP(hidden_dim=2 * C, out_features=C, implementation="swiglu",
                      activation="tanh", final_activation=True)
    port = MLP(C, 2 * C, C, implementation="swiglu", activation="tanh", final_activation=True)
    check(mod, port, [x], lambda p: {"node_dst_mlp": p}, "model.node_dst_mlp.", rng)


@pytest.mark.parametrize("qk_norm_type", ["layernorm", "rmsnorm"])
def test_cross_attention_qk_norm_matches_jax(qk_norm_type):
    rng = np.random.default_rng(2)
    src = rng.normal(size=(2, 20, C)).astype(np.float32)
    dst = rng.normal(size=(2, 12, C)).astype(np.float32)
    mod = JaxCrossAttention(num_heads=4, qk_norm=True, qk_norm_type=qk_norm_type)
    port = MultiHeadCrossAttention(C, 4, qk_norm=True, qk_norm_type=qk_norm_type)
    # the module's names inside a mapper: cross_attention/{q,k,v,q_norm,k_norm,out_proj}
    check(mod, port, [src, dst],
          lambda p: {"TransformerForwardMapper_0": {"cross_attention": p}},
          "model.encoder.data.proc.attention.", rng)


def test_self_attention_rmsnorm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, C)).astype(np.float32)
    mod = JaxSelfAttention(num_heads=4, window_size=8, qk_norm=True, qk_norm_type="rmsnorm")
    port = MultiHeadSelfAttention(C, 4, window_size=8, qk_norm=True, qk_norm_type="rmsnorm")
    check(mod, port, [x], lambda p: {"TransformerProcessor_0": {"blocks_0": {"attention": p}}},
          "model.processor.proc.0.attention.", rng)


def tiny_example(tmp_path) -> dict:
    cfg = example_o96_gt_config(num_channels=16, num_layers=1, precision="fp32", grid="o8",
                                mesh_resolution=1, num_times=24)
    cfg["graph"]["save_path"] = str(tmp_path / "graph.npz")
    cfg["output_dir"] = str(tmp_path / "run")
    cfg["hardware"] = {"platform": "cpu"}
    cfg["training"].update(max_steps=1, max_epochs=1)
    cfg["diagnostics"].update(callbacks=[], log_interval=1)
    return cfg


def test_variable_scaling_summary_matches_jax(tmp_path, caplog):
    cfg = tiny_example(tmp_path)
    with caplog.at_level(logging.INFO, logger="anemoi_tpu_torch.training.trainer"):
        port = AnemoiTrainer(json.loads(json.dumps(cfg)))
    ref = JaxTrainer(json.loads(json.dumps(cfg)))
    want = jax_summary(ref.losses["data"], ref.data_indices["data"])
    got = variable_scaling_summary(port.losses["data"], port.data_indices["data"])
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=TOL, atol=0)
    assert len(set(want.values())) > 1  # the level scaler weighs the variables apart
    assert f"variable loss scaling [data]: {got}" in caplog.text


def test_cli_train_validates_first(tmp_path, capsys):
    cfg = tiny_example(tmp_path)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    bad = ["training.rollout.start=2", "training.rollout.max=1"]
    assert main(["train", str(cfg_path), *bad]) == 1
    assert "training.rollout" in capsys.readouterr().out
    assert not (tmp_path / "run").exists() and not (tmp_path / "graph.npz").exists()
    with pytest.raises(Exception, match="rollout"):
        jax_main(["train", str(cfg_path), *bad])
    assert main(["train", str(cfg_path), *bad, "config_validation=false"]) == 0
    steps = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert [r["step"] for r in steps if "loss" in r] == [1]
