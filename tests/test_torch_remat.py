"""Remat (activation checkpointing) in the port, against the JAX package and
against itself.

The tiny flagship of tests/test_torch_training.py (o16 -> ico-2, 32
channels, 2 processor layers, 4 heads, ``segment`` backend, its seeded
weights) and a tiny ``transformer`` preset (the same graph, 2 dense
layers, window 16: the band runs) train with ``make_step_fns``:

- against JAX: the step's gradients at rollout 2 and 3 with
  ``remat_rollout`` (``remat_policy`` None and ``save_attention``) and the
  processor's ``gradient_checkpointing`` on and off equal the JAX step's
  (its gradients taken out by an optax transformation that stores them)
  within rtol/atol 3e-5 of each tensor's largest magnitude, float32;
- within the port: the gradients with remat -- per layer, per rollout
  step, nested, each policy -- equal those without remat bit for bit,
  float32 and bf16;
- the attention ops' forward calls in one training step are exact for
  each policy and nesting: the counts the card's launch gate
  (``chip_smoke.py``, phase ``remat``) holds K1 and K6 to.  A policy that
  keeps the attention's out/lse (``save_attention``,
  ``save_attention_mlp``) never runs the op again; ``full`` and ``dots``
  run it again in every recompute;
- ``resolve_remat_policy`` refuses an unknown name with the JAX package's
  message; parameter names and ``state_dict_from_jax`` loading do not
  change with remat on.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.models.layers.remat import resolve_remat_policy as jax_resolve_remat_policy
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu_torch.flagship import (
    VARIABLES,
    flagship_indices,
    transformer_config,
)
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.layers.processor import GraphTransformerProcessor
from anemoi_tpu_torch.models.layers.remat import resolve_remat_policy
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.ops import gt_attention as gt_ops
from anemoi_tpu_torch.ops import window_attention as band_ops
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState, make_step_fns
from test_torch_training import LOSS, OPT, SCALERS, config, grad_store, tiny  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 3e-5
LAYERS = 2  # processor layers of both tiny models
MAPPERS = 2  # encoder + decoder blocks: the graph attention's calls besides the processor's


def remat_config(kind="gt", layer_policy="save_attention", mapper_policy=None,
                 precision="fp32"):
    """The tiny model's config with the processor's remat (``layer_policy``
    "off": no per-layer checkpoint) and, with ``mapper_policy``, the
    mappers' too."""
    if kind == "gt":
        cfg = config(precision)
    else:
        cfg = transformer_config(num_channels=32, num_layers=LAYERS, num_heads=4,
                                 window_size=16, inference_precision=precision)
        cfg["model"]["graph_attention_backend"] = "segment"
    proc = cfg["model"]["processor"]
    proc["gradient_checkpointing"] = layer_policy != "off"
    if layer_policy != "off":
        proc["remat_policy"] = layer_policy
    if mapper_policy is not None:
        for part in ("encoder", "decoder"):
            cfg["model"][part].update(gradient_checkpointing=True, remat_policy=mapper_policy)
    return cfg


def batch_of(tiny, rollout):
    """m + rollout times of the seeded data-space batch."""
    rng = np.random.default_rng(5)
    mean, std = tiny["stats"]["data"]["mean"], tiny["stats"]["data"]["stdev"]
    n_grid = tiny["graph"]["data"].num_nodes
    return (mean + std * rng.normal(size=(1, 2 + rollout, 1, n_grid, len(VARIABLES)))
            ).astype(np.float32)


_PARAMS = {}


def port_iface(tiny, cfg):
    """The port's interface on the CPU with the tiny flagship's weights (the
    transformer: its own seeded weights, shared by every case)."""
    iface = AnemoiModelInterface(
        config=cfg, graph=tiny["port_graph"], data_indices=flagship_indices(),
        statistics=tiny["stats"], device="cpu", training=True,
    )
    if cfg["model"]["processor"]["name"] == "GraphTransformerProcessor":
        iface.load_state_dict(state_dict_from_jax(tiny["params"]), strict=True)
    else:
        if "transformer" not in _PARAMS:
            gen = torch.Generator().manual_seed(7)
            _PARAMS["transformer"] = {n: 0.3 * torch.randn(p.shape, generator=gen)
                                      for n, p in iface.named_parameters()}
        iface.load_state_dict(_PARAMS["transformer"], strict=True)
    return iface


def port_grads(tiny, cfg, batch, **step_kw):
    """(loss, {name: gradient}) of one step of the port."""
    iface = port_iface(tiny, cfg)
    losses = {"data": get_loss_function(LOSS, create_scalers(SCALERS, graph=tiny["port_graph"]))}
    train_step, _ = make_step_fns(iface, losses, **step_kw)
    state = TrainState.create(iface, build_optimizer(OPT))
    loss = train_step.compute_gradients(state, {"data": torch.from_numpy(batch)})
    return float(loss), {n: p.grad.clone() for n, p in iface.named_parameters()}


@pytest.fixture
def counted(monkeypatch):
    """Counts the forward calls of the two attention ops: their plain
    versions, which the ops run on CPU tensors (the band's plain backward,
    autograd of its plain forward, runs one more that is not counted)."""
    calls = {"gt": 0, "band": 0}
    in_backward = []
    gt_plain, band_plain = gt_ops.gt_attention_plain, band_ops.band_attention_plain
    band_bwd_plain = band_ops.band_attention_bwd_plain

    def gt(*a, **k):
        calls["gt"] += 1
        return gt_plain(*a, **k)

    def band(*a, **k):
        calls["band"] += not in_backward
        return band_plain(*a, **k)

    def band_bwd(*a, **k):
        in_backward.append(True)
        try:
            return band_bwd_plain(*a, **k)
        finally:
            in_backward.pop()

    monkeypatch.setattr(gt_ops, "gt_attention_plain", gt)
    monkeypatch.setattr(band_ops, "band_attention_plain", band)
    monkeypatch.setattr(band_ops, "band_attention_bwd_plain", band_bwd)
    return calls


# (rollout, remat_policy, processor gradient_checkpointing): each rollout
# with both policies, each policy with the per-layer remat on and off
JAX_CASES = [(2, None, True), (2, "save_attention", False), (3, "save_attention", True),
             (3, None, False)]


@pytest.mark.parametrize("rollout,policy,layer_remat", JAX_CASES,
                         ids=[f"r{r}-{p or 'full'}-{'layers' if g else 'nolayers'}"
                              for r, p, g in JAX_CASES])
def test_remat_gradients_match_jax(tiny, rollout, policy, layer_remat):
    cfg = remat_config(layer_policy="save_attention" if layer_remat else "off")
    batch = batch_of(tiny, rollout)
    jax_iface = JaxInterface(config=cfg, graph=tiny["graph"],
                             data_indices=tiny["iface"].data_indices, statistics=tiny["stats"])
    train_step, _ = jax_make_step_fns(jax_iface, tiny["jax_losses"], rollout=rollout,
                                      remat_rollout=True, remat_policy=policy)
    state, metrics = train_step(JaxTrainState.create(tiny["params"], grad_store()),
                                {"data": jnp.asarray(batch)})
    ref = state_dict_from_jax(state.opt_state)

    loss, grads = port_grads(tiny, cfg, batch, rollout=rollout, remat_rollout=True,
                             remat_policy=policy)
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=RTOL)
    assert sorted(grads) == sorted(ref)
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, want in ref.items():
        want, got = want.numpy(), grads[name].numpy()
        if name.endswith("lin_key.bias"):  # exactly 0 in truth: float noise on both sides
            assert np.abs(got).max() <= 1e-6 * top and np.abs(want).max() <= 1e-6 * top
            continue
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=name)


def forwards(kind, rollout, layer_policy, rollout_policy, mapper_policy=None, layers=LAYERS):
    """The attention ops' forward calls in one training step, from the
    structure: every rollout step's forward runs each op once (F calls); a
    rollout checkpoint that does not keep the attention's outputs runs the
    whole forward again in the backward (F more; with rollout 1 there is
    none); a block checkpoint that does not keep them runs its block's op
    once more in the backward.  Returns {"gt": n, "band": n}."""
    keeps = ("save_attention", "save_attention_mlp")
    gt_f, band_f = (MAPPERS + layers, 0) if kind == "gt" else (MAPPERS, layers)
    outer = rollout_policy != "off" and rollout > 1 and rollout_policy not in keeps
    layer_again = layers if layer_policy not in ("off", *keeps) else 0
    mapper_again = MAPPERS if mapper_policy is not None and mapper_policy not in keeps else 0
    per_step = {"gt": gt_f * (1 + outer) + mapper_again, "band": band_f * (1 + outer)}
    per_step["gt" if kind == "gt" else "band"] += layer_again
    return {k: n * rollout for k, n in per_step.items()}


# (kind, rollout, per-layer policy, rollout policy, mapper policy, precision);
# "off": no checkpoint at that level
POLICY_CASES = [
    ("gt", 2, "save_attention", "off", None, "fp32"),
    ("gt", 2, "full", "off", None, "fp32"),
    ("gt", 2, "off", "full", None, "fp32"),
    ("gt", 2, "save_attention", "full", None, "fp32"),
    ("gt", 2, "save_attention", "save_attention", None, "fp32"),
    ("gt", 2, "full", "full", "full", "fp32"),
    ("gt", 2, "dots", "dots", None, "fp32"),
    ("gt", 3, "save_attention_mlp", "save_attention_mlp", "save_attention", "fp32"),
    ("gt", 1, "save_attention", "full", None, "fp32"),
    ("gt", 2, "save_attention", "full", None, "bf16"),
    ("gt", 2, "full", "save_attention", "full", "bf16"),
    ("transformer", 2, "save_attention", "off", None, "fp32"),
    ("transformer", 2, "save_attention", "full", None, "fp32"),
    ("transformer", 2, "full", "full", None, "fp32"),
    ("transformer", 2, "save_attention_mlp", "dots", "full", "fp32"),
    ("transformer", 2, "save_attention", "save_attention", None, "bf16"),
]


@pytest.fixture(scope="module")
def no_remat(tiny):
    """{(kind, rollout, precision): gradients of the step without remat}."""
    cache = {}

    def get(kind, rollout, precision):
        key = (kind, rollout, precision)
        if key not in cache:
            cache[key] = port_grads(
                tiny, remat_config(kind, "off", precision=precision), batch_of(tiny, rollout),
                rollout=rollout, remat_rollout=False, precision=precision)
        return cache[key]

    return get


@pytest.mark.parametrize("kind,rollout,layer_policy,rollout_policy,mapper_policy,precision",
                         POLICY_CASES, ids=["-".join(map(str, c)) for c in POLICY_CASES])
def test_remat_is_bitwise_and_counts_are_exact(tiny, no_remat, counted, kind, rollout,
                                               layer_policy, rollout_policy, mapper_policy,
                                               precision):
    ref_loss, ref = no_remat(kind, rollout, precision)
    cfg = remat_config(kind, layer_policy, mapper_policy, precision)
    counted.update(gt=0, band=0)
    loss, grads = port_grads(
        tiny, cfg, batch_of(tiny, rollout), rollout=rollout,
        remat_rollout=rollout_policy != "off",
        remat_policy=None if rollout_policy == "off" else rollout_policy, precision=precision)
    assert counted == forwards(kind, rollout, layer_policy, rollout_policy, mapper_policy)
    assert loss == ref_loss
    for name, g in ref.items():
        assert torch.equal(grads[name], g), name


def test_remat_counts_on_the_flagship_structure():
    """The structure's counts at the flagship's 16 layers and 2 mappers
    (18 graph-attention blocks), rollout r: what the card's ``remat`` phase
    holds K1 to."""
    for r in (1, 2, 3):
        full = 36 if r > 1 else 18
        assert forwards("gt", r, "save_attention", "off", layers=16)["gt"] == 18 * r
        assert forwards("gt", r, "save_attention", "save_attention", layers=16)["gt"] == 18 * r
        assert forwards("gt", r, "save_attention", "full", layers=16)["gt"] == full * r
        assert forwards("gt", r, "full", "off", layers=16)["gt"] == 34 * r
        assert forwards("gt", r, "off", "full", layers=16)["gt"] == full * r


def test_resolve_remat_policy_names():
    for name in (None, "full"):
        assert resolve_remat_policy(name) is None
    ops = torch.ops.anemoi_tpu_torch
    assert resolve_remat_policy("save_attention") == {ops.gt_attention_fwd.default,
                                                      ops.band_attention_fwd.default}
    assert resolve_remat_policy("save_attention_mlp") == {
        ops.gt_attention_fwd.default, ops.band_attention_fwd.default, ops.mlp_hidden.default}
    assert torch.ops.aten.mm.default in resolve_remat_policy("dots")
    with pytest.raises(ValueError) as ref:
        jax_resolve_remat_policy("bogus")
    with pytest.raises(ValueError) as ours:
        resolve_remat_policy("bogus")
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        GraphTransformerProcessor(1, 8, 2, edge_dim=3, remat_policy="bogus")


def test_parameter_names_and_jax_loading_unchanged_by_remat(tiny):
    on = port_iface(tiny, remat_config(layer_policy="save_attention",
                                       mapper_policy="save_attention"))
    off = port_iface(tiny, remat_config(layer_policy="off"))
    assert [n for n, _ in on.named_parameters()] == [n for n, _ in off.named_parameters()]
    assert any(n.startswith("model.processor.proc.1.") for n, _ in on.named_parameters())
    for (n, a), (_, b) in zip(on.state_dict().items(), off.state_dict().items()):
        assert torch.equal(a, b), n
    assert on.model.processor.gradient_checkpointing
    assert on.model.encoder["data"].gradient_checkpointing
    assert not off.model.processor.gradient_checkpointing
