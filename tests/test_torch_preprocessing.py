"""Imputers, postprocessors, remappers and the processor chain of the port
against the JAX package.

- Every imputer (``InputImputer``, ``ConstantImputer``, ``CopyImputer`` and
  their ``Dynamic*`` names), every postprocessor and both remappers, each
  built by both packages' ``build_processors`` from the same entry: the
  transform of a data-space and of a model-input-space batch that holds
  NaNs, the NaN bookkeeping (``compute_aux``, ``loss_mask``) and the
  inverse with and without it.  rtol/atol 3e-5, NaNs where JAX has them.
- ``build_processors`` folding method keys given at the top level of an
  entry into its ``methods``; ``StepwiseProcessors``.
- An interface whose chain starts with a variable-expanding ``Remapper``
  (wind direction -> cos/sin) and an ``InputImputer``: the remapped
  indices and statistics, the model's widths, and ``predict_step`` on a
  NaN-bearing window (NaNs put back) against JAX's, the weights converted
  from JAX's.
- One training step of the tiny flagship (``tests/test_torch_training.py``)
  with ``[InputImputer (mean), InputNormalizer]`` on a batch whose ``q`` is
  NaN on a box of points: the loss and every gradient within 3e-5.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.preprocessing.processors import build_processors as jax_build_processors
from anemoi_tpu.preprocessing.processors import (
    build_stepwise_processors as jax_build_stepwise_processors,
)
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.flagship import VARIABLES, flagship_config, flagship_indices
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.preprocessing.imputer import BaseImputer
from anemoi_tpu_torch.preprocessing.processors import (
    build_processors,
    build_stepwise_processors,
)
from anemoi_tpu_torch.preprocessing.remapper import Remapper
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState, make_step_fns
from test_torch_remat import RTOL, batch_of, port_iface
from test_torch_training import LOSS, OPT, SCALERS, config, grad_store, tiny  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 3e-5
# the flagship's variables and two wind components given as cos/sin and as a direction
NAMES = VARIABLES + ["cos_w", "sin_w", "wdir"]
ROLES = {"forcing": ["cos_lat", "z"], "diagnostic": ["tp"]}
G = 16


def stats_for(names, seed=0):
    rng = np.random.default_rng(seed)
    n = len(names)
    mean = rng.normal(size=n)
    stdev = rng.uniform(0.5, 2.0, n)
    return {"mean": mean, "stdev": stdev, "minimum": mean - 3 * stdev,
            "maximum": mean + 3 * stdev}


def raw_batch(names, seed=1, t=3):
    """[2, t, 1, G, V] with NaNs in q, u and tp, zeros in tp, directions in wdir."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, 1, G, len(names))).astype(np.float32)
    pos = {n: i for i, n in enumerate(names)}
    for name, frac in (("q", 0.3), ("u", 0.2), ("tp", 0.25)):
        x[..., pos[name]][rng.random(x.shape[:-1]) < frac] = np.nan
    tp = x[..., pos["tp"]]
    tp[rng.random(tp.shape) < 0.3] = 0.0
    if "wdir" in pos:
        x[..., pos["wdir"]] = rng.uniform(0.0, 360.0, x.shape[:-1])
    return x


ENTRIES = {
    "InputImputer": {"name": "InputImputer", "default": "mean",
                     "methods": {"minimum": ["u"], "constant": ["tp"]}, "value": -2.5},
    "DynamicInputImputer": {"name": "DynamicInputImputer", "default": "none",
                            "methods": {"stdev": ["q", "tp"]}},
    "ConstantImputer": {"name": "ConstantImputer", "methods": {0.5: ["q"], -1.0: ["u", "tp"]}},
    "DynamicConstantImputer": {"name": "DynamicConstantImputer", "default": 3.0},
    "CopyImputer": {"name": "CopyImputer", "methods": {"t": ["q", "tp"], "v": ["u"]}},
    "DynamicCopyImputer": {"name": "DynamicCopyImputer", "methods": {"v": ["q", "u"]}},
    "Postprocessor": {"name": "Postprocessor",
                      "methods": {"relu": ["q", "tp"], "hardtanh": ["u"],
                                  "hardtanh_0_1": ["v"]}},
    **{f"NormalizedReluPostprocessor_{norm}": {
        "name": "NormalizedReluPostprocessor", "normalizer": norm,
        "methods": {-0.5: ["q", "u"], 0.2: ["tp"]}}
       for norm in ("none", "mean-std", "min-max", "max", "std")},
    "ConditionalZeroPostprocessor": {"name": "ConditionalZeroPostprocessor", "remap": "tp",
                                     "methods": {0.0: ["q"], 2.0: ["u", "v"]}},
    "ConditionalNaNPostprocessor": {"name": "ConditionalNaNPostprocessor", "remap": "tp",
                                    "methods": {"nan": ["q", "t"]}},
    "CosSinRemapper": {"name": "CosSinRemapper", "config": {"wdir": ["cos_w", "sin_w"]}},
}


def assert_same(ours, ref, label):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, label
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref), err_msg=f"{label}: NaN mask")
    np.testing.assert_allclose(np.nan_to_num(ours), np.nan_to_num(ref), rtol=TOL, atol=TOL,
                               err_msg=label)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_processor_matches_jax(entry):
    cfg = ENTRIES[entry]
    n2i = {n: i for i, n in enumerate(NAMES)}
    stats = stats_for(NAMES)
    jidx, pidx = JaxIndexCollection(n2i, **ROLES), IndexCollection(n2i, **ROLES)
    ref_chain = jax_build_processors([dict(cfg)], jidx, stats)
    chain = build_processors([dict(cfg)], pidx, stats)
    x = raw_batch(NAMES)
    assert_same(chain.transform(torch.from_numpy(x)), ref_chain.transform(jnp.asarray(x)),
                f"{entry} transform, data space")
    x_in = x[..., pidx.data.input.full]
    if entry == "CosSinRemapper":
        # data-space positions: JAX clamps them on narrower tensors, the port
        # leaves those as they are (ROADMAP.md Queue 3); its inverse in data space
        (remapper,) = chain.processors
        for narrow in (torch.from_numpy(x_in), torch.from_numpy(x[..., pidx.model.output.full])):
            assert remapper.transform(narrow) is narrow
            assert remapper.inverse_transform(narrow) is narrow
        assert_same(remapper.inverse_transform(torch.from_numpy(x)),
                    ref_chain.processors[0].inverse_transform(jnp.asarray(x)), "inverse")
        return
    assert_same(chain.transform(torch.from_numpy(x_in)), ref_chain.transform(jnp.asarray(x_in)),
                f"{entry} transform, model-input space")
    aux, ref_aux = chain.compute_aux(torch.from_numpy(x)), ref_chain.compute_aux(jnp.asarray(x))
    assert chain.has_imputer == ref_chain.has_imputer == (aux is not None)
    assert (ref_aux is None) == (aux is None)
    if aux is not None:
        assert sorted(aux) == sorted(ref_aux)
        for k in aux:
            assert_same(aux[k].to(torch.float32), np.asarray(ref_aux[k], np.float32), f"aux {k}")
        assert_same(chain.loss_mask(aux), ref_chain.loss_mask(ref_aux), f"{entry} loss mask")
        assert 0 < float(aux["loss_mask"].mean()) < 1 or "Dynamic" in entry
    assert chain.loss_mask(None) is None
    # the model's output space, with values around the thresholds and tp's zeros
    y = x[..., pidx.model.output.full]
    for a, ra in ((None, None), (aux, ref_aux)):
        assert_same(chain.inverse_transform(torch.from_numpy(y), aux=a),
                    ref_chain.inverse_transform(jnp.asarray(y), aux=ra),
                    f"{entry} inverse, aux {a is not None}")


def test_build_processors_folds_top_level_methods():
    n2i = {n: i for i, n in enumerate(NAMES)}
    stats = stats_for(NAMES)
    idx = IndexCollection(n2i, **ROLES)
    folded = {"name": "InputImputer", "default": "none", "mean": ["q"], "maximum": ["u"],
              "methods": {"minimum": ["tp"]}}
    explicit = {"name": "InputImputer", "default": "none",
                "methods": {"mean": ["q"], "maximum": ["u"], "minimum": ["tp"]}}
    (ours,) = build_processors([folded], idx, stats).processors
    (want,) = build_processors([explicit], idx, stats).processors
    (ref,) = jax_build_processors([dict(folded)], JaxIndexCollection(n2i, **ROLES),
                                  stats).processors
    assert ours.method_of == want.method_of == ref.method_of
    assert ours.method_of["q"] == "mean" and ours.method_of["t"] == "none"
    x = torch.from_numpy(raw_batch(NAMES))
    torch.testing.assert_close(ours.transform(x), want.transform(x), equal_nan=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_processors([{"name": "Remapper"}], idx, stats)  # built by the interface


def test_stepwise_processors_match_jax():
    n2i = {n: i for i, n in enumerate(NAMES)}
    stats = stats_for(NAMES)
    cfgs = {"6h": [{"name": "InputNormalizer"}], "12h": None,
            "18h": [{"name": "InputImputer", "default": "mean"}, {"name": "InputNormalizer"}]}
    ours = build_stepwise_processors(cfgs, IndexCollection(n2i, **ROLES), stats)
    ref = jax_build_stepwise_processors(cfgs, JaxIndexCollection(n2i, **ROLES), stats)
    assert ours.lead_times == ref.lead_times == ["6h", "12h", "18h"] and len(ours) == 3
    assert [c is None for c in ours] == [c is None for c in ref]
    x = raw_batch(NAMES)
    for step in (0, 1, 2, "18h"):
        assert_same(ours.transform(torch.from_numpy(x), step),
                    ref.transform(jnp.asarray(x), step), f"step {step}")
    y = x[..., IndexCollection(n2i, **ROLES).model.output.full]
    assert_same(ours.inverse_transform(torch.from_numpy(y), 2),
                ref.inverse_transform(jnp.asarray(y), 2), "inverse")


REMAP_NAMES = VARIABLES + ["wdir"]
REMAP_PROCESSORS = [
    {"name": "Remapper", "config": {"cos_sin": {"wdir": ["cos_wdir", "sin_wdir"]}}},
    {"name": "InputImputer", "default": "mean"},
    {"name": "InputNormalizer", "default": "mean-std"},
]


def test_interface_with_remapper_matches_jax(tiny):

    cfg = flagship_config(num_channels=32, num_layers=1, num_heads=4, inference_precision="fp32")
    cfg["model"]["graph_attention_backend"] = "segment"
    cfg["data"]["processors"] = REMAP_PROCESSORS
    n2i = {n: i for i, n in enumerate(REMAP_NAMES)}
    stats = {"data": stats_for(REMAP_NAMES, seed=4)}
    ref = JaxInterface(config=cfg, graph=tiny["graph"],
                       data_indices={"data": JaxIndexCollection(n2i, **ROLES)}, statistics=stats)
    ours = AnemoiModelInterface(config=cfg, graph=tiny["port_graph"],
                                data_indices={"data": IndexCollection(n2i, **ROLES)},
                                statistics=stats, device="cpu")
    idx, ref_idx = ours.data_indices["data"], ref.data_indices["data"]
    assert idx.name_to_index == ref_idx.name_to_index
    assert list(idx.name_to_index)[-2:] == ["cos_wdir", "sin_wdir"]
    assert idx.num_model_input_vars == ref_idx.num_model_input_vars == 8
    assert idx.num_model_output_vars == ref_idx.num_model_output_vars == 7
    for key in stats["data"]:
        np.testing.assert_array_equal(ours.remappers["data"].remap_statistics(stats["data"])[key],
                                      ref.remappers["data"].remap_statistics(stats["data"])[key])
    assert isinstance(ours.pre_processors["data"].processors[0], Remapper)
    assert isinstance(ours.pre_processors["data"].processors[1], BaseImputer)

    rng = np.random.default_rng(0)
    flat = flax.traverse_util.flatten_dict(jax.eval_shape(ref.init_params)["params"])
    params = {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()})}
    ours.load_state_dict(state_dict_from_jax(params), strict=True)
    n_grid = tiny["graph"]["data"].num_nodes
    x = rng.normal(size=(1, 2, 1, n_grid, len(REMAP_NAMES))).astype(np.float32)
    x[..., n2i["wdir"]] = rng.uniform(0, 360, x.shape[:-1])
    x[0, :, 0, : n_grid // 5, n2i["q"]] = np.nan  # q NaN on a fifth of the grid
    want = np.asarray(ref.predict_step(params, {"data": jnp.asarray(x)})["data"])
    got = ours.predict_step({"data": torch.from_numpy(x)})["data"]
    assert want.shape == (1, 1, 1, n_grid, 6)  # the original output space: wdir rebuilt
    assert np.isnan(want[0, 0, 0, : n_grid // 5, 0]).all()  # q's NaNs put back
    assert_same(got, want, "predict_step")


def nan_batch(tiny):
    """The seeded rollout-1 batch with ``q`` NaN on a box of points, at every time."""
    batch = batch_of(tiny, 1)
    coords = np.rad2deg(tiny["graph"]["data"].coords)
    box = (coords[:, 0] > 10) & (coords[:, 0] < 60) & (coords[:, 1] > 0) & (coords[:, 1] < 90)
    assert 0 < box.sum() < box.size
    batch[..., box, VARIABLES.index("q")] = np.nan
    return batch, box


def test_nan_step_with_imputer_matches_jax(tiny):
    cfg = config()
    cfg["data"]["processors"] = [{"name": "InputImputer", "default": "mean"},
                                 {"name": "InputNormalizer", "default": "mean-std"}]
    batch, box = nan_batch(tiny)
    jax_iface = JaxInterface(config=cfg, graph=tiny["graph"],
                             data_indices=tiny["iface"].data_indices, statistics=tiny["stats"])
    train_step, _ = jax_make_step_fns(jax_iface, tiny["jax_losses"], rollout=1)
    state, metrics = train_step(JaxTrainState.create(tiny["params"], grad_store()),
                                {"data": jnp.asarray(batch)})
    ref = state_dict_from_jax(state.opt_state)

    iface = port_iface(tiny, cfg)
    aux = iface.pre_processors["data"].compute_aux(torch.from_numpy(batch))
    mask = iface.pre_processors["data"].loss_mask(aux)
    q_out = flagship_indices()["data"].model.output.name_to_index["q"]
    np.testing.assert_array_equal(mask[0, :, q_out].numpy() == 0, box)  # zero exactly there
    assert float(mask.sum()) == mask.numel() - box.sum()

    losses = {"data": get_loss_function(LOSS, create_scalers(SCALERS, graph=tiny["port_graph"]))}
    p_train, p_eval = make_step_fns(iface, losses, rollout=1)
    loss = p_train.compute_gradients(TrainState.create(iface, build_optimizer(OPT)),
                                     {"data": torch.from_numpy(batch)})
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=RTOL)
    grads = {n: p.grad for n, p in iface.named_parameters()}
    assert sorted(grads) == sorted(ref)
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, want in ref.items():
        want, got = want.numpy(), grads[name].numpy()
        assert np.isfinite(got).all(), name
        if name.endswith("lin_key.bias"):  # exactly 0 in truth: float noise on both sides
            assert np.abs(got).max() <= 1e-6 * top and np.abs(want).max() <= 1e-6 * top
            continue
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()),
                                   err_msg=name)
    # the validation's metrics put the NaNs back and skip them
    val = {k: float(v) for k, v in p_eval(TrainState(0, iface, None),
                                          {"data": torch.from_numpy(batch)}).items()}
    assert all(np.isfinite(v) for v in val.values())
