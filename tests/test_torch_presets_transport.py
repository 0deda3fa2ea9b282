"""The four transport presets trained and served by the port and by the JAX
package.

Each preset (``transport_edm_diffusion``, ``transport_edm_diffusion_tendency``,
``transport_stochastic_interpolant``,
``transport_stochastic_interpolant_tendency``) is composed by both packages
with ``tests/test_config_presets.py``'s grid and mesh cuts (o8, ico-1, 16
times), one processor layer, 32 channels, float32 and no callbacks
(``diagnostics.callbacks=[]``: the default ``RolloutEvalCallback`` runs the
deterministic rollout, which a transport model cannot take); the JAX
trainer's initial weights go to the port through ``state_dict_from_jax``, and
both draw the same arrays (``SameDraws``).  Two steps and the validation:
every loss, grad norm, rate and validation loss within 1e-4.

Then ``predict``: the port's CLI serves the JAX trainer's bundle as the JAX
CLI serves it (the same draws, 1e-4), and serves the port's own bundle bit
for bit as an in-process ``make_transport_forecast_fn`` with the same seed.
The refusals: ``RolloutEvalCallback`` and ``cli evaluate`` on a transport
model, and a transport config with two datasets (which the JAX step fails
on with a ``KeyError``), all before any step.
"""

import json
import os

import numpy as np
import pytest
import torch

from anemoi_tpu.training.cli import main as jax_main
from anemoi_tpu_torch.data.dataset import open_dataset
from anemoi_tpu_torch.inference import make_transport_forecast_fn, transport_settings
from anemoi_tpu_torch.models.transport.objectives import EDMConfig
from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint
from anemoi_tpu_torch.training.cli import main
from anemoi_tpu_torch.training.trainer import AnemoiTrainer
from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config
from test_torch_presets_tasks import (
    RUN,
    _SMALL_DATA,
    _SMALL_MESH,
    assert_records_equal,
    composed,
    train_both,
)
from test_torch_transport import SameDraws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PRESETS = {  # preset -> (model class, objective, tendency)
    "transport_edm_diffusion": ("AnemoiTransportModelEncProcDec", "edm", False),
    "transport_edm_diffusion_tendency": ("AnemoiTransportTendModelEncProcDec", "edm", False),
    "transport_stochastic_interpolant": ("AnemoiTransportModelEncProcDec", "interpolant", False),
    "transport_stochastic_interpolant_tendency": ("AnemoiTransportTendModelEncProcDec",
                                                  "interpolant", True),
}
SMALL = _SMALL_DATA + _SMALL_MESH + ["model.processor.num_layers=1"]
NO_CALLBACKS = "diagnostics.callbacks=[]"


def preset_path(preset):
    return os.path.join(PACKAGED_CONFIG_DIR, f"{preset}.yaml")


def port_config(preset, tmp_path, extra=()):
    run = SMALL + list(extra) + RUN + [f"graph.save_path={tmp_path / 'graph.npz'}",
                                       f"output_dir={tmp_path / 'port'}"]
    return load_config(preset_path(preset), run, search_paths=[PACKAGED_CONFIG_DIR]).to_dict()


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_transport_preset_trains_as_jax_trains_it(tmp_path, monkeypatch, preset):
    model_name, objective, tendency = PRESETS[preset]
    draws = []
    ref, ours, trainer = train_both(
        tmp_path,
        lambda name: composed(preset_path(preset), PACKAGED_CONFIG_DIR, SMALL + [NO_CALLBACKS],
                              tmp_path, name),
        lambda: draws.append(SameDraws(monkeypatch, seed=12)))
    assert type(trainer.interface.model).__name__ == model_name
    tcfg = trainer.config["training"]["transport"]
    assert (tcfg["objective"], bool(tcfg.get("tendency", False))) == (objective, tendency)
    assert_records_equal(ref, ours)
    assert draws[0].turns["port"] and draws[0].turns["jax"]
    if preset != "transport_edm_diffusion_tendency":
        return
    # predict: the port serves the JAX bundle as the JAX CLI does (same draws)
    args = ["--steps", "2", "--seed", "3"]
    assert jax_main(["predict", str(tmp_path / "jax" / "inference"), *args,
                     "--output", str(tmp_path / "jax.npz")]) == 0
    assert main(["predict", str(tmp_path / "jax" / "inference"), *args, "--platform", "cpu",
                 "--output", str(tmp_path / "port_of_jax.npz")]) == 0
    ref_fc = np.load(tmp_path / "jax.npz")["data|forecast"]
    got_fc = np.load(tmp_path / "port_of_jax.npz")["data|forecast"]
    assert got_fc.shape == ref_fc.shape == (1, 2, 1, trainer.graph["data"].num_nodes, 11)
    np.testing.assert_allclose(got_fc, ref_fc, rtol=1e-4, atol=1e-4 * np.abs(ref_fc).max())


def test_predict_samples_the_port_bundle_bit_for_bit(tmp_path):
    """``cli predict --seed 5`` on the port's own bundle equals an in-process
    ``make_transport_forecast_fn`` with a generator seeded 5; another seed
    gives another forecast; the bundle carries ``training.transport``."""
    cfg = port_config("transport_stochastic_interpolant_tendency", tmp_path,
                      [NO_CALLBACKS, "training.transport.sampling_steps=3"])
    AnemoiTrainer(cfg, output_dir=cfg["output_dir"]).train()
    bundle = str(tmp_path / "port" / "inference")
    outs = {}
    for seed in (5, 6):
        out = tmp_path / f"fc{seed}.npz"
        assert main(["predict", bundle, "--steps", "2", "--seed", str(seed), "--platform", "cpu",
                     "--output", str(out)]) == 0
        outs[seed] = np.load(out)["data|forecast"]
    iface = load_inference_checkpoint(bundle, device="cpu")
    settings = transport_settings(iface.config)
    assert settings == {"objective": "interpolant", "sampler": "vf_heun", "num_steps": 3,
                        "tendency": True, "edm": EDMConfig()}
    window = open_dataset(iface.config["data"]["datasets"]["data"]).get_window(0, 4)[None]
    fn = make_transport_forecast_fn(iface, 2, **settings)
    want = fn({"data": torch.from_numpy(window)}, torch.Generator().manual_seed(5))["data"]
    np.testing.assert_array_equal(outs[5], want.numpy())
    assert np.isfinite(outs[6]).all() and not np.array_equal(outs[5], outs[6])


def test_predict_samples_with_the_bundle_edm_settings(tmp_path):
    """A bundle trained with a non-default ``training.transport.edm`` is
    sampled with it: ``predict`` equals an in-process forecast with that
    ``EDMConfig`` bit for bit, and not the forecast with the defaults (the
    JAX ``run_forecast_cli`` samples every bundle with ``EDMConfig()``)."""
    cfg = port_config("transport_edm_diffusion", tmp_path,
                      [NO_CALLBACKS, "training.transport.sampling_steps=2",
                       "training.transport.edm.sigma_data=0.5",
                       "training.transport.edm.sigma_max=40.0"])
    trainer = AnemoiTrainer(cfg, output_dir=cfg["output_dir"])
    assert trainer._transport_step_fns(cfg["training"]) is not None
    trainer.save_inference_checkpoint()
    bundle = str(tmp_path / "port" / "inference")
    out = tmp_path / "fc.npz"
    assert main(["predict", bundle, "--steps", "1", "--seed", "2", "--platform", "cpu",
                 "--output", str(out)]) == 0
    got = np.load(out)["data|forecast"]
    iface = load_inference_checkpoint(bundle, device="cpu")
    settings = transport_settings(iface.config)
    assert settings["edm"] == EDMConfig(sigma_data=0.5, sigma_max=40.0)
    batch = {"data": torch.from_numpy(
        open_dataset(iface.config["data"]["datasets"]["data"]).get_window(0, 3)[None])}
    fcs = {edm: make_transport_forecast_fn(iface, 1, **{**settings, "edm": edm})(
        batch, torch.Generator().manual_seed(2))["data"].numpy()
        for edm in (settings["edm"], EDMConfig())}
    np.testing.assert_array_equal(got, fcs[settings["edm"]])
    assert np.abs(got - fcs[EDMConfig()]).max() > 1e-3


def test_transport_refusals_before_any_step(tmp_path, capsys):
    """The default diagnostics' ``RolloutEvalCallback`` refuses a transport
    model at the start of training (the JAX one fails with an
    ``AssertionError`` at the first validation, after the steps);
    ``cli evaluate`` refuses it and returns 1; a transport config over two
    datasets is refused when the step is built (the JAX step fails with a
    ``KeyError`` at its first step)."""
    cfg = port_config("transport_edm_diffusion", tmp_path)
    assert [c["name"] for c in cfg["diagnostics"]["callbacks"]] == [
        "LearningRateMonitor", "RolloutEvalCallback"]
    trainer = AnemoiTrainer(cfg, output_dir=cfg["output_dir"])
    with pytest.raises(ValueError, match="make_rollout_eval_fn cannot run the transport model"):
        trainer.train()
    assert trainer.state.step == 0
    with open(tmp_path / "port" / "metrics.jsonl") as f:
        assert not [json.loads(line) for line in f]

    conf = tmp_path / "edm.yaml"
    conf.write_text(f"defaults:\n  - transport_edm_diffusion\n  - _self_\n")
    run = SMALL + RUN + [f"graph.save_path={tmp_path / 'graph.npz'}",
                         f"output_dir={tmp_path / 'eval'}"]
    assert main(["evaluate", str(conf), *run]) == 1
    assert "evaluate: make_rollout_eval_fn cannot run the transport model" in \
        capsys.readouterr().out

    multi = tmp_path / "multi_transport.yaml"
    multi.write_text("defaults:\n  - data: multi\n  - dataloader: default\n"
                     "  - diagnostics: default\n  - graph: multi\n  - model: transport\n"
                     "  - training: transport\n  - _self_\n"
                     "training:\n  loss: {name: WeightedMSELoss, scalers: []}\n"
                     "  scalers: {area: null}\n")
    small = [f"{k}.{ds}.{v}" for ds in ("era", "obs") for k, v in (
        ("data.datasets", "nodes.grid=o8"), ("data.datasets", "num_times=16"),
        ("graph.recipe.nodes", "node_builder.grid=o8"))]
    mcfg = load_config(str(multi), small + _SMALL_MESH + ["model.processor.num_layers=1",
                                                          NO_CALLBACKS, *RUN,
                                                          f"output_dir={tmp_path / 'multi'}"],
                       search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    trainer = AnemoiTrainer(mcfg, output_dir=mcfg["output_dir"])
    assert sorted(trainer.data_indices) == ["era", "obs"]
    with pytest.raises(ValueError, match="one dataset.*KeyError"):
        trainer.train()
    assert trainer.state.step == 0
