"""The presets that the GNN and point-wise families and the autoencoder and
temporal-downscaler tasks unlock, trained by the port's and the JAX
package's trainers.

Each preset (``point_wise``, ``autoencoder``, ``temporal_downscaler``,
``temporal_downscaler_ensemble``) and the GNN model (``model: gnn`` on
``graph: multi_scale``, from a config file's ``defaults:`` list: there is
no packaged GNN preset) is composed by both packages with
``tests/test_config_presets.py``'s grid and mesh cuts (o8, ico-1, 16
times), one processor layer (two for the GNN, so that its scanned stack is
not empty), 32 channels, float32, and the ``LearningRateMonitor`` alone
(the deterministic downscaler also ``PerTimestepMetrics``, whose ``t_1`` and
``t_2`` keys are compared); the JAX trainer's initial weights go to the port through
``state_dict_from_jax``.  Two steps and the validation: every loss, grad
norm, rate and validation metric within 1e-4.  The ensemble preset's 2
members draw the same noise in both packages (``SameNoise``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import anemoi_tpu
from anemoi_tpu.training.trainer import AnemoiTrainer as JaxTrainer
from anemoi_tpu.utils.config import load_config as jax_load_config
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training.trainer import AnemoiTrainer
from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config
from test_torch_ensemble import SameNoise, noise_arrays
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

JAX_CONFIG_DIR = os.path.join(os.path.dirname(anemoi_tpu.__file__), "config")
GNN_DEFAULTS = """defaults:
  - data: synthetic
  - dataloader: default
  - diagnostics: default
  - graph: multi_scale
  - model: gnn
  - task: forecaster
  - training: default
  - _self_
"""
_SMALL_DATA = ["data.datasets.data.nodes.grid=o8", "data.datasets.data.num_times=16",
               "graph.recipe.nodes.data.node_builder.grid=o8"]
_SMALL_MESH = ["graph.recipe.nodes.hidden.node_builder.resolution=1"]
RUN = ["training.max_steps=2", "training.max_epochs=1", "training.precision=fp32",
       "model.inference_precision=fp32", "dataloader.batch_size=1", "diagnostics.log_interval=1",
       "model.num_channels=32", "model.graph_attention_backend=segment", "hardware.platform=cpu"]
LR_ONLY = "diagnostics.callbacks=[{name: LearningRateMonitor}]"
PER_TIMESTEP = "diagnostics.callbacks=[{name: LearningRateMonitor}, {name: PerTimestepMetrics}]"


def composed(path, search, overrides, tmp_path, name):
    """The config composed by both packages (equal), run in ``tmp_path/name``."""
    run = overrides + RUN + [f"graph.save_path={tmp_path / 'graph.npz'}",
                             f"output_dir={tmp_path / name}"]
    cfg = load_config(str(path), run, search_paths=[search]).to_dict()
    ref = jax_load_config(str(path), run, search_paths=[JAX_CONFIG_DIR]).to_dict()
    assert cfg == ref
    cfg["hardware"]["num_devices"] = 1
    return cfg


def train_both(tmp_path, make_config, same_noise=None):
    """Both trainers from the JAX trainer's initial weights; their
    ``metrics.jsonl`` records.  ``same_noise()``, called once the JAX
    trainer has initialised its model, makes both draw the same noise."""
    jax_cfg = make_config("jax")
    jax_trainer = JaxTrainer(jax_cfg, output_dir=jax_cfg["output_dir"])
    initial = jax.device_get(jax_trainer.state.params)
    if same_noise is not None:
        same_noise()
    jax_trainer.train()
    port_cfg = make_config("port")
    port_trainer = AnemoiTrainer(port_cfg, output_dir=port_cfg["output_dir"])
    with torch.no_grad():
        port_trainer.interface.load_state_dict(state_dict_from_jax(initial), strict=True)
    port_trainer.train()

    def records(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    return records("jax"), records("port"), port_trainer


def assert_records_equal(ref, ours, steps=2):
    """Every step's loss, grad norm and rate, and every validation record's
    loss and metrics, within 1e-4."""
    assert len([r for r in ours if "loss" in r]) == steps
    ref = [r for r in ref if "loss" in r or "val_loss" in r]
    ours = [r for r in ours if "loss" in r or "val_loss" in r]
    assert len(ref) == len(ours)
    for a, b in zip(ref, ours):
        keys = sorted(k for k in a if k in ("loss", "grad_norm", "lr", "val_loss")
                      or k.startswith("rmse/"))
        assert keys and keys == sorted(k for k in b if k in keys or k.startswith("rmse/"))
        assert np.isfinite([b[k] for k in keys]).all()
        np.testing.assert_allclose([b[k] for k in keys], [a[k] for k in keys], rtol=1e-4,
                                   err_msg=str(keys))
    return ours


PRESETS = {  # preset -> (overrides, model, processor, members)
    "point_wise": ([LR_ONLY], "AnemoiModelEncProcDec", "PointWiseMLPProcessor", 1),
    "autoencoder": ([LR_ONLY], "AnemoiModelAutoEncoder", "PointWiseMLPProcessor", 1),
    "temporal_downscaler": ([PER_TIMESTEP], "AnemoiModelEncProcDec",
                            "GraphTransformerProcessor", 1),
    # PerTimestepMetrics, a deterministic rollout, cannot run a noise-drawing
    # model in either package (as RolloutEvalCallback)
    "temporal_downscaler_ensemble": ([LR_ONLY, "training.ensemble_size=2"],
                                     "AnemoiEnsModelEncProcDec", "GraphTransformerProcessor", 2),
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_trains_as_jax_trains_it(tmp_path, monkeypatch, preset):
    extra, model_name, processor, members = PRESETS[preset]
    overrides = _SMALL_DATA + _SMALL_MESH + ["model.processor.num_layers=1", *extra]
    path = os.path.join(PACKAGED_CONFIG_DIR, f"{preset}.yaml")
    # the same draws, in turn: one a step, one a validation batch
    noise = (lambda: SameNoise(monkeypatch, noise_arrays(4, 3, (members, 42, 8)))
             if members > 1 else None)
    ref, ours, trainer = train_both(
        tmp_path, lambda name: composed(path, PACKAGED_CONFIG_DIR, overrides, tmp_path, name),
        noise)
    model = trainer.interface.model
    assert type(model).__name__ == model_name
    assert type(model.processor).__name__ == processor
    assert (model.graph.processor.num_edges == 0) == (processor == "PointWiseMLPProcessor")
    ours = assert_records_equal(ref, ours)
    if preset == "temporal_downscaler":
        val = [r for r in ours if "val_loss" in r][-1]
        assert {"rmse/data/t/t_1", "rmse/data/t/t_2", "rmse/data/sfc/1"} <= set(val)


def test_gnn_config_trains_as_jax_trains_it(tmp_path):
    cfg_file = tmp_path / "gnn.yaml"
    cfg_file.write_text(GNN_DEFAULTS)
    overrides = _SMALL_DATA + _SMALL_MESH + ["model.processor.num_layers=2", LR_ONLY]
    ref, ours, trainer = train_both(
        tmp_path, lambda name: composed(cfg_file, PACKAGED_CONFIG_DIR, overrides, tmp_path,
                                        name))
    model = trainer.interface.model
    assert type(model.processor).__name__ == "GNNProcessor" and len(model.processor.proc) == 2
    assert type(model.encoder["data"]).__name__ == "GNNForwardMapper"
    assert_records_equal(ref, ours)
