"""The limited-area and stretched-grid presets, ``lam.yaml`` and
``stretched.yaml``, trained by the port's and the JAX package's trainers.

Each is composed by both packages with ``tests/test_config_presets.py``'s
cuts (``TINY_PER_EXPERIMENT``: an o8 grid with 16 times, an ico-2 mesh
clipped to the o8 grid with a 2 000 km margin for ``lam``, ico-1 outside
and ico-2 inside the cap for ``stretched``), one processor layer, 32
channels, float32 and the ``LearningRateMonitor`` alone, and trained two
steps and a validation from the JAX trainer's initial weights
(``state_dict_from_jax``); ``lam`` also at rollout 2, where the boundary is
re-forced, and ``stretched`` also with AdEMAMix and ``[InputImputer,
InputNormalizer]``, whose inference bundle must rebuild the same chain and
predict what the trained interface predicts.  Both trainers read the graph
the JAX trainer saved, so that KNN ties broken differently by the two
neighbour searches cannot part them.  Every loss, grad norm, rate and
validation metric within 1e-4.
"""

import os

import numpy as np
import pytest
import torch

from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint
from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR
from test_torch_presets_tasks import LR_ONLY, assert_records_equal, composed, train_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_SMALL_DATA = ["data.datasets.data.nodes.grid=o8", "data.datasets.data.num_times=16",
               "graph.recipe.nodes.data.node_builder.grid=o8"]
TINY = {  # test_config_presets.TINY_PER_EXPERIMENT
    "lam": _SMALL_DATA + ["graph.recipe.nodes.hidden.node_builder.resolution=2",
                          "graph.recipe.nodes.hidden.node_builder.margin_radius_km=2000.0"],
    "stretched": _SMALL_DATA + [
        "graph.recipe.nodes.hidden.node_builder.global_resolution=1",
        "graph.recipe.nodes.hidden.node_builder.lam_resolution=2"],
}
PROCESSORS = ("data.processors=[{name: InputImputer, default: mean}, "
              "{name: InputNormalizer, default: mean-std}]")
CASES = [("lam", []), ("lam", ["training.rollout.start=2", "training.rollout.max=2"]),
         ("stretched", []),
         ("stretched", ["training.optimizer={name: ademamix, alpha_warmup: 2, b3_warmup: 2}",
                        PROCESSORS])]


@pytest.mark.parametrize("preset,extra", CASES, ids=["lam", "lam_rollout_2", "stretched",
                                                     "stretched_ademamix_imputer"])
def test_lam_preset_trains_as_jax_trains_it(tmp_path, preset, extra):
    overrides = TINY[preset] + ["model.processor.num_layers=1", LR_ONLY, *extra]
    path = os.path.join(PACKAGED_CONFIG_DIR, f"{preset}.yaml")
    ref, ours, trainer = train_both(
        tmp_path, lambda name: composed(path, PACKAGED_CONFIG_DIR, overrides, tmp_path, name))
    mask = trainer.graph["data"].attributes["cutout_mask"].reshape(-1)
    assert 0 < mask.sum() < mask.size  # a real area, inside a global grid
    np.testing.assert_array_equal(trainer.output_masks["data"].mask, mask)
    assert "output_mask" in trainer.losses["data"].scalers
    assert_records_equal(ref, ours)
    if PROCESSORS not in extra:
        return
    assert type(trainer.state.optimizer.opt).__name__ == "AdEMAMix"
    bundle = load_inference_checkpoint(str(tmp_path / "port" / "inference"), device="cpu")
    chain = [type(p).__name__ for p in bundle.pre_processors["data"].processors]
    assert chain == [type(p).__name__ for p in trainer.interface.pre_processors["data"].processors]
    assert chain == ["InputImputer", "InputNormalizer"]
    trainer.datamodule.set_rollout(1)
    window = trainer.datamodule.make_batch(trainer.datamodule.train_starts[:1])["data"]
    window[0, :, 0, :5, 0] = np.nan  # an imputed variable, NaN at five points
    batch = {"data": torch.from_numpy(window)}
    got = bundle.predict_step(batch)["data"]
    want = trainer.interface.predict_step(batch)["data"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert torch.isnan(got[0, 0, 0, :5, 0]).all() and torch.isfinite(got[0, 0, 0, 5:]).all()
