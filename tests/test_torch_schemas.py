"""The port's config validation (plain functions) against the JAX
package's pydantic schemas.

Every packaged preset, composed by each package's ``load_config``, is
accepted by both; every failing case of tests/test_schemas.py and a set of
type, bound and coercion cases are refused by both, the port's
``ConfigValidationError.path`` equal to the location of the first error of
JAX's ``ValidationError``; ``cli validate`` accepts and refuses alike.
"""

import copy
import os

import pytest

import anemoi_tpu
from anemoi_tpu.training.schemas import validate_config as jax_validate
from anemoi_tpu.utils.config import load_config as jax_load_config
from anemoi_tpu_torch.training.schemas import ConfigValidationError, validate_config
from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config
from tests.test_schemas import base_config
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

JAX_PACKAGED = os.path.join(os.path.dirname(anemoi_tpu.__file__), "config")
PRESETS = sorted(f for f in os.listdir(PACKAGED_CONFIG_DIR) if f.endswith(".yaml"))


@pytest.mark.parametrize("preset", PRESETS)
def test_packaged_presets_validate_in_both(preset):
    ours = load_config(os.path.join(PACKAGED_CONFIG_DIR, preset),
                       search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    ref = jax_load_config(os.path.join(JAX_PACKAGED, preset),
                          search_paths=[JAX_PACKAGED]).to_dict()
    assert ours == ref
    jax_validate(ref)
    assert validate_config(ours) is ours


def edit(cfg, path, value):
    node = cfg
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value
    return cfg


CASES = {
    # tests/test_schemas.py
    "shard_strategy": (("model", "shard_strategy"), "edge"),
    "backend": (("model", "graph_attention_backend"), "triton"),
    "model_name": (("model", "name"), "AnemoiModelEncProcDecTypo"),
    "bounding": (("model", "bounding"), [{"name": "ReluBound"}]),
    "processor": (("model", "processor"), {"name": "GraphTransformerProc"}),
    "encoder": (("model", "encoder"), {"name": "GTForwardMapper"}),
    "loss": (("training", "loss"), {"name": "WeightedMSELos"}),
    "scaler": (("training", "scalers"), {"area": {"name": "GraphNodeAttrScaler"}}),
    "preprocessor": (("data", "processors"), [{"name": "InputNormaliser"}]),
    "hardware": (("hardware",), {"num_devices": 8, "num_devices_per_model": 3}),
    "rollout": (("training", "rollout"), {"start": 4, "max": 2}),
    "node_builder": (("graph",), {"recipe": {"nodes": {"data": {"node_builder": {
        "name": "ReducedGaussianNodes"}}}}}),
    "edge_builder": (("graph",), {"recipe": {"edges": [{"source_name": "a", "target_name": "b",
                                                        "edge_builder": {"name": "CutoffEdges"}}]}}),
    "overlap": (("data", "diagnostic"), ["cos_lat"]),
    # types, bounds and the other field checks
    "channels_fraction": (("model", "num_channels"), 16.5),
    "channels_zero": (("model", "num_channels"), 0),
    "heads_string": (("model", "processor"), {"num_heads": "many"}),
    "paged_block": (("model", "paged_block"), [8, 8]),
    "inference_precision": (("model", "inference_precision"), "fp8"),
    "remat_policy": (("model", "processor"), {"remat_policy": "everything"}),
    "mlp_implementation": (("model", "processor"), {"mlp_implementation": "kan"}),
    "qk_norm_type": (("model", "encoder"), {"qk_norm_type": "batchnorm"}),
    "lr_rate": (("training", "lr"), {"rate": 0}),
    "clip": (("training", "gradient_clip"), {"algorithm": "max"}),
    "b1": (("training", "optimizer"), {"b1": 1.0}),
    "precision": (("training", "precision"), "fp16"),
    "task": (("training", "task"), "nowcaster"),
    "combined_member": (("training", "loss"), {"name": "CombinedLoss",
                                              "losses": [{"name": "WeightedMSELoss"},
                                                         {"name": "Nope"}]}),
    "transport": (("training", "transport"), {"objective": "flow"}),
    "max_epochs": (("training", "max_epochs"), 0),
    "validation_fraction": (("dataloader", "validation_fraction"), 1.0),
    "prefetch": (("dataloader", "prefetch"), -1),
    "log_interval": (("diagnostics", "log_interval"), "often"),
    "callbacks": (("diagnostics", "callbacks"), {"name": "x"}),
    "dataset_kind": (("data", "datasets", "data", "kind"), "grib"),
    "forcing_type": (("data", "forcing"), "cos_lat"),
    "residual": (("model", "residual"), {"name": "SkipConection"}),
    "noise_injector": (("model", "noise_injector"), {"name": "Noise"}),
    "edge_attribute": (("graph",), {"recipe": {"edges": [{"edge_builder": {"name": "KNNEdges"},
                                                          "attributes": {"d": {
                                                              "name": "EdgeLen"}}}]}}),
    "trainable": (("model", "trainable_parameters"), {"data": -1}),
    "save_path": (("graph", "save_path"), 3),
    "no_data": ((), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_refused_alike(case):
    path, value = CASES[case]
    cfg = base_config()
    if case == "overlap":
        cfg["data"]["forcing"] = ["cos_lat"]
    if case == "no_data":
        del cfg["data"]
    else:
        edit(cfg, path, value)
    with pytest.raises(Exception) as ref:
        jax_validate(copy.deepcopy(cfg))
    with pytest.raises(ConfigValidationError) as ours:
        validate_config(cfg)
    assert isinstance(ours.value, ValueError)
    assert ours.value.path == tuple(ref.value.errors()[0]["loc"]), (ours.value, ref.value)


@pytest.mark.parametrize("path,value", [
    (("model", "num_channels"), "32"), (("model", "num_channels"), 32.0),
    (("model", "latent_skip"), "yes"), (("model", "latent_skip"), 0),
    (("training", "lr"), {"rate": "1e-3"}), (("hardware",), {"num_devices": 8,
                                                            "num_devices_per_model": 2,
                                                            "num_devices_per_ensemble": 2}),
    (("model", "paged_block"), [64, 16, 2]), (("training", "rollout"), {"start": 2, "max": 3}),
])
def test_accepted_alike(path, value):
    cfg = edit(base_config(), path, value)
    jax_validate(copy.deepcopy(cfg))
    validate_config(cfg)


def test_cli_validate_matches_jax(tmp_path, capsys):
    import json

    from anemoi_tpu.training.cli import main as jax_main
    from anemoi_tpu_torch.training.cli import main

    good = tmp_path / "good.json"
    good.write_text(json.dumps(base_config()))
    for fn in (jax_main, main):
        capsys.readouterr()
        assert fn(["validate", str(good)]) == 0
        assert "config OK" in capsys.readouterr().out
    args = ["validate", str(good), "training.rollout.start=4", "training.rollout.max=2"]
    with pytest.raises(Exception, match="rollout"):
        jax_main(args)
    assert main(args) == 1
    assert "training.rollout" in capsys.readouterr().out
