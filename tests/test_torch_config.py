"""The port's config system against the JAX package's (PyYAML) one.

- every packaged preset composed by ``anemoi_tpu.utils.config.load_config``
  and by the port's ``load_config`` gives equal dicts, with and without
  overrides;
- every one of the 49 packaged YAML files, read by the port's
  ``read_yaml``, equals ``yaml.safe_load`` of it (anchors and aliases
  included), and the port's copies are byte-identical to the JAX package's;
- YAML outside the subset raises with its file and line; ``dump_yaml``
  writes what both readers read back equal;
- ``config list`` and ``config generate`` (the port's CLI) round-trip;
- ``multi.yaml`` (two datasets on two grids), its grids overridden small,
  trains two steps through both packages' trainers with equal losses.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax

import anemoi_tpu
from anemoi_tpu.training.cli import main as jax_main
from anemoi_tpu.training.trainer import AnemoiTrainer as JaxTrainer
from anemoi_tpu.utils.config import load_config as jax_load_config
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training.cli import main
from anemoi_tpu_torch.training.trainer import AnemoiTrainer
from anemoi_tpu_torch.utils.config import (
    PACKAGED_CONFIG_DIR,
    YAMLSubsetError,
    dump_yaml,
    load_config,
    read_yaml,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

JAX_CONFIG_DIR = os.path.join(os.path.dirname(anemoi_tpu.__file__), "config")
FILES = sorted(os.path.relpath(p, JAX_CONFIG_DIR)
               for p in glob.glob(os.path.join(JAX_CONFIG_DIR, "**", "*.yaml"), recursive=True))
PRESETS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(JAX_CONFIG_DIR, "*.yaml")))


def test_packaged_files():
    assert len(FILES) == 49 and len(PRESETS) == 16
    ours = sorted(os.path.relpath(p, PACKAGED_CONFIG_DIR) for p in glob.glob(
        os.path.join(PACKAGED_CONFIG_DIR, "**", "*.yaml"), recursive=True))
    assert ours == FILES


@pytest.mark.parametrize("rel", FILES)
def test_file_reads_as_pyyaml_reads_it(rel):
    with open(os.path.join(JAX_CONFIG_DIR, rel), "rb") as f:
        raw = f.read()
    with open(os.path.join(PACKAGED_CONFIG_DIR, rel), "rb") as f:
        assert f.read() == raw, f"{rel}: the copy differs from the JAX package's"
    text = raw.decode()
    ref = yaml.safe_load(text)
    assert read_yaml(text, rel) == ref
    assert read_yaml(dump_yaml(ref)) == ref and yaml.safe_load(dump_yaml(ref)) == ref


def test_anchors_and_aliases():
    text = open(os.path.join(PACKAGED_CONFIG_DIR, "graph", "icon_mesh.yaml")).read()
    cfg = read_yaml(text)
    assert cfg == yaml.safe_load(text)
    assert cfg["recipe"]["nodes"]["hidden"]["node_builder"] == {
        "name": "ICONMultiMeshNodes", "grid_filename": "/path/to/icon_grid.nc", "max_level": 3}
    shared = read_yaml("a: &x {k: [1, 2]}\nb: *x\nc:\n  - &y\n    m: 1\n  - *y\n")
    assert shared["b"] is shared["a"] and shared["c"][1] is shared["c"][0]


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_composes_as_jax_composes_it(preset):
    ref = jax_load_config(os.path.join(JAX_CONFIG_DIR, preset),
                          search_paths=[JAX_CONFIG_DIR]).to_dict()
    ours = load_config(os.path.join(PACKAGED_CONFIG_DIR, preset),
                       search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    assert ours == ref


def test_overrides_on_yaml_configs():
    overrides = ["model.num_channels=64", "training.rollout.max=3", "training.lr.rate=1e-3",
                 "training.scalers.level=null", "data.forcing=[cos_lat, z]",
                 "model.processor.remat_policy=save_attention_mlp", "new.key={a: 1, b: [x]}"]
    ref = jax_load_config(os.path.join(JAX_CONFIG_DIR, "example_o96_gt.yaml"), overrides,
                          search_paths=[JAX_CONFIG_DIR]).to_dict()
    ours = load_config(os.path.join(PACKAGED_CONFIG_DIR, "example_o96_gt.yaml"), overrides,
                       search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    assert ours == ref
    assert ours["training"]["lr"]["rate"] == 1e-3 and ours["new"]["key"] == {"a": 1, "b": ["x"]}


def test_user_file_composes_from_its_folder_then_the_packaged_presets(tmp_path):
    (tmp_path / "model").mkdir()
    (tmp_path / "model" / "base.yaml").write_text("num_channels: 32\nprocessor: {num_layers: 4}\n")
    (tmp_path / "model" / "mine.yaml").write_text(  # composed within its group's folder
        "defaults:\n  - base\n  - _self_\nnum_channels: 48\n")
    (tmp_path / "exp.yaml").write_text(
        "defaults:\n- model: mine\n- training: default\n- _self_\ntraining:\n  max_epochs: 3\n")
    ours = load_config(str(tmp_path / "exp.yaml"), search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    ref = jax_load_config(str(tmp_path / "exp.yaml"), search_paths=[JAX_CONFIG_DIR]).to_dict()
    assert ours == ref
    assert ours["model"] == {"num_channels": 48, "processor": {"num_layers": 4}}
    assert ours["training"]["max_epochs"] == 3 and ours["training"]["remat_rollout"] is True


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: |\n  text\n", 2),
    ("a: 1\nb: >\n  text\n", 2),
    ("a: !!str 1\n", 1),
    ("a: 1\n---\nb: 2\n", 2),
    ("x: 1\n? a\n: b\n", 2),
    ("a: b\n  c\n", 2),
    ("a: b: c\n", 1),
    ("a:\n  b: 1\n c: 2\n", 3),
    ("a: 2020-01-01\n", 1),
    ("a: [0x1F]\n", 1),
    ("a: 017\n", 1),
    ("a: 1:30\n", 1),
    ("a: *missing\n", 1),
    ("a: \"bad \\q escape\"\n", 1),
    ("a: [1, 2]x\n", 1),
    ("a:\n\tb: 1\n", 2),
], ids=["literal", "folded", "tag", "documents", "complex-key", "multiline-plain",
        "nested-value", "indent", "date", "hex", "octal", "sexagesimal", "alias",
        "escape", "trailing", "tab"])
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(YAMLSubsetError, match=f"^f.yaml:{line}: "):
        read_yaml(text, "f.yaml")


def test_dump_round_trip_of_awkward_values():
    data = {"s": ["x: y", "- z", "", " pad", "#c", "1", "1.0", "yes", "null", "2020-01-01",
                  "a #b", "é", "tab\there", "k:", "~", "0x1", "it's", 'q"'],
            1: 1e-5, 2.5: -0.0, "f": [float("inf"), -float("inf"), 3.0, 1e20],
            "n": [[], {}, [1, [2, {"c": None}]], {"d": {"e": True}}], "b": False}
    assert read_yaml(dump_yaml(data)) == data
    assert yaml.safe_load(dump_yaml(data)) == data


def test_cli_config_list(capsys):
    assert main(["config", "list"]) == 0
    ours = capsys.readouterr().out.split()
    assert jax_main(["config", "list"]) == 0
    assert ours == capsys.readouterr().out.split()
    assert sorted(ours) == FILES


def test_cli_config_generate_round_trips(tmp_path, capsys):
    preset = os.path.join(PACKAGED_CONFIG_DIR, "transformer.yaml")
    out = tmp_path / "composed.yaml"
    overrides = ["model.num_channels=64", "training.rollout.max=2"]
    assert main(["config", "generate", preset, *overrides, "--output", str(out)]) == 0
    composed = load_config(preset, overrides, search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    assert read_yaml(out.read_text()) == composed
    assert load_config(str(out)).to_dict() == composed
    assert jax_load_config(str(out)).to_dict() == composed
    capsys.readouterr()
    assert main(["config", "generate", str(out)]) == 0
    assert read_yaml(capsys.readouterr().out) == composed


def multi_config(tmp_path, name):
    """``multi.yaml`` with its grids, mesh, widths and run cut small."""
    overrides = [
        "data.datasets.era.nodes.grid=o16", "data.datasets.obs.nodes.grid=o8",
        "data.datasets.era.num_times=16", "data.datasets.obs.num_times=16",
        "graph.recipe.nodes.era.node_builder.grid=o16",
        "graph.recipe.nodes.obs.node_builder.grid=o8",
        "graph.recipe.nodes.hidden.node_builder.resolution=1",
        "model.num_channels=16", "model.processor.num_layers=1",
        "model.graph_attention_backend=segment", "model.inference_precision=fp32",
        "training.max_steps=2", "training.max_epochs=1", "training.precision=fp32",
        "dataloader.batch_size=1", "diagnostics.log_interval=1", "hardware.platform=cpu",
        f"graph.save_path={tmp_path / 'graph.npz'}", f"output_dir={tmp_path / name}",
    ]
    cfg = load_config(os.path.join(PACKAGED_CONFIG_DIR, "multi.yaml"), overrides,
                      search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    ref = jax_load_config(os.path.join(JAX_CONFIG_DIR, "multi.yaml"), overrides,
                          search_paths=[JAX_CONFIG_DIR]).to_dict()
    assert cfg == ref
    cfg["hardware"]["num_devices"] = 1
    return cfg


def test_multi_dataset_preset_trains_as_jax_trains_it(tmp_path):
    jax_cfg = multi_config(tmp_path, "jax")
    jax_trainer = JaxTrainer(jax_cfg, output_dir=jax_cfg["output_dir"])
    initial = jax.device_get(jax_trainer.state.params)
    jax_trainer.train()
    port_cfg = multi_config(tmp_path, "port")
    port_trainer = AnemoiTrainer(port_cfg, output_dir=port_cfg["output_dir"])
    assert sorted(port_trainer.interface.data_indices) == ["era", "obs"]
    with torch.no_grad():
        port_trainer.interface.load_state_dict(state_dict_from_jax(initial, ["era", "obs"]),
                                               strict=True)
    port_trainer.train()

    def losses(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return [json.loads(line)["loss"] for line in f if '"loss"' in line]

    ref, ours = losses("jax"), losses("port")
    assert len(ref) == 2 and len(ours) == 2 and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
