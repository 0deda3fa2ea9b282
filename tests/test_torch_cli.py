"""The port's CLI end to end on the CPU: ``train`` (a JSON config with
dotted overrides) -> ``checkpoint inspect`` -> ``evaluate`` -> ``predict``,
``config generate``, and a YAML config trained and evaluated at rollout 2
through ``anemoi_tpu_torch.training.cli.main`` with
``hardware.platform=cpu``, the packaged example shrunk to an o8 grid, a
level-1 mesh, 16 channels and 1 processor layer, reading a zarr store
written by the port.  The subcommands that are not ported return 2; without
a platform, ``train`` and ``predict`` raise when no card is visible."""

import json

import numpy as np
import pytest
import torch

from anemoi_tpu_torch.data.dataset import open_dataset
from anemoi_tpu_torch.data.zarr_reader import save_zarr_dataset
from anemoi_tpu_torch.flagship import EXAMPLE_VARIABLES, example_o96_gt_config
from anemoi_tpu_torch.training.checkpoint import MIGRATION_NAMES, load_inference_checkpoint
from anemoi_tpu_torch.training.cli import main
from anemoi_tpu_torch.utils.config import dump_yaml, load_config, read_yaml

OVERRIDES = ["hardware.platform=cpu", "training.max_steps=3", "training.max_epochs=1",
             "diagnostics.log_interval=1", "dataloader.prefetch=2"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    cfg = example_o96_gt_config(num_channels=16, num_layers=1, precision="bf16", grid="o8",
                                mesh_resolution=1, num_times=24)
    synthetic = open_dataset(dict(cfg["data"]["datasets"]["data"]))
    fields = synthetic.get_window(0, 24).transpose(0, 3, 1, 2)  # [T, V, E, G]
    save_zarr_dataset(str(tmp / "data.zarr"), fields, synthetic.variables,
                      np.rad2deg(synthetic.latitudes), np.rad2deg(synthetic.longitudes))
    cfg["data"]["datasets"]["data"] = {"kind": "zarr", "path": str(tmp / "data.zarr")}
    cfg["graph"]["save_path"] = str(tmp / "graph.npz")
    cfg["output_dir"] = str(tmp / "run")
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    rc = main(["train", str(cfg_path)] + OVERRIDES)
    return rc, tmp, cfg_path


def test_cli_train(cli_run):
    rc, tmp, _ = cli_run
    assert rc == 0
    recs = [json.loads(line) for line in open(tmp / "run" / "metrics.jsonl")]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps)
    val = [r for r in recs if "val_loss" in r]
    assert val and any(k.startswith("rmse/data/") for k in val[-1])
    assert (tmp / "run" / "checkpoints" / "ckpt_3.pt").exists()
    assert (tmp / "run" / "inference" / "checkpoint.json").exists()
    assert (tmp / "graph.npz").exists()


def test_cli_checkpoint_inspect(cli_run, capsys):
    _, tmp, _ = cli_run
    capsys.readouterr()
    assert main(["checkpoint", "inspect", str(tmp / "run" / "inference")]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["model"] == "AnemoiModelEncProcDec"
    assert info["migrations_pending"] == []
    assert info["migrations_applied"] == list(MIGRATION_NAMES)
    assert info["datasets"] == ["data"] and info["num_params"] > 0


def test_cli_evaluate(cli_run, capsys):
    _, tmp, cfg_path = cli_run
    capsys.readouterr()
    assert main(["evaluate", str(cfg_path)] + OVERRIDES) == 0
    out = capsys.readouterr().out
    assert "evaluation:" in out and "'val_loss'" in out and "rmse/data/sfc/1" in out


def test_cli_predict(cli_run):
    _, tmp, _ = cli_run
    out = tmp / "forecast.npz"
    rc = main(["predict", str(tmp / "run" / "inference"), "--steps", "2", "--output", str(out),
               "--platform", "cpu"])
    assert rc == 0
    fc = np.load(out)
    field = fc["data|forecast"]
    assert field.shape == (1, 2, 1, 544, len(EXAMPLE_VARIABLES) - 1)
    assert np.isfinite(field).all()
    assert list(fc["data|variables"]) == [v for v in EXAMPLE_VARIABLES if v != "cos_lat"]
    # the bundle serves in bf16: parameters cast once, at load
    iface = load_inference_checkpoint(str(tmp / "run" / "inference"), device="cpu")
    assert {p.dtype for p in iface.parameters()} == {torch.bfloat16}


def test_bundle_with_pending_migrations_is_refused(cli_run, tmp_path):
    import shutil

    _, tmp, _ = cli_run
    bundle = tmp_path / "old"
    shutil.copytree(tmp / "run" / "inference", bundle)
    meta = json.loads((bundle / "checkpoint.json").read_text())
    meta["metadata"]["migrations"] = list(MIGRATION_NAMES[:1])
    (bundle / "checkpoint.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="checkpoint migrate"):
        load_inference_checkpoint(str(bundle), device="cpu")


def test_cli_config_generate_writes_the_composed_config(cli_run, tmp_path):
    _, _, cfg_path = cli_run
    out = tmp_path / "cfg.yaml"
    assert main(["config", "generate", str(cfg_path), *OVERRIDES, "--output", str(out)]) == 0
    want = load_config(str(cfg_path), OVERRIDES).to_dict()
    assert read_yaml(out.read_text()) == want
    assert load_config(str(out)).to_dict() == want


def test_cli_yaml_config_trains_and_evaluates_at_rollout_2(cli_run, tmp_path, capsys):
    """A YAML config through ``train`` with a rollout of 2 and the packaged
    remat defaults (``remat_rollout: true``, per-layer ``save_attention``),
    then ``evaluate --rollout 2``."""
    _, tmp, cfg_path = cli_run
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(dump_yaml(load_config(str(cfg_path)).to_dict()))
    assert load_config(str(cfg)).training.remat_rollout is True
    run = ["hardware.platform=cpu", "training.max_steps=1", "training.max_epochs=1",
           "diagnostics.log_interval=1",
           "training.rollout.start=2", "training.rollout.max=2", f"output_dir={tmp_path / 'r2'}"]
    assert main(["train", str(cfg), *run]) == 0
    recs = [json.loads(line) for line in open(tmp_path / "r2" / "metrics.jsonl")]
    steps = [r for r in recs if "loss" in r]
    assert [(r["step"], r["rollout"]) for r in steps] == [(1, 2)]
    assert np.isfinite(steps[0]["loss"]) and np.isfinite(steps[0]["grad_norm"])
    capsys.readouterr()
    assert main(["evaluate", str(cfg), *run, "--rollout", "2"]) == 0
    assert "rmse/data/sfc/2" in capsys.readouterr().out


def test_cli_predict_reads_a_yaml_config(cli_run, tmp_path):
    """``predict --config`` with a YAML config that composes its data from
    a ``defaults:`` entry in its own folder: the same forecast as the
    bundle's own config gives."""
    _, tmp, cfg_path = cli_run
    (tmp_path / "data").mkdir()
    data = load_config(str(cfg_path)).to_dict()["data"]
    (tmp_path / "data" / "store.yaml").write_text(dump_yaml(data))
    (tmp_path / "cfg.yaml").write_text("defaults:\n  - data: store\n")
    args = ["predict", str(tmp / "run" / "inference"), "--steps", "1", "--platform", "cpu"]
    assert main([*args, "--config", str(tmp_path / "cfg.yaml"),
                 "--output", str(tmp_path / "yaml.npz")]) == 0
    assert main([*args, "--output", str(tmp_path / "own.npz")]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "yaml.npz")["data|forecast"],
                                  np.load(tmp_path / "own.npz")["data|forecast"])


@pytest.mark.parametrize("argv", [["validate", "c.json"],
                                  ["mlflow", "sync", "runs"], ["profile", "c.json"],
                                  ["checkpoint", "migrate", "bundle"]])
def test_unported_subcommands_return_2(argv, capsys):
    assert main(argv) == 2
    assert "not ported to anemoi_tpu_torch" in capsys.readouterr().out


def test_no_platform_needs_the_card(cli_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid here")
    _, tmp, cfg_path = cli_run
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", str(cfg_path), "training.max_steps=1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["predict", str(tmp / "run" / "inference"), "--steps", "1",
              "--output", str(tmp / "x.npz")])
