"""The port's CLI end to end on the CPU: ``train`` (a JSON config with
dotted overrides) -> ``checkpoint inspect`` -> ``evaluate`` -> ``predict``,
``config generate``, and a YAML config trained and evaluated at rollout 2
through ``anemoi_tpu_torch.training.cli.main`` with
``hardware.platform=cpu``, the packaged example shrunk to an o8 grid, a
level-1 mesh, 16 channels and 1 processor layer, reading a zarr store
written by the port.  ``validate``, ``mlflow login|sync``, ``profile`` and
``checkpoint migrate`` against the JAX package's CLI; a bundle with a
migration pending serves as JAX serves it.  Without a platform, ``train``
and ``predict`` raise when no card is visible."""

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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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
    """No longer refused: ``load_inference_checkpoint`` applies the pending
    migrations.  The port's own bundle with all but the first marked pending
    serves the same forecast bit for bit; the committed JAX fixture (one
    migration pending, a float32 copy) forecasts through ``cli predict`` as
    the JAX package's ``predict`` does (rtol/atol 3e-5)."""
    import os
    import shutil

    from anemoi_tpu.training.cli import main as jax_main

    _, tmp, _ = cli_run
    bundle = tmp_path / "old"
    shutil.copytree(tmp / "run" / "inference", bundle)
    meta = json.loads((bundle / "checkpoint.json").read_text())
    meta["metadata"]["migrations"] = list(MIGRATION_NAMES[:1])
    (bundle / "checkpoint.json").write_text(json.dumps(meta))
    forecasts = {}
    for label, path in (("old", bundle), ("current", tmp / "run" / "inference")):
        out = tmp_path / f"{label}.npz"
        assert main(["predict", str(path), "--steps", "2", "--output", str(out),
                     "--platform", "cpu"]) == 0
        forecasts[label] = np.load(out)["data|forecast"]
    np.testing.assert_array_equal(forecasts["old"], forecasts["current"])
    assert load_inference_checkpoint(str(bundle), device="cpu").metadata["migrations"] == \
        list(MIGRATION_NAMES)

    fixture = tmp_path / "fixture"
    shutil.copytree(os.path.join(os.path.dirname(__file__), "fixtures", "inference_ckpt_r2"),
                    fixture)
    meta = json.loads((fixture / "checkpoint.json").read_text())
    meta["config"]["model"]["inference_precision"] = "fp32"
    (fixture / "checkpoint.json").write_text(json.dumps(meta))
    data = tmp_path / "data.json"
    data.write_text(json.dumps({"data": {"datasets": {"data": {
        "kind": "synthetic", "nodes": {"name": "ReducedGaussianGridNodes", "grid": "o8"},
        "variables": list(meta["data_indices"]["data"]["name_to_index"]), "num_times": 8}}}}))
    for label, fn in (("jax", jax_main), ("port", main)):
        assert fn(["predict", str(fixture), "--config", str(data), "--steps", "2",
                   "--output", str(tmp_path / f"{label}.npz"), "--platform", "cpu"]) == 0
    ours = np.load(tmp_path / "port.npz")["data|forecast"]
    ref = np.load(tmp_path / "jax.npz")["data|forecast"]
    assert ours.shape == ref.shape == (1, 2, 1, 544, 5) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=3e-5, atol=3e-5)


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


def run_both_clis(argv_of, capsys):
    """The JAX package's CLI, then the port's: (rc, stdout) of each."""
    from anemoi_tpu.training.cli import main as jax_main

    out = {}
    for label, fn in (("jax", jax_main), ("port", main)):
        capsys.readouterr()
        rc = fn(argv_of(label))
        out[label] = (rc, capsys.readouterr().out)
    return out


def subcommand_case(kind, tmp_path, monkeypatch):
    """(argv of each CLI, the outputs' normaliser, a check of both runs)."""
    import os
    import shutil

    from tests.test_torch_trainer import tiny_config

    if kind == "validate":
        cfg = tmp_path / "cfg.json"
        cfg.write_text(json.dumps(tiny_config(tmp_path, "run")))
        return lambda label: ["validate", str(cfg)], None, None
    if kind == "checkpoint":
        for label in ("jax", "port"):
            shutil.copytree(os.path.join(os.path.dirname(__file__), "fixtures",
                                         "inference_ckpt_r2"), tmp_path / label)

        def check(_):
            a, b = (json.loads((tmp_path / lb / "checkpoint.json").read_text())
                    for lb in ("jax", "port"))
            assert a == b and len(b["metadata"]["migrations"]) == len(MIGRATION_NAMES)

        return (lambda label: ["checkpoint", "migrate", str(tmp_path / label)],
                lambda text: text.replace(str(tmp_path), "<tmp>"), check)
    if kind == "profile":
        cfg = tiny_config(tmp_path, "profile")
        cfg["diagnostics"]["callbacks"] = []
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(cfg))

        def check(_):
            reports = [json.loads((tmp_path / lb / "profile" / "profiler_report.json")
                                  .read_text()) for lb in ("jax", "port")]
            assert sorted(reports[0]) == sorted(reports[1])
            stores = [os.listdir(tmp_path / f"store_{lb}") for lb in ("jax", "port")]
            assert stores[0] == stores[1] and len(stores[1]) == 1

        return (lambda label: ["profile", str(path), "--steps", "2", "--output-dir",
                               str(tmp_path / label), "--benchmark-store",
                               str(tmp_path / f"store_{label}")],
                lambda text: "\n".join(line.split(":")[0] for line in text.splitlines()),
                check)
    # mlflow login, then sync with the saved login, against a stub server
    from http.server import HTTPServer
    import threading

    from anemoi_tpu_torch.training.mlflow_store import OfflineMLflowRun
    from tests.test_torch_profiler_stores import _Stub

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    run = OfflineMLflowRun(str(tmp_path / "mlruns"), experiment="exp", run_name="r")
    run.log_params({"a": 1})
    run.log_metric("loss", 0.5, 1)
    run.finalize()
    srv = HTTPServer(("127.0.0.1", 0), _Stub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    uri = f"http://127.0.0.1:{srv.server_port}"
    _Stub.calls, _Stub.runs = [], {}

    def argv(label):
        assert main(["mlflow", "login", "--uri", uri, "--token", "t"]) == 0
        _Stub.runs = {}
        return ["mlflow", "sync", str(tmp_path / "mlruns")]

    def check(outputs):
        srv.shutdown()
        srv.server_close()
        assert all(auth == "Bearer t" for _, _, auth in _Stub.calls)
        assert sum(path.endswith("runs/create") for path, _, _ in _Stub.calls) == 2

    return argv, lambda text: text.replace(str(tmp_path), "<tmp>"), check


@pytest.mark.parametrize("argv", [["validate"], ["mlflow", "sync"], ["profile"],
                                  ["checkpoint", "migrate"]])
def test_unported_subcommands_return_2(argv, tmp_path, monkeypatch, capsys):
    """The subcommands that once returned 2 here, against the JAX CLI: the
    same exit code and output (``profile``: the same lines and report
    sections; ``mlflow sync``: the same runs pushed, with the saved login)."""
    argv_of, normalise, check = subcommand_case(argv[0], tmp_path, monkeypatch)
    outputs = run_both_clis(argv_of, capsys)
    assert outputs["port"][0] == outputs["jax"][0] == 0
    if normalise is not None:
        outputs = {k: (rc, normalise(text)) for k, (rc, text) in outputs.items()}
    assert outputs["port"] == outputs["jax"]
    if check is not None:
        check(outputs)


def test_no_platform_needs_the_card(cli_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid here")
    _, tmp, cfg_path = cli_run
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", str(cfg_path), "training.max_steps=1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["predict", str(tmp / "run" / "inference"), "--steps", "1",
              "--output", str(tmp / "x.npz")])
