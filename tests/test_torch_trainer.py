"""The port's trainer, checkpoints and serving against the JAX package.

Tiny runs of the packaged example (``example_o96_gt_config`` on an o8 grid
and a level-1 ``TriNodes`` mesh, 16 channels, 1 processor layer, float32,
a synthetic dataset of 24 times, batch 2), the JAX side on its ``segment``
backend, both in one process on one device:

- trajectory: the JAX ``AnemoiTrainer`` and the port's from the same config,
  the port's parameters copied from JAX's initial ones before ``train()``;
  every logged ``loss`` and ``grad_norm`` within rtol 1e-4, the validation
  records (``val_loss``, ``rmse/...`` of the step and of the
  ``RolloutEvalCallback`` at rollout 4) with the same keys and values within
  rtol 1e-4.  Once at rollout 1 (4 steps), once over the curriculum
  ``{start: 1, epoch_increment: 1, max: 2}`` (2 epochs, rollout 1 then 2);
- serving a JAX bundle: the port's ``predict`` on the bundle the JAX
  trainer wrote agrees with the JAX ``run_forecast_cli`` within rtol/atol
  1e-4 (both serving in float32);
- resume: save, restore into a new trainer, one step: the same parameters
  as the uninterrupted run, bit for bit;
- scalers: the example's ``area``/``variable``/``level`` scalers equal
  JAX's;
- the rollout evaluation: ``make_rollout_eval_fn`` (``rmse``, ``mse``,
  ``per_timestep``, one and two output steps) within rtol 1e-4 of JAX's;
  callbacks (early stop, time limit, EMA and SWA averages) and loggers;
- initialisation: every parameter that JAX initialises to a constant
  equals it exactly; the others have the mean and standard deviation of
  JAX's ``init_params`` within their statistical tolerance (standard
  deviation within 5 % from 4 096 elements on).
"""

import argparse
import json
import math

import numpy as np
import pytest
import torch

import flax
import jax

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.inference import run_forecast_cli as jax_run_forecast_cli
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.trainer import AnemoiTrainer as JaxTrainer
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.flagship import EXAMPLE_VARIABLES, example_o96_gt_config
from anemoi_tpu_torch.graphs.create import GraphCreator
from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.inference import run_forecast_cli
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.trainer import AnemoiTrainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-4


def tiny_config(tmp_path, name, **training):
    cfg = example_o96_gt_config(num_channels=16, num_layers=1, precision="fp32", grid="o8",
                                mesh_resolution=1, num_times=24)
    cfg["model"]["graph_attention_backend"] = "segment"
    cfg["model"]["inference_precision"] = "fp32"
    cfg["graph"]["save_path"] = str(tmp_path / "graph.npz")
    cfg["hardware"] = {"platform": "cpu", "num_devices": 1}
    cfg["dataloader"]["batch_size"] = 2
    cfg["diagnostics"]["log_interval"] = 1
    cfg["training"].update({"max_epochs": 1, **training})
    cfg["output_dir"] = str(tmp_path / name)
    return cfg


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_both(tmp_path, **training):
    """Train the JAX trainer, then the port's from JAX's initial weights."""
    jax_cfg = tiny_config(tmp_path, "jax", **training)
    jax_trainer = JaxTrainer(jax_cfg, output_dir=jax_cfg["output_dir"])
    initial = jax.device_get(jax_trainer.state.params)
    jax_trainer.train()
    port_cfg = tiny_config(tmp_path, "port", **training)
    port_trainer = AnemoiTrainer(port_cfg, output_dir=port_cfg["output_dir"])
    with torch.no_grad():
        port_trainer.interface.load_state_dict(state_dict_from_jax(initial), strict=True)
    port_trainer.train()
    return (jax_trainer, records(tmp_path / "jax" / "metrics.jsonl"),
            port_trainer, records(tmp_path / "port" / "metrics.jsonl"))


def assert_trajectories_agree(ref, ours):
    steps = [r for r in ref if "loss" in r]
    assert len(steps) == len([r for r in ours if "loss" in r]) and steps
    for want, got in zip(steps, (r for r in ours if "loss" in r)):
        assert (got["step"], got["epoch"], got["rollout"]) == (want["step"], want["epoch"],
                                                              want["rollout"])
        for key in ("loss", "grad_norm", "lr"):
            assert math.isfinite(got[key])
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=f"{key} {want}")
    vals = [r for r in ref if "val_loss" in r]
    ours_vals = [r for r in ours if "val_loss" in r]
    assert len(vals) == len(ours_vals) and vals
    for want, got in zip(vals, ours_vals):
        assert sorted(got) == sorted(want)
        assert any(k.startswith("rmse/data/") and k.endswith("/4") for k in want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


@pytest.fixture(scope="module")
def rollout1(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rollout1")
    return tmp, run_both(tmp, max_steps=4)


def test_trainer_trajectory_rollout1(rollout1):
    _, (_, ref, _, ours) = rollout1
    assert [r["step"] for r in ours if "loss" in r] == [1, 2, 3, 4]
    assert_trajectories_agree(ref, ours)


def test_trainer_trajectory_rollout_curriculum(tmp_path):
    _, ref, port_trainer, ours = run_both(
        tmp_path, max_epochs=2,
        rollout={"start": 1, "epoch_increment": 1, "max": 2})
    assert {r["rollout"] for r in ours if "loss" in r} == {1, 2}
    assert_trajectories_agree(ref, ours)
    assert port_trainer.datamodule.rollout >= 2


def test_port_serves_a_jax_bundle(rollout1, tmp_path):
    tmp, _ = rollout1
    args = dict(checkpoint=str(tmp / "jax" / "inference"), config=None, steps=2, start_index=3,
                seed=0, aot_cache=None)
    jax_run_forecast_cli(argparse.Namespace(output=str(tmp_path / "jax.npz"), platform=None,
                                            **args))
    run_forecast_cli(argparse.Namespace(output=str(tmp_path / "port.npz"), platform="cpu",
                                        **args))
    ref, ours = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(ours.files) == sorted(ref.files) == ["data|forecast", "data|variables"]
    assert ours["data|forecast"].shape == (1, 2, 1, 544, len(EXAMPLE_VARIABLES) - 1)
    np.testing.assert_array_equal(ours["data|variables"], ref["data|variables"])
    np.testing.assert_allclose(ours["data|forecast"], ref["data|forecast"], rtol=RTOL, atol=RTOL)


def test_resume_is_bit_for_bit(tmp_path):
    cfg = tiny_config(tmp_path, "run")
    first = AnemoiTrainer(cfg, output_dir=cfg["output_dir"])
    train_step, _ = first._get_step_fns(1)
    batches = [first.put_batch(b) for _, b in zip(range(3), first.datamodule.train_batches(0))]
    for b in batches[:2]:
        train_step(first.state, b)
    first.ckpt.save(2, first.state)
    train_step(first.state, batches[2])

    cfg_resume = tiny_config(tmp_path, "run", resume=True)
    second = AnemoiTrainer(cfg_resume, output_dir=cfg_resume["output_dir"])
    assert second.state.step == 2 and second.state.optimizer.count == 2
    step2, _ = second._get_step_fns(1)
    step2(second.state, batches[2])
    assert second.state.step == first.state.step == 3
    for (name, a), (_, b) in zip(first.interface.state_dict().items(),
                                 second.interface.state_dict().items()):
        assert torch.equal(a, b), name
    sa, sb = first.state.optimizer.opt.state_dict(), second.state.optimizer.opt.state_dict()
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_checkpoint_manager_keeps_the_latest(tmp_path):
    cfg = tiny_config(tmp_path, "keep")
    cfg["diagnostics"]["checkpoint_keep"] = 2
    trainer = AnemoiTrainer(cfg, output_dir=cfg["output_dir"])
    for step in (1, 2, 3):
        trainer.ckpt.save(step, trainer.state)
    assert trainer.ckpt.steps() == [2, 3]


def test_example_scalers_equal(tmp_path):
    cfg = example_o96_gt_config(grid="o8", mesh_resolution=1)
    graph = JaxGraphCreator(cfg["graph"]["recipe"]).create(str(tmp_path / "g.npz"))
    n2i = {n: i for i, n in enumerate(EXAMPLE_VARIABLES)}
    groups = {"default": "sfc", "pl": ["q", "t", "u", "v", "z"]}
    kw = {"forcing": ["cos_lat"], "diagnostic": ["tp"]}
    scalers = dict(cfg["training"]["scalers"])
    scalers["level_pl"] = {"name": "LinearVariableLevelScaler", "group": "pl", "slope": 0.002,
                           "y_intercept": 0.1}
    scalers["poly"] = {"name": "PolynomialVariableLevelScaler", "slope": 0.003}
    scalers["none"] = {"name": "NoVariableLevelScaler", "group": "sfc"}
    scalers["weights"] = {"name": "GeneralVariableLossScaler",
                          "weights": {"default": 0.5, "q": 2.0, "t_850": 3.0}}
    scalers["mask"] = {"name": "VariableMaskingLossScaler", "variables": ["tp", "z_500"]}
    ref = jax_create_scalers(scalers, graph=graph, data_indices=JaxIndexCollection(n2i, **kw),
                             variable_groups=groups)
    ours = create_scalers(scalers, graph=Graph.load(str(tmp_path / "g.npz")),
                          data_indices=IndexCollection(n2i, **kw), variable_groups=groups)
    assert sorted(ours) == sorted(ref)
    for name, (dims, arr) in ref.items():
        assert ours[name][0] == dims
        np.testing.assert_array_equal(ours[name][1], arr, err_msg=name)


def test_no_silent_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid here")
    cfg = tiny_config(tmp_path, "nocard")
    del cfg["hardware"]
    with pytest.raises(RuntimeError, match="CUDA"):
        AnemoiTrainer(cfg, output_dir=cfg["output_dir"])
    # the ensemble axis is ported (tests/test_torch_parallel_families.py); on
    # one process it needs the ranks it names, and says so with the JAX
    # mesh's message instead of training on one rank
    cfg["hardware"] = {"platform": "cpu", "num_devices_per_ensemble": 2}
    with pytest.raises(AssertionError, match=r"not divisible by model\(1\) x ensemble\(2\)"):
        AnemoiTrainer(cfg, output_dir=cfg["output_dir"])


# --- initialisation ------------------------------------------------------
INIT_CHANNELS = 64


@pytest.fixture(scope="module")
def initialised(tmp_path_factory):
    cfg = example_o96_gt_config(num_channels=INIT_CHANNELS, num_layers=2, precision="fp32",
                                grid="o8", mesh_resolution=1)
    cfg["model"]["graph_attention_backend"] = "segment"
    cfg["model"]["decoder"]["initialise_data_extractor_zero"] = True
    graph = JaxGraphCreator(cfg["graph"]["recipe"]).create()
    n2i = {n: i for i, n in enumerate(EXAMPLE_VARIABLES)}
    kw = {"forcing": ["cos_lat"], "diagnostic": ["tp"]}
    ones = np.ones(len(n2i), np.float32)
    stats = {"data": {"mean": 0 * ones, "stdev": ones, "minimum": -ones, "maximum": ones}}
    jax_iface = JaxInterface(config=cfg, graph=graph,
                             data_indices={"data": JaxIndexCollection(n2i, **kw)},
                             statistics=stats)
    ref = state_dict_from_jax(jax.device_get(jax_iface.init_params()))
    iface = AnemoiModelInterface(config=cfg, graph=GraphCreator(cfg["graph"]["recipe"]).create(),
                                 data_indices={"data": IndexCollection(n2i, **kw)},
                                 statistics=stats, device="cpu", training=True)
    return iface.state_dict(), ref


def test_initialisation_follows_jax(initialised):
    ours, ref = initialised
    assert sorted(ours) == sorted(ref)
    n_random = 0
    for name, want in ref.items():
        got = ours[name].detach().double()
        want = want.double()
        assert got.shape == want.shape, name
        if torch.all(want == want.flatten()[0]):
            assert torch.all(got == want.flatten()[0]), f"{name}: JAX sets {float(want[0])}"
            continue
        n_random += 1
        n = want.numel()
        sd_ref = float(want.std())
        # the sample standard deviation spreads by ~1/sqrt(2n) of itself
        tol = max(0.05, 5.0 / math.sqrt(2 * n)) if n < 4096 else 0.05
        assert abs(float(got.std()) / sd_ref - 1.0) < tol, (name, float(got.std()), sd_ref)
        assert abs(float(got.mean()) - float(want.mean())) < 5.0 * sd_ref * math.sqrt(2.0 / n), name
        bound = 2.0 * (1.0 / got.shape[1]) ** 0.5 / 0.87962566103423978
        assert float(got.abs().max()) <= bound * (1 + 1e-6), name  # truncated at 2 std
    assert n_random > 20
    big = [n for n, v in ref.items() if v.numel() >= 4096 and not torch.all(v == v.flatten()[0])]
    assert len(big) >= 10


# --- the rollout evaluation, callbacks and loggers ------------------------
@pytest.mark.parametrize("n_out", [1, 2])
def test_rollout_eval_matches_jax(tmp_path, n_out):
    """``make_rollout_eval_fn`` (rollout 2, ``rmse`` and ``mse``, with
    ``per_timestep``) against the JAX function on the same weights."""
    from anemoi_tpu.training.metrics import make_rollout_eval_fn as jax_make_rollout_eval_fn
    from anemoi_tpu_torch.training.metrics import make_rollout_eval_fn

    cfg = tiny_config(tmp_path, "eval")
    cfg["model"]["n_step_output"] = n_out
    graph = JaxGraphCreator(cfg["graph"]["recipe"]).create(cfg["graph"]["save_path"])
    n2i = {n: i for i, n in enumerate(EXAMPLE_VARIABLES)}
    kw = {"forcing": ["cos_lat"], "diagnostic": ["tp"]}
    rng = np.random.default_rng(3)
    v = len(n2i)
    stats = {"data": {"mean": rng.normal(size=v).astype(np.float32),
                      "stdev": rng.uniform(0.5, 2, v).astype(np.float32),
                      "minimum": -np.ones(v, np.float32), "maximum": np.ones(v, np.float32)}}
    jax_iface = JaxInterface(config=cfg, graph=graph,
                             data_indices={"data": JaxIndexCollection(n2i, **kw)},
                             statistics=stats)
    flat = flax.traverse_util.flatten_dict(jax.eval_shape(jax_iface.init_params)["params"])
    params = {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=x.shape)).astype(np.float32) for k, x in flat.items()})}
    iface = AnemoiModelInterface(config=cfg, graph=Graph.load(cfg["graph"]["save_path"]),
                                 data_indices={"data": IndexCollection(n2i, **kw)},
                                 statistics=stats, device="cpu", training=True)
    iface.load_state_dict(state_dict_from_jax(params), strict=True)
    batch = (stats["data"]["mean"] + stats["data"]["stdev"]
             * rng.normal(size=(2, 2 + 2 * n_out, 1, 544, v))).astype(np.float32)
    batch[0, 2, 0, :5, 1] = np.nan  # missing truth drops out
    metrics = ("rmse", "mse")
    ref = jax_make_rollout_eval_fn(jax_iface, 2, metrics, per_timestep=True)(
        params, {"data": batch})
    ours = make_rollout_eval_fn(iface, 2, metrics, per_timestep=True)(
        {"data": torch.from_numpy(batch)})
    assert sorted(ours) == sorted(ref)
    assert any("/t_2" in k for k in ours) == (n_out > 1)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=RTOL, err_msg=k)


def test_callbacks_and_loggers(tmp_path):
    from anemoi_tpu_torch.training.callbacks import (
        EarlyStopping, TimeLimit, WeightAveraging, build_callbacks,
    )
    from anemoi_tpu_torch.data_indices.collection import compare_variables
    from anemoi_tpu_torch.training.loggers import build_loggers

    compare_variables({"a": 0, "b": 1}, {"a": 0, "b": 1})
    compare_variables({"a": 0, "b": 1}, {"a": 0, "c": 1})  # a rename in place only warns
    with pytest.raises(ValueError, match="different positions"):
        compare_variables({"a": 0, "b": 1}, {"a": 1, "b": 0})
    stop = EarlyStopping(patience=2)
    for value in (1.0, 0.5, 0.6, 0.7):
        stop.on_validation(None, 0, {"val_loss": value})
    assert stop.should_stop(None) and stop.best == 0.5
    assert TimeLimit(limit="00:00:00").should_stop(None) is False
    assert TimeLimit(limit_s=1e-9).should_stop(None)
    from anemoi_tpu_torch.training.callbacks import PlotSample
    from anemoi_tpu_torch.training.loggers import OfflineMLflowLogger
    from anemoi_tpu_torch.training.mlflow_store import read_offline_run

    (plot,) = build_callbacks([{"name": "PlotSample", "async_plots": False}])
    assert isinstance(plot, PlotSample) and plot.max_vars == 4
    _, offline = build_loggers([{"name": "mlflow_offline", "system_metrics": False}],
                               str(tmp_path / "mlflow"))
    assert isinstance(offline, OfflineMLflowLogger)
    offline.log_metrics({"loss": 1.5}, 3)
    offline.finalize()
    run = read_offline_run(offline.run.run_dir)
    assert [(m["key"], m["value"], m["step"]) for m in run["metrics"]] == [("loss", 1.5, 3)]
    (jl,) = build_loggers([{"name": "jsonl"}], str(tmp_path))
    jl.log_metrics({"loss": 1.5}, 3)
    jl.finalize()
    assert json.loads((tmp_path / "experiment.jsonl").read_text())["loss"] == 1.5

    class Holder:
        interface = torch.nn.Linear(3, 2)

    for kind, decay in (("ema", 0.9), ("swa", None)):
        avg = WeightAveraging(decay=decay or 0.999, kind=kind)
        history = []
        for step in range(1, 5):
            with torch.no_grad():
                for p in Holder.interface.parameters():
                    p.add_(float(step))
            history.append([p.detach().clone() for p in Holder.interface.parameters()])
            avg.on_step(Holder, step, {})
        for i in range(2):
            want = history[0][i]
            for n, snap in enumerate(history[1:], start=2):
                d = decay if kind == "ema" else 1.0 - 1.0 / n
                want = d * want + (1 - d) * snap[i]
            torch.testing.assert_close(avg.avg_params[i], want, rtol=1e-6, atol=1e-6)
