"""Data parallelism and halo model parallelism of the port's training and
serving, on CPU ranks (gloo), against the JAX package.

The model is the one of ``tests/test_model_parallel.py`` (o8 -> ico-1,
``CutOffEdges`` 0.9, ``MultiScaleEdges`` 1 hop, ``KNNEdges`` 3; 16 channels,
2 processor layers, 4 heads) with trainable node and edge features, the
processor checkpointed per block, area-weighted ``WeightedMSELoss`` and
AdamW with value clipping at 32; random weights from the JAX package
(``state_dict_from_jax``).  The JAX side runs single-device at batch 2:
``tests/test_model_parallel.py`` holds its sharded runs to it.

- Four ranks (``tests/torch_parallel_worker.py:train_runs``, one spawn):
  ``edges`` on model 4, ``gspmd`` (upgraded to ``edges``) on data 2 x
  model 2, ``edges`` without ``halo_overlap`` on data 2 x model 2 with each
  rank reading its grid block.  Two steps: losses against JAX's at rtol
  5e-5, atol 1e-6 (JAX ``tests/test_model_parallel.py:166-177``); every
  parameter's step-1 gradient within 3e-5 relative L2 of JAX's.
- Two ranks: data parallelism alone (batch 1 a rank) equals one process at
  batch 2 for this model and for a tiny Transformer processor, and
  ``optimizer.zero`` gives the same losses as without it.
- ``cli train`` with ``hardware.num_devices: 2`` and
  ``num_devices_per_model: 2`` starts its own ranks; its losses equal the
  single-process run at rtol 2e-4, atol 1e-5 (JAX
  ``tests/test_multiprocess.py:130-196``), rank 0 alone writes
  ``metrics.jsonl`` and the bundle, and the bundle served on one device
  equals the bundle served over the two ranks' model group, through
  ``predict_step`` and through ``cli predict`` under the ranks' world.
"""

import copy
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu_torch.data.dataset import open_dataset
from anemoi_tpu_torch.data.zarr_reader import save_zarr_dataset
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.flagship import example_o96_gt_config
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.parallel.distributed import spawn
from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint
from anemoi_tpu_torch.training.cli import main
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState, make_step_fns
from tests import torch_parallel_worker as worker
from tests.test_model_parallel import _recipe
from tests.test_torch_training import grad_store, port_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

VARIABLES = ["q", "t", "u", "z", "cos_lat"]
INDICES = {"data": {"name_to_index": {n: i for i, n in enumerate(VARIABLES)},
                    "forcing": ["cos_lat"]}}
SCALERS = {"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                    "attribute_name": "area_weight"}}
LOSS = {"name": "WeightedMSELoss", "scalers": ["area"]}
OPT = {"lr": {"rate": 1e-3, "warmup": 1, "iterations": 100},
       "gradient_clip": {"val": 32.0, "algorithm": "value"}}


def model_config(processor="gt"):
    gt = {"num_heads": 4, "mlp_hidden_ratio": 2.0, "trainable_size": 2,
          "sub_graph_edge_attributes": ["edge_dirs", "edge_length"]}
    if processor == "gt":
        proc = {"name": "GraphTransformerProcessor", "num_layers": 2,
                "gradient_checkpointing": True, **gt}
    else:
        proc = {"name": "TransformerProcessor", "num_layers": 2, "num_heads": 4,
                "window_size": 8}
    return {
        "model": {
            "name": "AnemoiModelEncProcDec", "num_channels": 16, "n_step_input": 2,
            "n_step_output": 1, "graph_attention_backend": "segment",
            "trainable_parameters": {"data": 2, "hidden": 2},
            "encoder": {"name": "GraphTransformerForwardMapper", **gt},
            "processor": proc,
            "decoder": {"name": "GraphTransformerBackwardMapper", **gt},
        },
        "data": {"processors": [{"name": "InputNormalizer", "default": "mean-std"}]},
    }


def jax_setup(processor):
    graph = JaxGraphCreator(_recipe()).create()
    rng = np.random.default_rng(5)
    nv = len(VARIABLES)
    stats = {"data": {"mean": rng.normal(size=nv).astype(np.float32),
                      "stdev": (0.5 + rng.random(nv)).astype(np.float32),
                      "minimum": -np.ones(nv, np.float32), "maximum": np.ones(nv, np.float32)}}
    indices = {"data": JaxIndexCollection(INDICES["data"]["name_to_index"], forcing=["cos_lat"])}
    iface = JaxInterface(config=model_config(processor), graph=graph, data_indices=indices,
                         statistics=stats)
    flat = flax.traverse_util.flatten_dict(jax.eval_shape(iface.init_params)["params"])
    params = {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()})}
    n_grid = graph["data"].num_nodes
    batch = (stats["data"]["mean"] + stats["data"]["stdev"]
             * rng.normal(size=(2, 3, 1, n_grid, nv))).astype(np.float32)
    setup = {"graph": port_graph(graph), "config": model_config(processor), "indices": INDICES,
             "statistics": stats, "state_dict": {k: v.numpy() for k, v in
                                                 state_dict_from_jax(params).items()},
             "batch": batch, "loss": LOSS, "scalers": SCALERS, "optimizer": OPT}
    return graph, iface, params, setup


@pytest.fixture(scope="module")
def reference():
    """JAX single-device: two steps' losses and the step-1 gradients."""
    graph, iface, params, setup = jax_setup("gt")
    losses = {"data": jax_get_loss_function(LOSS, jax_create_scalers(
        SCALERS, graph=graph, data_indices=iface.data_indices["data"]))}
    batch = {"data": jnp.asarray(setup["batch"])}
    train_step, _ = jax_make_step_fns(iface, losses, rollout=1, remat_rollout=False)
    state, ref_losses = JaxTrainState.create(params, jax_build_optimizer(OPT)), []
    for _ in range(2):
        state, metrics = train_step(state, batch)
        ref_losses.append(float(metrics["loss"]))
    grads_state, _ = train_step(JaxTrainState.create(params, grad_store()), batch)
    grads = {k: v.numpy() for k, v in state_dict_from_jax(grads_state.opt_state).items()}
    return setup, ref_losses, grads


RUNS = {
    "edges_model4": {"data": 1, "steps": 2, "model": {"shard_strategy": "edges"}},
    "gspmd_data2_model2": {"data": 2, "steps": 2, "model": {"shard_strategy": "gspmd"}},
    "edges_no_overlap_data2_model2": {"data": 2, "steps": 2, "shard_grid": True,
                                      "model": {"shard_strategy": "edges",
                                                "halo_overlap": False}},
}


@pytest.fixture(scope="module")
def four_ranks(reference):
    setup = reference[0]
    results = spawn(worker.train_runs, 4, args=(setup, list(RUNS.values())), platform="cpu",
                    threads=1)
    return dict(zip(RUNS, zip(*results)))  # run -> per-rank results


def assert_grads_match(ours, ref, tol=3e-5):
    """Relative L2 of every parameter's gradient; the key biases' true
    gradient is exactly 0 (a constant on every key of a destination shifts
    its logits alike), so both sides must only be float noise there."""
    assert sorted(ours) == sorted(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    for name, want in ref.items():
        got = ours[name]
        if name.endswith("lin_key.bias"):
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-6 * top, name
            continue
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err < tol, (name, err)


@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_train_steps_match_jax(reference, four_ranks, run):
    _, ref_losses, ref_grads = reference
    per_rank = four_ranks[run]
    for r in per_rank:  # every rank reports the reduced loss and gradients
        assert r["halo"]
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=5e-5, atol=1e-6)
        assert_grads_match(r["grads"], ref_grads)


def single_process(setup, batch, steps=2, zero=False):
    iface = AnemoiModelInterface(
        config=copy.deepcopy(setup["config"]), graph=setup["graph"],
        data_indices={ds: IndexCollection(**kw) for ds, kw in setup["indices"].items()},
        statistics=setup["statistics"], device="cpu", training=True)
    iface.load_state_dict({k: torch.as_tensor(v) for k, v in setup["state_dict"].items()})
    losses = {"data": get_loss_function(LOSS, create_scalers(SCALERS, graph=setup["graph"]))}
    state = TrainState.create(iface, build_optimizer(OPT))
    train_step, _ = make_step_fns(iface, losses, rollout=1, remat_rollout=False)
    out = []
    for _ in range(steps):
        state, metrics = train_step(state, {"data": torch.as_tensor(batch)})
        out.append(float(metrics["loss"]))
    return out


@pytest.fixture(scope="module")
def transformer_setup():
    return jax_setup("transformer")[3]


DP_RUNS = [{"data": 2, "steps": 2}, {"data": 2, "steps": 2, "zero": True}]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``cli train`` on two ranks of one model group, and on one process."""
    tmp = tmp_path_factory.mktemp("cli_parallel")
    cfg = example_o96_gt_config(num_channels=16, num_layers=1, precision="fp32", grid="o8",
                                mesh_resolution=1, num_times=24)
    synthetic = open_dataset(dict(cfg["data"]["datasets"]["data"]))
    fields = synthetic.get_window(0, 24).transpose(0, 3, 1, 2)
    save_zarr_dataset(str(tmp / "data.zarr"), fields, synthetic.variables,
                      np.rad2deg(synthetic.latitudes), np.rad2deg(synthetic.longitudes))
    cfg["data"]["datasets"]["data"] = {"kind": "zarr", "path": str(tmp / "data.zarr")}
    cfg["graph"]["save_path"] = str(tmp / "graph.npz")
    cfg["model"]["inference_precision"] = "fp32"
    cfg_path = tmp / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    common = ["hardware.platform=cpu", "training.max_steps=3", "training.max_epochs=1",
              "diagnostics.log_interval=1"]
    runs = {}
    for name, extra in (("single", []),
                        ("ranks", ["hardware.num_devices=2", "hardware.num_devices_per_model=2"])):
        out = tmp / name
        assert main(["train", str(cfg_path), f"output_dir={out}"] + common + extra) == 0
        runs[name] = out
    return runs, synthetic.get_window(0, 2)[None]


def losses_of(run_dir):
    return [json.loads(line) for line in open(run_dir / "metrics.jsonl")]


@pytest.fixture(scope="module")
def two_ranks(reference, transformer_setup, cli_run):
    setup = reference[0]
    runs, window = cli_run
    calls = [(worker.train_runs, (setup, DP_RUNS)),
             (worker.train_runs, (transformer_setup, [{"data": 2, "steps": 2}])),
             (worker.serve_bundle, (str(runs["ranks"] / "inference"), window)),
             (worker.cli_predict, (str(runs["ranks"] / "inference"),
                                   str(runs["ranks"] / "forecast_ranks.npz")))]
    return spawn(worker.sequence, 2, args=(calls,), platform="cpu", threads=1)


def test_data_parallel_equals_one_process(reference, two_ranks):
    setup = reference[0]
    want = single_process(setup, setup["batch"])
    for rank in two_ranks:
        plain, zero = rank[0]
        np.testing.assert_allclose(plain["losses"], want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(zero["losses"], plain["losses"], rtol=1e-6, atol=1e-8)


def test_data_parallel_transformer_equals_one_process(transformer_setup, two_ranks):
    want = single_process(transformer_setup, transformer_setup["batch"])
    for rank in two_ranks:
        np.testing.assert_allclose(rank[1][0]["losses"], want, rtol=1e-5, atol=1e-7)


def test_cli_train_on_two_ranks_matches_one_process(cli_run):
    runs, _ = cli_run
    single = [r for r in losses_of(runs["single"]) if "loss" in r]
    ranks = [r for r in losses_of(runs["ranks"]) if "loss" in r]
    assert [r["step"] for r in ranks] == [1, 2, 3]  # written once: by rank 0 alone
    np.testing.assert_allclose([r["loss"] for r in ranks], [r["loss"] for r in single],
                               rtol=2e-4, atol=1e-5)
    val = [r for r in losses_of(runs["ranks"]) if "val_loss" in r]
    assert len(val) == 1 and any(k.startswith("rmse/data/") for k in val[0])
    assert (runs["ranks"] / "inference" / "checkpoint.json").exists()
    bundle = json.loads((runs["ranks"] / "inference" / "checkpoint.json").read_text())
    assert bundle["config"]["model"]["num_model_shards"] == 2


def test_bundle_from_ranks_serves_on_one_device(cli_run, two_ranks):
    runs, window = cli_run
    iface = load_inference_checkpoint(str(runs["ranks"] / "inference"), device="cpu")
    assert iface.model.halo is None  # re-based to one device
    want = iface.predict_step({"data": torch.as_tensor(window)})["data"].numpy()
    for rank in two_ranks:
        served = rank[2]
        assert served["halo"]
        np.testing.assert_allclose(served["data"], want, rtol=1e-5, atol=1e-5)


def test_cli_predict_under_a_launcher_matches_one_device(cli_run, two_ranks):
    """``cli predict`` on the ranks of a launcher serves over their model
    group; rank 0's forecast equals the one-device ``cli predict``."""
    runs, _ = cli_run
    assert [rank[3] for rank in two_ranks] == [0, 0]
    single = runs["ranks"] / "forecast_single.npz"
    assert main(["predict", str(runs["ranks"] / "inference"), "--steps", "2", "--platform",
                 "cpu", "--output", str(single)]) == 0
    got = np.load(runs["ranks"] / "forecast_ranks.npz")["data|forecast"]
    want = np.load(single)["data|forecast"]
    assert got.shape == want.shape == (1, 2, 1, 544, len(want[0, 0, 0, 0]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
