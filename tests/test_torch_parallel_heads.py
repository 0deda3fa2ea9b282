"""Ulysses head sharding (``shard_strategy: heads``) of the port on CPU
ranks (gloo), against the JAX package and the port's one process.

The models are those of ``tests/test_torch_parallel_training.py`` (the
model of ``tests/test_model_parallel.py``: o8 -> ico-1, 16 channels, 2
processor layers, 4 heads, trainable node and edge features) with the
GraphTransformer processor and with the dense Transformer processor
(window 8: the band, as 2 w + 1 < 42 hidden rows); random JAX weights
through ``state_dict_from_jax``.  The JAX side runs single-device at batch
2, as ``tests/test_model_parallel.py:166, 299`` holds its own heads runs
to it.

- Two ranks (one spawn): each model on a model group of 2 under ``heads``:
  two steps' losses against JAX's at rtol 5e-5, atol 1e-6; every
  parameter's step-1 gradient within 1e-5 relative L2 of the port's one
  process; a 2-step float32 forecast after them against one process's
  (rtol/atol 1e-5).  Then ``ulysses_mhsa``
  itself against JAX's ``_window_attention`` on the padded sequence with
  ``valid_len`` (its output and the gradients of q, k and v, rtol/atol
  3e-5): N = 30 at S = 2 with w = 15, where JAX's padded length
  ``ceil(N / S) S`` = 30 takes full attention and the blocks' 2 x 16 = 32
  rows would take the band; the band with ALiBi, softcap and rotary
  embeddings; and ``heads_to_seq(seq_to_heads(x)) == x`` with its
  gradient, and a head count the group does not divide refused.
- Four ranks (one spawn): both models on data 2 x model 2.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.models.layers.attention import _window_attention
from anemoi_tpu.models.layers.attention import apply_rotary_embeddings as jax_rotary
from anemoi_tpu.models.layers.attention import get_alibi_slopes as jax_alibi
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.inference import make_forecast_fn
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.parallel.distributed import spawn
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState, make_step_fns
from tests import torch_parallel_worker as worker
from tests.test_torch_parallel_training import LOSS, OPT, SCALERS, jax_setup
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PROCESSORS = ("gt", "transformer")
HEADS = {"shard_strategy": "heads"}


def one_process(setup):
    """The port on one process: the step-1 gradients, and a 2-step forecast
    after two steps."""
    iface = AnemoiModelInterface(
        config=copy.deepcopy(setup["config"]), graph=setup["graph"],
        data_indices={ds: IndexCollection(**kw) for ds, kw in setup["indices"].items()},
        statistics=setup["statistics"], device="cpu", training=True)
    iface.load_state_dict({k: torch.as_tensor(v) for k, v in setup["state_dict"].items()})
    losses = {"data": get_loss_function(LOSS, create_scalers(SCALERS, graph=setup["graph"]))}
    state = TrainState.create(iface, build_optimizer(OPT))
    train_step, _ = make_step_fns(iface, losses, rollout=1, remat_rollout=False)
    batch = {"data": torch.as_tensor(setup["batch"])}
    train_step.compute_gradients(state, batch)
    grads = {n: p.grad.numpy().copy() for n, p in iface.named_parameters()}
    state.apply_gradients()
    train_step(state, batch)  # the ranks forecast after their two steps
    forecast = make_forecast_fn(iface, 2)({"data": torch.as_tensor(setup["window"])})["data"]
    return grads, forecast.numpy()


@pytest.fixture(scope="module")
def setups():
    """Per processor: the setup (with a 4-step forecast window), JAX's two
    losses and the port's one-process gradients and forecast."""
    out = {}
    for proc in PROCESSORS:
        graph, iface, params, setup = jax_setup(proc)
        setup["config"]["model"]["inference_precision"] = "fp32"  # the forecasts' type
        rng = np.random.default_rng(17)
        stats = setup["statistics"]["data"]
        setup["window"] = (stats["mean"] + stats["stdev"] * rng.normal(
            size=(1, 4, 1, graph["data"].num_nodes, len(stats["mean"])))).astype(np.float32)
        losses = {"data": jax_get_loss_function(LOSS, jax_create_scalers(
            SCALERS, graph=graph, data_indices=iface.data_indices["data"]))}
        train_step, _ = jax_make_step_fns(iface, losses, rollout=1, remat_rollout=False)
        state, ref = JaxTrainState.create(params, jax_build_optimizer(OPT)), []
        for _ in range(2):
            state, metrics = train_step(state, {"data": jnp.asarray(setup["batch"])})
            ref.append(float(metrics["loss"]))
        out[proc] = (setup, ref, *one_process(setup))
    return out


def attention_cases():
    rng = np.random.default_rng(23)

    def case(n, window, softcap=None, alibi=False, rotary=False):
        arrays = {k: rng.normal(size=(2, n, 4, 6)).astype(np.float32)
                  for k in ("q", "k", "v", "cotangent")}
        return {**arrays, "window": window, "softcap": softcap, "alibi": alibi,
                "rotary": rotary}

    return {"full_at_padded_length": case(30, 15),
            "band_alibi_softcap_rotary": case(45, 6, softcap=3.0, alibi=True, rotary=True)}


CASES = attention_cases()


@pytest.fixture(scope="module")
def two_ranks(setups):
    calls = [(worker.train_runs, (setups[p][0], [
        {"data": 1, "steps": 2, "model": HEADS, "forecast": 2}])) for p in PROCESSORS]
    calls.append((worker.heads_attention, (list(CASES.values()),)))
    return spawn(worker.sequence, 2, args=(calls,), platform="cpu", threads=1)


@pytest.fixture(scope="module")
def four_ranks(setups):
    calls = [(worker.train_runs, (setups[p][0], [{"data": 2, "steps": 2, "model": HEADS}]))
             for p in PROCESSORS]
    return spawn(worker.sequence, 4, args=(calls,), platform="cpu", threads=1)


def assert_grads_close(ours, ref, tol=1e-5):
    """Relative L2 of every parameter's gradient against the port's one
    process; the key biases' true gradient is 0 (softmax is shift
    invariant), so both sides must only be float noise there."""
    assert sorted(ours) == sorted(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    for name, want in ref.items():
        got = ours[name]
        if name.endswith("lin_key.bias"):
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-6 * top, name
            continue
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err < tol, (name, err)


@pytest.mark.parametrize("mesh", ["model2", "data2_model2"])
@pytest.mark.parametrize("proc", PROCESSORS)
def test_heads_training_matches_jax_and_one_process(setups, two_ranks, four_ranks, proc, mesh):
    _, ref_losses, ref_grads, _ = setups[proc]
    ranks = two_ranks if mesh == "model2" else four_ranks
    for rank in ranks:
        run = rank[PROCESSORS.index(proc)][0]
        assert run["halo"]
        np.testing.assert_allclose(run["losses"], ref_losses, rtol=5e-5, atol=1e-6)
        assert_grads_close(run["grads"], ref_grads)


@pytest.mark.parametrize("proc", PROCESSORS)
def test_heads_forecast_matches_one_process(setups, two_ranks, proc):
    want = setups[proc][3]
    for rank in two_ranks:
        got = rank[PROCESSORS.index(proc)][0]["forecast"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def jax_ulysses_reference(case, shards):
    """JAX's heads attention on one device: the sequence padded to
    ``ceil(N / S) S`` (rotary over it), ``_window_attention`` with
    ``valid_len``; the real rows and the gradients of the real rows."""
    n = case["q"].shape[1]
    n_pad = -(-n // shards) * shards
    slopes = jax_alibi(case["q"].shape[2]) if case["alibi"] else None

    def f(q, k, v):
        pad = ((0, 0), (0, n_pad - n), (0, 0), (0, 0))
        q, k, v = (jnp.pad(t, pad) for t in (q, k, v))
        if case["rotary"]:
            q, k = jax_rotary(q, k)
        return _window_attention(q, k, v, case["window"], case["softcap"], slopes,
                                 valid_len=n)[:, :n]

    out, vjp = jax.vjp(f, *(jnp.asarray(case[k]) for k in ("q", "k", "v")))
    grads = vjp(jnp.asarray(case["cotangent"]))
    return {"out": np.asarray(out), **{f"d{k}": np.asarray(g) for k, g in zip("qkv", grads)}}


@pytest.mark.parametrize("name", list(CASES))
def test_ulysses_mhsa_matches_jax(two_ranks, name):
    want = jax_ulysses_reference(CASES[name], 2)
    i = list(CASES).index(name)
    got = {key: np.concatenate([r[2][i][key] for r in two_ranks], axis=1) for key in want}
    assert [r[2][i]["rows"] for r in two_ranks] == (
        [(0, 16), (16, 30)] if name == "full_at_padded_length" else [(0, 24), (24, 45)])
    for key, ref in want.items():
        np.testing.assert_allclose(got[key], ref, rtol=3e-5, atol=3e-5, err_msg=key)


def test_full_or_band_follows_the_jax_padded_length():
    """At N = 30, S = 2, w = 15 the JAX rule's full attention and the band
    that 2 x 16 = 32 rows would pick differ: the case above tells them
    apart."""
    case = CASES["full_at_padded_length"]
    q, k, v = (jnp.asarray(case[t]) for t in ("q", "k", "v"))
    full = _window_attention(q, k, v, 15)
    pad = ((0, 0), (0, 2), (0, 0), (0, 0))
    band = _window_attention(*(jnp.pad(t, pad) for t in (q, k, v)), 15, valid_len=30)[:, :30]
    assert float(jnp.abs(full - band).max()) > 1e-2


def test_heads_round_trip_and_refusals(two_ranks, setups):
    for rank in two_ranks:
        tail = rank[2][len(CASES):]
        assert tail[0] == {"round_trip": True, "grad": True}
        assert "not divisible" in tail[1]["refused"]
    setup = setups["gt"][0]
    config = copy.deepcopy(setup["config"])
    config["model"].update(shard_strategy="heads", num_model_shards=3)
    with pytest.raises(ValueError, match="num_heads 4 is not divisible"):
        AnemoiModelInterface(
            config=config, graph=setup["graph"],
            data_indices={ds: IndexCollection(**kw) for ds, kw in setup["indices"].items()},
            statistics=setup["statistics"], device="cpu", training=True)
