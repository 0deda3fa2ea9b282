"""The ensemble CRPS family (AIFS-ENS) of the port against the JAX package.

A tiny ensemble model of the flagship's shape (o16 -> ico-2, 32 channels, 2
processor layers, 4 heads, GT mappers, ``AnemoiEnsModelEncProcDec`` with
``NoiseConditioning`` and ``processor.conditional: true``) with the JAX
package's initialised parameters replaced by seeded random numbers (the
conditional norms' zero ``scale``/``bias`` included, so the noise matters),
moved with ``state_dict_from_jax``.  The JAX side's noise: ``jax.random.normal``
is patched inside each test, around ``apply`` and the step (never ``init``),
to return seeded numpy arrays, and the port's draw
(``models.layers.ensemble.standard_normal``) returns the same arrays, in the
same turn.  Float32 at rtol/atol 3e-5 of the largest magnitude for single
modules and the loss; 1e-4 for whole forwards and steps (ROADMAP rule 3,
``tests/test_torch_config.py``):

- ``NoiseConditioning`` and ``NoiseInjector``; ``KernelCRPS`` (fair and
  not, M = 1, NaN targets, its gradient, the single-truth check);
- the ensemble forward at B = 2, M = 3 (member-major rows: noise row
  ``b * M + m`` belongs to member m of sample b), both injectors, and the
  forecast-step channel;
- ``make_step_fns(ensemble_size=3)`` gradients at rollout 1, and at rollout
  2 with ``remat_rollout``; at rollout 2 the port's gradients with and
  without the rollout checkpoint are equal bit for bit, and its noise seeds
  follow (base seed, training step, rollout step);
- ``ensemble_crps.yaml`` at a narrow width: two ``cli train`` steps and the
  validation equal to the JAX trainer's records; its bundle served by
  ``predict_step`` and refused by ``cli predict``;
- the initial weights: the conditional norms start at zero, the members
  equal, until the scales move; ``make_forecast_fn`` and the rollout
  evaluation refuse a model that draws noise, as the JAX ones fail.
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

import anemoi_tpu
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.inference import make_forecast_fn as jax_make_forecast_fn
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.models.layers import ensemble as jax_ensemble
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu.training.trainer import AnemoiTrainer as JaxTrainer
from anemoi_tpu.utils.config import load_config as jax_load_config
from anemoi_tpu_torch.flagship import flagship_config, flagship_indices, flagship_recipe
from anemoi_tpu_torch.flagship import flagship_statistics
from anemoi_tpu_torch.inference import make_forecast_fn
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.layers import ensemble
from anemoi_tpu_torch.models.layers.normalization import ConditionalLayerNorm
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint
from anemoi_tpu_torch.training.cli import main
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.metrics import make_rollout_eval_fn
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState, make_step_fns
from anemoi_tpu_torch.training.trainer import AnemoiTrainer
from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config
from anemoi_tpu_torch.utils.seeding import context_seed, fold_seed
from test_torch_switches import _indices
from test_torch_training import grad_store, port_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

JAX_CONFIG_DIR = os.path.join(os.path.dirname(anemoi_tpu.__file__), "config")
TOL = 3e-5
NOISE = {"name": "NoiseConditioning", "noise_std": 1.3, "noise_channels_dim": 4,
         "noise_mlp_hidden_dim": 8}
M = 3  # members


class SameNoise:
    """The JAX package's and the port's standard normal draws, both replaced
    by ``arrays`` in turn (each package keeps its own turn)."""

    def __init__(self, monkeypatch, arrays):
        self.arrays, self.turns = arrays, {"jax": 0, "port": 0}
        monkeypatch.setattr(jax.random, "normal", self.jax_normal)
        monkeypatch.setattr(ensemble, "standard_normal", self.port_normal)

    def _next(self, who, shape):
        a = self.arrays[self.turns[who] % len(self.arrays)]
        self.turns[who] += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return a

    def jax_normal(self, key, shape, dtype=jnp.float32):
        return jnp.asarray(self._next("jax", shape), dtype)

    def port_normal(self, shape, generator):
        return torch.from_numpy(self._next("port", shape))


def ens_config(injector="NoiseConditioning"):
    cfg = flagship_config(num_channels=32, num_layers=2, num_heads=4, inference_precision="fp32")
    model = cfg["model"]
    model.update(name="AnemoiEnsModelEncProcDec", graph_attention_backend="segment",
                 noise_injector={**NOISE, "name": injector})
    model["processor"]["conditional"] = injector == "NoiseConditioning"
    return cfg


def randomised(params, rng):
    flat = flax.traverse_util.flatten_dict(params["params"])
    return {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()})}


@pytest.fixture(scope="module")
def ens():
    graph = JaxGraphCreator(flagship_recipe("o16", 2)).create()
    stats = flagship_statistics(seed=1)
    out = {"graph": graph, "port_graph": port_graph(graph), "stats": stats,
           "n_grid": graph["data"].num_nodes, "n_hidden": graph["hidden"].num_nodes}
    rng = np.random.default_rng(0)
    for injector in ("NoiseConditioning", "NoiseInjector"):
        iface = JaxInterface(config=ens_config(injector), graph=graph, data_indices=_indices(),
                             statistics=stats)
        out[injector] = (iface, randomised(jax.eval_shape(iface.init_params), rng))
    mean, std = stats["data"]["mean"], stats["data"]["stdev"]
    out["batch"] = (mean + std * rng.normal(size=(1, 4, 1, out["n_grid"], 7))).astype(np.float32)
    return out


def port_interface(ens, injector="NoiseConditioning", training=False):
    iface = AnemoiModelInterface(config=ens_config(injector), graph=ens["port_graph"],
                                 data_indices=flagship_indices(), statistics=ens["stats"],
                                 device="cpu", training=training)
    iface.load_state_dict(state_dict_from_jax(ens[injector][1]), strict=True)
    return iface


def noise_arrays(seed, n, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def assert_grads_close(grads, ref, tol=1e-4):
    """Every gradient within ``tol`` of its tensor's largest magnitude; the
    key biases' (exactly 0 in truth: softmax is shift invariant) both float
    noise."""
    assert sorted(grads) == sorted(ref)
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, want in ref.items():
        want, got = want.numpy(), grads[name].numpy()
        if name.endswith("lin_key.bias"):
            assert np.abs(got).max() <= 1e-6 * top and np.abs(want).max() <= 1e-6 * top
            continue
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=name)


def close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours.detach().float().numpy(), ref, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("injector", ["NoiseConditioning", "NoiseInjector"])
def test_noise_injector_matches_jax(monkeypatch, injector):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 13, 16)).astype(np.float32)
    kw = {k: v for k, v in NOISE.items() if k != "name"}
    mod = getattr(jax_ensemble, injector)(**kw)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(mod.init, {"params": key, "noise": key}, jnp.asarray(x))
    params = randomised(shapes, rng)
    noise = noise_arrays(2, 1, (6, 13, 4))
    SameNoise(monkeypatch, noise)
    ref_x, ref_cond = mod.apply(params, jnp.asarray(x), rngs={"noise": key})
    port = ensemble.build_noise_injector({**NOISE, "name": injector}, 16)
    sd = state_dict_from_jax({"params": {f"{injector}_0": params["params"]}})
    port.load_state_dict({k[len("model.noise_injector."):]: v for k, v in sd.items()},
                         strict=True)
    assert port.noise_shape(6, 13) == (6, 13, 4)
    out_x, cond = port(torch.from_numpy(x), torch.from_numpy(noise[0]))
    close(out_x, ref_x, TOL)
    if injector == "NoiseConditioning":
        close(cond, ref_cond, TOL)
    else:
        assert cond is None and ref_cond is None
    with pytest.raises(ValueError, match="needs a noise draw"):
        port(torch.from_numpy(x))


@pytest.mark.parametrize("fair,members,nans", [(True, 3, False), (False, 3, False),
                                               (True, 1, False), (True, 4, True)],
                         ids=["fair", "not_fair", "one_member", "nan_targets"])
def test_kernel_crps_matches_jax(fair, members, nans):
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(2, 1, members, 9, 5)).astype(np.float32)
    target = rng.normal(size=(2, 1, 1, 9, 5)).astype(np.float32)
    if nans:
        target[0, 0, 0, :3, 1] = np.nan
    scalers = {"grid": (("grid",), rng.uniform(0.5, 1.5, 9).astype(np.float32)),
               "variable": (("variable",), rng.uniform(0.5, 1.5, 5).astype(np.float32))}
    cfg = {"name": "KernelCRPS", "fair": fair, "scalers": ["grid", "variable"]}
    ref_loss = jax_get_loss_function(cfg, scalers)
    loss = get_loss_function(cfg, scalers)
    ref, ref_grad = jax.value_and_grad(lambda p: ref_loss(p, jnp.asarray(target)))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    ours = loss(p, torch.from_numpy(target))
    ours.backward()
    close(ours, ref, TOL)
    close(p.grad, ref_grad, TOL)
    per_var = loss(torch.from_numpy(pred), torch.from_numpy(target), squash=False)
    close(per_var, ref_loss(jnp.asarray(pred), jnp.asarray(target), squash=False), TOL)
    two_truths = np.repeat(target, 2, axis=2)
    with pytest.raises(AssertionError):
        ref_loss(jnp.asarray(pred), jnp.asarray(two_truths))
    with pytest.raises(ValueError, match="single-truth"):
        loss(torch.from_numpy(pred), torch.from_numpy(two_truths))


@pytest.mark.parametrize("injector,fcstep", [("NoiseConditioning", 0), ("NoiseConditioning", 1),
                                             ("NoiseInjector", 0)])
def test_ensemble_forward_matches_jax(ens, monkeypatch, injector, fcstep):
    jax_iface, params = ens[injector]
    rng = np.random.default_rng(4)
    x = np.repeat(rng.normal(size=(2, 2, 1, ens["n_grid"], 6)), M, axis=2).astype(np.float32)
    noise = noise_arrays(5, 1, (2 * M, ens["n_hidden"], 4))
    SameNoise(monkeypatch, noise)
    ref = jax_iface.model.apply(params, {"data": jnp.asarray(x)}, jax_iface.graph_inputs,
                                fcstep=fcstep, rngs={"noise": jax.random.PRNGKey(7)})["data"]
    iface = port_interface(ens, injector)
    with torch.no_grad():
        out = iface.run_model({"data": torch.from_numpy(x)},
                              noise=torch.from_numpy(noise[0]), fcstep=fcstep)["data"]
        applied = iface.apply({"data": torch.from_numpy(x)})["data"]
    assert tuple(out.shape) == (2, 1, M, ens["n_grid"], 5)
    close(out, ref, 1e-4)
    if fcstep == 0:  # apply: the same draw, through the interface
        assert torch.equal(applied, out)
    members = out[0, 0]
    assert not torch.allclose(members[0], members[1])  # the noise spreads the members


def jax_ens_steps(ens, rollout, remat):
    jax_iface, params = ens["NoiseConditioning"]
    losses = {"data": jax_get_loss_function({"name": "KernelCRPS", "scalers": []}, {})}
    train_step, _ = jax_make_step_fns(jax_iface, losses, rollout=rollout, remat_rollout=remat,
                                      ensemble_size=M)
    return JaxTrainState.create(params, grad_store()), train_step


def port_ens_steps(ens, rollout, remat, **kw):
    iface = port_interface(ens, training=True)
    losses = {"data": get_loss_function({"name": "KernelCRPS", "scalers": []}, {})}
    train_step, eval_step = make_step_fns(iface, losses, rollout=rollout, remat_rollout=remat,
                                          ensemble_size=M, **kw)
    state = TrainState.create(iface, build_optimizer({"lr": {"rate": 1e-3}}))
    return iface, state, train_step, eval_step


@pytest.mark.parametrize("rollout,remat", [(1, False), (2, True)], ids=["r1", "r2_remat"])
def test_ensemble_step_gradients_match_jax(ens, monkeypatch, rollout, remat):
    batch = ens["batch"][:, :2 + rollout]
    # one draw per rollout step, in rollout order on both sides
    SameNoise(monkeypatch, noise_arrays(6, rollout, (M, ens["n_hidden"], 4)))
    state, train_step = jax_ens_steps(ens, rollout, remat)
    state, metrics = train_step(state, {"data": jnp.asarray(batch)})
    ref_grads = state_dict_from_jax(state.opt_state)

    iface, pstate, p_train, _ = port_ens_steps(ens, rollout, remat)
    loss = p_train.compute_gradients(pstate, {"data": torch.from_numpy(batch)})
    grads = {n: p.grad for n, p in iface.named_parameters()}
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=1e-4)
    assert float(metrics["grad_norm"]) > 0
    assert grads["model.processor.proc.1.layer_norm_attention.scale.weight"].abs().max() > 0
    assert_grads_close(grads, ref_grads)


def test_rollout_checkpoint_recompute_is_bitwise(ens, monkeypatch):
    """The packaged remat_rollout: the recompute in the backward reads the
    noise drawn for the forward, so the gradient equals the one without the
    rollout checkpoint bit for bit; the draws are seeded by (base seed,
    training step, rollout step)."""
    seeds = []
    draw = ensemble.standard_normal

    def recorded(shape, generator):
        seeds.append(generator.initial_seed())
        return draw(shape, generator)

    monkeypatch.setattr(ensemble, "standard_normal", recorded)
    batch = {"data": torch.from_numpy(ens["batch"])}
    grads = {}
    for remat in (False, True):
        iface, state, train_step, _ = port_ens_steps(ens, 2, remat)
        state.step = 5
        train_step.compute_gradients(state, batch)
        grads[remat] = {n: p.grad.clone() for n, p in iface.named_parameters()}
    assert all(torch.equal(grads[False][n], grads[True][n]) for n in grads[False])
    base = context_seed("ensemble-noise")
    want = [fold_seed(base, 5, 0), fold_seed(base, 5, 1)]
    assert seeds == want * 2 and want[0] != want[1]


def test_initial_weights_give_equal_members(ens):
    iface = AnemoiModelInterface(config=ens_config(), graph=ens["port_graph"],
                                 data_indices=flagship_indices(), statistics=ens["stats"],
                                 device="cpu")
    norms = [m for m in iface.modules() if isinstance(m, ConditionalLayerNorm)]
    assert len(norms) == 2 * 2  # two per processor layer
    assert all(not p.any() for m in norms for p in m.parameters())
    batch = {"data": torch.from_numpy(np.repeat(ens["batch"][:, :2], M, axis=2))}
    members = iface.predict_step(batch)["data"][0, 0]
    torch.testing.assert_close(members[0], members[1], rtol=0, atol=1e-6)
    # random kernels: a constant one would give scale(cond) = c * sum(cond) = 0,
    # the conditioning being a LayerNorm's zero-mean output
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in norms:
            m.scale.weight.add_(0.1 * torch.randn(m.scale.weight.shape, generator=gen))
    members = iface.predict_step(batch)["data"][0, 0]
    assert (members[0] - members[1]).abs().max() > 1e-2 * members.abs().max()
    # the default draw is context_generator("noise"): reproducible
    torch.testing.assert_close(iface.predict_step(batch)["data"][0, 0], members, rtol=0, atol=0)


def test_deterministic_rollouts_refuse_noise(ens):
    jax_iface, params = ens["NoiseConditioning"]
    window = jnp.asarray(np.repeat(ens["batch"], M, axis=2))
    with pytest.raises(flax.errors.InvalidRngError):
        jax_make_forecast_fn(jax_iface, 2)(params, {"data": window})
    iface = port_interface(ens)
    for fn in (make_forecast_fn, make_rollout_eval_fn):
        with pytest.raises(ValueError, match="predict_step"):
            fn(iface, 2)
    # NoOpNoiseInjector draws nothing: its forecast runs
    cfg = ens_config("NoOpNoiseInjector")
    noop = AnemoiModelInterface(config=cfg, graph=ens["port_graph"],
                                data_indices=flagship_indices(), statistics=ens["stats"],
                                device="cpu")
    out = make_forecast_fn(noop, 2)({"data": torch.from_numpy(ens["batch"])})["data"]
    assert tuple(out.shape) == (1, 2, 1, ens["n_grid"], 5) and torch.isfinite(out).all()


def crps_preset(tmp_path, name):
    """``ensemble_crps.yaml`` with its grid, mesh, widths and run cut small
    (the preset's 4 members); the rollout evaluation callback, which neither
    package runs on a noise-drawing model, left out."""
    overrides = [
        "data.datasets.data.nodes.grid=o8", "data.datasets.data.num_times=16",
        "graph.recipe.nodes.data.node_builder.grid=o8",
        "graph.recipe.nodes.hidden.node_builder.resolution=1",
        "model.num_channels=16", "model.processor.num_layers=2",
        "model.graph_attention_backend=segment", "model.inference_precision=fp32",
        "training.max_steps=2", "training.max_epochs=1", "training.precision=fp32",
        "training.lr.warmup=1", "dataloader.batch_size=1", "diagnostics.log_interval=1",
        "diagnostics.callbacks=[{name: LearningRateMonitor}]", "hardware.platform=cpu",
        f"graph.save_path={tmp_path / 'graph.npz'}", f"output_dir={tmp_path / name}",
    ]
    cfg = load_config(os.path.join(PACKAGED_CONFIG_DIR, "ensemble_crps.yaml"), overrides,
                      search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    ref = jax_load_config(os.path.join(JAX_CONFIG_DIR, "ensemble_crps.yaml"), overrides,
                          search_paths=[JAX_CONFIG_DIR]).to_dict()
    assert cfg == ref and cfg["training"]["ensemble_size"] == 4
    cfg["hardware"]["num_devices"] = 1
    return cfg


def test_ensemble_crps_preset_trains_as_jax_trains_it(tmp_path, monkeypatch):
    jax_cfg = crps_preset(tmp_path, "jax")
    jax_trainer = JaxTrainer(jax_cfg, output_dir=jax_cfg["output_dir"])
    initial = jax.device_get(jax_trainer.state.params)
    n_hidden = jax_trainer.interface.model_graph.num_nodes["hidden"]
    SameNoise(monkeypatch, noise_arrays(8, 1, (4, n_hidden, 8)))
    jax_trainer.train()
    port_cfg = crps_preset(tmp_path, "port")
    port_trainer = AnemoiTrainer(port_cfg, output_dir=port_cfg["output_dir"])
    with torch.no_grad():
        port_trainer.interface.load_state_dict(state_dict_from_jax(initial), strict=True)
    port_trainer.train()

    def records(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    ref, ours = records("jax"), records("port")
    steps = [r for r in ours if "loss" in r]
    assert len(steps) == 2 and all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in steps)
    for a, b in zip([r for r in ref if "loss" in r or "val_loss" in r],
                    [r for r in ours if "loss" in r or "val_loss" in r]):
        keys = [k for k in a if k in ("loss", "grad_norm", "lr", "val_loss")
                or k.startswith("rmse/")]
        assert keys and all(k in b for k in keys)
        np.testing.assert_allclose([b[k] for k in keys], [a[k] for k in keys], rtol=1e-4,
                                   err_msg=str(keys))

    # the bundle: served by predict_step for 4 members, refused by cli predict
    bundle = os.path.join(port_cfg["output_dir"], "inference")
    iface = load_inference_checkpoint(bundle, device="cpu")
    window = port_trainer.datamodule.make_batch(port_trainer.datamodule.train_starts[:1])
    out = iface.predict_step({"data": torch.from_numpy(np.repeat(window["data"], 4, axis=2))})
    n_grid = iface.model_graph.num_nodes["data"]
    assert tuple(out["data"].shape) == (1, 1, 4, n_grid, 11) and torch.isfinite(out["data"]).all()
    assert main(["predict", bundle, "--platform", "cpu", "--steps", "1",
                 "--output", str(tmp_path / "f.npz")]) == 1


def test_rollout_eval_callback_refuses_an_ensemble(tmp_path):
    cfg = crps_preset(tmp_path, "callback")
    cfg["diagnostics"]["callbacks"] = [{"name": "RolloutEvalCallback", "rollout": 2}]
    with pytest.raises(ValueError, match="make_rollout_eval_fn cannot run"):
        AnemoiTrainer(cfg, output_dir=cfg["output_dir"]).train()
    assert not os.path.exists(tmp_path / "callback" / "inference")
