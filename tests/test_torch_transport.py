"""The transport family (EDM diffusion, stochastic interpolants) of the port
against the JAX package.

Tiny transport models of the flagship's shape (o8 -> ico-1, 32 channels,
one processor layer, 4 heads, GT mappers, the ``segment`` attention) with
the JAX package's initialised parameters replaced by seeded random numbers
(the conditional norms' zero scale and bias included, so the conditioning
matters), moved with ``state_dict_from_jax`` and loaded strictly:

- ``plain``: ``AnemoiTransportModelEncProcDec``, the ``fourier`` embedding,
  processor-only conditioning, no diagnostic variable (so the
  ``reference_state`` source applies);
- ``mappers``: ``AnemoiTransportTendModelEncProcDec`` with ``noise_channels``
  (``noise_cond_mlp``, conditional mappers), the ``random_fourier``
  embedding, the flagship's diagnostic ``tp``.

The draws: ``jax.random.normal`` / ``uniform`` and the port's
``random_fields.standard_normal`` / ``uniform`` are patched inside each test
to return the same seeded arrays (``SameDraws``), so both packages see the
same sigma, t, noise and initial states.  Float32 tolerances, relative to
the largest magnitude: 3e-5 for functions and forwards, 1e-4 for steps,
gradients and samples.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.inference import make_transport_forecast_fn as jax_make_transport_forecast_fn
from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
from anemoi_tpu.models.transport import objectives as jax_objectives
from anemoi_tpu.models.transport import paths as jax_paths
from anemoi_tpu.models.transport import samplers as jax_samplers
from anemoi_tpu.models.transport import schedules as jax_schedules
from anemoi_tpu.models.transport import sources as jax_sources
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.transport_step import make_sampler as jax_make_sampler
from anemoi_tpu.training.transport_step import (
    make_transport_step_fns as jax_make_transport_step_fns,
)
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.flagship import VARIABLES, flagship_config, flagship_recipe
from anemoi_tpu_torch.flagship import flagship_statistics
from anemoi_tpu_torch.inference import make_forecast_fn, make_transport_forecast_fn
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.models.transport import objectives, paths, random_fields, samplers
from anemoi_tpu_torch.models.transport import schedules, sources
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.metrics import make_rollout_eval_fn
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState
from anemoi_tpu_torch.training.transport_step import make_sampler, make_transport_step_fns
from anemoi_tpu_torch.utils import threefry
from anemoi_tpu_torch.utils.seeding import context_seed, fold_seed
from test_torch_ensemble import assert_grads_close, close
from test_torch_training import grad_store, port_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 3e-5
STEP_TOL = 1e-4
FORCING = ["cos_lat", "z"]
MODELS = {  # name -> (model class, model keys, diagnostic variables)
    "plain": ("AnemoiTransportModelEncProcDec", {}, []),
    "mappers": ("AnemoiTransportTendModelEncProcDec",
                {"noise_channels": 16, "noise_cond_dim": 8, "noise_embedding": "random_fourier"},
                ["tp"]),
}


class SameDraws:
    """The JAX package's ``jax.random.normal`` / ``uniform`` and the port's
    ``random_fields.standard_normal`` / ``uniform`` return the same seeded
    arrays: per (kind, shape), ``n`` arrays taken in turn by each package
    (``n=1``: one array per shape, whatever the turn, for code that the JAX
    package traces once and runs several times).  The 1-D normal draw of
    the JAX ``random_fourier`` embedding (its frequencies) is left alone:
    the port recomputes it with ``utils/threefry.py``."""

    def __init__(self, monkeypatch, seed=0, n=1):
        self.rng, self.n, self.arrays = np.random.default_rng(seed), n, {}
        self.turns = {"jax": {}, "port": {}}
        self.jax_normal_orig = jax.random.normal
        monkeypatch.setattr(jax.random, "normal", self.jax_normal)
        monkeypatch.setattr(jax.random, "uniform", self.jax_uniform)
        monkeypatch.setattr(random_fields, "standard_normal", self.port_normal)
        monkeypatch.setattr(random_fields, "uniform", self.port_uniform)

    def draw(self, who, kind, shape):
        key = (kind, tuple(int(s) for s in shape))
        if key not in self.arrays:
            make = (self.rng.normal if kind == "normal"
                    else lambda size: self.rng.uniform(0.05, 0.95, size))
            self.arrays[key] = [make(size=key[1]).astype(np.float32) for _ in range(self.n)]
        turn = self.turns[who].get(key, 0)
        self.turns[who][key] = turn + 1
        return self.arrays[key][turn % self.n]

    def jax_normal(self, key, shape=(), dtype=jnp.float32):
        if len(shape) == 1:
            return self.jax_normal_orig(key, shape, dtype)
        return jnp.asarray(self.draw("jax", "normal", shape), dtype)

    def jax_uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(self.draw("jax", "uniform", shape), dtype)

    def port_normal(self, shape, generator, dtype=torch.float32):
        return torch.from_numpy(self.draw("port", "normal", shape)).to(dtype)

    def port_uniform(self, shape, generator):
        return torch.from_numpy(self.draw("port", "uniform", shape))


def model_config(name):
    cls, keys, _ = MODELS[name]
    cfg = flagship_config(num_channels=32, num_layers=1, num_heads=4, inference_precision="fp32")
    cfg["model"].update(name=cls, graph_attention_backend="segment", noise_embed_dim=8, **keys)
    return cfg


def indices(name, jax_side):
    cls = JaxIndexCollection if jax_side else IndexCollection
    return {"data": cls({n: i for i, n in enumerate(VARIABLES)}, forcing=FORCING,
                        diagnostic=MODELS[name][2])}


def n_in(name):
    """The model's input variables: every variable but the diagnostic ones."""
    return len(VARIABLES) - len(MODELS[name][2])


def randomised(params, rng):
    flat = flax.traverse_util.flatten_dict(params["params"])
    return {"params": flax.traverse_util.unflatten_dict(
        {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()})}


@pytest.fixture(scope="module")
def tr():
    graph = JaxGraphCreator(flagship_recipe("o8", 1)).create()
    stats = flagship_statistics(seed=1)
    out = {"graph": graph, "port_graph": port_graph(graph), "stats": stats,
           "n_grid": graph["data"].num_nodes}
    rng = np.random.default_rng(0)
    for name in MODELS:
        iface = JaxInterface(config=model_config(name), graph=graph,
                             data_indices=indices(name, True), statistics=stats)
        out[name] = (iface, randomised(jax.eval_shape(iface.init_params), rng))
    mean, std = stats["data"]["mean"], stats["data"]["stdev"]
    out["batch"] = (mean + std * rng.normal(size=(2, 4, 1, out["n_grid"], 7))).astype(np.float32)
    return out


def port_interface(tr, name, training=False):
    iface = AnemoiModelInterface(config=model_config(name), graph=tr["port_graph"],
                                 data_indices=indices(name, False), statistics=tr["stats"],
                                 device="cpu", training=training)
    iface.load_state_dict(state_dict_from_jax(tr[name][1]), strict=True)
    return iface


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --- schedules, paths, distributions, embeddings, sources ----------------------------
@pytest.mark.parametrize("name", sorted(jax_schedules.SIGMA_SCHEDULES))
def test_sigma_schedules_match_jax(name):
    for n in (1, 4, 20):
        want = jax_schedules.SIGMA_SCHEDULES[name](n, 0.03, 80.0)
        np.testing.assert_array_equal(schedules.SIGMA_SCHEDULES[name](n, 0.03, 80.0), want)
    np.testing.assert_array_equal(schedules.unit_time_schedule(5),
                                  jax_schedules.unit_time_schedule(5))
    assert schedules.karras_sigma_schedule(20).dtype == np.float32


@pytest.mark.parametrize("kind,stratified", [("lognormal", False), ("karras", False),
                                             ("linear", True), ("exponential", False),
                                             ("cosine", True)])
def test_training_sigma_distributions_match_jax(monkeypatch, kind, stratified):
    draws = SameDraws(monkeypatch, seed=1)
    shape = (4, 1, 2, 1, 1)
    kw = dict(kind=kind, sigma_min=0.03, sigma_max=70.0, p_mean=-1.0, p_std=1.1,
              stratified=stratified)
    want = jax_schedules.sample_training_sigma_dist(jax.random.PRNGKey(0), shape, **kw)
    got = schedules.sample_training_sigma_dist(torch.Generator(), shape, **kw)
    close(got, want, TOL)
    # the pure layer, on the same draw
    draw = draws.arrays[("normal" if kind == "lognormal" else "uniform", shape)][0]
    close(schedules.training_sigma_from_draw(t(draw), **kw), want, TOL)
    want_t = jax_schedules.sample_training_time(jax.random.PRNGKey(0), shape,
                                                stratified=stratified)
    close(schedules.sample_training_time(torch.Generator(), shape, stratified=stratified),
          want_t, TOL)
    with pytest.raises(ValueError, match="Unknown training sigma"):
        schedules.training_sigma_from_draw(t(draw), kind="uniform")


def test_paths_match_jax():
    u = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    close(paths.karras_sigma_from_unit_time(t(u), sigma_max=80.0, sigma_min=0.02, rho=7.0),
          jax_paths.karras_sigma_from_unit_time(jnp.asarray(u), sigma_max=80.0,
                                                sigma_min=0.02, rho=7.0), TOL)
    close(paths.edm_loss_weight(t(u + 0.1), 0.7), jax_paths.edm_loss_weight(u + 0.1, 0.7), TOL)
    for beta in ("linear", "quadratic"):
        close(paths.interpolant_beta(t(u), beta), jax_paths.interpolant_beta(u, beta), TOL)
        close(paths.interpolant_beta_dot(t(u), beta), jax_paths.interpolant_beta_dot(u, beta),
              TOL)
    close(paths.interpolant_alpha(t(u)), jax_paths.interpolant_alpha(u), TOL)
    close(paths.interpolant_alpha_dot(t(u)), jax_paths.interpolant_alpha_dot(jnp.asarray(u)),
          TOL)
    for sched in ("brownian_bridge", "quadratic_bridge"):
        close(paths.interpolant_sigma(t(u), schedule=sched, noise_scale=0.5),
              jax_paths.interpolant_sigma(jnp.asarray(u), schedule=sched, noise_scale=0.5), TOL)
        # the endpoints: the bridge's derivative guarded by eps, finite
        got = paths.interpolant_sigma_dot(t(u), schedule=sched)
        assert torch.isfinite(got).all()
        close(got, jax_paths.interpolant_sigma_dot(jnp.asarray(u), schedule=sched), TOL)
    with pytest.raises(ValueError):
        paths.interpolant_alpha(t(u), "cos")


@pytest.mark.parametrize("seed", [0, 1, 3, 42, 2**31 - 1])
def test_random_fourier_frequencies_are_jax_threefry(seed):
    """``random_fourier``'s frequencies: ``jax.random.normal(PRNGKey(seed),
    (half,))`` recomputed without JAX (the bits exactly)."""
    for half in (1, 4, 8, 16, 64):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(threefry.random_bits(threefry.prng_key(seed), (half,)),
                                      np.asarray(jax.random.bits(key, (half,))))
        np.testing.assert_allclose(threefry.normal(seed, (half,)),
                                   np.asarray(jax.random.normal(key, (half,))), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(jax_objectives.TIME_EMBEDDINGS))
def test_time_embeddings_match_jax(name):
    level = np.random.default_rng(2).normal(size=(6,)).astype(np.float32)
    for dim in (8, 16):
        close(objectives.TIME_EMBEDDINGS[name](t(level), dim),
              jax_objectives.TIME_EMBEDDINGS[name](jnp.asarray(level), dim), TOL)
    kw = {"fourier": {"max_freq": 8.0}, "random_fourier": {"seed": 3, "scale": 4.0},
          "sinusoidal": {"max_period": 1000.0}}[name]
    close(objectives.TIME_EMBEDDINGS[name](t(level), 12, **kw),
          jax_objectives.TIME_EMBEDDINGS[name](jnp.asarray(level), 12, **kw), TOL)


def test_edm_and_interpolant_targets_match_jax(monkeypatch):
    rng = np.random.default_rng(3)
    y0, y1 = (rng.normal(size=(2, 1, 3, 9, 4)).astype(np.float32) for _ in range(2))
    cfg = objectives.EDMConfig(sigma_data=0.8, p_mean=-0.5)
    jcfg = jax_objectives.EDMConfig(sigma_data=0.8, p_mean=-0.5)
    sigma = np.exp(rng.normal(size=(2, 1, 3, 1, 1))).astype(np.float32)
    for got, want in zip(objectives.edm_preconditioning(t(sigma), 0.8),
                         jax_objectives.edm_preconditioning(jnp.asarray(sigma), 0.8)):
        close(got, want, TOL)
    SameDraws(monkeypatch, seed=4, n=2)
    for sigma_dist in (None, {"kind": "karras", "sigma_max": 50.0}):
        want = jax_objectives.edm_training_targets(jax.random.PRNGKey(0), jnp.asarray(y1), jcfg,
                                                   sigma_dist=sigma_dist)
        got = objectives.edm_training_targets(torch.Generator(), t(y1), cfg, sigma_dist)
        for a, b in zip(got, want):
            close(a, b, TOL)
        close(objectives.edm_denoise(t(y0), got[0], got[1], cfg),
              jax_objectives.edm_denoise(jnp.asarray(y0), want[0], want[1], jcfg), TOL)
    for gamma, beta, sched in ((0.0, "linear", "brownian_bridge"),
                               (0.3, "quadratic", "quadratic_bridge"),
                               (0.5, "linear", "brownian_bridge")):
        want = jax_objectives.interpolant_training_targets(
            jax.random.PRNGKey(0), jnp.asarray(y0), jnp.asarray(y1), gamma,
            beta_schedule=beta, sigma_schedule=sched)
        got = objectives.interpolant_training_targets(
            torch.Generator(), t(y0), t(y1), gamma, beta_schedule=beta, sigma_schedule=sched)
        for a, b in zip(got, want):
            close(a, b, TOL)


def test_sources_match_jax(tr, monkeypatch):
    SameDraws(monkeypatch, seed=5)
    idx, jidx = indices("plain", False), indices("plain", True)
    x = tr["batch"][:, :2].copy()
    for n_out in (1, 2):
        specs = sources.sampling_source_specs({"data": t(x)}, n_step_output=n_out,
                                              num_output_channels={"data": 5})
        assert specs["data"].shape == (2, n_out, 1, tr["n_grid"], 5)
        jspecs = jax_sources.sampling_source_specs({"data": jnp.asarray(x)}, n_step_output=n_out,
                                                   num_output_channels={"data": 5})
        for kind in sorted(sources.TRANSPORT_SOURCE_KINDS):
            want = jax_sources.build_sources(kind, jax.random.PRNGKey(0), jspecs,
                                             x={"data": jnp.asarray(x)}, data_indices=jidx,
                                             n_step_output=n_out)
            got = sources.build_sources(kind, torch.Generator(), specs, x={"data": t(x)},
                                        data_indices=idx, n_step_output=n_out)
            assert got["data"].shape == specs["data"].shape
            close(got["data"], want["data"], TOL)
    with pytest.raises(ValueError, match="missing \\['tp'\\]"):
        sources.reference_state_source({"data": t(x)}, data_indices=indices("mappers", False),
                                       n_step_output=1)
    with pytest.raises(ValueError, match="Unknown transport source"):
        sources.build_sources("uniform", None, specs)
    # a field sharded over the grid: the block of the one-process draw
    # (the model-parallel runs: tests/test_torch_parallel_families.py)
    block = random_fields.randn_grid_sharded(torch.Generator().manual_seed(3), (3, 2),
                                             shard_sizes=(5, 3), shard_index=1)
    whole = random_fields.standard_normal((8, 2), torch.Generator().manual_seed(3))
    assert torch.equal(block, whole[5:])
    with pytest.raises(ValueError, match="needs shard_index"):
        random_fields.randn_grid_sharded(torch.Generator(), (2, 4), shard_sizes=(2, 2))


# --- samplers ------------------------------------------------------------------------
def toy_denoiser(lib):
    return lambda y, s: 0.6 * lib.tanh(y) + 0.05 * s


def toy_velocity(lib):
    return lambda x, s: -0.8 * x + lib.sin(x) * s


@pytest.mark.parametrize("sampler", sorted(samplers.SAMPLERS))
def test_samplers_match_jax_on_a_toy_field(sampler):
    y0 = np.random.default_rng(6).normal(size=(2, 1, 1, 7, 3)).astype(np.float32)
    vf = sampler.startswith("vf_")
    grid = (schedules.unit_time_schedule(6) if vf
            else schedules.karras_sigma_schedule(6, 0.02, 20.0))
    fn = toy_velocity if vf else toy_denoiser
    calls = []

    def counted(y, s):
        calls.append(s)
        return fn(torch)(y, s)

    got = samplers.SAMPLERS[sampler](counted, t(y0) * float(grid[0] if not vf else 1), grid)
    want = jax_samplers.SAMPLERS[sampler](fn(jnp), jnp.asarray(y0) * (grid[0] if not vf else 1),
                                          jnp.asarray(grid))
    close(got, want, TOL)
    assert all(isinstance(s, float) for s in calls)  # host floats: the loop never reads the card
    assert len(calls) == samplers.evaluations(sampler, 6, grid)
    assert samplers.evaluations("edm_heun", 20, schedules.karras_sigma_schedule(20)) == 39
    assert samplers.evaluations("vf_heun", 20, schedules.unit_time_schedule(20)) == 40


EDM_SAMPLING = {"sigma_data": 0.5, "sigma_min": 0.05, "sigma_max": 40.0}


@pytest.mark.parametrize("sampler", sorted(samplers.SAMPLERS))
def test_samplers_match_jax_on_the_model(tr, monkeypatch, sampler):
    """Four steps of each sampler with the model, from the same initial
    state; the EDM samplers with a non-default ``EDMConfig``."""
    jax_iface, params = tr["plain"]
    objective = "interpolant" if sampler.startswith("vf_") else "edm"
    SameDraws(monkeypatch, seed=7)
    x = np.random.default_rng(8).normal(size=(2, 2, 1, tr["n_grid"], n_in("plain")))
    x = x.astype(np.float32)
    want = jax_make_sampler(jax_iface, objective=objective, sampler=sampler, num_steps=4,
                            edm=jax_objectives.EDMConfig(**EDM_SAMPLING))(
        params, {"data": jnp.asarray(x)}, jax.random.PRNGKey(0))["data"]
    iface = port_interface(tr, "plain")
    generate = make_sampler(iface, objective=objective, sampler=sampler, num_steps=4,
                            edm=objectives.EDMConfig(**EDM_SAMPLING))
    if objective == "edm":
        assert generate.schedule[0] == 40.0 and generate.schedule[-2] == pytest.approx(0.05)
    got = generate({"data": t(x)}, torch.Generator())["data"]
    assert got.shape == (2, 1, 1, tr["n_grid"], 5) and got.dtype == torch.float32
    close(got, want, STEP_TOL)


# --- the models ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MODELS))
def test_transport_forward_matches_jax(tr, name):
    jax_iface, params = tr[name]
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 2, 1, tr["n_grid"], n_in(name))).astype(np.float32)
    y = rng.normal(size=(2, 1, 1, tr["n_grid"], 5)).astype(np.float32)
    level = rng.normal(size=(2, 1)).astype(np.float32)
    want = jax_iface.model.apply(params, {"data": jnp.asarray(x)}, {"data": jnp.asarray(y)},
                                 jnp.asarray(level), jax_iface.graph_inputs)["data"]
    iface = port_interface(tr, name)
    assert type(iface.model).__name__ == MODELS[name][0] and iface.is_transport
    with torch.no_grad():
        got = iface.run_model({"data": t(x)}, y_noised={"data": t(y)},
                              noise_level=t(level))["data"]
        other = iface.run_model({"data": t(x)}, y_noised={"data": t(y)},
                                noise_level=t(level + 1.0))["data"]
    assert got.shape == (2, 1, 1, tr["n_grid"], 5)
    close(got, want, TOL)
    assert (got - other).abs().max() > 1e-3  # the noise level conditions the output
    mappers = [m for n, m in iface.model.named_modules() if n.endswith("layer_norm_mlp_dst")]
    conditional = {type(m).__name__ for m in mappers}
    assert conditional == {"ConditionalLayerNorm"} if name == "mappers" else len(conditional) == 2
    assert hasattr(iface.model, "noise_cond_mlp") == (name == "mappers")
    assert not hasattr(iface.model, "residual") and not hasattr(iface.model, "boundings")


def jax_transport_step(tr, name, **kw):
    jax_iface, params = tr[name]
    losses = {"data": jax_get_loss_function({"name": "WeightedMSELoss", "scalers": []}, {})}
    train_step, eval_step = jax_make_transport_step_fns(jax_iface, losses, **kw)
    return JaxTrainState.create(params, grad_store()), train_step, eval_step


def port_transport_step(tr, name, **kw):
    iface = port_interface(tr, name, training=True)
    losses = {"data": get_loss_function({"name": "WeightedMSELoss", "scalers": []}, {})}
    train_step, eval_step = make_transport_step_fns(iface, losses, **kw)
    return iface, TrainState.create(iface, build_optimizer({"lr": {"rate": 1e-3}})), \
        train_step, eval_step


STEPS = {  # id -> (model, make_transport_step_fns keywords); the validation loss of two
    "edm": ("plain", {"objective": "edm"}),
    "edm_karras_tendency": ("mappers", {"objective": "edm", "tendency": True,
                                        "sigma_dist": {"kind": "karras"}}),
    "interpolant_zero": ("plain", {"objective": "interpolant", "source": "zero"}),
    "interpolant_gaussian_gamma": ("plain", {"objective": "interpolant", "source": "gaussian",
                                             "interpolant_gamma": 0.3}),
    "interpolant_reference_tendency": ("plain", {"objective": "interpolant", "tendency": True,
                                                 "source": "reference_state",
                                                 "interpolant_gamma": 0.2,
                                                 "beta_schedule": "quadratic"}),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_transport_step_matches_jax(tr, monkeypatch, case):
    """One training step's loss and gradients (and, in two cases, the
    validation loss)."""
    name, kw = STEPS[case]
    SameDraws(monkeypatch, seed=10, n=2)
    batch = tr["batch"][:, :3]
    state, train_step, eval_step = jax_transport_step(tr, name, **kw)
    new_state, metrics = train_step(state, {"data": jnp.asarray(batch)})
    ref_grads = state_dict_from_jax(new_state.opt_state)
    iface, pstate, p_train, p_eval = port_transport_step(tr, name, **kw)
    loss = p_train.compute_gradients(pstate, {"data": t(batch)})
    grads = {n: p.grad for n, p in iface.named_parameters()}
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=STEP_TOL)
    assert grads["model.processor.proc.0.layer_norm_attention.scale.weight"].abs().max() > 0
    assert_grads_close(grads, ref_grads, STEP_TOL)
    if case in ("edm", "interpolant_reference_tendency"):
        val = eval_step(new_state, {"data": jnp.asarray(batch)})["val_loss"]
        np.testing.assert_allclose(float(p_eval(pstate, {"data": t(batch)})["val_loss"]),
                                   float(val), rtol=STEP_TOL)


def test_transport_step_seeds_and_bf16(tr):
    """The noise of step s comes from fold_seed(base, s, 0), the
    validation's from fold_seed(base, 2**31 - 1, 0); bf16 runs the model on
    bfloat16 copies with a float32 loss."""
    seeds = []
    orig = random_fields.standard_normal

    def recorded(shape, generator, dtype=torch.float32):
        seeds.append(generator.initial_seed())
        return orig(shape, generator, dtype)

    batch = {"data": t(tr["batch"][:1, :3])}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(random_fields, "standard_normal", recorded)
        iface, state, train_step, eval_step = port_transport_step(tr, "plain")
        state.step = 4
        state, metrics = train_step(state, batch)
        eval_step(state, batch)
    base = context_seed("transport-noise")
    assert seeds == [fold_seed(base, 4, 0)] * 2 + [fold_seed(base, 2**31 - 1, 0)] * 2
    assert state.step == 5 and float(metrics["grad_norm"]) > 0
    iface, state, train_step, _ = port_transport_step(tr, "plain", precision="bf16")
    state, metrics = train_step(state, batch)
    assert metrics["loss"].dtype == torch.float32 and torch.isfinite(metrics["loss"])
    assert all(p.dtype == torch.float32 for p in iface.parameters())


def test_transport_forecast_matches_jax(tr, monkeypatch):
    """Two generative steps of the tendency model: sample, add the last
    state, denormalise, advance the window."""
    jax_iface, params = tr["mappers"]
    SameDraws(monkeypatch, seed=11)
    batch = tr["batch"][:1]
    want = jax_make_transport_forecast_fn(jax_iface, 2, sampler="edm_heun", num_steps=3,
                                          tendency=True)(params, {"data": jnp.asarray(batch)},
                                                         jax.random.PRNGKey(0))["data"]
    iface = port_interface(tr, "mappers")
    fn = make_transport_forecast_fn(iface, 2, sampler="edm_heun", num_steps=3, tendency=True)
    got = fn({"data": t(batch)}, torch.Generator())["data"]
    assert got.shape == (1, 2, 1, tr["n_grid"], 5)
    close(got, want, STEP_TOL)


def test_deterministic_paths_and_multi_dataset_refuse_transport(tr):
    iface = port_interface(tr, "plain")
    for fn in (make_forecast_fn, make_rollout_eval_fn):
        with pytest.raises(ValueError, match="transport model"):
            fn(iface, 2)
    with pytest.raises(ValueError, match="sampled, not applied"):
        iface.apply({"data": t(tr["batch"][:, :2])})
    two = IndexCollection({n: i for i, n in enumerate(VARIABLES)}, forcing=FORCING)
    iface.data_indices = {"a": two, "b": two}
    for fn in (make_transport_step_fns, make_sampler):
        with pytest.raises(ValueError, match="one dataset.*KeyError"):
            fn(iface, {})
