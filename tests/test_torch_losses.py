"""Losses, scalers and AdEMAMix of the port against the JAX package.

The same inputs, made from a numpy seed, go through both: ``[B, T, E, G,
V]`` predictions and targets with NaN targets, the example's 12 variables
(11 model outputs), a 24-node grid with area weights and a boolean mask.

- Every leaf (MSE, MAE, RMSE, Huber, log-cosh), ``CombinedLoss`` whose
  members select their own scalers, ``TimeAggregateLossWrapper`` with a
  time scaler, and ``LossVariableMapper`` with variable scalers filtered to
  its subset (also scoring one variable against another): the value with
  and without the imputer mask, ``squash=False``, and the gradient with
  respect to the prediction.  rtol/atol 3e-5.
- Every scaler of ``ReweightedGraphNodeAttributeScaler``, the tendency
  scalers, the time-step scalers and ``SpectralDimensionScaler`` against
  ``create_scalers``.
- AdEMAMix (both warmups, weight decay, value clipping, a warmup-cosine
  rate) over 10 steps against the JAX optimizer's trajectory.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
from anemoi_tpu.graphs.graph import Graph as JaxGraph
from anemoi_tpu.graphs.graph import NodeSet as JaxNodeSet
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.flagship import EXAMPLE_VARIABLES
from anemoi_tpu_torch.graphs.graph import Graph, NodeSet
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import AdEMAMix, build_optimizer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 3e-5
N2I = {n: i for i, n in enumerate(EXAMPLE_VARIABLES)}
ROLES = {"forcing": ["cos_lat"], "diagnostic": ["tp"]}
G = 24
SCALERS = {
    "area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
             "attribute_name": "area_weight"},
    "variable": {"name": "GeneralVariableLossScaler", "weights": {"q": 2.0, "t_850": 3.0}},
    "level": {"name": "ReluVariableLevelScaler", "slope": 0.001, "y_intercept": 0.2},
    "time": {"name": "TimeStepScaler", "weights": [1.0, 0.5, 0.25]},
    "tendency": {"name": "StdevTendencyScaler"},
}


def make_graphs():
    rng = np.random.default_rng(0)
    coords = np.stack([rng.uniform(-1.5, 1.5, G), rng.uniform(-3, 3, G)], -1)
    attrs = {"area_weight": rng.uniform(0.2, 1.0, (G, 1)).astype(np.float32),
             "interior": (rng.random((G, 1)) < 0.4)}
    g_jax, g_port = JaxGraph(), Graph()
    g_jax["data"] = JaxNodeSet(coords=coords, attributes=dict(attrs))
    g_port["data"] = NodeSet(coords=coords, attributes=dict(attrs))
    return g_jax, g_port


def statistics():
    rng = np.random.default_rng(1)
    v = len(EXAMPLE_VARIABLES)
    stdev = rng.uniform(0.5, 2.0, v)
    tend = {"stdev": rng.uniform(0.1, 1.0, v)}
    tend["stdev"][N2I["z_500"]] = 0.0  # no tendency spread: weight 1
    return {"mean": rng.normal(size=v), "stdev": stdev}, tend


@pytest.fixture(scope="module")
def setup():
    g_jax, g_port = make_graphs()
    stats, tend = statistics()
    jidx = JaxIndexCollection(N2I, **ROLES)
    pidx = IndexCollection(N2I, **ROLES)
    kw = dict(statistics=stats, statistics_tendencies=tend)
    ref = jax_create_scalers(SCALERS, graph=g_jax, data_indices=jidx, **kw)
    ours = create_scalers(SCALERS, graph=g_port, data_indices=pidx, **kw)
    return {"jidx": jidx, "pidx": pidx, "ref": ref, "ours": ours}


def data(t=3, v=11, seed=2, nans=True):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(2, t, 1, G, v)).astype(np.float32)
    target = (pred + rng.normal(size=pred.shape) * 1.5).astype(np.float32)
    if nans:
        target[rng.random(target.shape) < 0.1] = np.nan
    mask = (rng.random((2, G, v)) > 0.2).astype(np.float32)
    return pred, target, mask


def compare(setup, cfg, metadata=None, nans=True, masked=True):
    """The loss built by both packages from ``cfg``: value and gradient,
    squashed and per variable, with the imputer mask (``masked``) and
    without."""
    jloss = jax_get_loss_function(dict(cfg), setup["ref"], data_indices=setup["jidx"],
                                  variables_metadata=metadata)
    ploss = get_loss_function(dict(cfg), setup["ours"], data_indices=setup["pidx"],
                              variables_metadata=metadata)
    pred, target, mask = data(nans=nans)
    for kw in ({}, {"squash": False}) + (({"mask": True}, {"squash": False, "mask": True})
                                         if masked else ()):
        jkw = {k: jnp.asarray(mask) if k == "mask" else v for k, v in kw.items()}
        pkw = {k: torch.from_numpy(mask) if k == "mask" else v for k, v in kw.items()}

        def jfn(p):
            return jnp.sum(jloss(p, jnp.asarray(target), **jkw))

        ref, ref_grad = jfn(jnp.asarray(pred)), jax.grad(jfn)(jnp.asarray(pred))
        p = torch.tensor(pred, requires_grad=True)
        out = ploss(p, torch.from_numpy(target), **pkw)
        if kw.get("squash") is False:
            want = np.asarray(jloss(jnp.asarray(pred), jnp.asarray(target), **jkw))
            assert out.shape == want.shape
            np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL, atol=TOL,
                                       err_msg=f"{cfg['name']} {kw}")
        out.sum().backward()
        np.testing.assert_allclose(float(out.detach().sum()), float(ref), rtol=TOL, atol=TOL,
                                   err_msg=f"{cfg['name']} {kw}")
        assert torch.isfinite(p.grad).all()
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad), rtol=TOL,
                                   atol=TOL * float(np.abs(ref_grad).max()),
                                   err_msg=f"{cfg['name']} {kw} gradient")
    return ploss


@pytest.mark.parametrize("name,extra", [
    ("WeightedMSELoss", {}), ("WeightedMAELoss", {}), ("WeightedRMSELoss", {}),
    ("WeightedHuberLoss", {"delta": 0.5}), ("WeightedLogCoshLoss", {}),
    ("WeightedMSELoss", {"ignore_nans": False}),
])
def test_leaves_match_jax(setup, name, extra):
    cfg = {"name": name, "scalers": ["area", "variable", "level"], **extra}
    # without NaN masking a NaN target poisons both: none then
    compare(setup, cfg, nans=extra.get("ignore_nans", True))


def test_combined_loss_matches_jax(setup):
    cfg = {"name": "CombinedLoss", "scalers": ["area", "variable", "level"],
           "losses": [{"name": "WeightedMSELoss", "scalers": ["area", "level"]},
                      {"name": "WeightedMAELoss", "scalers": ["variable"]},
                      {"name": "WeightedHuberLoss", "delta": 0.3}],
           "loss_weights": [1.0, 0.5, 2.0]}
    loss = compare(setup, cfg)
    assert [sorted(m.scalers.scalers) for m in loss.members] == [
        ["area", "level"], ["variable"], ["area", "level", "variable"]]


def test_time_aggregate_wrapper_matches_jax(setup):
    cfg = {"name": "TimeAggregateLossWrapper", "time_aggregation_types": ["diff", "mean", "min",
                                                                          "max"],
           "scalers": ["area", "variable", "time"], "loss": {"name": "WeightedMSELoss"}}
    compare(setup, cfg)
    with pytest.raises(ValueError, match="time dimension"):
        get_loss_function(cfg, setup["ours"])(torch.zeros(1, 1, 1, G, 11), torch.zeros(1, 1, 1, G,
                                                                                         11))
    with pytest.raises(ValueError, match="aggregation type"):
        get_loss_function({**cfg, "time_aggregation_types": ["median"]}, setup["ours"])


@pytest.mark.parametrize("case", ["subset", "renamed"])
def test_loss_variable_mapper_matches_jax(setup, case):
    predicted = ["q_850", "t_850", "2t", "10u"]
    cfg = {"name": "LossVariableMapper", "predicted_variables": predicted,
           "loss": {"name": "WeightedMSELoss", "scalers": ["area", "variable", "level",
                                                           "tendency"]}}
    metadata = None
    if case == "renamed":  # 2t scored against t_850, 10u against 10v: same units
        cfg["target_variables"] = ["q_850", "t_850", "t_850", "10v"]
        metadata = {"2t": {"units": "K"}, "t_850": {"units": "K"}, "10u": {"units": "m/s"},
                    "10v": {"units": "m/s"}}
    # the targets of the step are laid out in model-output order; the
    # imputer's mask has the full model-output width, which neither package
    # cuts to the mapper's subset
    cfg["target_layout"] = "model_output"
    loss = compare(setup, cfg, metadata=metadata, masked=False)
    var = dict(loss.loss.scalers.scalers)["variable"][1]
    out_pos = setup["pidx"].model.output.name_to_position
    full = setup["ours"]["variable"][1]
    np.testing.assert_array_equal(var.numpy(), full[[out_pos[n] for n in predicted]])
    if case == "renamed":
        bad = dict(metadata, **{"10v": {"units": "K"}})
        for get, idx in ((jax_get_loss_function, setup["jidx"]), (get_loss_function,
                                                                   setup["pidx"])):
            scalers = setup["ref"] if get is jax_get_loss_function else setup["ours"]
            with pytest.raises(ValueError, match="not compatible"):
                get(dict(cfg), scalers, data_indices=idx, variables_metadata=bad)


def test_loss_variable_mapper_needs_indices(setup):
    with pytest.raises(ValueError, match="data_indices"):
        get_loss_function({"name": "LossVariableMapper"}, setup["ours"])
    with pytest.raises(ValueError, match="Cannot resolve"):
        get_loss_function({"name": "LossVariableMapper", "predicted_variables": ["nope"]},
                          setup["ours"], data_indices=setup["pidx"])


MORE_SCALERS = {
    "reweighted": {"name": "ReweightedGraphNodeAttributeScaler", "nodes_name": "data",
                   "attribute_name": "area_weight", "scaling_mask_attribute_name": "interior",
                   "weight_frac_of_total": 0.7},
    "reweighted_inverse": {"name": "ReweightedGraphNodeAttributeScaler",
                           "scaling_mask_attribute_name": "interior",
                           "weight_frac_of_total": 0.25, "inverse": True, "norm": "unit-max"},
    "no_tendency": {"name": "NoTendencyScaler"},
    "stdev_tendency": {"name": "StdevTendencyScaler", "norm": "unit-mean"},
    "var_tendency": {"name": "VarTendencyScaler"},
    "legacy_tendency": {"name": "TendencyScaler"},
    "time_weights": {"name": "TimeStepScaler", "weights": [3.0, 1.0], "norm": "unit-sum"},
    "time_gamma": {"name": "TimeStepScaler", "n_steps": 4, "gamma": 0.8},
    "uniform_time": {"name": "UniformTimeStepScaler", "n_steps": 5},
    "decay_linear": {"name": "LeadTimeDecayScaler", "output_lead_times": [6, 12, 18, 24],
                     "decay_factor": 0.5, "max_lead_time": 24},
    "decay_exp_inverse": {"name": "LeadTimeDecayScaler", "output_lead_times": [6, 12, 48],
                          "decay_factor": 2.0, "max_lead_time": 48,
                          "decay_type": "exponential", "inverse": True},
    "spectral": {"name": "SpectralDimensionScaler", "n_spectral_modes": 8},
    "spectral_dims": {"name": "SpectralDimensionScaler", "n_spectral_modes": 8,
                      "spectral_dims": 5, "norm": "unit-max"},
}


def test_scalers_match_create_scalers():
    g_jax, g_port = make_graphs()
    stats, tend = statistics()
    ref = jax_create_scalers(MORE_SCALERS, graph=g_jax, data_indices=JaxIndexCollection(
        N2I, **ROLES), statistics=stats, statistics_tendencies=tend)
    ours = create_scalers(MORE_SCALERS, graph=g_port, data_indices=IndexCollection(N2I, **ROLES),
                          statistics=stats, statistics_tendencies=tend)
    assert sorted(ours) == sorted(ref) == sorted(MORE_SCALERS)
    for name, (dims, arr) in ref.items():
        assert ours[name][0] == dims, name
        assert ours[name][1].dtype == np.float32, name
        np.testing.assert_allclose(ours[name][1], arr, rtol=1e-6, atol=0, err_msg=name)
    # the dataset without tendency statistics: every tendency weight is 1
    plain = create_scalers({"t": {"name": "VarTendencyScaler"}},
                           data_indices=IndexCollection(N2I, **ROLES), statistics=stats)
    np.testing.assert_array_equal(plain["t"][1], np.ones(11, np.float32))
    with pytest.raises(ValueError, match="weight_frac_of_total"):
        create_scalers({"r": {**MORE_SCALERS["reweighted"], "weight_frac_of_total": 1.0}},
                       graph=g_port)
    with pytest.raises(KeyError, match="available boolean node attributes"):
        create_scalers({"r": {**MORE_SCALERS["reweighted"],
                              "scaling_mask_attribute_name": "nope"}}, graph=g_port)


OPTIMIZER = {"optimizer": {"name": "ademamix", "b1": 0.9, "b2": 0.99, "b3": 0.999,
                           "alpha": 4.0, "b3_warmup": 6, "alpha_warmup": 4,
                           "weight_decay": 0.01},
             "lr": {"rate": 1e-2, "min": 1e-4, "warmup": 3, "iterations": 20},
             "gradient_clip": {"val": 0.5, "algorithm": "value"}}


@pytest.mark.parametrize("options", [{}, {"weight_decay": 0.0, "b3_warmup": None,
                                          "alpha_warmup": None}],
                         ids=["warmups_and_decay", "plain"])
def test_ademamix_trajectory_matches_jax(options):
    cfg = {**OPTIMIZER, "optimizer": {**OPTIMIZER["optimizer"], **options}}
    rng = np.random.default_rng(3)
    init = {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}
    goal = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}

    def grad(params):  # of sum((p - goal)^3 / 3 + p^2): a gradient that changes sign
        return {k: (p - goal[k]) ** 2 * np.sign(p - goal[k]) + 2 * p for k, p in params.items()}

    tx = jax_build_optimizer(cfg)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    ref = []
    for _ in range(10):
        g = {k: jnp.asarray(v) for k, v in grad({k: np.asarray(p) for k, p in params.items()})
             .items()}
        updates, state = tx.update(g, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        ref.append({k: np.asarray(v) for k, v in params.items()})

    ours = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = build_optimizer(cfg)(ours.values())
    assert isinstance(opt.opt, AdEMAMix)
    for step in range(10):
        for k, p in ours.items():
            p.grad = torch.from_numpy(grad({k: p.detach().numpy()})[k])
        opt.step()
        for k, p in ours.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[step][k], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step + 1} {k}")
    for p in ours.values():
        st = opt.opt.state[p]
        assert st["count"] == 10
        assert all(st[k].dtype == torch.float32 and st[k].shape == p.shape
                   for k in ("m1", "m2", "nu"))


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_adam_ignores_eps_as_jax_does(name):
    """``training.optimizer.eps`` is swallowed by the JAX factories (optax
    keeps 1e-8); the port's must swallow it too: with ``eps: 0.1`` both
    packages' four float32 steps agree to 1e-6."""
    cfg = {"optimizer": {"name": name, "eps": 0.1, "b1": 0.9, "b2": 0.95,
                         **({"weight_decay": 0.01} if name == "adamw" else {})},
           "lr": {"rate": 1e-2, "min": 1e-4, "warmup": 1, "iterations": 20}}
    rng = np.random.default_rng(4)
    init = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=init.shape).astype(np.float32) * 1e-3 for _ in range(4)]
    tx = jax_build_optimizer(cfg)
    params = jnp.asarray(init)
    state = tx.init(params)
    ours = torch.nn.Parameter(torch.from_numpy(init.copy()))
    opt = build_optimizer(cfg)([ours])
    for step, g in enumerate(grads):
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = params + updates
        ours.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(params), rtol=0, atol=1e-6,
                                   err_msg=f"step {step + 1}")
    assert float(np.abs(np.asarray(params) - init).max()) > 1e-3  # the steps moved the weights
