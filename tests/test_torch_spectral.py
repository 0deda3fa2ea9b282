"""The spectral transforms, the spectral losses and the spectral Ornstein
residual of the port against the JAX package.

The same arrays, made from a numpy seed, go through both, in float32:

- ``ReducedSHT`` (octahedral and classic reduced, n 8 and 16) and
  ``GaussianSHT`` (F8): ``analysis``, ``synthesis`` of the JAX
  coefficients and ``power_spectrum``; ``fft2``, ``ifft2``, ``dct2`` and
  ``ring_power_spectrum``; a band-limited field survives analysis and
  synthesis (1e-4).  Within 3e-5 of the largest magnitude.
- Each of the eight losses on ``[B, T, E, G, V]`` predictions and targets
  (NaNs in the target), over ``octahedral_sht`` (O8) and, where the loss
  takes them, ``fft2d`` / ``dct2d`` (an 8 x 12 grid), with a variable
  scaler: the value (3e-5), ``squash=False`` (3e-5) and the gradient with
  respect to the prediction (1e-4); ``SpectralCRPSLoss`` over 1 and 3
  members.  The refusals: a grid scaler sized to the grid, a power
  spectrum of ``fft2d``.
- ``SpectralOrnsteinConnection`` (octahedral O8, full F8) as a module: the
  skip and the gradients of its theta, its mu and the input; a grid of the
  wrong size raises.
- ``point_wise.yaml`` cut to o8 (as ``tests/test_torch_presets_tasks.py``)
  with ``CombinedLoss`` (area-weighted MSE + ``SpectralAMSELoss`` on O8)
  and ``residual: SpectralOrnsteinConnection``, trained two steps by both
  trainers: every record within 1e-4.
"""

import os

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from anemoi_tpu.ops import spectral as jax_spectral
from anemoi_tpu.models.layers.residual import (
    SpectralOrnsteinConnection as JaxSpectralOrnstein,
)
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.models.layers.residual import SpectralOrnsteinConnection, build_residual
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.ops import spectral
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR
from test_torch_presets_tasks import (
    LR_ONLY,
    _SMALL_DATA,
    _SMALL_MESH,
    assert_records_equal,
    composed,
    train_both,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL, GRAD_TOL = 3e-5, 1e-4
O8_POINTS = 544
NY, NX = 8, 12  # the regular grid of fft2d / dct2d / the zonal losses


def close(ours, ref, tol=TOL):
    ref = np.asarray(ref)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * float(np.abs(ref).max()))


# --- the transforms -------------------------------------------------------
SHTS = {"octahedral_8": ("octahedral", 8), "octahedral_16": ("octahedral", 16),
        "reduced_8": ("reduced", 8), "reduced_16": ("reduced", 16), "full_8": ("full", 8)}


def both_shts(kind, n):
    if kind == "full":
        return jax_spectral.GaussianSHT.create(n), spectral.GaussianSHT.create(n)
    return (jax_spectral.ReducedSHT.create(n, kind=kind),
            spectral.ReducedSHT.create(n, kind=kind))


@pytest.mark.parametrize("case", sorted(SHTS))
def test_sht_matches_jax(case):
    kind, n = SHTS[case]
    ref, ours = both_shts(kind, n)
    shape = (3, 2 * n, 4 * n) if kind == "full" else (3, ref.n_points)
    field = np.random.default_rng(n).normal(size=shape).astype(np.float32)
    coeffs = ref.analysis(jnp.asarray(field))
    got = ours.analysis(torch.from_numpy(field))
    assert got.dtype == torch.complex64
    close(got, coeffs)
    close(ours.synthesis(torch.from_numpy(np.asarray(coeffs))), ref.synthesis(coeffs))
    close(ours.power_spectrum(torch.from_numpy(field)), ref.power_spectrum(jnp.asarray(field)))
    # a band-limited field (l <= n / 2, a few modes) comes back through both ways
    band = np.zeros(np.asarray(coeffs).shape[-2:], np.complex64)
    band[2, 1], band[n // 2, 3], band[1, 0] = 1.0 + 0.5j, -0.7j, 0.8
    smooth = ours.synthesis(torch.from_numpy(band))
    close(ours.synthesis(ours.analysis(smooth)), smooth.numpy(), 1e-4)


def test_fft_dct_and_ring_spectrum_match_jax():
    g = np.random.default_rng(1).normal(size=(2, 3, NY, NX)).astype(np.float32)
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    close(spectral.fft2(tg), jax_spectral.fft2(jg))
    close(spectral.ifft2(spectral.fft2(tg)), jax_spectral.ifft2(jax_spectral.fft2(jg)))
    close(spectral.ifft2(spectral.fft2(tg)), g)
    close(spectral.dct2(tg), jax_spectral.dct2(jg))
    flat = g.reshape(2, 3, NY * NX)
    close(spectral.ring_power_spectrum(torch.from_numpy(flat), NY, NX),
          jax_spectral.ring_power_spectrum(jnp.asarray(flat), NY, NX))


# --- the losses -----------------------------------------------------------
SHT = {"transform": "octahedral_sht", "gaussian_n": 8}
FFT = {"transform": "fft2d", "x_dim": NX, "y_dim": NY}
DCT = {"transform": "dct2d", "x_dim": NX, "y_dim": NY}
LOSSES = {  # case -> (config, grid points, members)
    "PowerSpectrumLoss_sht": ({"name": "PowerSpectrumLoss", **SHT}, O8_POINTS, 1),
    "SpectralAMSELoss_sht": ({"name": "SpectralAMSELoss", **SHT}, O8_POINTS, 1),
    "LogSpectralDistance_sht": ({"name": "LogSpectralDistance", **SHT}, O8_POINTS, 1),
    "LogSpectralDistance_fft2d": ({"name": "LogSpectralDistance", **FFT}, NY * NX, 1),
    "LogSpectralDistance_dct2d": ({"name": "LogSpectralDistance", **DCT}, NY * NX, 1),
    "LogFFT2Distance": ({"name": "LogFFT2Distance", "x_dim": NX, "y_dim": NY}, NY * NX, 1),
    "SpectralCRPSLoss_sht": ({"name": "SpectralCRPSLoss", **SHT}, O8_POINTS, 1),
    "SpectralCRPSLoss_sht_3_members": ({"name": "SpectralCRPSLoss", "alpha": 0.9, **SHT},
                                       O8_POINTS, 3),
    "SpectralCRPSLoss_fft2d_3_members": ({"name": "SpectralCRPSLoss", **FFT}, NY * NX, 3),
    "ZonalSpectralLoss": ({"name": "ZonalSpectralLoss", "nlat": NY, "nlon": NX}, NY * NX, 1),
    "SphericalSpectralLoss_octahedral": ({"name": "SphericalSpectralLoss", "gaussian_n": 8,
                                          "grid_kind": "octahedral"}, O8_POINTS, 1),
    "SphericalSpectralLoss_full": ({"name": "SphericalSpectralLoss", "gaussian_n": 4,
                                    "log_space": False}, 8 * 16, 1),
    "FourierCorrelationLoss": ({"name": "FourierCorrelationLoss", "nlat": NY, "nlon": NX},
                               NY * NX, 1),
}
V = 3
VARIABLE_SCALER = {"variable": (("variable",), np.array([1.0, 2.0, 0.5], np.float32))}


def loss_inputs(n_grid, members, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(2, 1, members, n_grid, V)).astype(np.float32)
    target = rng.normal(size=(2, 1, 1, n_grid, V)).astype(np.float32)
    target[0, 0, 0, :5, 1] = np.nan
    return pred, target


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_jax(case):
    cfg, n_grid, members = LOSSES[case]
    pred, target = loss_inputs(n_grid, members)
    ref = jax_get_loss_function(dict(cfg), VARIABLE_SCALER)
    ours = get_loss_function(dict(cfg), VARIABLE_SCALER)
    jt = jnp.asarray(target)
    value, grad = jax.value_and_grad(lambda p: ref(p, jt))(jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    got = ours(tp, torch.from_numpy(target))
    assert got.dim() == 0 and torch.isfinite(got)
    close(got, value)
    got.backward()
    close(tp.grad, grad, GRAD_TOL)
    close(ours(torch.from_numpy(pred), torch.from_numpy(target), squash=False),
          ref(jnp.asarray(pred), jt, squash=False))


def test_loss_refusals_match_jax():
    pred, target = loss_inputs(O8_POINTS, 1)
    area = {"area": (("grid",), np.ones(O8_POINTS, np.float32))}
    cfg = {"name": "SpectralAMSELoss", **SHT}
    with pytest.raises(AssertionError, match="spectral-dimension scalers"):
        jax_get_loss_function(dict(cfg), area)(jnp.asarray(pred), jnp.asarray(target))
    with pytest.raises(ValueError, match="spectral-dimension scalers"):
        get_loss_function(dict(cfg), area)(torch.from_numpy(pred), torch.from_numpy(target))
    # a grid scaler sized to the modes (8 degrees) is a spectral scaler
    modes = {"degree": (("grid",), np.linspace(1.0, 2.0, 8).astype(np.float32))}
    close(get_loss_function(dict(cfg), modes)(torch.from_numpy(pred), torch.from_numpy(target)),
          jax_get_loss_function(dict(cfg), modes)(jnp.asarray(pred), jnp.asarray(target)))
    with pytest.raises(AssertionError):
        jax_get_loss_function({"name": "PowerSpectrumLoss", **FFT})
    with pytest.raises(ValueError, match="per-degree power"):
        get_loss_function({"name": "PowerSpectrumLoss", **FFT})


# --- the spectral Ornstein residual --------------------------------------
@pytest.mark.parametrize("grid_kind, n, n_grid", [("octahedral", 8, O8_POINTS),
                                                  ("full", 4, 8 * 16)])
def test_spectral_ornstein_matches_jax(grid_kind, n, n_grid):
    prog, num_vars = (0, 1, 3), 5
    kw = dict(gaussian_n=n, grid_kind=grid_kind, theta_init=0.4, theta_buff=0.1)
    ref = JaxSpectralOrnstein(prog_idx=prog, num_vars=num_vars, name="residual_data", **kw)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 2, 1, n_grid, num_vars)).astype(np.float32)
    params = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = flax.traverse_util.flatten_dict(params["params"])
    assert np.all(np.asarray(flat[("theta_logit",)]) == np.float32(0.4))
    params = {"params": flax.traverse_util.unflatten_dict(
        {k: (v + 0.3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()})}
    ours = SpectralOrnsteinConnection(prog, num_vars, **kw)
    assert torch.all(ours.theta_logit == 0.4) and not ours.mu.any()
    sd = state_dict_from_jax({"residual_data": params["params"]})
    ours.load_state_dict({k[len("model.residual.data."):]: v for k, v in sd.items()},
                         strict=True)
    cot = rng.normal(size=(2, 2, 1, n_grid, num_vars)).astype(np.float32)

    def loss(p, xx):
        out = ref.apply(p, xx, n_step_output=2)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = ours(tx, n_step_output=2)
    close(out, want)
    (out * torch.from_numpy(cot)).sum().backward()
    close(ours.theta_logit.grad, grads[0]["params"]["theta_logit"], GRAD_TOL)
    close(ours.mu.grad, grads[0]["params"]["mu"], GRAD_TOL)
    close(tx.grad, grads[1], GRAD_TOL)
    with pytest.raises(ValueError, match="points"):
        ours(tx[..., :-1, :])


def test_spectral_ornstein_is_built_from_the_config():
    idx = IndexCollection({"q": 0, "t": 1, "z": 2, "tp": 3}, forcing=["z"], diagnostic=["tp"])
    res = build_residual({"name": "SpectralOrnsteinConnection", "gaussian_n": 8,
                          "grid_kind": "octahedral", "lmax": 5}, idx)
    assert res.prog_idx == [0, 1] and res.num_vars == 3 and res.theta_logit.shape == (6,)
    with pytest.raises(ValueError, match="data_indices"):
        build_residual({"name": "SpectralOrnsteinConnection", "gaussian_n": 8})


# --- trained by both trainers ---------------------------------------------
SPECTRAL_TRAINING = [
    "training.loss={name: CombinedLoss, losses: [{name: WeightedMSELoss, scalers: [area, "
    "variable]}, {name: SpectralAMSELoss, transform: octahedral_sht, gaussian_n: 8, scalers: "
    "[variable]}], loss_weights: [1.0, 0.5]}",
    "model.residual={name: SpectralOrnsteinConnection, gaussian_n: 8, grid_kind: octahedral, "
    "theta_init: 0.3}",
]


def test_spectral_loss_and_residual_train_as_jax_trains_them(tmp_path):
    path = os.path.join(PACKAGED_CONFIG_DIR, "point_wise.yaml")
    overrides = (_SMALL_DATA + _SMALL_MESH + ["model.processor.num_layers=1", LR_ONLY]
                 + SPECTRAL_TRAINING)
    ref, ours, trainer = train_both(
        tmp_path, lambda name: composed(path, PACKAGED_CONFIG_DIR, overrides, tmp_path, name))
    model = trainer.interface.model
    assert type(model.residual["data"]).__name__ == "SpectralOrnsteinConnection"
    assert [type(m).__name__ for m in trainer.losses["data"].members] == [
        "WeightedMSELoss", "SpectralAMSELoss"]
    assert_records_equal(ref, ours)
