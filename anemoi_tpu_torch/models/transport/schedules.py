"""Schedules of the transport samplers and training distributions.

Port of ``anemoi_tpu.models.transport.schedules``.  The inference schedules
(Karras, linear, cosine and exponential sigma schedules, descending with a
terminal 0, and the unit-time grid of the vector-field samplers) stay numpy
float32 arrays: the samplers loop over them on the host, so the loop never
reads the device.  ``training/transport_step.make_sampler`` samples on the
Karras schedule, as the JAX ``predict`` does; the other three are kept as
the JAX module has them.

The training distributions are split in two layers: a pure function of the
draw (``training_sigma_from_draw``, ``unit_time_from_uniform``) that the
tests feed with the JAX package's arrays, and a thin draw from a
``torch.Generator`` (``sample_training_sigma_dist``,
``sample_training_time``) through ``random_fields.standard_normal`` and
``random_fields.uniform``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from anemoi_tpu_torch.models.transport import random_fields


def karras_sigma_schedule(
    num_steps: int, sigma_min: float = 0.02, sigma_max: float = 88.0, rho: float = 7.0
) -> np.ndarray:
    """Karras et al. (2022) rho-schedule, descending, with terminal 0."""
    i = np.arange(num_steps)
    s = (
        sigma_max ** (1 / rho)
        + i / max(num_steps - 1, 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))
    ) ** rho
    return np.concatenate([s, [0.0]]).astype(np.float32)


def linear_sigma_schedule(num_steps: int, sigma_min: float = 0.02,
                          sigma_max: float = 88.0) -> np.ndarray:
    s = np.linspace(sigma_max, sigma_min, num_steps)
    return np.concatenate([s, [0.0]]).astype(np.float32)


def cosine_sigma_schedule(num_steps: int, sigma_min: float = 0.02,
                          sigma_max: float = 88.0) -> np.ndarray:
    i = np.linspace(0, 1, num_steps)
    s = sigma_min + 0.5 * (sigma_max - sigma_min) * (1 + np.cos(np.pi * i))
    return np.concatenate([s, [0.0]]).astype(np.float32)


def exponential_sigma_schedule(num_steps: int, sigma_min: float = 0.02,
                               sigma_max: float = 88.0) -> np.ndarray:
    s = np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), num_steps))
    return np.concatenate([s, [0.0]]).astype(np.float32)


def unit_time_schedule(num_steps: int) -> np.ndarray:
    """t from 0 to 1 inclusive (the vector-field integration grid)."""
    return np.linspace(0.0, 1.0, num_steps + 1).astype(np.float32)


SIGMA_SCHEDULES = {
    "karras": karras_sigma_schedule,
    "linear": linear_sigma_schedule,
    "cosine": cosine_sigma_schedule,
    "exponential": exponential_sigma_schedule,
}


def unit_time_from_uniform(u: torch.Tensor, stratified: bool = False) -> torch.Tensor:
    """A uniform draw ``u [N, ...]`` as the training time: itself, or with
    ``stratified`` one stratum of ``[0, 1)`` per element of dim 0."""
    if not stratified:
        return u
    n = u.shape[0]
    offsets = torch.arange(n, dtype=u.dtype, device=u.device).reshape((n,) + (1,) * (u.dim() - 1))
    return (u + offsets) / n


def training_sigma_from_draw(
    draw: torch.Tensor, *, kind: str = "lognormal", sigma_min: float = 0.02,
    sigma_max: float = 88.0, rho: float = 7.0, s: float = 0.008, p_mean: float = -1.2,
    p_std: float = 1.2, stratified: bool = False,
) -> torch.Tensor:
    """The training sigma of one draw: ``lognormal`` (EDM) takes a standard
    normal, the other kinds a uniform in ``[0, 1)`` mapped through their
    sigma-of-unit-time curve (``karras``, ``linear``, ``exponential``, and
    ``cosine``: the squared-cosine alphas of Nichol and Dhariwal)."""
    if kind == "lognormal":
        return torch.exp(p_mean + p_std * draw)
    u = unit_time_from_uniform(draw, stratified)
    if kind == "karras":
        from anemoi_tpu_torch.models.transport.paths import karras_sigma_from_unit_time

        return karras_sigma_from_unit_time(u, sigma_max=sigma_max, sigma_min=sigma_min, rho=rho)
    if kind == "linear":
        return sigma_max + u * (sigma_min - sigma_max)
    if kind == "exponential":
        log_hi, log_lo = np.log(sigma_max), np.log(sigma_min)
        return torch.exp(float(log_hi) + u * float(log_lo - log_hi))
    if kind == "cosine":
        f = torch.cos((u + s) / (1 + s) * np.pi / 2) ** 2
        f0 = np.cos(s / (1 + s) * np.pi / 2) ** 2
        alpha = torch.clamp(f / float(f0), 1e-8, 1.0)
        sigma = torch.sqrt((1 - alpha) / alpha)
        return torch.clamp(sigma, sigma_min, sigma_max)
    raise ValueError(f"Unknown training sigma distribution '{kind}'")


def sample_training_sigma_dist(generator: torch.Generator, shape: Sequence[int], *,
                               kind: str = "lognormal", **kwargs) -> torch.Tensor:
    """Draw the training sigma of ``shape`` from ``generator`` (float32):
    a standard normal for ``lognormal``, a uniform for the other kinds."""
    draw = (random_fields.standard_normal(shape, generator) if kind == "lognormal"
            else random_fields.uniform(shape, generator))
    return training_sigma_from_draw(draw, kind=kind, **kwargs)


def sample_training_time(generator: torch.Generator, shape: Sequence[int], *,
                         stratified: bool = False) -> torch.Tensor:
    """The uniform interpolation time of ``shape``, drawn from ``generator``."""
    return unit_time_from_uniform(random_fields.uniform(shape, generator), stratified)
