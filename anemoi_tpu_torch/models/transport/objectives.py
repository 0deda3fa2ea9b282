"""Transport training objectives and noise-level embeddings.

Port of ``anemoi_tpu.models.transport.objectives``: the EDM diffusion
preconditioning and loss weighting (Karras et al. 2022), the stochastic
interpolant's velocity objective, and the three time embeddings
(``TIME_EMBEDDINGS``).

Each training-target function comes in two layers: a pure function of the
drawn arrays (:func:`edm_noised` of sigma and the noise,
:func:`interpolant_path` of t and z) and a thin draw from a
``torch.Generator`` (:func:`edm_training_targets`,
:func:`interpolant_training_targets`), which draws in the JAX functions'
order (sigma, then the noise; t, then z).

``random_fourier_time_embedding`` fixes its frequencies as the JAX one
does, ``jax.random.normal(PRNGKey(seed), (half,))``, recomputed by
``utils/threefry.py``, so a model trained by the JAX package keeps them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from anemoi_tpu_torch.models.transport import random_fields
from anemoi_tpu_torch.models.transport.paths import (
    edm_loss_weight,
    interpolant_alpha,
    interpolant_alpha_dot,
    interpolant_beta,
    interpolant_beta_dot,
    interpolant_sigma,
    interpolant_sigma_dot,
)
from anemoi_tpu_torch.models.transport.schedules import (
    sample_training_sigma_dist,
    sample_training_time,
)
from anemoi_tpu_torch.utils.threefry import cached_normal


@dataclass(frozen=True)
class EDMConfig:
    sigma_data: float = 1.0
    sigma_min: float = 0.02
    sigma_max: float = 88.0
    p_mean: float = -1.2  # the log-normal training sigma distribution
    p_std: float = 1.2

    @classmethod
    def from_config(cls, cfg) -> "EDMConfig":
        """The ``training.transport.edm`` mapping of a config (absent: the
        defaults)."""
        return cls(**{k: float(v) for k, v in dict(cfg or {}).items()})


def edm_preconditioning(sigma: torch.Tensor, sigma_data: float):
    """The Karras preconditioning ``(c_skip, c_out, c_in, c_noise)`` of
    ``sigma`` (broadcastable to the state)."""
    s2 = sigma**2
    d2 = sigma_data**2
    c_skip = d2 / (s2 + d2)
    c_out = sigma * sigma_data / torch.sqrt(s2 + d2)
    c_in = 1.0 / torch.sqrt(s2 + d2)
    c_noise = torch.log(sigma) / 4.0
    return c_skip, c_out, c_in, c_noise


def edm_denoise(model_out: torch.Tensor, y_noised: torch.Tensor, sigma: torch.Tensor,
                cfg: EDMConfig) -> torch.Tensor:
    """``D(y; sigma) = c_skip * y + c_out * F``, F the network's output on
    ``(c_in * y, c_noise)``."""
    c_skip, c_out, _, _ = edm_preconditioning(sigma, cfg.sigma_data)
    return c_skip * y_noised + c_out * model_out


def edm_noised(y: torch.Tensor, sigma: torch.Tensor, noise: torch.Tensor, cfg: EDMConfig):
    """``(y + sigma * noise, sigma, lambda(sigma))`` for drawn ``sigma
    [B, 1, E, 1, 1]`` and ``noise`` (``y``'s shape)."""
    sigma = sigma.to(y.dtype)
    return y + sigma * noise.to(y.dtype), sigma, edm_loss_weight(sigma, cfg.sigma_data)


def _per_sample(draw, shape, shard: Optional[random_fields.DrawShard]) -> torch.Tensor:
    """A per-sample draw ``[B, 1, E, 1, 1]``: for the global batch and cut
    to the rank's rows under a ``shard``."""
    if shard is None:
        return draw(shape)
    return shard.block(draw(shard.global_shape(shape)), shape)


def edm_training_targets(generator: torch.Generator, y: torch.Tensor, cfg: EDMConfig,
                         sigma_dist: Optional[dict] = None,
                         shard: Optional[random_fields.DrawShard] = None):
    """Draw one EDM training step's sigma (one per batch and ensemble
    member: ``[B, 1, E, 1, 1]``, log-normal with ``cfg``'s ``p_mean`` and
    ``p_std`` unless ``sigma_dist`` names another distribution) and noise,
    then :func:`edm_noised`.  ``y``: the clean target ``[B, T, E, G, V]``,
    or a rank's block of it under ``shard`` (the draws are then the
    one-process draws of the global batch and grid, cut to the block)."""
    shape = (y.shape[0], 1, y.shape[2], 1, 1)
    if not sigma_dist:
        sigma_dist = {"kind": "lognormal", "p_mean": cfg.p_mean, "p_std": cfg.p_std}
    sigma = _per_sample(lambda sh: sample_training_sigma_dist(generator, sh, **sigma_dist),
                        shape, shard)
    noise = random_fields.sharded_normal(generator, y.shape, y.dtype, shard)
    return edm_noised(y, sigma, noise, cfg)


def interpolant_path(y0: torch.Tensor, y1: torch.Tensor, t: torch.Tensor,
                     z: Optional[torch.Tensor], gamma: float = 0.0, *,
                     beta_schedule: str = "linear", sigma_schedule: str = "brownian_bridge"):
    """``x_t = alpha(t) y0 + beta(t) y1 + gamma sigma(t) z`` and its time
    derivative, the velocity target; ``z`` is used only when ``gamma > 0``."""
    t = t.to(y0.dtype)
    x_t = interpolant_alpha(t) * y0 + interpolant_beta(t, beta_schedule) * y1
    velocity = interpolant_alpha_dot(t) * y0 + interpolant_beta_dot(t, beta_schedule) * y1
    if gamma > 0:
        x_t = x_t + gamma * interpolant_sigma(t, schedule=sigma_schedule) * z
        velocity = velocity + gamma * interpolant_sigma_dot(t, schedule=sigma_schedule) * z
    return x_t, t, velocity


def interpolant_training_targets(
    generator: torch.Generator, y0: torch.Tensor, y1: torch.Tensor, gamma: float = 0.0, *,
    beta_schedule: str = "linear", sigma_schedule: str = "brownian_bridge",
    stratified: bool = False, shard: Optional[random_fields.DrawShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw t ``[B, 1, E, 1, 1]`` (and, with ``gamma > 0``, the bridge noise
    z), then :func:`interpolant_path`; returns ``(x_t, t, velocity)``.
    ``shard``: as for :func:`edm_training_targets`."""
    t = _per_sample(lambda sh: sample_training_time(generator, sh, stratified=stratified),
                    (y0.shape[0], 1, y0.shape[2], 1, 1), shard)
    z = (random_fields.sharded_normal(generator, y0.shape, y0.dtype, shard) if gamma > 0
         else None)
    return interpolant_path(y0, y1, t, z, gamma, beta_schedule=beta_schedule,
                            sigma_schedule=sigma_schedule)


def fourier_time_embedding(t: torch.Tensor, dim: int = 16, max_freq: float = 16.0) -> torch.Tensor:
    """sin/cos embedding of a scalar noise level or time per sample."""
    half = dim // 2
    freqs = torch.exp(torch.linspace(0.0, math.log(max_freq), half, device=t.device))
    ang = t[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def random_fourier_time_embedding(t: torch.Tensor, dim: int = 32, scale: float = 16.0,
                                  seed: int = 0) -> torch.Tensor:
    """Random Fourier embedding: frequencies ``N(0, scale^2)``, JAX's draw
    from ``PRNGKey(seed)``."""
    half = dim // 2
    freqs = torch.from_numpy(cached_normal(int(seed), half) * np.float32(scale)).to(t.device)
    ang = t[..., None] * freqs * (2.0 * math.pi)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_time_embedding(t: torch.Tensor, dim: int = 32,
                              max_period: float = 10000.0) -> torch.Tensor:
    """Transformer-style sinusoidal embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


TIME_EMBEDDINGS = {
    "fourier": fourier_time_embedding,
    "random_fourier": random_fourier_time_embedding,
    "sinusoidal": sinusoidal_time_embedding,
}
