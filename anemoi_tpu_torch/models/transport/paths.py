"""Interpolation-path math of the transport objectives and samplers.

Port of ``anemoi_tpu.models.transport.paths``: the Karras unit-time ->
sigma map, the EDM loss weight, and the stochastic interpolant's alpha,
beta and sigma with their time derivatives (the bridge's derivative guarded
by ``eps`` at the endpoints).  Functions of tensors (or floats).
"""

from __future__ import annotations

import torch


def karras_sigma_from_unit_time(t, *, sigma_max: float, sigma_min: float, rho: float):
    """Map t in [0, 1] to the Karras EDM noise schedule."""
    hi = sigma_max ** (1.0 / rho)
    lo = sigma_min ** (1.0 / rho)
    return (hi + t * (lo - hi)) ** rho


def edm_loss_weight(sigma, sigma_data: float):
    """EDM lambda(sigma)."""
    return (sigma**2 + sigma_data**2) / (sigma * sigma_data) ** 2


def _brownian_bridge_variance(t):
    return 2.0 * t * (1.0 - t)


def interpolant_alpha(t, schedule: str = "linear"):
    """The source field's weight along the bridge."""
    if schedule != "linear":
        raise ValueError(f"Unsupported interpolant alpha schedule: {schedule}")
    return 1.0 - t


def interpolant_beta(t, schedule: str = "linear"):
    """The target field's weight."""
    if schedule == "linear":
        return t
    if schedule == "quadratic":
        return torch.square(t)
    raise ValueError(f"Unsupported interpolant beta schedule: {schedule}")


def interpolant_sigma(t, *, schedule: str = "brownian_bridge", noise_scale: float = 1.0):
    """The bridge's noise amplitude."""
    if schedule == "brownian_bridge":
        return noise_scale * torch.sqrt(torch.clamp(_brownian_bridge_variance(t), min=0.0))
    if schedule == "quadratic_bridge":
        return noise_scale * t * (1.0 - t)
    raise ValueError(f"Unsupported interpolant sigma schedule: {schedule}")


def interpolant_alpha_dot(t, schedule: str = "linear"):
    if schedule != "linear":
        raise ValueError(f"Unsupported interpolant alpha schedule: {schedule}")
    return -torch.ones_like(t)


def interpolant_beta_dot(t, schedule: str = "linear"):
    if schedule == "linear":
        return torch.ones_like(t)
    if schedule == "quadratic":
        return 2.0 * t
    raise ValueError(f"Unsupported interpolant beta schedule: {schedule}")


def interpolant_sigma_dot(t, *, schedule: str = "brownian_bridge", noise_scale: float = 1.0,
                          eps: float = 1e-6):
    """d sigma / dt; the bridge's variance is clamped at ``eps`` so the
    derivative stays finite at t = 0 and 1."""
    if schedule == "brownian_bridge":
        var = torch.clamp(_brownian_bridge_variance(t), min=eps)
        return noise_scale * (1.0 - 2.0 * t) / torch.sqrt(var)
    if schedule == "quadratic_bridge":
        return noise_scale * (1.0 - 2.0 * t)
    raise ValueError(f"Unsupported interpolant sigma schedule: {schedule}")
