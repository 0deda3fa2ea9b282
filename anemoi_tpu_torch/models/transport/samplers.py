"""Inference-time ODE samplers of the transport models.

Port of ``anemoi_tpu.models.transport.samplers``: EDM Euler and Heun over a
sigma schedule, the DPM-Solver++(2M) multistep sampler, and Euler and Heun
over a unit-time grid for stochastic-interpolant velocity fields.

Each sampler is a Python loop over the schedule, a numpy float32 array on
the host: every step size and branch is decided on host floats (computed in
float32, as the JAX scan computes them on the device), so the loop never
reads the device.  ``denoise_fn(y, sigma)`` and ``velocity_fn(x, t)`` take
the state and a host float.  Where the JAX scan selects with ``lax.cond``
or ``jnp.where``, the loop branches: EDM Heun skips its correction where
``sigma_next == 0`` (N steps are ``2N - 1`` evaluations), and DPM++(2M)
takes the plain denoised value on its first step (no ``r = 0`` is formed).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_F32 = np.float32


def edm_euler_sample(denoise_fn: Callable, y_init: torch.Tensor,
                     sigmas: np.ndarray) -> torch.Tensor:
    """First-order Euler over the sigma schedule (descending, last entry 0)."""
    sigmas = np.asarray(sigmas, _F32)
    y = y_init
    for s, s_next in zip(sigmas[:-1], sigmas[1:]):
        d = (y - denoise_fn(y, float(s))) / float(s)
        y = y + float(s_next - s) * d
    return y


def edm_heun_sample(denoise_fn: Callable, y_init: torch.Tensor,
                    sigmas: np.ndarray) -> torch.Tensor:
    """The EDM second-order Heun sampler."""
    sigmas = np.asarray(sigmas, _F32)
    y = y_init
    for s, s_next in zip(sigmas[:-1], sigmas[1:]):
        dt = float(s_next - s)
        d = (y - denoise_fn(y, float(s))) / float(s)
        y_euler = y + dt * d
        if s_next > 0:
            d2 = (y_euler - denoise_fn(y_euler, float(s_next))) / float(s_next)
            y = y + float(dt * _F32(0.5)) * (d + d2)
        else:
            y = y_euler
    return y


def _lam(s) -> np.float32:
    return -np.log(np.maximum(_F32(s), _F32(1e-10)))


def dpmpp_2m_sample(denoise_fn: Callable, y_init: torch.Tensor,
                    sigmas: np.ndarray) -> torch.Tensor:
    """DPM-Solver++(2M) over sigma (log-space lambda)."""
    sigmas = np.asarray(sigmas, _F32)
    y, old = y_init, None
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        denoised = denoise_fn(y, float(s))
        if s_next <= 0:
            y = denoised
        else:
            h = _lam(s_next) - _lam(s)
            d_eff = denoised
            if old is not None:
                h_last = _lam(s) - _lam(sigmas[i - 1])
                r = h_last / np.maximum(h, _F32(1e-10))
                inv = _F32(1) / (_F32(2) * r)
                d_eff = float(_F32(1) + inv) * denoised - float(inv) * old
            y = float(s_next / s) * y - float(np.expm1(-h)) * d_eff
        old = denoised
    return y


def vector_field_euler_sample(velocity_fn: Callable, x_init: torch.Tensor,
                              times: np.ndarray) -> torch.Tensor:
    """Euler integration of dx/dt = b(x, t) over an ascending time grid."""
    times = np.asarray(times, _F32)
    x = x_init
    for t, t_next in zip(times[:-1], times[1:]):
        x = x + float(t_next - t) * velocity_fn(x, float(t))
    return x


def vector_field_heun_sample(velocity_fn: Callable, x_init: torch.Tensor,
                             times: np.ndarray) -> torch.Tensor:
    """Heun integration of dx/dt = b(x, t): two evaluations a step."""
    times = np.asarray(times, _F32)
    x = x_init
    for t, t_next in zip(times[:-1], times[1:]):
        dt = float(t_next - t)
        v1 = velocity_fn(x, float(t))
        v2 = velocity_fn(x + dt * v1, float(t_next))
        x = x + float(_F32(dt) * _F32(0.5)) * (v1 + v2)
    return x


SAMPLERS = {
    "edm_euler": edm_euler_sample,
    "edm_heun": edm_heun_sample,
    "dpmpp_2m": dpmpp_2m_sample,
    "vf_euler": vector_field_euler_sample,
    "vf_heun": vector_field_heun_sample,
}


def evaluations(sampler: str, num_steps: int, schedule: np.ndarray) -> int:
    """Model evaluations of one sample: ``num_steps`` (Euler, DPM++),
    ``2 num_steps`` (vector-field Heun), and for EDM Heun one fewer for each
    step that ends at sigma 0."""
    if sampler == "edm_heun":
        return 2 * num_steps - int(np.sum(np.asarray(schedule)[1:] <= 0))
    if sampler == "vf_heun":
        return 2 * num_steps
    return num_steps
