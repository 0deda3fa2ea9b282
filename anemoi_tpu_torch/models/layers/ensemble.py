"""Ensemble noise injection.

Port of ``anemoi_tpu.models.layers.ensemble``:

- ``NoiseConditioning``: a Gaussian noise field per member on the hidden
  mesh, ``[B·M, N_hidden, noise_channels_dim]`` times ``noise_std``, through
  ``noise_mlp`` (its trailing LayerNorm on); returned as the conditioning of
  the processor's ``ConditionalLayerNorm`` blocks, the latent unchanged;
- ``NoiseInjector``: the same noise, concatenated to the latent channels and
  projected back by ``projection`` (no conditioning);
- ``NoOpNoiseInjector``: the latent unchanged, no conditioning, no noise.

The JAX modules draw from the flax ``noise`` RNG stream; here the standard
normal draw is an input (``noise``), made by :func:`standard_normal` from an
explicit ``torch.Generator`` by whoever calls the model (the interface's
``apply`` and ``predict_step``, the training step), never from the global
RNG.  A caller that has the draw already -- a recompute, or a test holding
the port against the JAX package's draw -- passes it in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from anemoi_tpu_torch.models.layers.mlp import MLP


def standard_normal(shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """A float32 standard normal draw of ``shape`` on the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)


class NoOpNoiseInjector(nn.Module):
    """The deterministic passthrough."""

    draws_noise = False
    conditioning_dim = None  # no conditioning for the processor's norms

    def __init__(self, noise_std: float = 1.0, noise_channels_dim: int = 4,
                 noise_mlp_hidden_dim: int = 32) -> None:
        super().__init__()

    def noise_shape(self, batch_flat: int, num_nodes: int) -> Optional[Tuple[int, int, int]]:
        return None

    def forward(self, x_latent: torch.Tensor, noise: Optional[torch.Tensor] = None):
        return x_latent, None


class NoiseConditioning(nn.Module):
    """Noise -> ``noise_mlp`` -> the conditioning of the processor's norms."""

    draws_noise = True

    def __init__(self, noise_std: float = 1.0, noise_channels_dim: int = 4,
                 noise_mlp_hidden_dim: int = 32) -> None:
        super().__init__()
        self.noise_std = float(noise_std)
        self.noise_channels_dim = int(noise_channels_dim)
        self.conditioning_dim = self.noise_channels_dim
        self.noise_mlp = MLP(self.noise_channels_dim, int(noise_mlp_hidden_dim),
                             self.noise_channels_dim, layer_norm=True)

    def noise_shape(self, batch_flat: int, num_nodes: int) -> Tuple[int, int, int]:
        """The shape of the standard normal draw: one field per member."""
        return (batch_flat, num_nodes, self.noise_channels_dim)

    def _noise(self, x_latent: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
        if noise is None:
            raise ValueError(f"{type(self).__name__} needs a noise draw: call the model "
                             "through AnemoiModelInterface.apply / predict_step, or pass noise")
        want = self.noise_shape(x_latent.shape[0], x_latent.shape[1])
        if tuple(noise.shape) != want:
            raise ValueError(f"noise of shape {tuple(noise.shape)}, want {want}")
        return self.noise_mlp((noise.float() * self.noise_std).to(x_latent.dtype))

    def forward(self, x_latent: torch.Tensor, noise: Optional[torch.Tensor] = None):
        return x_latent, self._noise(x_latent, noise)


class NoiseInjector(NoiseConditioning):
    """Noise concatenated to the latent and projected back to its width."""

    def __init__(self, num_channels: int, noise_std: float = 1.0, noise_channels_dim: int = 4,
                 noise_mlp_hidden_dim: int = 32) -> None:
        super().__init__(noise_std, noise_channels_dim, noise_mlp_hidden_dim)
        self.conditioning_dim = None
        self.projection = nn.Linear(num_channels + self.noise_channels_dim, num_channels)

    def forward(self, x_latent: torch.Tensor, noise: Optional[torch.Tensor] = None):
        cond = self._noise(x_latent, noise)
        return self.projection(torch.cat([x_latent, cond], dim=-1)), None


INJECTORS = {"NoOpNoiseInjector": NoOpNoiseInjector, "NoiseConditioning": NoiseConditioning,
             "NoiseInjector": NoiseInjector}


def build_noise_injector(config: Optional[dict], num_channels: int) -> nn.Module:
    """The injector of ``model.noise_injector`` (default ``NoiseConditioning``)."""
    cfg = dict(config or {"name": "NoiseConditioning"})
    name = cfg.pop("name", "NoiseConditioning")
    if name not in INJECTORS:
        raise ValueError(f"unknown noise injector '{name}' (known: {sorted(INJECTORS)})")
    if name == "NoiseInjector":
        cfg.setdefault("num_channels", num_channels)
    return INJECTORS[name](**cfg)
