"""Residual connection between the input state and the predicted output.

Port of ``anemoi_tpu.models.layers.residual``, ``SkipConnection`` only; the
other residuals (NoResidual, Truncated, Ornstein) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch


class SkipConnection:
    """The input's timestep ``step`` (default: the most recent), repeated over
    the output steps: [B, T, E, G, V] -> [B, n_step_output, E, G, V]."""

    def __init__(self, step: int = -1) -> None:
        self.step = step

    def __call__(self, x: torch.Tensor, n_step_output: int = 1) -> torch.Tensor:
        x_skip = x[:, self.step]
        return x_skip[:, None].expand((x_skip.shape[0], n_step_output) + x_skip.shape[1:])


def build_residual(config: Optional[dict]) -> SkipConnection:
    if config is None:
        return SkipConnection()
    cfg = dict(config)
    name = cfg.pop("name", None)
    if name != "SkipConnection":
        raise NotImplementedError(f"residual '{name}' is not ported to anemoi_tpu_torch")
    return SkipConnection(**cfg)
