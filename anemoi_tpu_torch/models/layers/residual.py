"""Residual connection between the input state and the predicted output.

Port of ``anemoi_tpu.models.layers.residual``: ``SkipConnection``,
``NoResidualConnection`` and the learnable ``ScalarOrnsteinConnection``
(with ``ornstein_init_theta``).  Each maps ``x [B, T, E, G, V]`` to the
skip state ``[B, n_step_output, E, G, V]``.  ``TruncatedConnection`` (it
needs ``ops/sparse_projector.py``) and ``SpectralOrnsteinConnection`` (it
needs ``ops/spectral.py``) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


def _expand_time(x_skip: torch.Tensor, n_step_output: int) -> torch.Tensor:
    return x_skip[:, None].expand((x_skip.shape[0], n_step_output) + x_skip.shape[1:])


class SkipConnection(nn.Module):
    """The input's timestep ``step`` (default: the most recent), repeated over
    the output steps."""

    def __init__(self, step: int = -1) -> None:
        super().__init__()
        self.step = step

    def forward(self, x: torch.Tensor, n_step_output: int = 1) -> torch.Tensor:
        return _expand_time(x[:, self.step], n_step_output)


class NoResidualConnection(nn.Module):
    """Zero skip: the decoder's output is the whole state."""

    def forward(self, x: torch.Tensor, n_step_output: int = 1) -> torch.Tensor:
        return torch.zeros_like(_expand_time(x[:, -1], n_step_output))


def ornstein_init_theta(theta_init, theta_buff: float, statistics: Optional[dict]) -> np.ndarray:
    """Initial theta logits from per-variable tendency statistics: with
    ``theta_init`` 0 and ``stdev``/``stdev_tend`` known, ``0.5 * (stdev_tend /
    stdev) ** 2``; mapped into ``(theta_buff, 1)``, clipped to (0.01, 0.99),
    returned as logits."""
    statistics = statistics or {}
    if np.all(np.asarray(theta_init) == 0) and {"stdev", "stdev_tend"} <= set(statistics):
        theta_init = 0.5 * (np.asarray(statistics["stdev_tend"])
                            / np.asarray(statistics["stdev"])) ** 2
    theta = (np.asarray(theta_init, dtype=np.float64) - theta_buff) / (1.0 - theta_buff)
    theta = np.clip(theta, 0.01, 0.99)
    return np.log(theta / (1.0 - theta)).astype(np.float32)


class ScalarOrnsteinConnection(nn.Module):
    """Learnable Ornstein-Uhlenbeck skip per prognostic variable:
    ``(1 - theta) * x_prog + mu + sum_i beta_i * f_i``, theta a sigmoid into
    ``(theta_buff, 1)``.  ``weight [len(regressors) + 2, n_prog]``: row 0 the
    theta logits, row 1 mu, then one beta row per regressor variable.  The
    non-prognostic columns of the skip are zero."""

    def __init__(self, prog_idx: Sequence[int], num_vars: int,
                 regressor_idx: Sequence[int] = (), theta_logit_init: Sequence[float] = (),
                 theta_buff: float = 0.0, theta_train: bool = True) -> None:
        super().__init__()
        self.prog_idx = [int(i) for i in prog_idx]
        self.regressor_idx = [int(i) for i in regressor_idx]
        self.num_vars = int(num_vars)
        self.theta_buff = float(theta_buff)
        self.theta_train = bool(theta_train)
        n_prog = len(self.prog_idx)
        self.theta_logit_init = (list(theta_logit_init) if len(theta_logit_init)
                                 else [0.0] * n_prog)
        self.weight = nn.Parameter(torch.empty(len(self.regressor_idx) + 2, n_prog))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The JAX package's initial weight: theta logits in row 0, zeros below."""
        self.weight.zero_()
        self.weight[0] = torch.as_tensor(self.theta_logit_init, dtype=self.weight.dtype)

    def forward(self, x: torch.Tensor, n_step_output: int = 1) -> torch.Tensor:
        x_last = x[:, -1]  # [B, E, G, V]
        weight = self.weight.to(x_last.dtype)
        theta = weight[0] if self.theta_train else weight[0].detach()
        gain = 1.0 - torch.sigmoid(theta) * (1.0 - self.theta_buff) - self.theta_buff
        out = gain * x_last[..., self.prog_idx] + weight[1]
        for i, k in enumerate(self.regressor_idx):
            out = out + weight[i + 2] * x_last[..., k : k + 1]
        full = out.new_zeros(out.shape[:-1] + (self.num_vars,))
        full[..., self.prog_idx] = out
        return _expand_time(full, n_step_output)


def build_residual(config: Optional[dict], data_indices=None,
                   statistics: Optional[dict] = None) -> nn.Module:
    """The residual of ``model.residual`` (default ``SkipConnection``) for
    one dataset; ``ScalarOrnsteinConnection`` needs its ``data_indices`` and
    takes its ``statistics`` (data-space order) for theta's start."""
    if config is None:
        return SkipConnection()
    cfg = dict(config)
    name = cfg.pop("name", None)
    if name == "SkipConnection":
        return SkipConnection(**cfg)
    if name == "NoResidualConnection":
        return NoResidualConnection()
    if name == "ScalarOrnsteinConnection":
        if data_indices is None:
            raise ValueError("ScalarOrnsteinConnection needs data_indices")
        mi = data_indices.model.input
        prog_idx = [int(i) for i in mi.prognostic]
        regressor_idx = [int(mi.name_to_index[r]) for r in cfg.get("regressors") or []]
        if statistics:  # per-variable statistics sliced to the prognostic ones
            dprog = np.asarray(data_indices.data.input.prognostic)
            statistics = {k: np.asarray(v)[dprog] for k, v in statistics.items()
                          if hasattr(v, "__getitem__")}
        theta_buff = float(cfg.get("theta_buff", 0.0))
        logits = ornstein_init_theta(cfg.get("theta_init", 0.0), theta_buff, statistics)
        return ScalarOrnsteinConnection(
            prog_idx, len(mi.full), regressor_idx,
            [float(t) for t in np.broadcast_to(logits, (len(prog_idx),))],
            theta_buff, bool(cfg.get("theta_train", True)),
        )
    raise NotImplementedError(f"residual '{name}' is not ported to anemoi_tpu_torch")
