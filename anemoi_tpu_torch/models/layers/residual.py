"""Residual connection between the input state and the predicted output.

Port of ``anemoi_tpu.models.layers.residual``: ``SkipConnection``,
``NoResidualConnection``, the learnable ``ScalarOrnsteinConnection`` (with
``ornstein_init_theta``) and ``SpectralOrnsteinConnection`` (a learnable
damping per spherical-harmonic degree, through ``ops/spectral.py``).  Each
maps ``x [B, T, E, G, V]`` to the skip state ``[B, n_step_output, E, G,
V]``.  ``TruncatedConnection`` (it needs ``ops/sparse_projector.py``) raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from anemoi_tpu_torch.ops.spectral import GaussianSHT, ReducedSHT


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


class SpectralOrnsteinConnection(nn.Module):
    """Per-degree Ornstein-Uhlenbeck skip: ``ISHT((1 - theta_l) * SHT(x_prog))
    + mu``, theta a sigmoid into ``(theta_buff, 1)`` per spherical-harmonic
    degree l, so that small scales relax faster than large ones.
    ``theta_logit [lmax + 1]`` starts at ``theta_init``, ``mu [n_prog]`` at 0.
    ``grid_kind``: ``full`` (F<n>, rings of 4n points), ``octahedral``
    (O<n>) or ``reduced`` (N<n>); the grid's points in ring order, north to
    south.  The transform runs in float32 whatever the input's type."""

    def __init__(self, prog_idx: Sequence[int], num_vars: int, gaussian_n: int,
                 grid_kind: str = "full", lmax: int = 0, theta_init: float = 0.0,
                 theta_buff: float = 0.0, theta_train: bool = True) -> None:
        super().__init__()
        self.prog_idx = [int(i) for i in prog_idx]
        self.num_vars = int(num_vars)
        self.grid_kind = grid_kind
        self.gaussian_n = int(gaussian_n)
        self.theta_init = float(theta_init)
        self.theta_buff = float(theta_buff)
        self.theta_train = bool(theta_train)
        lmax_or_none = int(lmax) if lmax else None
        if grid_kind == "full":
            self.sht = GaussianSHT.create(self.gaussian_n, lmax_or_none)
            self.n_points = self.sht.nlat * self.sht.nlon
        else:
            self.sht = ReducedSHT.create(self.gaussian_n, lmax_or_none, kind=grid_kind)
            self.n_points = self.sht.n_points
        self.theta_logit = nn.Parameter(torch.empty(self.sht.lmax + 1))
        self.mu = nn.Parameter(torch.empty(len(self.prog_idx)))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The JAX package's initial weights: theta_init everywhere, mu 0."""
        self.theta_logit.fill_(self.theta_init)
        self.mu.zero_()

    def forward(self, x: torch.Tensor, n_step_output: int = 1) -> torch.Tensor:
        x_last = x[:, -1]  # [B, E, G, V]
        n_grid = x_last.shape[-2]
        if n_grid != self.n_points:
            raise ValueError(f"SpectralOrnsteinConnection: {self.grid_kind} grid n="
                             f"{self.gaussian_n} has {self.n_points} points, got {n_grid}")
        theta = self.theta_logit if self.theta_train else self.theta_logit.detach()
        gain = 1.0 - torch.sigmoid(theta) * (1.0 - self.theta_buff) - self.theta_buff
        prog = x_last[..., self.prog_idx]
        field = prog.movedim(-1, -2).float()  # [B, E, n_prog, G]
        if self.grid_kind == "full":
            field = field.reshape(field.shape[:-1] + (self.sht.nlat, self.sht.nlon))
        coeffs = self.sht.analysis(field) * gain.float()[:, None]  # per degree, over m
        damped = self.sht.synthesis(coeffs).reshape(prog.shape[:-2] + (len(self.prog_idx),
                                                                       n_grid))
        out = damped.movedim(-2, -1).to(x_last.dtype) + self.mu.to(x_last.dtype)
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
    if name == "SpectralOrnsteinConnection":
        if data_indices is None:
            raise ValueError("SpectralOrnsteinConnection needs data_indices")
        mi = data_indices.model.input
        return SpectralOrnsteinConnection(
            [int(i) for i in mi.prognostic], len(mi.full), int(cfg["gaussian_n"]),
            grid_kind=str(cfg.get("grid_kind", "full")), lmax=int(cfg.get("lmax", 0)),
            theta_init=float(cfg.get("theta_init", 0.0)),
            theta_buff=float(cfg.get("theta_buff", 0.0)),
            theta_train=bool(cfg.get("theta_train", True)),
        )
    raise NotImplementedError(f"residual '{name}' is not ported to anemoi_tpu_torch")
