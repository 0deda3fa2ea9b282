"""Spectral losses: differences between the spatial spectra of prediction
and target.

Port of ``anemoi_tpu.training.losses.spectral``: ``PowerSpectrumLoss``,
``SpectralAMSELoss``, ``LogSpectralDistance``, ``LogFFT2Distance``,
``SpectralCRPSLoss`` (over the ensemble dim), ``ZonalSpectralLoss``,
``SphericalSpectralLoss`` and ``FourierCorrelationLoss``.  The first five
share :class:`_SpectralAdapter`, which maps a ``transform`` name
(``gaussian_sht``, ``reduced_sht``, ``octahedral_sht``, ``fft2d``,
``dct2d``) to the transforms of ``ops/spectral.py``, and
:class:`_SpectralLossBase`'s scaler-weighted mean over the spectral modes,
in which a scaler bound to the grid dim must be sized to the modes (or 1).

As in the JAX package, NaNs are zeroed before the transform, and every
spectral loss replaces ``BaseLoss.__call__``: the NaN masking, the imputer's
loss mask and the scaler selections of the pointwise losses do not apply.
The transforms run in float32 (the training step hands the loss float32
predictions whatever the compute type).
"""

from __future__ import annotations

from typing import Optional

import torch

from anemoi_tpu_torch.ops.spectral import GaussianSHT, ReducedSHT, dct2, ring_power_spectrum
from anemoi_tpu_torch.training.losses.base import BaseLoss, register_loss

_SHTS = ("gaussian_sht", "reduced_sht", "octahedral_sht")


def _mean_all_but_last(err: torch.Tensor, squash: bool) -> torch.Tensor:
    return err.mean() if squash else err.mean(dim=tuple(range(err.dim() - 1)))


class _SpectralAdapter:
    """Config -> transform of ``[..., G, V]`` fields into ``[..., A, B, V]``
    coefficients (complex, except ``dct2d``): ``gaussian_sht`` on the full
    Gaussian grid F<n>, ``reduced_sht`` / ``octahedral_sht`` on N<n> / O<n>
    (``gaussian_n``, ``truncation``), ``fft2d`` / ``dct2d`` on regular
    ``y_dim`` x ``x_dim`` grids."""

    def __init__(self, transform: str = "gaussian_sht", gaussian_n: int = 0,
                 truncation: Optional[int] = None, x_dim: int = 0, y_dim: int = 0):
        self.kind = transform
        if transform in _SHTS:
            if gaussian_n <= 0:
                raise ValueError(f"{transform} needs gaussian_n")
            if transform == "gaussian_sht":
                self.sht = GaussianSHT.create(gaussian_n, truncation)
            else:
                kind = "octahedral" if transform == "octahedral_sht" else "reduced"
                self.sht = ReducedSHT.create(gaussian_n, truncation, kind=kind)
            self.has_psd = True
        elif transform in ("fft2d", "dct2d"):
            if x_dim <= 0 or y_dim <= 0:
                raise ValueError(f"{transform} needs x_dim and y_dim")
            self.x_dim, self.y_dim = x_dim, y_dim
            self.has_psd = False
        else:
            raise ValueError(f"Unknown spectral transform '{transform}'")

    def to_spectral(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., G, V]`` -> coefficients ``[..., A, B, V]``."""
        x = torch.nan_to_num(x)
        if self.kind in _SHTS:
            f = x.movedim(-1, -2)  # [..., V, G]
            if self.kind == "gaussian_sht":
                f = f.reshape(f.shape[:-1] + (self.sht.nlat, self.sht.nlon))
            return self.sht.analysis(f).movedim(-3, -1)  # [..., L, M, V]
        grid = x.reshape(x.shape[:-2] + (self.y_dim, self.x_dim, x.shape[-1]))
        if self.kind == "fft2d":
            return torch.fft.fft2(grid, dim=(-3, -2))
        return dct2(grid.movedim(-1, -3)).movedim(-3, -1)

    def to_spectral_flat(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., G, V]`` -> ``[..., modes, V]``, the two spectral axes flattened."""
        c = self.to_spectral(x)
        return c.reshape(c.shape[:-3] + (-1, c.shape[-1]))

    @staticmethod
    def psd(coeffs: torch.Tensor) -> torch.Tensor:
        """Per-total-wavenumber power ``sum_M |c|^2`` -> ``[..., L, V]`` (the
        half spectrum, no doubling of m > 0)."""
        return (coeffs.abs() ** 2).sum(-2)

    @staticmethod
    def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per-L cross-spectral density ``Re[sum_M a conj(b)]`` -> ``[..., L, V]``."""
        return (a.real * b.real + a.imag * b.imag).sum(-2)


class _SpectralLossBase(BaseLoss):
    """The transform and the scaler-weighted mean over the spectral modes."""

    def __init__(self, scalers=None, ignore_nans: bool = True,
                 transform: str = "gaussian_sht", gaussian_n: int = 0,
                 truncation: Optional[int] = None, x_dim: int = 0, y_dim: int = 0):
        super().__init__(scalers, ignore_nans)
        self.adapter = _SpectralAdapter(transform, gaussian_n, truncation, x_dim, y_dim)

    def _reduce(self, err: torch.Tensor, squash: bool) -> torch.Tensor:
        """Scaler-weighted mean of ``err [B, T, E, modes, V]``.  A scaler
        bound to the grid dim must be sized to the modes (or 1): an area
        weight of the grid points has no meaning over spectral modes."""
        n_modes = err.shape[3]
        for name, (dims, arr) in self.scalers.scalers.items():
            if "grid" in dims:
                size = arr.shape[dims.index("grid")]
                if size not in (1, n_modes):
                    raise ValueError(
                        f"Scaler '{name}' is bound to the grid dim with size {size}, but this "
                        f"spectral loss reduces over {n_modes} spectral modes; grid-dim "
                        "scalers must be spectral-dimension scalers.")
        weighted = self.scalers.scale(err)
        weight = self.scalers.combined_weight(err)
        if squash:
            return weighted.sum() / weight.sum().clamp_min(1e-12)
        axes = tuple(range(err.dim() - 1))
        return weighted.sum(axes) / weight.sum(axes).clamp_min(1e-12)


def _needs_psd(loss: _SpectralLossBase) -> None:
    if not loss.adapter.has_psd:
        raise ValueError(f"{type(loss).__name__} needs a transform with a per-degree power "
                         "spectrum (an SHT); fft2d and dct2d have none")


@register_loss("PowerSpectrumLoss")
class PowerSpectrumLoss(_SpectralLossBase):
    """L2 on the power per total wavenumber: ``(sum_M |p_LM|^2 - sum_M
    |t_LM|^2)^2``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _needs_psd(self)

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        p = self.adapter.psd(self.adapter.to_spectral(pred))
        t = self.adapter.psd(self.adapter.to_spectral(target))
        return self._reduce((p - t) ** 2, squash)


@register_loss("SpectralAMSELoss")
class SpectralAMSELoss(_SpectralLossBase):
    """Adjusted MSE in spectral space (Subich et al. 2025): per total
    wavenumber, ``(sqrt(S^p) - sqrt(S^t))^2 + 2 max(S^p, S^t) (1 - gamma)``
    with ``S`` the power and ``gamma`` the coherence."""

    def __init__(self, *args, eps: float = 1e-8, **kwargs):
        super().__init__(*args, **kwargs)
        _needs_psd(self)
        self.eps = eps

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        cp, ct = self.adapter.to_spectral(pred), self.adapter.to_spectral(target)
        sp, st = self.adapter.psd(cp), self.adapter.psd(ct)
        amp_p, amp_t = torch.sqrt(sp + self.eps), torch.sqrt(st + self.eps)
        coherence = self.adapter.cross(cp, ct) / (amp_p * amp_t + self.eps)
        amse = (amp_p - amp_t) ** 2 + 2.0 * torch.maximum(sp, st) * (1.0 - coherence)
        return self._reduce(amse, squash)


@register_loss("LogSpectralDistance")
class LogSpectralDistance(_SpectralLossBase):
    """The square root of the weighted mean of ``(log|t|^2 - log|p|^2)^2``
    over all spectral modes."""

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        eps = float(torch.finfo(pred.dtype).eps)
        cp = self.adapter.to_spectral_flat(pred)
        ct = self.adapter.to_spectral_flat(target)
        log_diff = torch.log(ct.abs() ** 2 + eps) - torch.log(cp.abs() ** 2 + eps)
        return torch.sqrt(self._reduce(log_diff**2, squash) + eps)


@register_loss("LogFFT2Distance")
class LogFFT2Distance(LogSpectralDistance):
    """The log spectral distance on ``fft2d`` regular grids."""

    def __init__(self, x_dim: int, y_dim: int, scalers=None, ignore_nans: bool = True,
                 **kwargs):
        super().__init__(scalers=scalers, ignore_nans=ignore_nans, transform="fft2d",
                         x_dim=x_dim, y_dim=y_dim)


@register_loss("SpectralCRPSLoss")
class SpectralCRPSLoss(_SpectralLossBase):
    """The kernel CRPS over the ensemble dim of every spectral mode, ``|.|``
    the complex modulus: ``E|X - y| - coef * sum_{i<j} |X_i - X_j|`` with
    ``coef = alpha / (m (m - 1)) + (1 - alpha) / m^2`` (``alpha`` 1: fair)."""

    def __init__(self, *args, alpha: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        self.alpha = alpha

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        if target.shape[2] != 1:
            raise ValueError("SpectralCRPSLoss expects a single-truth target with ensemble dim "
                             f"1, got {tuple(target.shape)}")
        m = pred.shape[2]
        cp = self.adapter.to_spectral_flat(pred)  # [B, T, M, S, V]
        ct = self.adapter.to_spectral_flat(target)  # [B, T, 1, S, V]
        crps = (cp - ct).abs().mean(dim=2, keepdim=True)
        if m > 1:
            pair_sum = 0.5 * (cp[:, :, :, None] - cp[:, :, None, :]).abs().sum(dim=(2, 3))
            coef = self.alpha / (m * (m - 1)) + (1.0 - self.alpha) / (m * m)
            crps = crps - coef * pair_sum[:, :, None]
        return self._reduce(crps, squash)


@register_loss("ZonalSpectralLoss")
class ZonalSpectralLoss(BaseLoss):
    """MSE between the (log) zonal power spectra of regular ``nlat`` x
    ``nlon`` grids; no scalers."""

    def __init__(self, scalers=None, ignore_nans: bool = True, nlat: int = 0, nlon: int = 0,
                 log_space: bool = True, eps: float = 1e-12):
        super().__init__(scalers, ignore_nans)
        if nlat <= 0 or nlon <= 0:
            raise ValueError("ZonalSpectralLoss needs nlat and nlon of the grid")
        self.nlat, self.nlon, self.log_space, self.eps = nlat, nlon, log_space, eps

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        p, t = (ring_power_spectrum(torch.nan_to_num(x).movedim(-1, -2), self.nlat, self.nlon)
                for x in (pred, target))
        if self.log_space:
            p, t = torch.log(p + self.eps), torch.log(t + self.eps)
        return _mean_all_but_last((p - t) ** 2, squash)


@register_loss("SphericalSpectralLoss")
class SphericalSpectralLoss(BaseLoss):
    """MSE between the (log) per-degree power spectra of spherical
    harmonics; ``grid_kind`` ``full`` (F<n>), ``octahedral`` (O<n>) or
    ``reduced`` (N<n>); no scalers."""

    def __init__(self, scalers=None, ignore_nans: bool = True, gaussian_n: int = 0,
                 lmax: Optional[int] = None, log_space: bool = True, eps: float = 1e-12,
                 grid_kind: str = "full"):
        super().__init__(scalers, ignore_nans)
        if gaussian_n <= 0:
            raise ValueError("SphericalSpectralLoss needs the Gaussian grid's n")
        self.grid_kind = grid_kind
        self.sht = (GaussianSHT.create(gaussian_n, lmax) if grid_kind == "full"
                    else ReducedSHT.create(gaussian_n, lmax, kind=grid_kind))
        self.log_space, self.eps = log_space, eps

    def _spectra(self, x: torch.Tensor) -> torch.Tensor:
        f = torch.nan_to_num(x).movedim(-1, -2)  # [..., V, G]
        if self.grid_kind == "full":
            f = f.reshape(f.shape[:-1] + (self.sht.nlat, self.sht.nlon))
        return self.sht.power_spectrum(f)

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        p, t = self._spectra(pred), self._spectra(target)
        if self.log_space:
            p, t = torch.log(p + self.eps), torch.log(t + self.eps)
        return _mean_all_but_last((p - t) ** 2, squash)


@register_loss("FourierCorrelationLoss")
class FourierCorrelationLoss(BaseLoss):
    """``1 -`` the coherence of prediction and target zonal spectra on a
    regular ``nlat`` x ``nlon`` grid; no scalers."""

    def __init__(self, scalers=None, ignore_nans: bool = True, nlat: int = 0, nlon: int = 0,
                 eps: float = 1e-12):
        super().__init__(scalers, ignore_nans)
        self.nlat, self.nlon, self.eps = nlat, nlon, eps

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        shape = pred.shape[:-2] + (pred.shape[-1], self.nlat, self.nlon)
        pf, tf = (torch.fft.rfft(torch.nan_to_num(x).movedim(-1, -2).reshape(shape), dim=-1)
                  for x in (pred, target))
        num = (pf * tf.conj()).sum(dim=(-2, -1)).abs()
        den = torch.sqrt((pf.abs() ** 2).sum(dim=(-2, -1)) * (tf.abs() ** 2).sum(dim=(-2, -1)))
        return _mean_all_but_last(1.0 - num / den.clamp_min(self.eps), squash)
