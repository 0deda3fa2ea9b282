"""Spectral transforms: spherical harmonics on Gaussian grids, 2-D FFT and DCT.

Port of ``anemoi_tpu.ops.spectral``: ``associated_legendre`` (the port's own
numpy copy), ``GaussianSHT`` (full Gaussian grids F<n>: a per-ring
``rfft`` and Gauss-Legendre quadrature), ``ReducedSHT`` (the reduced grids
models run on: octahedral O<n> and the classic N<n>), ``fft2``, ``ifft2``,
``dct2`` and ``ring_power_spectrum``.  The JAX package computes them with
host-built tables, FFTs and ``einsum``s and no Pallas kernel; here they are
``torch.fft`` and ``torch.einsum`` (cuBLAS batched products on the card).

``ReducedSHT`` keeps the JAX formulation, so that both packages give the
same values: each ring's variable-length DFT is one batched product over a
padded ``[nlat, Nmax]`` layout with float32 cos/sin tables masked beyond each
ring's length, and the Legendre quadrature another; synthesis drops the
modes a short polar ring cannot represent (``m > (n_j - 1) // 2``).  The
tables are built on the host once per ``(n, lmax, kind)`` and copied to a
device once, on the first call there (at O96, ``lmax`` 95, the four ring
tables take 118 MB in float32).

The transforms compute in float32 (``torch.fft`` on the card takes no bf16
at these sizes); complex coefficients are ``complex64``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from anemoi_tpu_torch.graphs.generate.gaussian import (
    octahedral_ring_lengths,
    reduced_ring_lengths,
)


def associated_legendre(lmax: int, x: np.ndarray) -> np.ndarray:
    """Normalised associated Legendre P_l^m(x) for 0 <= m <= l <= lmax:
    ``[lmax + 1, lmax + 1, len(x)]``, orthonormal (spherical-harmonic)
    normalisation, zero where m > l; the standard stable recurrence."""
    n = len(x)
    p = np.zeros((lmax + 1, lmax + 1, n))
    p[0, 0] = 1.0 / np.sqrt(4.0 * np.pi)
    somx2 = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
    for m in range(1, lmax + 1):  # diagonal: P_m^m
        p[m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * somx2 * p[m - 1, m - 1]
    for m in range(lmax):  # off-diagonal: P_{m+1}^m
        p[m + 1, m] = np.sqrt(2 * m + 3.0) * x * p[m, m]
    for m in range(lmax + 1):  # upward recurrence in l
        for l in range(m + 2, lmax + 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            p[l, m] = a * (x * p[l - 1, m] - b * p[l - 2, m])
    return p


def _gauss_legendre(n: int):
    """The 2n Gauss-Legendre nodes and weights, north to south (the order
    the grids are generated in)."""
    nodes, weights = np.polynomial.legendre.leggauss(2 * n)
    order = np.argsort(-nodes)
    return nodes[order], weights[order]


class _Tables:
    """Host tables (numpy) with one copy on each device they were asked on."""

    host: Dict[str, np.ndarray]

    def __init__(self) -> None:
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tables(self, device: torch.device) -> Dict[str, torch.Tensor]:
        if device not in self._on:
            self._on[device] = {k: torch.as_tensor(v, device=device) for k, v in self.host.items()}
        return self._on[device]


def _power(coeffs: torch.Tensor) -> torch.Tensor:
    """Per-degree power ``sum_m |a_lm|^2``, the ``m > 0`` terms doubled."""
    p = coeffs.abs() ** 2
    factor = torch.ones(p.shape[-1], dtype=p.dtype, device=p.device)
    factor[1:] = 2.0
    return (p * factor).sum(-1)


def _contract(fm: torch.Tensor, table: torch.Tensor, spec: str) -> torch.Tensor:
    """``einsum(spec, fm, table)`` of a complex ``fm`` and a real ``table``."""
    return torch.complex(torch.einsum(spec, fm.real, table), torch.einsum(spec, fm.imag, table))


class GaussianSHT(_Tables):
    """Spherical-harmonic transform on a full Gaussian grid F<n> (2n
    latitudes, 4n longitudes), truncated at ``lmax`` (default 2n - 1)."""

    def __init__(self, n: int, lmax: Optional[int] = None) -> None:
        super().__init__()
        nodes, weights = _gauss_legendre(n)
        self.nlat, self.nlon = 2 * n, 4 * n
        self.lmax = lmax if lmax is not None else 2 * n - 1
        plm = associated_legendre(self.lmax, nodes)
        # float32, as the JAX package's jnp.asarray of the float64 tables
        self.host = {"plm": plm.astype(np.float32),
                     "wplm": (plm * weights[None, None, :]).astype(np.float32)}

    @classmethod
    @lru_cache(maxsize=8)
    def create(cls, n: int, lmax: Optional[int] = None) -> "GaussianSHT":
        return cls(n, lmax)

    def analysis(self, field: torch.Tensor) -> torch.Tensor:
        """``[..., nlat, nlon]`` -> complex coefficients ``[..., lmax + 1,
        lmax + 1]`` (degree l, order m; zero where m > l)."""
        t = self.tables(field.device)
        fm = torch.fft.rfft(field.float(), dim=-1) * (2.0 * np.pi / self.nlon)
        return _contract(fm[..., : self.lmax + 1], t["wplm"], "...jm,lmj->...lm")

    def synthesis(self, coeffs: torch.Tensor) -> torch.Tensor:
        """The inverse: coefficients ``[..., L, M]`` -> field ``[..., nlat, nlon]``."""
        fm = _contract(coeffs, self.tables(coeffs.device)["plm"], "...lm,lmj->...jm")
        pad = self.nlon // 2 + 1 - fm.shape[-1]
        full = torch.nn.functional.pad(fm, (0, pad))
        return torch.fft.irfft(full, n=self.nlon, dim=-1) * self.nlon

    def power_spectrum(self, field: torch.Tensor) -> torch.Tensor:
        """Per-degree power ``[..., lmax + 1]``."""
        return _power(self.analysis(field))


class ReducedSHT(_Tables):
    """Spherical-harmonic transform on a reduced Gaussian grid: ``kind``
    ``octahedral`` (O<n>) or ``reduced`` (the classic N<n>), truncated at
    ``lmax`` (default n - 1).  Fields are flat ``[..., n_points]`` in the
    grid's ring order, north to south, each ring from longitude 0."""

    def __init__(self, n: int, lmax: Optional[int] = None, kind: str = "octahedral") -> None:
        super().__init__()
        nodes, weights = _gauss_legendre(n)
        rings = (octahedral_ring_lengths(n) if kind == "octahedral"
                 else reduced_ring_lengths(n)).astype(np.int64)
        self.nlat = 2 * n
        self.lmax = lmax if lmax is not None else n - 1
        self.ring_lengths = rings
        self.n_points = int(rings.sum())
        m_dim, nmax = self.lmax + 1, int(rings.max())

        gather_idx = np.full((self.nlat, nmax), self.n_points, dtype=np.int64)
        flat_idx = np.empty(self.n_points, dtype=np.int64)
        cos_a = np.zeros((self.nlat, nmax, m_dim), dtype=np.float32)
        sin_a = np.zeros((self.nlat, nmax, m_dim), dtype=np.float32)
        cos_s = np.zeros((self.nlat, m_dim, nmax), dtype=np.float32)
        sin_s = np.zeros((self.nlat, m_dim, nmax), dtype=np.float32)
        m = np.arange(m_dim)
        factor = np.where(m == 0, 1.0, 2.0)
        off = 0
        for j, nj in enumerate(rings):
            nj = int(nj)
            gather_idx[j, :nj] = np.arange(off, off + nj)
            flat_idx[off: off + nj] = j * nmax + np.arange(nj)
            phase = m[None, :] * (2.0 * np.pi * np.arange(nj) / nj)[:, None]  # [nj, M]
            cos_a[j, :nj] = np.cos(phase) * (2.0 * np.pi / nj)
            sin_a[j, :nj] = -np.sin(phase) * (2.0 * np.pi / nj)
            # synthesis drops the modes the ring cannot represent, so that no
            # energy aliases back onto the short polar rings
            m_ok = (m <= (nj - 1) // 2).astype(np.float32)
            cos_s[j, :, :nj] = (factor * m_ok)[:, None] * np.cos(phase).T
            sin_s[j, :, :nj] = (factor * m_ok)[:, None] * np.sin(phase).T
            off += nj
        plm = associated_legendre(self.lmax, nodes).astype(np.float32)
        self.host = {"gather_idx": gather_idx.reshape(-1), "flat_idx": flat_idx,
                     "cos_a": cos_a, "sin_a": sin_a, "cos_s": cos_s, "sin_s": sin_s,
                     "plm": plm, "wplm": (plm * weights[None, None, :]).astype(np.float32)}
        self._ring_shape = (self.nlat, nmax)

    @classmethod
    @lru_cache(maxsize=8)
    def create(cls, n: int, lmax: Optional[int] = None, kind: str = "octahedral") -> "ReducedSHT":
        return cls(n, lmax, kind)

    def to_rings(self, field: torch.Tensor) -> torch.Tensor:
        """``[..., n_points]`` -> padded ``[..., nlat, Nmax]`` (pad slots 0)."""
        pad = torch.nn.functional.pad(field, (0, 1))
        ringed = pad.index_select(-1, self.tables(field.device)["gather_idx"])
        return ringed.reshape(field.shape[:-1] + self._ring_shape)

    def from_rings(self, ringed: torch.Tensor) -> torch.Tensor:
        """Padded ``[..., nlat, Nmax]`` -> flat ``[..., n_points]``."""
        flat = ringed.reshape(ringed.shape[:-2] + (-1,))
        return flat.index_select(-1, self.tables(ringed.device)["flat_idx"])

    def analysis(self, field: torch.Tensor) -> torch.Tensor:
        """``[..., n_points]`` -> complex coefficients ``[..., L, M]`` (m <= l)."""
        t = self.tables(field.device)
        ringed = self.to_rings(field.float())
        fm = torch.complex(torch.einsum("...jn,jnm->...jm", ringed, t["cos_a"]),
                           torch.einsum("...jn,jnm->...jm", ringed, t["sin_a"]))
        return _contract(fm, t["wplm"], "...jm,lmj->...lm")

    def synthesis(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Coefficients ``[..., L, M]`` -> field ``[..., n_points]``."""
        t = self.tables(coeffs.device)
        fm = _contract(coeffs, t["plm"], "...lm,lmj->...jm")
        ringed = (torch.einsum("...jm,jmn->...jn", fm.real, t["cos_s"])
                  - torch.einsum("...jm,jmn->...jn", fm.imag, t["sin_s"]))
        return self.from_rings(ringed)

    def power_spectrum(self, field: torch.Tensor) -> torch.Tensor:
        """Per-degree power ``[..., lmax + 1]``."""
        return _power(self.analysis(field))


def fft2(field: torch.Tensor) -> torch.Tensor:
    """The 2-D FFT over the trailing two dims."""
    return torch.fft.fft2(field, dim=(-2, -1))


def ifft2(coeffs: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(coeffs, dim=(-2, -1)).real


def _dct1d(x: torch.Tensor) -> torch.Tensor:
    """Type-II DCT over the last dim, from the FFT of the even extension."""
    n = x.shape[-1]
    spec = torch.fft.fft(torch.cat([x, x.flip(-1)], dim=-1), dim=-1)[..., :n]
    angle = -np.pi * torch.arange(n, device=x.device, dtype=x.dtype) / (2.0 * n)
    return (spec * torch.polar(torch.ones_like(angle), angle)).real


def dct2(field: torch.Tensor) -> torch.Tensor:
    """The 2-D type-II DCT over the trailing two dims."""
    return _dct1d(_dct1d(field).transpose(-1, -2)).transpose(-1, -2)


def ring_power_spectrum(field: torch.Tensor, nlat: int, nlon: int) -> torch.Tensor:
    """The mean zonal power per wavenumber of a regular ``[..., nlat * nlon]``
    field, averaged over the latitude rings."""
    f = field.reshape(field.shape[:-1] + (nlat, nlon))
    return (torch.fft.rfft(f, dim=-1).abs() ** 2).mean(-2)
