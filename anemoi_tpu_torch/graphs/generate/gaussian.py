"""Gaussian grid generation (pure numpy).

Copy of ``anemoi_tpu.graphs.generate.gaussian``, trimmed to the grids that
``ReducedGaussianGridNodes`` builds: Gaussian latitudes from Gauss-Legendre
quadrature roots; ring lengths follow the octahedral rule (O-grids), the
vendored classic tables (N-grids) or a full ring (F-grids).
"""

from __future__ import annotations

import numpy as np


def gaussian_latitudes(n: int) -> np.ndarray:
    """The 2n Gaussian latitudes (radians), north to south."""
    nodes, _ = np.polynomial.legendre.leggauss(2 * n)
    lats = np.arcsin(nodes)  # south to north
    return lats[::-1].copy()


def _fft_friendly(n: int) -> int:
    """Smallest integer >= n that factors into 2,3,5 (and is even)."""
    m = max(int(n), 4)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1 and m % 2 == 0:
            return m
        m += 1


def octahedral_ring_lengths(n: int) -> np.ndarray:
    """Points per latitude ring for the octahedral O(n) grid: 20, 24, ... from pole."""
    half = 16 + 4 * np.arange(1, n + 1)
    return np.concatenate([half, half[::-1]])


def reduced_ring_lengths(n: int) -> np.ndarray:
    """Classic reduced-Gaussian (N-grid) ring lengths: the vendored tables,
    else the approximate FFT-friendly rule nlon(ring) ~ 4n*cos(lat)."""
    from anemoi_tpu_torch.graphs.generate._ngrid_tables import CLASSIC_RING_TABLES

    if n in CLASSIC_RING_TABLES:
        half = np.asarray(CLASSIC_RING_TABLES[n], dtype=np.int64)
        return np.concatenate([half, half[::-1]])
    import warnings

    warnings.warn(
        f"No vendored classic ring table for N{n}; using the approximate "
        f"4n*cos(lat) rule whose point count differs from the official grid.",
        stacklevel=2,
    )
    lats = gaussian_latitudes(n)
    half = [_fft_friendly(max(16, int(np.ceil(4 * n * np.cos(lat))))) for lat in lats[:n]]
    half = np.asarray(half, dtype=np.int64)
    return np.concatenate([half, half[::-1]])


def grid_from_rings(lats: np.ndarray, ring_lengths: np.ndarray) -> np.ndarray:
    """(lat, lon) radians for all points of a ring-structured grid.

    Longitudes start at 0 and are uniformly spaced per ring; points are ordered
    ring-by-ring from north to south, west to east.
    """
    total = int(ring_lengths.sum())
    coords = np.empty((total, 2), dtype=np.float64)
    offset = 0
    for lat, nlon in zip(lats, ring_lengths):
        lons = 2.0 * np.pi * np.arange(nlon) / nlon
        lons = np.where(lons > np.pi, lons - 2.0 * np.pi, lons)
        coords[offset : offset + nlon, 0] = lat
        coords[offset : offset + nlon, 1] = lons
        offset += nlon
    return coords


def octahedral_gaussian_grid(n: int) -> np.ndarray:
    """Octahedral reduced Gaussian grid O<n>: 4n^2 + 36n points."""
    return grid_from_rings(gaussian_latitudes(n), octahedral_ring_lengths(n))


def reduced_gaussian_grid(n: int) -> np.ndarray:
    """Classic-style reduced Gaussian grid N<n>."""
    return grid_from_rings(gaussian_latitudes(n), reduced_ring_lengths(n))


def full_gaussian_grid(n: int) -> np.ndarray:
    """Full Gaussian grid F<n>: 2n lats x 4n lons."""
    lats = gaussian_latitudes(n)
    return grid_from_rings(lats, np.full(2 * n, 4 * n, dtype=np.int64))
