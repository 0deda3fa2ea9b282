"""Gaussian grid generation (pure numpy).

Copy of ``anemoi_tpu.graphs.generate.gaussian``: the grids that
``ReducedGaussianGridNodes`` and ``RegularLatLonNodes`` build.  Gaussian
latitudes come from Gauss-Legendre quadrature roots; ring lengths follow the
octahedral rule (O-grids), official pl arrays named by
``ANEMOI_TPU_PL_TABLES`` or the vendored classic tables (N-grids), or a full
ring (F-grids).
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


def _pl_table_override(n: int) -> np.ndarray | None:
    """Official pl array override from ANEMOI_TPU_PL_TABLES (npz with keys
    like 'n320' holding the full 2n-ring pl array or the n-ring NH half)."""
    import os

    path = os.environ.get("ANEMOI_TPU_PL_TABLES")
    if not path:
        return None
    with np.load(path) as tables:
        key = f"n{n}"
        if key not in tables:
            return None
        pl = np.asarray(tables[key], dtype=np.int64)
    if pl.size == n:  # NH half-table
        pl = np.concatenate([pl, pl[::-1]])
    if pl.size != 2 * n:
        raise ValueError(f"{path}[{key}] has {pl.size} rings, expected {n} or {2 * n}")
    return pl


def reduced_ring_lengths(n: int) -> np.ndarray:
    """Classic reduced-Gaussian (N-grid) ring lengths: the official pl array
    of ``ANEMOI_TPU_PL_TABLES`` where it holds one for ``n``, else the
    vendored tables, else the approximate FFT-friendly rule
    nlon(ring) ~ 4n*cos(lat)."""
    override = _pl_table_override(n)
    if override is not None:
        return override
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


def regular_latlon_grid(resolution_deg: float) -> np.ndarray:
    """Regular lat/lon grid at the given spacing (degrees), poles excluded."""
    nlat = int(round(180.0 / resolution_deg)) - 1
    nlon = int(round(360.0 / resolution_deg))
    lats = np.deg2rad(90.0 - resolution_deg * np.arange(1, nlat + 1))
    lons = np.deg2rad(np.arange(nlon) * resolution_deg)
    lons = np.where(lons > np.pi, lons - 2.0 * np.pi, lons)
    lat_grid, lon_grid = np.meshgrid(lats, lons, indexing="ij")
    return np.stack([lat_grid.ravel(), lon_grid.ravel()], axis=-1)
