"""Spatial node orderings.

Copy of ``anemoi_tpu.graphs.ordering``.  The TPU kernel needs nearby nodes at
nearby indices (its slot tables are dense only then); the CUDA kernel gathers
rows by index and does not care, but the order still decides the row order of
the trainable node attributes, so the port reproduces it exactly.
"""

from __future__ import annotations

import numpy as np


def cube_morton_order(lats: np.ndarray, lons: np.ndarray, bits: int = 12) -> np.ndarray:
    """Order spherical points (degrees) along a cube-sphere Morton curve.

    Project each unit vector onto its dominant cube face, Morton-interleave
    the (u, v) face coordinates, and key by (face, morton).  Locality is what
    matters here, not curve continuity across faces.  Returns ``order`` such
    that ``coords[order]`` walks the curve (old id per new position)."""
    lat = np.deg2rad(lats)
    lon = np.deg2rad(lons)
    x = np.cos(lat) * np.cos(lon)
    y = np.cos(lat) * np.sin(lon)
    z = np.sin(lat)
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    # face: 0..5 by dominant axis and sign
    face = np.where(
        (ax >= ay) & (ax >= az), np.where(x >= 0, 0, 1),
        np.where(ay >= az, np.where(y >= 0, 2, 3), np.where(z >= 0, 4, 5)),
    )
    denom = np.choose(face, [ax, ax, ay, ay, az, az])
    u = np.choose(face, [y, -y, -x, x, x, -x]) / denom
    v = np.choose(face, [z, z, z, z, y, y]) / denom
    n = 1 << bits
    ui = np.clip(((u + 1.0) * 0.5 * n).astype(np.int64), 0, n - 1)
    vi = np.clip(((v + 1.0) * 0.5 * n).astype(np.int64), 0, n - 1)

    def spread(a):
        a = a & ((1 << 16) - 1)
        a = (a | (a << 8)) & 0x00FF00FF
        a = (a | (a << 4)) & 0x0F0F0F0F
        a = (a | (a << 2)) & 0x33333333
        a = (a | (a << 1)) & 0x55555555
        return a

    morton = spread(ui) | (spread(vi) << 1)
    key = (face.astype(np.int64) << 32) | morton
    return np.argsort(key, kind="stable")
