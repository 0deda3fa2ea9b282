"""HEALPix pixel centres (ring scheme), pure numpy (no healpy).

Copy of ``anemoi_tpu.graphs.generate.healpix``: the pixel centres of
``HEALPixNodes`` in the ring and nested schemes, and the nested-scheme pixel
adjacency of ``HEALPixMultiScaleEdges``.  Implements the standard analytic ring-scheme centre formulas
(Gorski et al. 2005) for 12*nside^2 pixels.
"""

from __future__ import annotations

import numpy as np


def healpix_grid(nside: int) -> np.ndarray:
    """(lat, lon) radians of all 12*nside^2 HEALPix pixel centres (ring order)."""
    npix = 12 * nside * nside
    p = np.arange(npix, dtype=np.int64)
    z = np.empty(npix, dtype=np.float64)
    phi = np.empty(npix, dtype=np.float64)

    ncap = 2 * nside * (nside - 1)  # pixels in the north polar cap

    # North polar cap ---------------------------------------------------
    cap = p < ncap
    ph = (p[cap] + 1) / 2.0
    i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(np.int64) + 1
    j = p[cap] + 1 - 2 * i * (i - 1)
    z[cap] = 1.0 - (i * i) / (3.0 * nside * nside)
    phi[cap] = (np.pi / (2.0 * i)) * (j - 0.5)

    # Equatorial belt ---------------------------------------------------
    belt = (p >= ncap) & (p < npix - ncap)
    pb = p[belt] - ncap
    i = pb // (4 * nside) + nside
    j = pb % (4 * nside) + 1
    s = (i - nside + 1) % 2  # phase shift of alternating rings
    z[belt] = 4.0 / 3.0 - 2.0 * i / (3.0 * nside)
    phi[belt] = (np.pi / (2.0 * nside)) * (j - s / 2.0)

    # South polar cap (mirror of north) --------------------------------
    south = p >= npix - ncap
    ps = npix - 1 - p[south]
    ph = (ps + 1) / 2.0
    i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(np.int64) + 1
    j = ps + 1 - 2 * i * (i - 1)
    z[south] = -(1.0 - (i * i) / (3.0 * nside * nside))
    # mirror longitudes so ring order stays west->east
    phi[south] = 2.0 * np.pi - (np.pi / (2.0 * i)) * (j - 0.5)

    lat = np.arcsin(np.clip(z, -1.0, 1.0))
    lon = np.mod(phi, 2.0 * np.pi)
    lon = np.where(lon > np.pi, lon - 2.0 * np.pi, lon)
    return np.stack([lat, lon], axis=-1)


# ----------------------------------------------------------------------
# nested scheme + pixel adjacency (pure numpy, no healpy)
# ----------------------------------------------------------------------
# Face layout constants of the HEALPix tessellation (Gorski et al. 2005):
# ring offset (jrll, in units of nside) and longitude offset (jpll, in units
# of pi/4) of each of the 12 base faces.
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def _spread_bits(x: np.ndarray) -> np.ndarray:
    """Interleave zeros between the bits of x (for the nested Morton index)."""
    x = x.astype(np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _compress_bits(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x5555555555555555)
    x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x


def nest_to_fxy(p: np.ndarray, nside: int):
    """Nested pixel index -> (face, ix, iy)."""
    p = np.asarray(p, dtype=np.int64)
    face = p // (nside * nside)
    rem = (p % (nside * nside)).astype(np.uint64)
    ix = _compress_bits(rem).astype(np.int64)
    iy = _compress_bits(rem >> np.uint64(1)).astype(np.int64)
    return face, ix, iy


def fxy_to_nest(face: np.ndarray, ix: np.ndarray, iy: np.ndarray, nside: int):
    return (
        np.asarray(face, np.int64) * nside * nside
        + (_spread_bits(ix) | (_spread_bits(iy) << np.uint64(1))).astype(np.int64)
    )


def _fxy_to_zphi(face, ix, iy, nside: int):
    """(face, ix, iy) -> (z, phi) pixel centres (standard pix2ang_nest)."""
    jr = _JRLL[face] * nside - ix - iy - 1  # 1 .. 4*nside-1
    z = np.empty(jr.shape, dtype=np.float64)
    nr = np.empty(jr.shape, dtype=np.int64)
    kshift = np.zeros(jr.shape, dtype=np.int64)

    north = jr < nside
    nr[north] = jr[north]
    z[north] = 1.0 - (nr[north] ** 2) / (3.0 * nside * nside)

    eq = (jr >= nside) & (jr <= 3 * nside)
    nr[eq] = nside
    z[eq] = (2 * nside - jr[eq]) * 2.0 / (3.0 * nside)
    kshift[eq] = (jr[eq] - nside) & 1

    south = jr > 3 * nside
    nr[south] = 4 * nside - jr[south]
    z[south] = -1.0 + (nr[south] ** 2) / (3.0 * nside * nside)

    jp = (_JPLL[face] * nr + ix - iy + 1 + kshift) / 2.0
    jp = np.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = np.where(jp < 1, jp + 4 * nr, jp)
    phi = (jp - (kshift + 1) * 0.5) * (np.pi / (2.0 * nr))
    return z, phi


def healpix_grid_nested(nside: int) -> np.ndarray:
    """(lat, lon) radians of all pixel centres in NESTED order."""
    p = np.arange(12 * nside * nside, dtype=np.int64)
    face, ix, iy = nest_to_fxy(p, nside)
    z, phi = _fxy_to_zphi(face, ix, iy, nside)
    lat = np.arcsin(np.clip(z, -1.0, 1.0))
    lon = np.mod(phi, 2 * np.pi)
    lon = np.where(lon > np.pi, lon - 2 * np.pi, lon)
    return np.stack([lat, lon], axis=-1)


def _hpx_projection_centers(face, ix, iy, nside: int):
    """Pixel centres in the HPX projection plane, where every pixel is a
    diamond with half-diagonals h = pi/(4*nside) along x and y."""
    h = np.pi / (4.0 * nside)
    xc = _JPLL[face] * (np.pi / 4.0) + (ix - iy) * h
    # jr (ring units of h): face centre ring = _JRLL*nside; y = (2*nside-jr)*h
    jr = _JRLL[face] * nside - ix - iy - 1
    yc = (2 * nside - jr) * h
    return xc, yc


def _hpx_inverse(x, y):
    """HPX projection plane -> unit vectors (exact; Calabretta & Roukema)."""
    x = np.mod(x, 2 * np.pi)
    ay = np.abs(y)
    z = np.empty_like(y)
    phi = np.empty_like(y)
    eq = ay <= np.pi / 4
    z[eq] = y[eq] * 8.0 / (3.0 * np.pi)
    phi[eq] = x[eq]
    po = ~eq
    sigma = 2.0 - 4.0 * ay[po] / np.pi
    xc = (np.floor(x[po] / (np.pi / 2.0)) + 0.5) * (np.pi / 2.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        phi_p = np.where(sigma > 1e-12, xc + (x[po] - xc) / sigma, 0.0)
    z[po] = np.sign(y[po]) * (1.0 - sigma * sigma / 3.0)
    phi[po] = phi_p
    st = np.sqrt(np.clip(1.0 - z * z, 0.0, 1.0))
    return np.stack([st * np.cos(phi), st * np.sin(phi), z], axis=-1)


def healpix_neighbours(resolution: int) -> np.ndarray:
    """[npix, <=8] nested-scheme neighbour lists via shared pixel vertices.

    Equivalent of healpy.get_all_neighbours over all pixels without healpy: every HEALPix pixel is an
    exact diamond in the HPX projection plane; two pixels are neighbours
    (edge- OR corner-adjacent, healpy's definition) iff they share a vertex
    on the sphere.  Vertices are matched by rounded 3-D position so polar
    gore seams unify correctly.  Returns -1-padded rows (the polar-corner
    pixels have 7 neighbours)."""
    nside = 2**resolution
    npix = 12 * nside * nside
    p = np.arange(npix, dtype=np.int64)
    face, ix, iy = nest_to_fxy(p, nside)
    xc, yc = _hpx_projection_centers(face, ix, iy, nside)
    h = np.pi / (4.0 * nside)
    # 4 vertices per pixel: E, W, N, S corners of the diamond
    vx = np.concatenate([xc + h, xc - h, xc, xc])
    vy = np.concatenate([yc, yc, yc + h, yc - h])
    vecs = _hpx_inverse(vx, vy)
    # quantise to a grid well below the minimum distinct-vertex separation
    # (~0.8h measured) and match rows EXACTLY (no hashing -- collisions gave
    # false adjacency)
    quant = np.round(vecs / (h * 0.05)).astype(np.int64)
    _, key = np.unique(quant, axis=0, return_inverse=True)
    owner = np.tile(p, 4)
    order = np.argsort(key, kind="stable")
    key_s, owner_s = key[order], owner[order]
    starts = np.flatnonzero(np.concatenate([[True], key_s[1:] != key_s[:-1]]))
    counts = np.diff(np.append(starts, len(key_s)))
    # pairs of pixels sharing each vertex (vertices are shared by <= 4 pixels)
    pairs = []
    for c in np.unique(counts):
        idx = starts[counts == c]
        if c < 2:
            continue
        group = owner_s[idx[:, None] + np.arange(c)]
        a, b = np.triu_indices(int(c), k=1)
        pairs.append(np.stack([group[:, a].ravel(), group[:, b].ravel()], 1))
    pairs = np.concatenate(pairs, axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    both = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
    both = np.unique(both, axis=0)
    src, dst = both[:, 1], both[:, 0]
    deg = np.bincount(dst, minlength=npix)
    kmax = int(deg.max())
    out = np.full((npix, kmax), -1, dtype=np.int64)
    ptr = np.zeros(npix + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    within = np.arange(len(dst)) - ptr[dst]
    out[dst, within] = src
    return out


def healpix_edge_index(resolution: int) -> np.ndarray:
    """[2, E] directed nested-scheme adjacency edges (both directions)."""
    nbr = healpix_neighbours(resolution)
    npix = nbr.shape[0]
    src = nbr.ravel()
    dst = np.repeat(np.arange(npix, dtype=np.int64), nbr.shape[1])
    keep = src >= 0
    return np.stack([src[keep], dst[keep]])


def healpix_multiscale_edges(resolution: int, scale_resolutions=None) -> np.ndarray:
    """Union of nested adjacency edges over resolutions, coarse indices mapped
    to their first fine descendant (x 4^(res_diff)); deduplicated.

    Unlike anemoi-graphs' HEALPixMultiScaleEdges, healpy's -1 'missing
    neighbour' sentinels are dropped and repeated coarse/fine pairs
    deduplicated."""
    if scale_resolutions is None:
        scale_resolutions = list(range(1, resolution + 1))
    if isinstance(scale_resolutions, int):
        scale_resolutions = list(range(1, scale_resolutions + 1))
    if min(scale_resolutions) < 1:
        raise ValueError("scale_resolutions must be positive")
    if max(scale_resolutions) > resolution:
        raise ValueError(f"scale_resolutions {scale_resolutions} exceed the node resolution "
                         f"{resolution}")
    parts = []
    for res in sorted(scale_resolutions):
        ei = healpix_edge_index(res)
        parts.append(ei * (4 ** (resolution - res)))
    edges = np.concatenate(parts, axis=1)
    return np.unique(edges, axis=1)
