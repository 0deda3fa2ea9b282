"""Spherical coordinate transforms (host-side numpy).

Copy of ``anemoi_tpu.graphs.transforms``. Convention throughout the port:
node coords are (lat, lon) in **radians**.
"""

from __future__ import annotations

import numpy as np


def latlon_rad_to_xyz(coords: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """(lat, lon) radians -> unit-sphere cartesian [N, 3]."""
    lat, lon = coords[..., 0], coords[..., 1]
    clat = np.cos(lat)
    return np.stack(
        [radius * clat * np.cos(lon), radius * clat * np.sin(lon), radius * np.sin(lat)],
        axis=-1,
    )


def xyz_to_latlon_rad(xyz: np.ndarray) -> np.ndarray:
    """Unit-sphere cartesian [N, 3] -> (lat, lon) radians [N, 2]."""
    norm = np.linalg.norm(xyz, axis=-1, keepdims=True)
    unit = xyz / np.clip(norm, 1e-12, None)
    lat = np.arcsin(np.clip(unit[..., 2], -1.0, 1.0))
    lon = np.arctan2(unit[..., 1], unit[..., 0])
    return np.stack([lat, lon], axis=-1)


def latlon_deg_to_rad(coords_deg: np.ndarray) -> np.ndarray:
    return np.deg2rad(coords_deg)


def great_circle_distance(coords_a: np.ndarray, coords_b: np.ndarray) -> np.ndarray:
    """Haversine distance (radians of arc) between (lat, lon)-radian points."""
    lat1, lon1 = coords_a[..., 0], coords_a[..., 1]
    lat2, lon2 = coords_b[..., 0], coords_b[..., 1]
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    h = np.sin(dlat / 2.0) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2.0) ** 2
    return 2.0 * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))


def edge_directions(src_coords: np.ndarray, dst_coords: np.ndarray) -> np.ndarray:
    """Direction of each edge as the (dlat, dlon) displacement rotated to the
    destination's local east/north frame, matching the reference's
    `EdgeDirection` attribute (graphs/.../edges/attributes.py:95): the source
    point expressed in a local coordinate system centred on the destination.
    """
    # Rotate the source into a frame where the destination sits at (0, 0):
    # apply Rz(-lon_dst) then Ry(lat_dst) to the source's xyz.
    lat_d, lon_d = dst_coords[..., 0], dst_coords[..., 1]
    xyz = latlon_rad_to_xyz(src_coords)
    cos_l, sin_l = np.cos(-lon_d), np.sin(-lon_d)
    x1 = cos_l * xyz[..., 0] - sin_l * xyz[..., 1]
    y1 = sin_l * xyz[..., 0] + cos_l * xyz[..., 1]
    z1 = xyz[..., 2]
    cos_p, sin_p = np.cos(-lat_d), np.sin(-lat_d)
    x2 = cos_p * x1 + sin_p * z1
    z2 = -sin_p * x1 + cos_p * z1
    rotated = np.stack([x2, y1, z2], axis=-1)
    local = xyz_to_latlon_rad(rotated)
    return local  # (dlat, dlon) of source in destination-centred frame


def azimuth(src_coords: np.ndarray, dst_coords: np.ndarray) -> np.ndarray:
    """Forward azimuth (radians) from src to dst along the great circle.

    Equivalent of the reference's `Azimuth` edge attribute
    (graphs/.../edges/attributes.py:143).
    """
    lat1, lon1 = src_coords[..., 0], src_coords[..., 1]
    lat2, lon2 = dst_coords[..., 0], dst_coords[..., 1]
    dlon = lon2 - lon1
    y = np.sin(dlon) * np.cos(lat2)
    x = np.cos(lat1) * np.sin(lat2) - np.sin(lat1) * np.cos(lat2) * np.cos(dlon)
    return np.arctan2(y, x)
