"""Dataset backends.

The port's copy of ``anemoi_tpu.data.dataset``: the same readers, layouts
and synthetic fields, so both packages read the same windows and
statistics from the same store or config.  Layouts:

- ``NpyDataset`` (directory)::

    <dir>/data.npy            [time, variable, ensemble, grid]  (memmap-able)
    <dir>/coords.npz          latitudes, longitudes (degrees)
    <dir>/statistics.npz      mean, stdev, minimum, maximum     [variable]
    <dir>/statistics_tendencies.npz  (optional, same keys)
    <dir>/metadata.json       variables (ordered names), timestep_hours,
                              missing (list of missing time indices)

- ``TrajectoryDataset``: the same with ``trajectories.npy`` [base, variable,
  ensemble, step, grid], one sequence per base date;
- ``ZarrDataset``: an anemoi-layout zarr v2 store (``data/zarr_reader.py``);
- ``SyntheticDataset``: deterministic smooth fields generated from a seed,
  on the coordinates of a node builder of the port's ``graphs/nodes.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class BaseDataset:
    """Interface: indexable time series of [variable, ensemble, grid] fields.

    Datasets expose a *sequence* structure (ref data_reader.py:130-180): an
    analysis dataset is ONE sequence covering the whole time axis, while a
    trajectory (forecast) dataset is one sequence per base date.  Training
    windows never cross sequence boundaries.
    """

    variables: List[str]
    latitudes: np.ndarray  # radians
    longitudes: np.ndarray  # radians
    statistics: Dict[str, np.ndarray]
    statistics_tendencies: Optional[Dict[str, np.ndarray]]
    timestep_hours: float
    missing: set
    # per-variable metadata (units, mars param/levtype, ...) as written by
    # anemoi-datasets; feeds variable-group extraction + compat checks
    # (utils/variables_metadata.py)
    variables_metadata: Optional[Dict[str, dict]] = None

    @property
    def name_to_index(self) -> Dict[str, int]:
        return {name: i for i, name in enumerate(self.variables)}

    @property
    def num_grid_points(self) -> int:
        return len(self.latitudes)

    def __len__(self) -> int:
        raise NotImplementedError

    # ----- sequence API (single-sequence defaults for analysis datasets)
    @property
    def num_sequences(self) -> int:
        return 1

    def sequence_length(self, sequence: int = 0) -> int:
        return len(self)

    @property
    def missing_sequences(self) -> set:
        """Sequences that are entirely missing (trajectory: missing base dates)."""
        return set()

    def missing_positions(self, sequence: int = 0) -> set:
        """Missing positions WITHIN a sequence."""
        return self.missing

    def get_window(self, start: int, length: int, grid_slice: slice = slice(None)) -> np.ndarray:
        """[length, ensemble, grid, variable] float32 window starting at
        ``start``, of the grid points ``grid_slice`` (a rank's block)."""
        raise NotImplementedError

    def get_seq_window(self, sequence: int, start: int, length: int,
                       grid_slice: slice = slice(None)) -> np.ndarray:
        """Window within one sequence; analysis datasets ignore ``sequence``."""
        return self.get_window(start, length, grid_slice)

    def compute_anchors(self, relative_indices) -> np.ndarray:
        """Valid ``(sequence, position)`` anchors for the requested relative
        offsets (ref data_reader.py compute_anchors + usable_indices.py:91-124):
        anchor (s, p) is valid iff every p + i (i in relative_indices) is
        in-bounds and not missing within sequence s."""
        rel = np.asarray(relative_indices, dtype=np.int64)
        rows = []
        for s in range(self.num_sequences):
            if s in self.missing_sequences:
                continue
            n = self.sequence_length(s)
            pos = np.arange(n, dtype=np.int64)
            pos = pos[(pos + rel.min() >= 0) & (pos + rel.max() < n)]
            for m in self.missing_positions(s):
                hit = m - rel  # anchors whose relative offsets land on m
                pos = pos[np.all(pos != hit[:, None], axis=0)]
            if len(pos):
                rows.append(np.stack([np.full(len(pos), s, dtype=np.int64), pos], 1))
        if not rows:
            return np.empty((0, 2), dtype=np.int64)
        return np.concatenate(rows, axis=0)


class NpyDataset(BaseDataset):
    def __init__(self, path: str) -> None:
        self.path = path
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        self.variables = list(meta["variables"])
        self.variables_metadata = meta.get("variables_metadata")
        self.timestep_hours = float(meta.get("timestep_hours", 6))
        self.missing = set(meta.get("missing", []))
        coords = np.load(os.path.join(path, "coords.npz"))
        self.latitudes = np.deg2rad(coords["latitudes"].astype(np.float64))
        self.longitudes = np.deg2rad(coords["longitudes"].astype(np.float64))
        stats = np.load(os.path.join(path, "statistics.npz"))
        self.statistics = {k: stats[k] for k in stats.files}
        tpath = os.path.join(path, "statistics_tendencies.npz")
        if os.path.exists(tpath):
            t = np.load(tpath)
            self.statistics_tendencies = {k: t[k] for k in t.files}
        else:
            self.statistics_tendencies = None
        self.data = np.load(os.path.join(path, "data.npy"), mmap_mode="r")
        assert self.data.ndim == 4, "data.npy must be [time, variable, ensemble, grid]"
        assert self.data.shape[1] == len(self.variables)

    def __len__(self) -> int:
        return self.data.shape[0]

    def get_window(self, start: int, length: int, grid_slice: slice = slice(None)) -> np.ndarray:
        w = np.asarray(self.data[start : start + length, :, :, grid_slice], dtype=np.float32)
        # [T, V, E, G] -> [T, E, G, V]
        return np.transpose(w, (0, 2, 3, 1))


class TrajectoryDataset(BaseDataset):
    """Forecast-trajectory dataset with an explicit lead-step axis
    (ref data_reader.py:339-464).

    On-disk layout mirrors the npy analysis format with a 5-D data file:

        <dir>/trajectories.npy   [base_dates, variable, ensemble, step, grid]
        <dir>/coords.npz / statistics.npz / metadata.json  (as NpyDataset;
        metadata may list ``missing`` base-date indices and
        ``step_frequency_hours``)

    Each base date (forecast initialisation) is one sequence and the forecast
    step is the within-sequence position, so a training sample is always
    contained inside a single forecast and never crosses initialisation
    boundaries."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        self.variables = list(meta["variables"])
        self.variables_metadata = meta.get("variables_metadata")
        # step frequency comes from the dataset itself (ref data_reader.py:378:
        # passing data.frequency is rejected there; here it is simply ignored)
        self.timestep_hours = float(
            meta.get("step_frequency_hours", meta.get("timestep_hours", 6))
        )
        self.missing = set()  # per-position gaps do not exist in forecasts
        self._missing_bases = set(meta.get("missing", []))
        coords = np.load(os.path.join(path, "coords.npz"))
        self.latitudes = np.deg2rad(coords["latitudes"].astype(np.float64))
        self.longitudes = np.deg2rad(coords["longitudes"].astype(np.float64))
        stats = np.load(os.path.join(path, "statistics.npz"))
        self.statistics = {k: stats[k] for k in stats.files}
        tpath = os.path.join(path, "statistics_tendencies.npz")
        self.statistics_tendencies = (
            {k: v for k, v in np.load(tpath).items()} if os.path.exists(tpath) else None
        )
        self.data = np.load(os.path.join(path, "trajectories.npy"), mmap_mode="r")
        assert self.data.ndim == 5, (
            "trajectories.npy must be [base, variable, ensemble, step, grid]"
        )
        assert self.data.shape[1] == len(self.variables)

    def __len__(self) -> int:  # total steps across forecasts (informational)
        return self.data.shape[0] * self.data.shape[3]

    @property
    def num_sequences(self) -> int:
        return self.data.shape[0]

    def sequence_length(self, sequence: int = 0) -> int:
        return self.data.shape[3]

    @property
    def missing_sequences(self) -> set:
        return self._missing_bases

    def missing_positions(self, sequence: int = 0) -> set:
        return set()

    def get_window(self, start: int, length: int, grid_slice: slice = slice(None)) -> np.ndarray:
        return self.get_seq_window(0, start, length, grid_slice)

    def get_seq_window(self, sequence: int, start: int, length: int,
                       grid_slice: slice = slice(None)) -> np.ndarray:
        w = np.asarray(
            self.data[sequence, :, :, start : start + length, grid_slice],
            dtype=np.float32,
        )  # [V, E, T, G]
        return np.transpose(w, (2, 1, 3, 0))  # [T, E, G, V]


class ZarrDataset(BaseDataset):
    """Anemoi-layout zarr v2 store (anemoi-datasets' native format), read
    with the pure-numpy reader in `data/zarr_reader.py`.

    Group layout: ``data`` [time, variable, ensemble, cell] (time-chunked),
    ``latitudes``/``longitudes`` (degrees), ``mean``/``stdev``/``minimum``/
    ``maximum`` [variable]; `.zattrs`: ``variables`` (ordered names, or a
    ``name_to_index`` map), ``frequency`` ("6h"), ``missing`` (time indices).
    Codecs: raw, zlib, gzip and blosc (lz4/lz4hc/zlib inside).
    """

    def __init__(self, path: str) -> None:
        from anemoi_tpu_torch.data.zarr_reader import ZarrGroup

        self.path = path
        group = ZarrGroup(path)
        attrs = group.attrs
        if "variables" in attrs:
            self.variables = list(attrs["variables"])
        elif "name_to_index" in attrs:
            n2i = attrs["name_to_index"]
            self.variables = sorted(n2i, key=n2i.__getitem__)
        else:
            raise ValueError(f"{path}: .zattrs has neither variables nor name_to_index")
        self.variables_metadata = attrs.get("variables_metadata")
        self.timestep_hours = _parse_frequency_hours(attrs.get("frequency", "6h"))
        self.missing = set(int(i) for i in attrs.get("missing", []))
        self.latitudes = np.deg2rad(np.asarray(group["latitudes"], np.float64))
        self.longitudes = np.deg2rad(np.asarray(group["longitudes"], np.float64))
        self.statistics = {
            k: np.asarray(group[k], np.float32)
            for k in ("mean", "stdev", "minimum", "maximum")
            if k in group
        }
        self.statistics_tendencies = None
        self.data = group["data"]
        assert self.data.ndim == 4, "zarr data must be [time, variable, ensemble, cell]"
        assert self.data.shape[1] == len(self.variables), (
            f"{self.data.shape[1]} data variables != {len(self.variables)} names"
        )

    def __len__(self) -> int:
        return self.data.shape[0]

    def get_window(self, start: int, length: int, grid_slice: slice = slice(None)) -> np.ndarray:
        w = self.data[start : start + length]  # the chunks hold every grid point
        # [T, V, E, G] -> [T, E, G, V]
        return np.transpose(np.asarray(w, np.float32)[..., grid_slice], (0, 2, 3, 1))


def _parse_frequency_hours(freq) -> float:
    """'6h' / '30m' / '1d' / plain numbers -> hours."""
    if isinstance(freq, (int, float)):
        return float(freq)
    s = str(freq).strip().lower()
    unit = {"h": 1.0, "m": 1.0 / 60.0, "d": 24.0, "s": 1.0 / 3600.0}
    if s and s[-1] in unit:
        return float(s[:-1]) * unit[s[-1]]
    return float(s)


class SyntheticDataset(BaseDataset):
    """Deterministic synthetic weather-like fields: per-variable sums of
    rotating spherical harmonics-ish waves so that consecutive steps are
    smoothly correlated (autoregression is learnable)."""

    def __init__(
        self,
        latitudes: np.ndarray,  # radians
        longitudes: np.ndarray,
        variables: Sequence[str],
        num_times: int = 64,
        timestep_hours: float = 6.0,
        seed: int = 0,
        num_modes: int = 4,
        speed_range: tuple = (0.05, 0.25),
    ) -> None:
        self.latitudes = np.asarray(latitudes, dtype=np.float64)
        self.longitudes = np.asarray(longitudes, dtype=np.float64)
        self.variables = list(variables)
        self.num_times = num_times
        self.timestep_hours = timestep_hours
        self.missing = set()
        rng = np.random.default_rng(seed)
        v = len(self.variables)
        self._amps = rng.uniform(0.5, 1.5, (v, num_modes)).astype(np.float32)
        self._freq_lat = rng.integers(1, 4, (v, num_modes))
        self._freq_lon = rng.integers(1, 5, (v, num_modes))
        self._speed = rng.uniform(*speed_range, (v, num_modes)).astype(np.float32)
        self._phase = rng.uniform(0, 2 * np.pi, (v, num_modes)).astype(np.float32)
        self._offsets = rng.normal(0, 1, v).astype(np.float32)

        sample = self._fields(np.arange(min(num_times, 16)))
        mean = sample.mean(axis=(0, 2))
        std = sample.std(axis=(0, 2)) + 1e-6
        self.statistics = {
            "mean": mean.astype(np.float32),
            "stdev": std.astype(np.float32),
            "minimum": sample.min(axis=(0, 2)).astype(np.float32),
            "maximum": sample.max(axis=(0, 2)).astype(np.float32),
        }
        tend = np.diff(sample, axis=0)
        self.statistics_tendencies = {
            "mean": tend.mean(axis=(0, 2)).astype(np.float32),
            "stdev": (tend.std(axis=(0, 2)) + 1e-6).astype(np.float32),
            "minimum": tend.min(axis=(0, 2)).astype(np.float32),
            "maximum": tend.max(axis=(0, 2)).astype(np.float32),
        }

    def _fields(self, times: np.ndarray, grid_slice: slice = slice(None)) -> np.ndarray:
        """[T, V, G] raw fields."""
        lat = self.latitudes[grid_slice]
        lon = self.longitudes[grid_slice]
        t = np.asarray(times, dtype=np.float32)[:, None, None, None]  # [T,1,1,1]
        amps = self._amps[None, :, :, None]
        phase = (
            self._freq_lat[None, :, :, None] * lat[None, None, None, :]
            + self._freq_lon[None, :, :, None] * lon[None, None, None, :]
            + self._speed[None, :, :, None] * t
            + self._phase[None, :, :, None]
        )
        fields = (amps * np.sin(phase)).sum(axis=2) + self._offsets[None, :, None]
        return fields.astype(np.float32)  # [T, V, G]

    def __len__(self) -> int:
        return self.num_times

    def get_window(self, start: int, length: int, grid_slice: slice = slice(None)) -> np.ndarray:
        f = self._fields(np.arange(start, start + length), grid_slice)
        return f.transpose(0, 2, 1)[:, None]  # [T, E=1, G, V]


def open_dataset(path_or_config) -> BaseDataset:
    if isinstance(path_or_config, str):
        if path_or_config.rstrip("/").endswith(".zarr"):
            return ZarrDataset(path_or_config)
        return NpyDataset(path_or_config)
    cfg = dict(path_or_config)
    kind = cfg.pop("kind", "npy")
    if kind == "npy":
        return NpyDataset(cfg["path"])
    if kind == "zarr":
        return ZarrDataset(cfg["path"])
    if kind == "trajectory":
        return TrajectoryDataset(cfg["path"])
    if kind == "synthetic":
        from anemoi_tpu_torch.graphs.nodes import build_nodes

        coords = build_nodes(dict(cfg.pop("nodes")))
        return SyntheticDataset(
            latitudes=coords[:, 0], longitudes=coords[:, 1], **cfg
        )
    raise ValueError(f"Unknown dataset kind '{kind}'")


def save_trajectory_dataset(
    path: str,
    data: np.ndarray,  # [base, variable, ensemble, step, grid]
    variables: List[str],
    latitudes_deg: np.ndarray,
    longitudes_deg: np.ndarray,
    step_frequency_hours: float = 6.0,
    missing_bases: Optional[List[int]] = None,
) -> None:
    """Write the on-disk trajectory dataset format (see TrajectoryDataset)."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "trajectories.npy"), data.astype(np.float32))
    np.savez(
        os.path.join(path, "coords.npz"),
        latitudes=latitudes_deg,
        longitudes=longitudes_deg,
    )
    flat = np.transpose(data, (1, 0, 2, 3, 4)).reshape(data.shape[1], -1)
    np.savez(
        os.path.join(path, "statistics.npz"),
        mean=flat.mean(axis=1).astype(np.float32),
        stdev=(flat.std(axis=1) + 1e-12).astype(np.float32),
        minimum=flat.min(axis=1).astype(np.float32),
        maximum=flat.max(axis=1).astype(np.float32),
    )
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(
            {
                "variables": list(variables),
                "step_frequency_hours": step_frequency_hours,
                "missing": sorted(missing_bases or []),
            },
            f,
        )


def save_zarr_copy(ds: BaseDataset, path: str, times_per_read: int = 8) -> None:
    """Write the fields, variables and coordinates of ``ds`` (one sequence)
    as an anemoi-layout zarr v2 store with ``save_zarr_dataset``'s default
    compressor (zlib level 1), reading ``times_per_read`` times at a time."""
    from anemoi_tpu_torch.data.zarr_reader import save_zarr_dataset

    fields = np.concatenate([ds.get_window(t, min(times_per_read, len(ds) - t))
                             for t in range(0, len(ds), times_per_read)])
    save_zarr_dataset(path, fields.transpose(0, 3, 1, 2), ds.variables,
                      np.rad2deg(ds.latitudes), np.rad2deg(ds.longitudes),
                      timestep_hours=ds.timestep_hours, missing=sorted(ds.missing))


def save_dataset(
    path: str,
    data: np.ndarray,  # [T, V, E, G]
    variables: List[str],
    latitudes_deg: np.ndarray,
    longitudes_deg: np.ndarray,
    timestep_hours: float = 6.0,
    missing: Optional[List[int]] = None,
) -> None:
    """Write the on-disk npy dataset format."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "data.npy"), data.astype(np.float32))
    np.savez(
        os.path.join(path, "coords.npz"),
        latitudes=latitudes_deg,
        longitudes=longitudes_deg,
    )
    flat = data.reshape(data.shape[0], data.shape[1], -1)
    np.savez(
        os.path.join(path, "statistics.npz"),
        mean=flat.mean(axis=(0, 2)).astype(np.float32),
        stdev=(flat.std(axis=(0, 2)) + 1e-12).astype(np.float32),
        minimum=flat.min(axis=(0, 2)).astype(np.float32),
        maximum=flat.max(axis=(0, 2)).astype(np.float32),
    )
    tend = np.diff(flat, axis=0)
    np.savez(
        os.path.join(path, "statistics_tendencies.npz"),
        mean=tend.mean(axis=(0, 2)).astype(np.float32),
        stdev=(tend.std(axis=(0, 2)) + 1e-12).astype(np.float32),
        minimum=tend.min(axis=(0, 2)).astype(np.float32),
        maximum=tend.max(axis=(0, 2)).astype(np.float32),
    )
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(
            {
                "variables": list(variables),
                "timestep_hours": timestep_hours,
                "missing": sorted(missing or []),
            },
            f,
        )
