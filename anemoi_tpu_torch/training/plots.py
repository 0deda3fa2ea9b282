"""Plotting diagnostics: map, spectrum and histogram figures, executors.

Port of ``anemoi_tpu.training.plots``: matplotlib figure builders (the
Agg backend, no display), per-variable colormaps, the focus-area spatial
masks, and the executors that render figures on a background thread
(``AsyncPlotExecutor``) or inline (``SyncPlotExecutor``) for the plot
callbacks of ``training/callbacks.py``, which write them to
``<output_dir>/plots/``.  matplotlib is imported inside the functions that
draw; the data each figure draws is computed with numpy and torch
(:func:`power_spectra`: the port's ``ops/spectral.py``).
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from anemoi_tpu_torch.ops.spectral import GaussianSHT, ReducedSHT

LOGGER = logging.getLogger(__name__)


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


# ----------------------------------------------------------------------
# figure builders
# ----------------------------------------------------------------------
def plot_field_map(lats, lons, values, title: str = "", ax=None, cmap="viridis"):
    """Scatter a node field on a lat/lon map."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 3))
    sc = ax.scatter(
        np.rad2deg(np.asarray(lons)), np.rad2deg(np.asarray(lats)),
        c=np.asarray(values), s=1.0, cmap=cmap, rasterized=True,
    )
    ax.set_xlim(-180, 180)
    ax.set_ylim(-90, 90)
    ax.set_title(title, fontsize=8)
    plt.colorbar(sc, ax=ax, shrink=0.8)
    return ax


def plot_sample_maps(
    lats, lons, pred: np.ndarray, truth: np.ndarray, names: Sequence[str],
    cmaps: Optional[Dict[str, object]] = None,
):
    """Per-variable rows of (truth, prediction, error) maps.  ``cmaps``
    maps variable names to custom colormaps (:func:`build_colormaps`)."""
    plt = _plt()
    n = len(names)
    cmaps = cmaps or {}
    fig, axes = plt.subplots(n, 3, figsize=(15, 3 * n), squeeze=False)
    for i, name in enumerate(names):
        t, p = np.asarray(truth[..., i]), np.asarray(pred[..., i])
        lim = max(np.nanmax(np.abs(t)), np.nanmax(np.abs(p)), 1e-12)
        cmap = cmaps.get(name, "viridis")
        plot_field_map(lats, lons, t, f"{name} truth", ax=axes[i, 0], cmap=cmap)
        plot_field_map(lats, lons, p, f"{name} prediction", ax=axes[i, 1], cmap=cmap)
        err = p - t
        plot_field_map(
            lats, lons, err, f"{name} error (max {np.nanmax(np.abs(err)):.3g})",
            ax=axes[i, 2], cmap="RdBu_r",
        )
        del lim
    fig.tight_layout()
    return fig


def plot_ensemble_maps(
    lats, lons, members: np.ndarray, truth: np.ndarray, name: str, max_members: int = 4
):
    """Truth / ensemble-mean / spread / first-K-member maps for one variable."""
    plt = _plt()
    members = np.asarray(members)  # [M, G]
    k = min(max_members, members.shape[0])
    n_cols = 3 + k
    fig, axes = plt.subplots(1, n_cols, figsize=(5 * n_cols, 3), squeeze=False)
    plot_field_map(lats, lons, truth, f"{name} truth", ax=axes[0, 0])
    plot_field_map(lats, lons, members.mean(0), f"{name} ens mean", ax=axes[0, 1])
    plot_field_map(
        lats, lons, members.std(0), f"{name} ens spread", ax=axes[0, 2], cmap="magma"
    )
    for m in range(k):
        plot_field_map(lats, lons, members[m], f"{name} member {m}", ax=axes[0, 3 + m])
    fig.tight_layout()
    return fig


# ----------------------------------------------------------------------
# per-variable custom colormaps
# ----------------------------------------------------------------------
def build_colormaps(configs: Optional[List[dict]]) -> Dict[str, object]:
    """Variable -> matplotlib colormap map from config entries:

    - {"name": "viridis", "variables": [...]} — a named matplotlib colormap
    - {"clevels": ["#aabbcc", ...], "variables": [...]} — a ListedColormap
    - {"distinctipy": N, "variables": [...]} — N distinct colors
      (needs the distinctipy package; gated)
    """
    out: Dict[str, object] = {}
    for cfg in configs or []:
        cfg = dict(cfg)
        variables = cfg.pop("variables", None) or []
        if "clevels" in cfg:
            from matplotlib.colors import ListedColormap

            cmap = ListedColormap(cfg["clevels"])
        elif "distinctipy" in cfg:
            try:
                from distinctipy import distinctipy
            except ImportError as err:
                raise ImportError(
                    "distinctipy package is not available; install it to use "
                    "distinctipy colormaps"
                ) from err
            cmap = distinctipy.get_colormap(
                distinctipy.get_colors(
                    int(cfg["distinctipy"]), colorblind_type=cfg.get("colorblind_type")
                )
            )
        else:
            import matplotlib

            cmap = matplotlib.colormaps.get_cmap(cfg["name"])
        for var in variables:
            out[var] = cmap
    return out


# ----------------------------------------------------------------------
# focus-area spatial masks
# ----------------------------------------------------------------------
class SpatialMask:
    """Restrict plots to a sub-area. ``apply`` masks latlons plus any number
    of [..., G, V] fields along their node axis."""

    def __init__(self, tag: str = "") -> None:
        self.tag = tag
        self.focus_mask: Optional[np.ndarray] = None

    def compute_mask(self, graph, nodes_name: str, lats, lons) -> None: ...

    def apply(self, graph, nodes_name: str, lats, lons, *fields):
        self.compute_mask(graph, nodes_name, lats, lons)
        if self.focus_mask is None:
            return (lats, lons, *fields)
        m = self.focus_mask
        return (np.asarray(lats)[m], np.asarray(lons)[m],
                *[np.asarray(f)[..., m, :] for f in fields])


class NoOpSpatialMask(SpatialMask):
    pass


class NodeAttributeSpatialMask(SpatialMask):
    """Focus on nodes flagged by a boolean graph node attribute (e.g. a
    CutOutMask / LimitedAreaMask)."""

    def __init__(self, node_attribute_name: str, name: Optional[str] = None) -> None:
        super().__init__(name if name is not None else f"_{node_attribute_name}")
        self.node_attribute_name = node_attribute_name

    def compute_mask(self, graph, nodes_name, lats, lons) -> None:
        attrs = graph[nodes_name].attributes
        if self.node_attribute_name not in attrs:
            raise KeyError(
                f"Spatial mask {self.node_attribute_name!r} not found in graph nodes "
                f"{nodes_name!r}. Available attributes: {sorted(attrs)}"
            )
        vals = np.asarray(attrs[self.node_attribute_name]).reshape(-1)
        n = len(np.asarray(lats))
        if vals.dtype == np.bool_ and len(vals) == n:
            self.focus_mask = vals
        else:  # a list of node indices
            mask = np.zeros(n, dtype=bool)
            mask[vals.astype(np.int64)] = True
            self.focus_mask = mask


class BoundingBoxSpatialMask(SpatialMask):
    """Focus on a (lat_min, lon_min, lat_max, lon_max) degree box."""

    def __init__(self, bbox, name: Optional[str] = None) -> None:
        lat_min, lon_min, lat_max, lon_max = bbox
        if not (lat_min < lat_max and lon_min < lon_max):
            raise ValueError(f"invalid bbox {bbox}: need lat_min<lat_max, lon_min<lon_max")
        super().__init__(
            name if name is not None else f"_bbox_lat-{lat_min}-{lat_max}_lon-{lon_min}-{lon_max}"
        )
        self.bbox = tuple(float(v) for v in bbox)

    def compute_mask(self, graph, nodes_name, lats, lons) -> None:
        lat_min, lon_min, lat_max, lon_max = self.bbox
        lat = np.rad2deg(np.asarray(lats))
        lon = np.rad2deg(np.asarray(lons))
        lon = np.where(lon > 180.0, lon - 360.0, lon)
        self.focus_mask = (
            (lat >= lat_min) & (lat <= lat_max) & (lon >= lon_min) & (lon <= lon_max)
        )


def build_spatial_mask(
    node_attribute_name: Optional[str] = None,
    latlon_bbox=None,
    name: Optional[str] = None,
) -> SpatialMask:
    """Config entry point: node-attribute mask wins, then bbox, else no-op."""
    if node_attribute_name is not None:
        return NodeAttributeSpatialMask(node_attribute_name, name)
    if latlon_bbox is not None:
        return BoundingBoxSpatialMask(latlon_bbox, name)
    return NoOpSpatialMask()


def power_spectra(pred: np.ndarray, truth: np.ndarray, names: Sequence[str],
                  gaussian_n: int, grid_kind: str = "octahedral") -> Optional[Dict[str, np.ndarray]]:
    """Per-degree power spectra of ``pred`` and ``truth`` (``[G, V]``, NaN
    read as 0) through the port's spherical-harmonic transforms
    (``ops/spectral.py``: ``GaussianSHT`` on a ``full`` grid, else
    ``ReducedSHT`` of ``grid_kind``): ``{"<name> pred": ..., "<name>
    truth": ...}``, or None where ``G`` is not the grid's point count."""
    if grid_kind == "full":
        sht = GaussianSHT.create(gaussian_n)
        n_exp = sht.nlat * sht.nlon
    else:
        sht = ReducedSHT.create(gaussian_n, kind=grid_kind)
        n_exp = sht.n_points
    if pred.shape[0] != n_exp:
        LOGGER.warning("PlotSpectrum: grid size %d != %s n=%d (%d points); skipping",
                       pred.shape[0], grid_kind, gaussian_n, n_exp)
        return None
    spectra = {}
    for i, name in enumerate(names):
        for label, field in (("pred", pred[:, i]), ("truth", truth[:, i])):
            f = torch.from_numpy(np.nan_to_num(np.asarray(field, dtype=np.float32)))
            if grid_kind == "full":
                f = f.reshape(sht.nlat, sht.nlon)
            spectra[f"{name} {label}"] = sht.power_spectrum(f).numpy()
    return spectra


def plot_power_spectra(spectra: Dict[str, np.ndarray], title: str = "power spectrum"):
    """Log-log per-degree power spectra, one line per label."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, spec in spectra.items():
        spec = np.asarray(spec)
        ax.loglog(np.arange(1, len(spec) + 1), np.maximum(spec, 1e-20), label=label)
    ax.set_xlabel("wavenumber")
    ax.set_ylabel("power")
    ax.set_title(title, fontsize=9)
    ax.legend(fontsize=6)
    fig.tight_layout()
    return fig


def plot_histograms(
    pred: np.ndarray, truth: np.ndarray, names: Sequence[str], bins: int = 80
):
    """Per-variable predicted-vs-truth histograms."""
    plt = _plt()
    n = len(names)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
    for i, name in enumerate(names):
        ax = axes[0, i]
        t = np.asarray(truth[..., i]).ravel()
        p = np.asarray(pred[..., i]).ravel()
        t, p = t[np.isfinite(t)], p[np.isfinite(p)]
        lo = min(t.min(initial=0.0), p.min(initial=0.0))
        hi = max(t.max(initial=1.0), p.max(initial=1.0))
        ax.hist(t, bins=bins, range=(lo, hi), alpha=0.5, label="truth", density=True)
        ax.hist(p, bins=bins, range=(lo, hi), alpha=0.5, label="pred", density=True)
        ax.set_title(name, fontsize=8)
        ax.set_yscale("log")
        ax.legend(fontsize=6)
    fig.tight_layout()
    return fig


def plot_loss_curve(steps: Sequence[int], losses: Sequence[float],
                    val_steps: Sequence[int] = (), val_losses: Sequence[float] = ()):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(steps, losses, label="train", lw=0.8)
    if len(val_steps):
        ax.plot(val_steps, val_losses, "o-", label="val", ms=3)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    return fig


def save_figure(fig, path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path, dpi=110)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path


# ----------------------------------------------------------------------
# executors
# ----------------------------------------------------------------------
class AsyncPlotExecutor:
    """Render figures on a background thread so the train loop never waits;
    errors are logged, not raised."""

    def __init__(self, max_workers: int = 1) -> None:
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="plot")

    def schedule(self, fn, *args, **kwargs) -> None:
        def run():
            try:
                fn(*args, **kwargs)
            except Exception:
                LOGGER.exception("plot callback failed")

        self._pool.submit(run)

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)


class SyncPlotExecutor:
    def schedule(self, fn, *args, **kwargs) -> None:
        try:
            fn(*args, **kwargs)
        except Exception:
            LOGGER.exception("plot callback failed")

    def shutdown(self, wait: bool = True) -> None:
        pass
