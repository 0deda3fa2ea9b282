"""The port's plotting diagnostics against the JAX package's.

On an o16 grid (o16 -> ico-1 graph built by the JAX package, loaded by
both): the focus-area masks (no-op, lat/lon box, node attribute) select the
same nodes; the colormaps are the same; the power spectra of seeded fields
through the port's ``ReducedSHT`` equal JAX's within rtol 1e-4 (float32
transforms, sums in another order); the histograms draw the same bars.
Then the tiny example trainer of both packages with the six plot
callbacks (drawn inline) writes the same figure files.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from anemoi_tpu.training import plots as jax_plots
from anemoi_tpu_torch.training import plots
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
    from anemoi_tpu.graphs.graph import Graph as JaxGraph
    from anemoi_tpu_torch.flagship import flagship_recipe
    from anemoi_tpu_torch.graphs.graph import Graph

    path = str(tmp_path_factory.mktemp("graph") / "graph.npz")
    JaxGraphCreator(flagship_recipe("o16", 1)).create(path)
    jax_graph, graph = JaxGraph.load(path), Graph.load(path)
    roi = np.zeros(graph["data"].num_nodes, dtype=bool)
    roi[::7] = True
    jax_graph["data"].attributes["roi"] = roi
    graph["data"].attributes["roi"] = roi.copy()
    return jax_graph, graph


@pytest.mark.parametrize("kwargs", [{}, {"latlon_bbox": (0.0, -180.0, 90.0, 180.0)},
                                    {"latlon_bbox": (-30.0, 10.0, 40.0, 120.0), "name": "box"},
                                    {"node_attribute_name": "roi"}])
def test_spatial_masks_match_jax(graphs, kwargs):
    jax_graph, graph = graphs
    coords = graph["data"].coords
    field = np.random.default_rng(0).normal(size=(2, len(coords), 3)).astype(np.float32)
    ref_mask = jax_plots.build_spatial_mask(**kwargs)
    ref = ref_mask.apply(jax_graph, "data", coords[:, 0], coords[:, 1], field)
    mask = plots.build_spatial_mask(**kwargs)
    ours = mask.apply(graph, "data", coords[:, 0], coords[:, 1], field)
    assert mask.tag == ref_mask.tag
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    if kwargs:
        assert 0 < len(ours[0]) < len(coords)
    with pytest.raises(KeyError):
        plots.build_spatial_mask(node_attribute_name="nope").apply(
            graph, "data", coords[:, 0], coords[:, 1], field)
    with pytest.raises(ValueError):
        plots.build_spatial_mask(latlon_bbox=(50.0, 0.0, 10.0, 20.0))


def test_colormaps_match_jax():
    configs = [{"name": "RdBu_r", "variables": ["t_850", "t_500"]},
               {"clevels": ["#ffffff", "#88ccee", "#332288"], "variables": ["tp"]}]
    ref, ours = jax_plots.build_colormaps(configs), plots.build_colormaps(configs)
    assert sorted(ours) == sorted(ref) == ["t_500", "t_850", "tp"]
    x = np.linspace(0.0, 1.0, 7)
    for name in ref:
        assert (ours[name].name, ours[name].N) == (ref[name].name, ref[name].N)
        np.testing.assert_array_equal(ours[name](x), ref[name](x))
    assert plots.build_colormaps(None) == {}


def test_power_spectra_match_jax(graphs):
    from anemoi_tpu.ops.spectral import ReducedSHT as JaxReducedSHT

    _, graph = graphs
    n = graph["data"].num_nodes
    rng = np.random.default_rng(1)
    pred, truth = (rng.normal(size=(n, 2)).astype(np.float32) for _ in range(2))
    truth[3, 1] = np.nan  # read as 0, as JAX's callback reads it
    ours = plots.power_spectra(pred, truth, ["q", "t"], 16, "octahedral")
    sht = JaxReducedSHT.create(16, kind="octahedral")
    for i, name in enumerate(["q", "t"]):
        for label, field in (("pred", pred[:, i]), ("truth", truth[:, i])):
            ref = np.asarray(sht.power_spectrum(jnp.nan_to_num(jnp.asarray(field))))
            np.testing.assert_allclose(ours[f"{name} {label}"], ref, rtol=1e-4,
                                       atol=1e-6 * ref.max())
    assert plots.power_spectra(pred[:10], truth[:10], ["q", "t"], 16) is None  # not the grid


def test_histograms_and_maps_match_jax(graphs, tmp_path):
    _, graph = graphs
    coords = graph["data"].coords
    rng = np.random.default_rng(2)
    pred, truth = (rng.normal(size=(len(coords), 3)).astype(np.float32) for _ in range(2))
    figs = {}
    for label, mod in (("jax", jax_plots), ("port", plots)):
        hist = mod.plot_histograms(pred, truth, ["a", "b", "c"])
        figs[label] = [[p.get_height() for p in ax.patches] for ax in hist.axes]
        maps = mod.plot_sample_maps(coords[:, 0], coords[:, 1], pred[:, :1], truth[:, :1], ["a"])
        figs[label].append([ax.get_title() for ax in maps.axes])
        ens = mod.plot_ensemble_maps(coords[:, 0], coords[:, 1], pred.T, truth[:, 0], "a")
        figs[label].append([ax.get_title() for ax in ens.axes])
        mod.save_figure(hist, str(tmp_path / label / "hist.png"))
        for fig in (maps, ens):
            mod._plt().close(fig)
    assert figs["port"] == figs["jax"]
    assert os.path.getsize(tmp_path / "port" / "hist.png") > 0


CALLBACKS = [{"name": "PlotSample", "async_plots": False, "max_vars": 2},
             {"name": "PlotEnsembleSample", "async_plots": False},
             {"name": "PlotSpectrum", "async_plots": False, "gaussian_n": 8, "max_vars": 2},
             {"name": "PlotHistogram", "async_plots": False,
              "focus_area": {"latlon_bbox": [0.0, -180.0, 90.0, 180.0]}},
             {"name": "GraphTrainableFeaturesPlot", "async_plots": False},
             {"name": "LossCurvePlot", "async_plots": False}]


def test_plot_callbacks_write_the_jax_figures(tmp_path):
    from anemoi_tpu.training.trainer import AnemoiTrainer as JaxTrainer
    from anemoi_tpu_torch.training.trainer import AnemoiTrainer
    from tests.test_torch_trainer import tiny_config

    files = {}
    for label, cls in (("jax", JaxTrainer), ("port", AnemoiTrainer)):
        cfg = tiny_config(tmp_path, label, max_steps=1)
        cfg["diagnostics"]["callbacks"] = [dict(c) for c in CALLBACKS]
        trainer = cls(cfg, output_dir=cfg["output_dir"])
        trainer.train()
        plot_dir = tmp_path / label / "plots"
        files[label] = sorted(os.listdir(plot_dir))
        assert all(os.path.getsize(plot_dir / f) > 0 for f in files[label])
    assert files["port"] == files["jax"]
    assert {f.split("_step")[0] for f in files["port"]} == {
        "sample", "spectrum", "histogram_bbox_lat-0.0-90.0_lon--180.0-180.0", "node_features",
        "loss_curve"}
