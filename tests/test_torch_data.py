"""The port's data pipeline, graphs I/O and config against the JAX package.

- zarr: stores written by the JAX package's ``save_zarr_dataset`` (raw,
  zlib, blosc-lz4) read bit for bit by the port, and the port's stores read
  bit for bit by the JAX package; the LZ4 decoder's C and Python paths;
  npy and trajectory datasets written by either package read alike;
- synthetic data: ``SyntheticDataset`` windows and statistics exactly equal;
- batch order: the ``DataModule`` anchors and arrays of 2 training epochs
  and of validation exactly equal, with ``ANEMOI_BASE_SEED`` set and unset;
  after the window grows, the port keeps the configured validation
  fraction (the JAX package re-splits at 0.15) and its validation windows
  equal the JAX package's windows at the same anchors;
- graphs: ``Graph.save``/``Graph.load`` in both directions, and
  ``SphericalAreaWeights`` at o8 within rtol 1e-6;
- overrides: a table of override strings parses to the same values under
  the port's parser and the JAX package's ``_parse_value`` (``yaml``);
- config: ``example_o96_gt_config()`` equals the JAX package's composition
  of ``example_o96_gt.yaml`` with the same overrides;
- prefetch: batches arrive in order as tensors; an early close joins the
  worker; a worker's error reaches the consumer.
"""

import math
import os
import threading

import numpy as np
import pytest
import torch

import anemoi_tpu
from anemoi_tpu.data.datamodule import DataModule as JaxDataModule
from anemoi_tpu.data.dataset import ZarrDataset as JaxZarrDataset
from anemoi_tpu.data.dataset import open_dataset as jax_open_dataset
from anemoi_tpu.data.zarr_reader import save_zarr_dataset as jax_save_zarr_dataset
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.graphs.graph import Graph as JaxGraph
from anemoi_tpu.utils.config import _parse_value as jax_parse_value
from anemoi_tpu.utils.config import load_config as jax_load_config
from anemoi_tpu_torch.data import _lz4
from anemoi_tpu_torch.data.datamodule import DataModule, compute_valid_anchors
from anemoi_tpu_torch.data.dataset import ZarrDataset, open_dataset
from anemoi_tpu_torch.data.prefetch import HostToDevice, prefetch_to_device
from anemoi_tpu_torch.data.zarr_reader import save_zarr_dataset
from anemoi_tpu_torch.flagship import EXAMPLE_VARIABLES, example_o96_gt_config
from anemoi_tpu_torch.graphs.create import GraphCreator
from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.utils.config import (
    PACKAGED_CONFIG_DIR,
    _parse_value,
    apply_overrides,
    load_config,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CODECS = {
    "raw": None,
    "zlib": {"id": "zlib", "level": 1},
    "blosc-lz4": {"id": "blosc", "cname": "lz4", "shuffle": 1},
}
SYNTHETIC = {"kind": "synthetic", "nodes": {"name": "ReducedGaussianGridNodes", "grid": "o8"},
             "variables": list(EXAMPLE_VARIABLES), "num_times": 20}


def fields(rng, t=12, v=5, g=544):
    return (rng.normal(size=(t, v, 1, g)) * 10).astype(np.float32)


def store_args(rng):
    lat = rng.uniform(-90, 90, 544)
    lon = rng.uniform(0, 360, 544)
    return fields(rng), [f"v{i}" for i in range(5)], lat, lon


def assert_same_dataset(ours, ref):
    assert ours.variables == ref.variables
    assert ours.missing == ref.missing
    assert ours.timestep_hours == ref.timestep_hours
    np.testing.assert_array_equal(ours.latitudes, ref.latitudes)
    np.testing.assert_array_equal(ours.longitudes, ref.longitudes)
    assert sorted(ours.statistics) == sorted(ref.statistics)
    for k in ref.statistics:
        np.testing.assert_array_equal(ours.statistics[k], ref.statistics[k])
    for start, length in ((0, 12), (3, 4), (11, 1)):
        np.testing.assert_array_equal(ours.get_window(start, length),
                                      ref.get_window(start, length))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_port_reads_jax_zarr_store(tmp_path, rng, codec):
    data, names, lat, lon = store_args(rng)
    path = str(tmp_path / "jax.zarr")
    jax_save_zarr_dataset(path, data, names, lat, lon, missing=[5], compressor=CODECS[codec])
    ours, ref = ZarrDataset(path), JaxZarrDataset(path)
    assert_same_dataset(ours, ref)
    np.testing.assert_array_equal(ours.get_window(0, 12), data.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_jax_reads_port_zarr_store(tmp_path, rng, codec):
    data, names, lat, lon = store_args(rng)
    path = str(tmp_path / "port.zarr")
    save_zarr_dataset(path, data, names, lat, lon, missing=[2, 7], compressor=CODECS[codec])
    ours, ref = open_dataset(path), jax_open_dataset(path)
    assert_same_dataset(ours, ref)
    np.testing.assert_array_equal(ref.get_window(0, 12), data.transpose(0, 2, 3, 1))
    # the bytes of every file are the same as the JAX package's writer's
    jax_path = str(tmp_path / "jax.zarr")
    jax_save_zarr_dataset(jax_path, data, names, lat, lon, missing=[2, 7],
                          compressor=CODECS[codec])
    for root, _, files in os.walk(path):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), path)
            with open(os.path.join(path, rel), "rb") as a, open(os.path.join(jax_path, rel),
                                                                "rb") as b:
                assert a.read() == b.read(), rel


def test_lz4_python_decoder_matches_native(rng):
    raw = np.repeat(rng.integers(0, 7, 3000, dtype=np.uint8), 3).tobytes()
    packed = _lz4.compress(raw)
    assert _lz4._decompress_py(packed, len(raw)) == raw
    before = _lz4.decoded_blocks()
    assert _lz4.decompress(packed, len(raw)) == raw
    after = _lz4.decoded_blocks()
    assert sorted(after) == ["C", "python"]
    assert sum(after.values()) == sum(before.values()) + 1


def test_synthetic_dataset_equal():
    ours, ref = open_dataset(dict(SYNTHETIC)), jax_open_dataset(dict(SYNTHETIC))
    assert ours.variables == ref.variables
    np.testing.assert_array_equal(ours.latitudes, ref.latitudes)
    for stats in ("statistics", "statistics_tendencies"):
        a, b = getattr(ours, stats), getattr(ref, stats)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for start, length in ((0, 3), (7, 6), (14, 6)):
        np.testing.assert_array_equal(ours.get_window(start, length),
                                      ref.get_window(start, length))


@pytest.mark.parametrize("base_seed", [None, "7"])
def test_datamodule_batches_equal(monkeypatch, base_seed):
    if base_seed is None:
        monkeypatch.delenv("ANEMOI_BASE_SEED", raising=False)
    else:
        monkeypatch.setenv("ANEMOI_BASE_SEED", base_seed)
    kw = dict(n_step_input=2, n_step_output=1, rollout=1, batch_size=2, validation_fraction=0.2)
    ours = DataModule({"data": open_dataset(dict(SYNTHETIC))}, **kw)
    ref = JaxDataModule({"data": jax_open_dataset(dict(SYNTHETIC))}, **kw)
    np.testing.assert_array_equal(ours.train_starts, ref.train_starts)
    np.testing.assert_array_equal(ours.val_starts, ref.val_starts)
    for epoch in range(2):
        a = list(ours.train_sampler.epoch_batches(epoch))
        b = list(ref.train_sampler.epoch_batches(epoch))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(ours.train_batches(epoch), ref.train_batches(epoch)):
            np.testing.assert_array_equal(x["data"], y["data"])
    ours.set_rollout(2)
    ref.set_rollout(2)
    anchors = compute_valid_anchors(ours.datasets, 4)
    n_val = max(1, int(len(anchors) * kw["validation_fraction"]))
    np.testing.assert_array_equal(ours.train_starts, anchors[:-n_val])
    np.testing.assert_array_equal(ours.val_starts, anchors[-n_val:])
    vals = list(zip(ours.val_sampler.epoch_batches(0), ours.val_batches()))
    assert vals
    for idx, x in vals:
        assert x["data"].shape[1] == 4
        np.testing.assert_array_equal(x["data"], ref.make_batch(idx)["data"])


RECIPE = example_o96_gt_config(grid="o8", mesh_resolution=1)["graph"]["recipe"]


def assert_same_graph(a, b):
    assert list(a.nodes) == list(b.nodes)
    for name in b.nodes:
        np.testing.assert_array_equal(a.nodes[name].coords, b.nodes[name].coords)
        assert sorted(a.nodes[name].attributes) == sorted(b.nodes[name].attributes)
        for k, v in b.nodes[name].attributes.items():
            np.testing.assert_array_equal(a.nodes[name].attributes[k], v)
    assert list(a.edges) == list(b.edges)
    for key, es in b.edges.items():
        np.testing.assert_array_equal(a.edges[key].edge_index, es.edge_index)
        np.testing.assert_array_equal(a.edges[key].dst_ptr, es.dst_ptr)
        for k, v in es.attributes.items():
            np.testing.assert_array_equal(a.edges[key].attributes[k], v)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_save_load_across_packages(tmp_path, writer):
    path = str(tmp_path / "graph.npz")
    if writer == "jax":
        written = JaxGraphCreator(RECIPE).create(path)
        loaded = Graph.load(path)
    else:
        written = GraphCreator(RECIPE).create(path)
        loaded = JaxGraph.load(path)
    assert os.path.exists(path)
    assert_same_graph(loaded, written)
    # create(save_path) loads the file when it exists
    again = (GraphCreator if writer == "port" else JaxGraphCreator)(RECIPE).create(path)
    assert_same_graph(again, written)


def test_spherical_area_weights_match():
    ours = GraphCreator(RECIPE).create()
    ref = JaxGraphCreator(RECIPE).create()
    a = ours["data"].attributes["area_weight"]
    b = ref["data"].attributes["area_weight"]
    assert a.shape == b.shape == (ref["data"].num_nodes, 1)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    assert float(a.max()) == 1.0 and float(a.min()) > 0


# the forms an override uses: ints, floats (also 1e-3), YAML 1.1's booleans
# and nulls, flow lists and maps, quoted strings; other text stays a string
OVERRIDES = [
    "1", "-3", "+4", "0", "1e-3", "1E5", "+1e3", "1.5e3", "-2.5e-3", "1.5",
    ".5", "1.", "2.5e-4", "6.25e-5", "1.0e+3", "-0.5", ".inf", "-.inf", ".nan", "inf", "nan",
    "true", "True", "TRUE", "false", "yes", "no", "on", "Off", "y", "n", "null", "~", "", "Null",
    "[]", "{}", "[ ]", "{ }", "[a, b]", "[1, 2.5, true]", "[o8, 'x y']", "[1, [2, 3]]", "[a, b,]",
    "{a: 1, b: [c, d]}", "{a: {b: c}}", "[null, ~]", "[1e-3, 2]", "{lr: 1e-3}", "'quoted'",
    '"dq"', "'it''s'", '"a\\"b"', "'1'", '"true"',
    "abc", "o96", "cpu", "bf16", "16-mixed", "runs/o96", "/tmp/x.zarr", "hello world",
    "x#y", "[unclosed", "1,2",
]


@pytest.mark.parametrize("text", OVERRIDES)
def test_override_values_parse_as_in_jax(text):
    want, got = jax_parse_value(text), _parse_value(text)
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
        return
    assert got == want and type(got) is type(want), (got, want)


def test_overrides_and_json_config(tmp_path):
    import json

    cfg = {"a": {"b": 1}, "c": [1]}
    apply_overrides(cfg, ["a.b=2.5", "a.d.e=[x, 1]", "c=null"])
    assert cfg == {"a": {"b": 2.5, "d": {"e": ["x", 1]}}, "c": None}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"model": {"num_channels": 8}}))
    loaded = load_config(str(path), ["model.num_channels=16", "training.precision=bf16"])
    assert loaded.model.num_channels == 16 and loaded.to_dict()["training"] == {"precision": "bf16"}
    # a dict's defaults compose from the search paths
    with pytest.raises(FileNotFoundError, match="model/x.yaml"):
        load_config({"defaults": ["model/x"]})
    composed = load_config({"defaults": [{"model": "graphtransformer"}], "model": {"x": 1}},
                           search_paths=[PACKAGED_CONFIG_DIR])
    assert composed.model.x == 1 and composed.model.processor.name == "GraphTransformerProcessor"
    for text in ("2024-01-01", "0x1f", "1:30", "a: b"):  # beyond the override forms
        assert _parse_value(text) == text


def test_example_config_equals_jax_composition():
    root = os.path.join(os.path.dirname(anemoi_tpu.__file__), "config")
    ref = jax_load_config(
        os.path.join(root, "example_o96_gt.yaml"),
        overrides=["model.num_channels=512", "model.processor.num_layers=16",
                   "training.precision=bf16"],
        search_paths=[root],
    ).to_dict()
    assert example_o96_gt_config() == ref


def test_prefetch_yields_tensors_in_order_and_joins():
    batches = ({"data": np.full((1, 2), i, np.float32)} for i in range(10))
    put = HostToDevice("cpu")
    it = prefetch_to_device(batches, put, size=2)
    first = [next(it)["data"] for _ in range(3)]
    assert all(isinstance(t, torch.Tensor) for t in first)
    assert [float(t[0, 0]) for t in first] == [0.0, 1.0, 2.0]
    it.close()  # early close: the worker stops and is joined
    assert not any(t.name == "batch-prefetch" for t in threading.enumerate())


def test_prefetch_surfaces_worker_errors():
    def bad():
        yield {"data": np.zeros(2, np.float32)}
        raise OSError("chunk unreadable")

    it = prefetch_to_device(bad(), HostToDevice("cpu"), size=1)
    next(it)
    with pytest.raises(OSError, match="chunk unreadable"):
        next(it)


@pytest.mark.parametrize("kind", ["npy", "trajectory"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npy_and_trajectory_datasets_across_packages(tmp_path, rng, kind, writer):
    import anemoi_tpu.data.dataset as jax_ds
    import anemoi_tpu_torch.data.dataset as port_ds

    lat, lon = rng.uniform(-90, 90, 30), rng.uniform(0, 360, 30)
    names = ["a", "b_500", "c"]
    mod = jax_ds if writer == "jax" else port_ds
    path = str(tmp_path / kind)
    if kind == "npy":
        data = rng.normal(size=(10, 3, 1, 30)).astype(np.float32)
        mod.save_dataset(path, data, names, lat, lon, missing=[4])
    else:
        data = rng.normal(size=(4, 3, 1, 6, 30)).astype(np.float32)
        mod.save_trajectory_dataset(path, data, names, lat, lon, missing_bases=[2])
    cfg = {"kind": kind, "path": path}
    ours, ref = port_ds.open_dataset(dict(cfg)), jax_ds.open_dataset(dict(cfg))
    assert ours.variables == ref.variables == names
    np.testing.assert_array_equal(ours.compute_anchors(np.arange(3)),
                                  ref.compute_anchors(np.arange(3)))
    for k in ref.statistics:
        np.testing.assert_array_equal(ours.statistics[k], ref.statistics[k])
    np.testing.assert_array_equal(ours.get_seq_window(1, 2, 3), ref.get_seq_window(1, 2, 3))


def test_zarr_copy_of_synthetic_reads_back(tmp_path):
    """``save_zarr_copy`` of the synthetic dataset: the port and the JAX
    package read its windows equal to the synthetic fields."""
    from anemoi_tpu_torch.data.dataset import save_zarr_copy

    ds = open_dataset(dict(SYNTHETIC))
    path = str(tmp_path / "copy.zarr")
    save_zarr_copy(ds, path, times_per_read=3)
    ours, ref = ZarrDataset(path), JaxZarrDataset(path)
    assert ours.variables == ref.variables == ds.variables
    np.testing.assert_allclose(ours.latitudes, ds.latitudes, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ours.get_window(0, len(ds)), ds.get_window(0, len(ds)))
    np.testing.assert_array_equal(ref.get_window(5, 7), ds.get_window(5, 7))
