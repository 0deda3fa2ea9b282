"""The port's parallel building blocks on the CPU, against the JAX package.

- ``parallel/partition.py`` and the halo tables of ``parallel/halo.py``
  (``shard_tables``, ``shard_split_tables``, ``interior_boundary_rows``)
  equal JAX's element for element, at 2 and 4 shards, for the processor set
  and both bipartite mapper sets of the ``tests/test_model_parallel.py``
  graph; the flagship's partition (o96 -> ico-5) has the sizes recorded in
  PERF.md.
- ``parallel/mesh.py``: the mesh factorisation, the rank layout and ZeRO's
  rule as JAX's ``MeshSpec``, ``create_mesh`` and ``zero_sharding``.
- ``halo_gt_attention`` with the fused edge projection on 2 and 4 CPU ranks
  (gloo; one spawn of 4 ranks, ``tests/torch_parallel_worker.py``), with
  ``halo_overlap`` on and off: its output and the gradients of q, k, v, the
  edge attributes and the projection's weight and bias against JAX's halo
  attention on the conftest's virtual devices and against the single-device
  op, fp32, rtol/atol 3e-5.
- The strategies the port once refused (ROADMAP item 9) and now runs: each
  builds a model-parallel interface and takes its route; worlds that fail:
  a world whose rank fails, or that never completes, raises, and no rank
  carries on alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.parallel import halo as jax_halo
from anemoi_tpu.parallel import mesh as jax_mesh
from anemoi_tpu.parallel.partition import partition_graph as jax_partition_graph
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.flagship import flagship_recipe
from anemoi_tpu_torch.graphs.create import GraphCreator
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.ops.gt_attention import gt_attention_fe
from anemoi_tpu_torch.parallel import halo, mesh
from anemoi_tpu_torch.parallel.distributed import free_port, spawn
from anemoi_tpu_torch.parallel.partition import partition_graph
from anemoi_tpu_torch.training.trainer import trainer_device
from tests import torch_parallel_worker as worker
from tests.test_model_parallel import _recipe
from tests.test_torch_training import port_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SETS = {"processor": ("hidden", "hidden"), "encoder": ("data", "hidden"),
        "decoder": ("hidden", "data")}
H, D, F = 4, 4, 3


@pytest.fixture(scope="module")
def graph():
    return JaxGraphCreator(_recipe()).create()


def partitioned(graph, part, shards, partition):
    es = graph[SETS[part]]
    ns, nd = graph[SETS[part][0]].num_nodes, graph[SETS[part][1]].num_nodes
    return partition(es.edge_index.astype(np.int64), es.dst_ptr.astype(np.int64), nd, shards,
                     num_src_nodes=ns if ns != nd else None)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("part", list(SETS))
def test_tables_equal_jax(graph, part, shards):
    ref = partitioned(graph, part, shards, jax_partition_graph)
    sg = partitioned(graph, part, shards, partition_graph)
    for field in ref.__dataclass_fields__:
        want, got = np.asarray(getattr(ref, field)), np.asarray(getattr(sg, field))
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    n_ext = sg.n_local_src + shards * sg.h_pair
    want = {**jax_halo.shard_tables(ref, n_ext), **jax_halo.shard_split_tables(ref, n_ext)}
    got = {**halo.shard_tables(sg), **halo.shard_split_tables(sg)}
    # the TPU's source-transpose tables are the one part with no counterpart
    assert sorted(set(want) - set(got)) == sorted(
        p + k for p in ("", "int_", "bnd_") for k in ("src_gather_mask", "src_gather_slots"))
    for key, table in got.items():
        ref_table = np.asarray(want[key])
        assert table.dtype == ref_table.dtype and np.array_equal(table, ref_table), key
    for ours, theirs in zip(halo.interior_boundary_rows(sg), jax_halo.interior_boundary_rows(ref)):
        assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))


def test_flagship_partition_sizes():
    """o96 -> ico-5 (the flagship): the per-shard sizes the chip runs,
    per set and model group size: (dst rows a shard, src rows a shard,
    h_pair, edges a shard, halo rows received, boundary dst rows)."""
    g = GraphCreator(flagship_recipe("o96", 5)).create()
    want = {
        ("encoder", 2): (5128, 20160, 10616, [32808, 30172], [10612, 9773], [2611, 2581]),
        ("encoder", 4): (2568, 10080, 5016, [16453, 16397, 15750, 14380],
                         [9687, 5728, 7681, 3109], [2320, 1484, 2012, 831]),
        ("processor", 2): (5128, 5128, 400, [40998, 40902], [398, 400], [400, 398]),
        ("processor", 4): (2568, 2568, 168, [20496, 20568, 20508, 20328],
                           [395, 362, 279, 383], [347, 326, 265, 335]),
        ("decoder", 2): (20160, 5128, 2672, [60480, 60480], [2589, 2667], [9937, 10783]),
        ("decoder", 4): (10080, 2568, 1256, [30240] * 4, [2572, 1361, 1961, 1160],
                         [9178, 5305, 7629, 4144]),
    }
    for (part, s), sizes in want.items():
        sg = partitioned(g, part, s, partition_graph)
        received = [int(sg.send_mask[:, r].sum()) for r in range(s)]
        boundary = [len(b) for b in halo.interior_boundary_rows(sg)[1]]
        got = (sg.n_local, sg.n_local_src, sg.h_pair, sg.edge_pad_mask.sum(1).tolist(),
               received, boundary)
        assert got == sizes, (part, s)
    # the hidden mesh pads 10 242 rows to 2 x 5 128: the last shard's 14 rows have no edge
    proc = partitioned(g, "processor", 2, partition_graph)
    assert int((~proc.mask[1].any(1)).sum()) == 14


def test_mesh_layout_matches_jax():
    for hw, n in (({"num_devices_per_model": 2}, 4), ({}, 2), ({"num_devices_per_model": 4}, 4),
                  ({"num_devices_per_model": 2, "num_devices_per_ensemble": 2}, 8)):
        spec = mesh.MeshSpec.from_config(hw, num_devices=n)
        ref = jax_mesh.MeshSpec.from_config(hw, num_devices=n)
        assert (spec.data, spec.model, spec.ensemble) == (ref.data, ref.model, ref.ensemble)
        layout = np.arange(spec.world).reshape(spec.data, spec.model, spec.ensemble)
        for rank in range(spec.world):
            assert layout[mesh.mesh_coords(rank, spec)] == rank
        for axis in mesh.AXES:
            k = mesh.AXES.index(axis)
            want = sorted(np.moveaxis(layout, k, -1).reshape(-1, layout.shape[k]).tolist())
            assert sorted(mesh.axis_lines(spec, axis)) == want
    with pytest.raises(AssertionError, match="not divisible by model"):
        mesh.MeshSpec.from_config({"num_devices_per_model": 3}, num_devices=4)
    # ZeRO's rule, against the JAX sharding it picks on a data axis of 2
    jm = jax_mesh.create_mesh(jax_mesh.MeshSpec(data=2, model=1), jax.devices()[:2])
    shapes = [(4, 3), (3, 4), (6,), (), (0, 2), (2,)]
    specs = jax_mesh.zero_sharding(jm, [jnp.zeros(s) for s in shapes])
    for shape, spec in zip(shapes, specs):
        assert mesh.zero_sharding(shape, 2) == (not spec.is_fully_replicated), shape
    # the batch layout: batch rows over data, grid blocks of partition_graph over model
    layout = mesh.BatchSharding(data_size=2, data_index=1, model_size=4, model_index=3,
                                shard_grid=True)
    assert layout.slices((4, 3, 1, 42, 5))[0] == slice(2, 4)
    assert layout.slices((4, 3, 1, 42, 5))[3] == slice(42, 42)  # a block with no real rows
    assert mesh.grid_block(544, 4, 1) == slice(136, 272)


def test_datamodule_shards_and_local_plan_match_jax():
    """Anchor striding (``shard_index``/``num_shards``) and a rank's
    ``local_plan`` (its batch rows and grid block) read what JAX's
    ``DataModule`` reads."""
    from anemoi_tpu.data.datamodule import DataModule as JaxDataModule
    from anemoi_tpu.data.dataset import open_dataset as jax_open_dataset
    from anemoi_tpu_torch.data.datamodule import DataModule
    from anemoi_tpu_torch.data.dataset import open_dataset
    from tests.test_torch_data import SYNTHETIC

    kw = dict(n_step_input=2, n_step_output=1, rollout=1, batch_size=2, validation_fraction=0.2)
    plan = {"data": (slice(1, 2), mesh.grid_block(544, 4, 1))}
    for shard in (0, 1):
        ours = DataModule({"data": open_dataset(dict(SYNTHETIC))}, shard_index=shard,
                          num_shards=2, **kw)
        ref = JaxDataModule({"data": jax_open_dataset(dict(SYNTHETIC))}, shard_index=shard,
                            num_shards=2, **kw)
        a, b = list(ours.train_sampler.epoch_batches(1)), list(ref.train_sampler.epoch_batches(1))
        assert len(a) == len(b) == len(ours.train_sampler) > 0
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        ours.local_plan, ref.local_plan = plan, plan
        got, want = ours.make_batch(a[0])["data"], ref.make_batch(b[0])["data"]
        assert got.shape == (1, 3, 1, 136, want.shape[-1])
        np.testing.assert_array_equal(got, want)


def attention_case(graph, part, shards, overlap, rng):
    es = graph[SETS[part]]
    ns, nd = graph[SETS[part][0]].num_nodes, graph[SETS[part][1]].num_nodes
    hd = H * D
    return {
        "part": part, "S": shards, "overlap": overlap, "heads": H,
        "edge_index": es.edge_index.astype(np.int32), "dst_ptr": es.dst_ptr.astype(np.int32),
        "num_src": ns, "num_dst": nd,
        "attr": rng.normal(size=(es.num_edges, F)).astype(np.float32),
        "weight": (0.5 * rng.normal(size=(F, hd))).astype(np.float32),
        "bias": (0.5 * rng.normal(size=hd)).astype(np.float32),
        "q": rng.normal(size=(2, nd, hd)).astype(np.float32),
        "k": rng.normal(size=(2, ns, hd)).astype(np.float32),
        "v": rng.normal(size=(2, ns, hd)).astype(np.float32),
        "cotangent": rng.normal(size=(2, nd, hd)).astype(np.float32),
    }


CASES = [(part, s, overlap) for s in (2, 4) for part in SETS for overlap in (True, False)]


@pytest.fixture(scope="module")
def halo_runs(graph):
    rng = np.random.default_rng(0)
    inputs = {(part, s): attention_case(graph, part, s, True, rng)
              for part in SETS for s in (2, 4)}
    cases = [{**inputs[(part, s)], "overlap": overlap} for part, s, overlap in CASES]
    results = spawn(worker.halo_attention, 4, args=(cases,), platform="cpu", threads=1)
    return inputs, {key: [r[i] for r in results] for i, key in enumerate(CASES)}


def jax_halo_attention(graph, case):
    """JAX's halo attention (padded tables, no overlap split: JAX's
    ``tests/test_halo.py`` holds the split to it) on ``S`` virtual devices,
    with the edge projection in the differentiated function."""
    s = case["S"]
    sg = partitioned(graph, case["part"], s, jax_partition_graph)
    tables = jax_halo.shard_tables(sg, sg.n_local_src + s * sg.h_pair)
    nd, ns = case["num_dst"], case["num_src"]

    def pad(x, rows):
        return jnp.pad(jnp.asarray(x), ((0, 0), (0, rows - x.shape[1]), (0, 0)))

    perm = jnp.asarray(sg.edge_attr_perm)
    cot = pad(case["cotangent"], s * sg.n_local)  # zero on the padded rows

    def loss(q, k, v, attr, w, b):
        e_pad = jnp.concatenate([attr, jnp.zeros((1, attr.shape[1]), attr.dtype)], 0)[perm]
        out = jax_halo.halo_gt_attention(q, k, v, e_pad @ w + b, tables, H)
        return jnp.sum(out * cot), out

    mesh_ = Mesh(np.asarray(jax.devices()[:s]), axis_names=("model",))
    args = [pad(case["q"], s * sg.n_local), pad(case["k"], s * sg.n_local_src),
            pad(case["v"], s * sg.n_local_src),
            *(jnp.asarray(case[k]) for k in ("attr", "weight", "bias"))]
    with jax.set_mesh(mesh_):
        grads, out = jax.jit(jax.grad(loss, argnums=tuple(range(6)), has_aux=True))(*args)
    grads = [np.asarray(g) for g in grads]
    rows = (nd, ns, ns)
    return {"out": np.asarray(out)[:, :nd],
            **{n: g[:, : rows[i]] if i < 3 else g
               for i, (n, g) in enumerate(zip(("dq", "dk", "dv", "d_attr", "d_weight", "d_bias"),
                                              grads))}}


def single_device(case):
    leaf = {k: torch.tensor(case[k], requires_grad=True)
            for k in ("q", "k", "v", "attr", "weight", "bias")}
    out, _ = gt_attention_fe(leaf["q"], leaf["k"], leaf["v"], leaf["attr"], leaf["weight"],
                             leaf["bias"], torch.as_tensor(case["edge_index"]),
                             torch.as_tensor(case["dst_ptr"]), H)
    (out * torch.as_tensor(case["cotangent"])).sum().backward()
    names = {"q": "dq", "k": "dk", "v": "dv", "attr": "d_attr", "weight": "d_weight",
             "bias": "d_bias"}
    return {"out": out.detach().numpy(), **{names[k]: t.grad.numpy() for k, t in leaf.items()}}


def assembled(per_rank):
    """The whole sets from one model group's ranks (data index 0)."""
    group = [r for r in per_rank if r["data_index"] == 0]
    rows = {"out": "dst", "dq": "dst", "dk": "src", "dv": "src"}
    out = {k: np.concatenate([r[k] for r in sorted(group, key=lambda r: r[v])], axis=1)
           for k, v in rows.items()}
    out.update({k: sum(r[k] for r in group) for k in ("d_attr", "d_weight", "d_bias")})
    return out


@pytest.fixture(scope="module")
def jax_refs(graph, halo_runs):
    inputs = halo_runs[0]
    return {key: jax_halo_attention(graph, case) for key, case in inputs.items()}


@pytest.mark.parametrize("part,shards,overlap", CASES,
                         ids=[f"{p}-S{s}-{'overlap' if o else 'plain'}" for p, s, o in CASES])
def test_halo_attention_matches_jax(halo_runs, jax_refs, part, shards, overlap):
    inputs, runs = halo_runs
    got = assembled(runs[(part, shards, overlap)])
    for label, ref in (("jax", jax_refs[(part, shards)]),
                       ("single device", single_device(inputs[(part, shards)]))):
        for key, want in ref.items():
            np.testing.assert_allclose(got[key], want, rtol=3e-5, atol=3e-5,
                                       err_msg=f"{key} against {label}")


def tiny_interface(model_update, graph):
    """A tiny training interface; with ``num_model_shards`` in the update,
    its shares of a model group of that size are built for rank 0 (a mesh
    without process groups: the tables, not the collectives)."""
    from tests.test_torch_parallel_training import model_config

    cfg = model_config()
    cfg["model"].update(model_update)
    nv = 5
    stats = {"data": {k: np.ones(nv, np.float32) for k in ("mean", "stdev", "minimum",
                                                           "maximum")}}
    shards = int(model_update.get("num_model_shards", 1))
    return AnemoiModelInterface(
        config=cfg, graph=port_graph(graph),
        data_indices={"data": IndexCollection({n: i for i, n in enumerate("qtuzc")},
                                              forcing=["c"])},
        statistics=stats, device="cpu", training=True,
        mesh=mesh.Mesh(mesh.MeshSpec(model=shards)) if shards > 1 else None)


@pytest.mark.parametrize("update,want", [
    # a GNN processor has no heads to split: under heads it keeps the halo
    ({"shard_strategy": "heads", "num_model_shards": 2,
      "processor": {"name": "GNNProcessor", "num_layers": 1}},
     {"processor": "HaloShard", "encoder/data": "HaloShard"}),
    ({"shard_strategy": "edges", "num_model_shards": 2,
      "processor": {"name": "GNNProcessor", "num_layers": 1}}, {"processor": "HaloShard"}),
    # halo_mappers false: the GraphTransformer mappers on the halo route still
    ({"shard_strategy": "edges", "num_model_shards": 2, "halo_mappers": False},
     {"encoder/data": "HaloShard", "decoder/data": "HaloShard"}),
], ids=["heads", "gnn_processor_under_edges", "no_halo_mappers"])
def test_not_ported_strategies_name_item_9(graph, update, want):
    """Once refused naming ROADMAP item 9; each now builds its route (the
    runs: ``tests/test_torch_parallel_routes.py``)."""
    routes = worker.routes(tiny_interface(update, graph).model)
    assert {k: routes[k] for k in want} == want


def test_ensemble_axis_names_item_9():
    # the ensemble axis is ported (tests/test_torch_parallel_families.py):
    # the device rule no longer refuses it
    assert trainer_device({"platform": "cpu", "num_devices_per_ensemble": 2}) == torch.device(
        "cpu")
    spec = mesh.MeshSpec.from_config({"num_devices_per_model": 2,
                                      "num_devices_per_ensemble": 2}, num_devices=4)
    assert (spec.data, spec.model, spec.ensemble) == (1, 2, 2)
    assert mesh.axis_lines(spec, "ensemble") == [[0, 1], [2, 3]]


def test_failed_rank_stops_the_world():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn(worker.fail_on_rank_one, 2, platform="cpu", threads=1, timeout_s=120)


def test_world_that_never_completes_raises():
    with pytest.raises(RuntimeError, match="did not start"):
        spawn(worker.lonely_rank, 1, args=(free_port(),), platform="cpu", threads=1,
              timeout_s=120)
