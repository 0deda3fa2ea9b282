"""Limited-area and stretched-grid pieces of the port against the JAX package.

- The graph pieces: ``AreaMask``, ``CutOutMask``, ``BooleanOp``,
  ``LimitedAreaTriNodes`` and ``StretchedTriNodes`` (node sets equal to
  1e-12 rad, masks equal), ``LimitedAreaTriNodes`` both against a global
  grid and against a regional one, where it drops nodes; the packaged
  ``limited_area`` and ``stretched_grid`` recipes at small size, edge sets
  equal per destination except where a KNN tie is broken differently (each
  such tie checked to be a true tie, as ``tests/test_torch_graphs.py``
  does; the edge attributes of tie-free sets equal to 1e-6).
- ``advance_input`` with a boundary mask, bit for bit.
- ``make_step_fns(output_masks=...)`` on the tiny flagship of
  ``tests/test_torch_training.py`` with the trainer's ``output_mask`` loss
  scaler, at rollout 1 and at rollout 2 under rollout remat: the loss and
  every gradient within 3e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import anemoi_tpu
from anemoi_tpu.graphs import nodes as jax_nodes
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.graphs.graph import Graph as JaxGraph
from anemoi_tpu.graphs.graph import NodeSet as JaxNodeSet
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.losses.scalers import create_scalers as jax_create_scalers
from anemoi_tpu.training.masks import Boolean1DMask as JaxBoolean1DMask
from anemoi_tpu.training.step import TrainState as JaxTrainState
from anemoi_tpu.training.step import _index_arrays as jax_index_arrays
from anemoi_tpu.training.step import advance_input as jax_advance_input
from anemoi_tpu.training.step import make_step_fns as jax_make_step_fns
from anemoi_tpu.utils.config import load_config as jax_load_config
from anemoi_tpu_torch.flagship import flagship_indices
from anemoi_tpu_torch.graphs import nodes
from anemoi_tpu_torch.graphs.create import GraphCreator
from anemoi_tpu_torch.graphs.graph import Graph, NodeSet
from anemoi_tpu_torch.graphs.transforms import latlon_rad_to_xyz
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.masks import Boolean1DMask, NoOutputMask, build_output_masks
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.step import TrainState, _index_arrays, advance_input, make_step_fns
from test_torch_remat import RTOL, batch_of, port_iface
from test_torch_training import LOSS, OPT, SCALERS, config, grad_store, tiny  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

JAX_CONFIG_DIR = os.path.join(os.path.dirname(anemoi_tpu.__file__), "config")
BOX = {"lat_min": 30.0, "lat_max": 70.0, "lon_min": -30.0, "lon_max": 40.0}


def both_graphs(coords: dict):
    """A JAX graph and a port graph holding the same node sets."""
    g_jax, g_port = JaxGraph(), Graph()
    for name, c in coords.items():
        g_jax[name] = JaxNodeSet(coords=c)
        g_port[name] = NodeSet(coords=c)
    return g_jax, g_port


def o16_with_region():
    """The o16 grid, and its points inside ``BOX`` as a regional node set."""
    grid = nodes.reduced_gaussian_nodes("o16")
    lat, lon = np.rad2deg(grid).T
    inside = ((lat >= BOX["lat_min"]) & (lat <= BOX["lat_max"]) & (lon >= BOX["lon_min"])
              & (lon <= BOX["lon_max"]))
    return grid, grid[inside]


def test_mask_attributes_match_jax():
    grid, region = o16_with_region()
    g_jax, g_port = both_graphs({"data": grid, "lam": region})
    cases = [
        ("AreaMask", {"name": "AreaMask", **BOX}),
        ("CutOutMask", {"name": "CutOutMask", "reference_node_name": "lam"}),
        ("CutOutMask_far", {"name": "CutOutMask", "reference_node_name": "lam",
                            "min_distance_km": 900.0}),
    ]
    for attr, cfg in cases:
        ref = jax_nodes.build_node_attribute(g_jax, "data", dict(cfg))
        ours = nodes.build_node_attribute(g_port, "data", dict(cfg))
        assert ours.dtype == bool and ours.shape == (len(grid), 1)
        np.testing.assert_array_equal(ours, ref, err_msg=attr)
        assert 0 < ours.sum() < len(grid), attr  # the masks split the grid
        g_jax["data"].attributes[attr] = ref
        g_port["data"].attributes[attr] = ours
    for op, attrs in (("and", ["AreaMask", "CutOutMask"]), ("or", ["AreaMask", "CutOutMask_far"]),
                      ("not", ["AreaMask"])):
        cfg = {"name": "BooleanOp", "op": op, "attributes": attrs}
        np.testing.assert_array_equal(nodes.build_node_attribute(g_port, "data", dict(cfg)),
                                      jax_nodes.build_node_attribute(g_jax, "data", dict(cfg)))
    with pytest.raises(ValueError, match="boolean op"):
        nodes.apply_boolean_op(g_port, "data", "xor", ["AreaMask"])


@pytest.mark.parametrize("reference,resolution,margin_km", [
    ("lam", 4, 300.0),  # regional: most of the icosphere is dropped
    ("lam", 3, 0.0),  # within no margin only nodes on a grid point would stay
    ("data", 3, 1000.0),  # global, and wider than the grid spacing: the whole icosphere
])
def test_limited_area_tri_nodes_match_jax(reference, resolution, margin_km):
    grid, region = o16_with_region()
    g_jax, g_port = both_graphs({"data": grid, "lam": region})
    cfg = {"name": "LimitedAreaTriNodes", "resolution": resolution,
           "reference_node_name": reference, "margin_radius_km": margin_km}
    if margin_km == 0.0:
        for build, g in ((jax_nodes.build_nodes, g_jax), (nodes.build_nodes, g_port)):
            with pytest.raises((AssertionError, ValueError)):
                build(dict(cfg), graph=g)
        return
    ref = jax_nodes.build_nodes(dict(cfg), graph=g_jax)
    ours = nodes.build_nodes(dict(cfg), graph=g_port)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    full = 10 * 4**resolution + 2
    if reference == "lam":
        assert 0 < len(ours) < full // 2
    else:
        assert len(ours) == full
    with pytest.raises(ValueError, match="built earlier"):
        nodes.build_nodes(dict(cfg, reference_node_name="missing"), graph=g_port)


@pytest.mark.parametrize("cfg", [
    {"global_resolution": 2, "lam_resolution": 4, "centre": [57.0, 20.0], "radius_deg": 20.0},
    {"global_resolution": 1, "lam_resolution": 3},
])
def test_stretched_tri_nodes_match_jax(cfg):
    full = {"name": "StretchedTriNodes", **cfg}
    ref = jax_nodes.build_nodes(dict(full))
    ours = nodes.build_nodes(dict(full))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    coarse = 10 * 4 ** cfg["global_resolution"] + 2
    assert coarse // 2 < len(ours)  # most coarse nodes stay, and fine ones come in


def tied_destinations(g_jax, g_port):
    """Per edge set, the destinations whose sources differ; every such
    difference must be a tie at the boundary distance.  Node sets and node
    attributes must be equal, and the edge attributes of sets without ties."""
    assert list(g_jax.nodes) == list(g_port.nodes)
    for name, ns in g_jax.nodes.items():
        np.testing.assert_array_equal(ns.coords, g_port[name].coords)
        assert sorted(ns.attributes) == sorted(g_port[name].attributes)
        for attr, value in ns.attributes.items():
            np.testing.assert_allclose(g_port[name].attributes[attr], value, rtol=1e-6, atol=1e-6)
    ties = {}
    assert list(g_jax.edges) == list(g_port.edges)
    for key, ej in g_jax.edges.items():
        ep = g_port[key]
        src = latlon_rad_to_xyz(g_jax[key[0]].coords)
        dst = latlon_rad_to_xyz(g_jax[key[1]].coords)
        np.testing.assert_array_equal(ej.dst_ptr, ep.dst_ptr)
        tied = 0
        for d in range(len(ej.dst_ptr) - 1):
            lo, hi = ej.dst_ptr[d], ej.dst_ptr[d + 1]
            sj, sp = set(ej.edge_index[0, lo:hi]), set(ep.edge_index[0, lo:hi])
            if sj == sp:
                continue
            tied += 1
            dist = {s: np.linalg.norm(src[s] - dst[d]) for s in sj | sp}
            boundary = max(dist[s] for s in sj)
            for s in sj ^ sp:
                assert abs(dist[s] - boundary) < 1e-12, (key, d, s)
        ties[key] = tied
        if tied:
            continue  # a normalised attribute sees the other tied edge

        def keyed(es):
            order = np.lexsort((es.edge_index[0], es.edge_index[1]))
            return es.edge_index[:, order], {k: v[order] for k, v in es.attributes.items()}

        ij, aj = keyed(ej)
        ip, ap = keyed(ep)
        np.testing.assert_array_equal(ip, ij)
        for attr in aj:
            np.testing.assert_allclose(ap[attr], aj[attr], rtol=1e-6, atol=1e-6)
    return ties


@pytest.mark.parametrize("preset,overrides", [
    ("lam", ["graph.recipe.nodes.hidden.node_builder.resolution=2",
             "graph.recipe.nodes.hidden.node_builder.margin_radius_km=2000.0"]),
    ("lam", ["graph.recipe.nodes.data.node_builder.grid=o16",
             "graph.recipe.nodes.hidden.node_builder.resolution=3",
             "graph.recipe.nodes.hidden.node_builder.margin_radius_km=1000.0"]),
    ("stretched", ["graph.recipe.nodes.hidden.node_builder.global_resolution=1",
                   "graph.recipe.nodes.hidden.node_builder.lam_resolution=2"]),
], ids=["lam_o8", "lam_o16", "stretched_o8"])
def test_packaged_lam_graphs_match_jax(preset, overrides):
    overrides = ["graph.recipe.nodes.data.node_builder.grid=o8", *overrides]
    recipe = jax_load_config(os.path.join(JAX_CONFIG_DIR, f"{preset}.yaml"), overrides,
                             search_paths=[JAX_CONFIG_DIR]).to_dict()["graph"]["recipe"]
    g_jax, g_port = JaxGraphCreator(recipe).create(), GraphCreator(recipe).create()
    ties = tied_destinations(g_jax, g_port)
    mask = g_port["data"].attributes["cutout_mask"]
    assert mask.dtype == bool and 0 < mask.sum() < mask.size
    assert ties[("data", "hidden")] == 0  # cut-off edges never tie
    if preset == "lam":
        assert ties[("hidden", "hidden")] == 0  # multi-scale edges are not searched
    assert sum(ties.values()) <= 0.05 * g_port["data"].num_nodes


def test_masks():
    graph = Graph()
    mask = np.array([True, False, True, False])
    graph["data"] = NodeSet(coords=np.zeros((4, 2)), attributes={"m": mask[:, None]})
    (ds, m), = build_output_masks({"data": {"attribute_name": "m"}}, graph).items()
    assert ds == "data" and m.as_tensor() is m.as_tensor()  # one copy per device
    x = torch.arange(8.0).reshape(4, 2)
    np.testing.assert_array_equal(m.apply(x, -1.0).numpy(),
                                  np.where(mask[:, None], x.numpy(), -1.0))
    np.testing.assert_array_equal(m.rollout_boundary(x, -x).numpy(),
                                  np.where(mask[:, None], x.numpy(), -x.numpy()))
    np.testing.assert_array_equal(m.loss_scaler(), mask.astype(np.float32))
    jm = JaxBoolean1DMask(mask)
    np.testing.assert_array_equal(m.apply(x, 2.0).numpy(), np.asarray(jm.apply(x.numpy(), 2.0)))
    none = NoOutputMask()
    assert none.as_tensor() is None and none.loss_scaler() is None and none.apply(x) is x


@pytest.mark.parametrize("offset", [2, 3])
def test_advance_input_with_boundary_matches_jax(offset):
    idx = flagship_indices()["data"]
    ref_ia, ia = jax_index_arrays(jax_indices(idx)), _index_arrays(idx)
    rng = np.random.default_rng(offset)
    g = 13
    x = rng.normal(size=(2, 2, 1, g, idx.num_model_input_vars)).astype(np.float32)
    y = rng.normal(size=(2, 1, 1, g, idx.num_model_output_vars)).astype(np.float32)
    bn = rng.normal(size=(2, 5, 1, g, idx.num_data_vars)).astype(np.float32)
    mask = rng.random(g) < 0.5
    ref = jax_advance_input(jnp.asarray(x), jnp.asarray(y), jnp.asarray(bn), offset, ref_ia,
                            boundary_mask=jnp.asarray(mask))
    ours = advance_input(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(bn), offset,
                         {k: torch.as_tensor(v) for k, v in ia.items()},
                         boundary_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # outside the area every new input is the truth, inside only the forcings
    new = ours[:, -1].numpy()
    truth = bn[:, offset][..., ia["from_data"]]
    np.testing.assert_array_equal(new[:, :, ~mask], truth[:, :, ~mask])
    np.testing.assert_array_equal(new[:, :, mask][..., ~ia["is_prog"]],
                                  truth[:, :, mask][..., ~ia["is_prog"]])


def jax_indices(idx):
    from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection

    return JaxIndexCollection(idx.name_to_index, forcing=idx.forcing, diagnostic=idx.diagnostic)


def area_mask(tiny):
    """The tiny graph's data nodes north of 20 degrees."""
    return tiny["graph"]["data"].coords[:, 0] > np.deg2rad(20.0)


@pytest.mark.parametrize("rollout", [1, 2])
def test_step_with_output_mask_matches_jax(tiny, rollout):
    mask = area_mask(tiny)
    assert 0 < mask.sum() < mask.size
    loss_cfg = {**LOSS, "scalers": LOSS["scalers"] + ["output_mask"]}
    batch = batch_of(tiny, rollout)

    jax_scalers = jax_create_scalers(SCALERS, graph=tiny["graph"],
                                     data_indices=tiny["iface"].data_indices["data"])
    jax_scalers["output_mask"] = (("grid",), JaxBoolean1DMask(mask).loss_scaler())
    train_step, _ = jax_make_step_fns(
        tiny["iface"], {"data": jax_get_loss_function(loss_cfg, jax_scalers)}, rollout=rollout,
        remat_rollout=True, output_masks={"data": JaxBoolean1DMask(mask)})
    state, metrics = train_step(JaxTrainState.create(tiny["params"], grad_store()),
                                {"data": jnp.asarray(batch)})
    ref = state_dict_from_jax(state.opt_state)

    iface = port_iface(tiny, config())
    scalers = create_scalers(SCALERS, graph=tiny["port_graph"])
    scalers["output_mask"] = (("grid",), Boolean1DMask(mask).loss_scaler())
    p_train, _ = make_step_fns(iface, {"data": get_loss_function(loss_cfg, scalers)},
                               rollout=rollout, remat_rollout=True,
                               output_masks={"data": Boolean1DMask(mask)})
    loss = p_train.compute_gradients(TrainState.create(iface, build_optimizer(OPT)),
                                     {"data": torch.from_numpy(batch)})
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=RTOL)
    grads = {n: p.grad for n, p in iface.named_parameters()}
    assert sorted(grads) == sorted(ref)
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, want in ref.items():
        want, got = want.numpy(), grads[name].numpy()
        if name.endswith("lin_key.bias"):  # exactly 0 in truth: float noise on both sides
            assert np.abs(got).max() <= 1e-6 * top and np.abs(want).max() <= 1e-6 * top
            continue
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()),
                                   err_msg=name)
