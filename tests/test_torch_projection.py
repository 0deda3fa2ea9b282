"""The sparse projector and its two users, the multiscale loss and the
truncated residual, in the port against the JAX package.

The same arrays, made from a numpy seed, go through both, in float32:

- ``SparseProjector`` on dst-sorted random edges (a destination with no
  edge, in-degrees 0-6), row-normalised or not: the projection, ``as_dense``
  and the gradient with respect to the input (3e-5 of the largest
  magnitude); ``from_graph`` (an edge attribute, a source-node attribute,
  ones) and ``from_file`` (both ``.npz`` layouts, written here); a bf16
  input projects to float32 in both packages, and its gradient is bf16.
- ``GaussianDistanceWeights`` (``sigma``, ``sigma_factor``; ``l1`` per
  target, ``unit-max``, none) on the KNN edges of o8 -> ico-1 (1e-6).
- ``graphs/builders.py``: the projection, truncation and smoother
  sub-graphs (edges equal, ``gauss_weight`` within 1e-6) and the node-name
  helpers.
- The ``ScaleTensor`` hooks (``update_scaler``, ``freeze``, ``validate``,
  ``subset_by_dim``, ``without_by_dim``).
- ``MultiscaleLossWrapper`` in the cases of ``tests/test_losses.py``
  (native only, an identity scale, a 4 -> 1 coarsening, the graph form with
  a grid scaler dropped at the coarse scale, NaN targets): the value and its
  gradient with respect to the prediction (3e-5); an imputer's ``mask``,
  which the JAX wrapper does not take, refused.
- ``TruncatedConnection`` from arrays and from a graph's ``truncation``
  sets: the skip state and its input gradient; the hierarchical model
  with it, its forward (1e-4).
- ``point_wise.yaml`` cut to o8 with a ``truncation`` node set (o4, KNN-3
  both ways, ``GaussianDistanceWeights`` l1) in its graph, ``residual:
  TruncatedConnection`` and ``MultiscaleLossWrapper`` (one scale onto
  ``hidden``), trained two steps by both trainers: every record within
  1e-4.  The JAX training step passes ``mask=`` to its loss, which the JAX
  wrapper does not take (ROADMAP Queue 3); the test wraps the JAX loss to
  drop a ``mask`` of None.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anemoi_tpu.graphs import builders as jax_builders
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.graphs.edges import gaussian_distance_weights as jax_gauss
from anemoi_tpu.graphs.graph import EdgeSet as JaxEdgeSet
from anemoi_tpu.graphs.graph import Graph as JaxGraph
from anemoi_tpu.graphs.graph import NodeSet as JaxNodeSet
from anemoi_tpu.models.layers.residual import TruncatedConnection as JaxTruncated
from anemoi_tpu.ops.sparse_projector import SparseProjector as JaxProjector
from anemoi_tpu.training.losses import get_loss_function as jax_get_loss_function
from anemoi_tpu.training.losses.base import ScaleTensor as JaxScaleTensor
from anemoi_tpu.training.losses.multiscale import MultiscaleLossWrapper as JaxMultiscale
from anemoi_tpu_torch.flagship import flagship_recipe
from anemoi_tpu_torch.graphs import builders
from anemoi_tpu_torch.graphs.edges import gaussian_distance_weights
from anemoi_tpu_torch.models.layers.residual import TruncatedConnection, build_residual
from anemoi_tpu_torch.models.port import state_dict_from_jax
from anemoi_tpu_torch.ops.sparse_projector import SparseProjector
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.base import ScaleTensor
from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR
from test_torch_blocks import randomised
from test_torch_model import port_graph
from test_torch_presets_tasks import (
    LR_ONLY,
    _SMALL_DATA,
    _SMALL_MESH,
    assert_records_equal,
    composed,
    train_both,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 3e-5


def close(ours, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(ours.detach().float() if torch.is_tensor(ours)
                                          else ours, np.float32), ref, rtol=tol,
                               atol=tol * scale)


def random_projection(rng, n_src=23, n_dst=11):
    """dst-sorted edges with in-degrees 0-6 (destination 3 has none)."""
    deg = rng.integers(1, 7, size=n_dst)
    deg[3] = 0
    dst = np.repeat(np.arange(n_dst), deg)
    src = rng.integers(0, n_src, size=dst.shape[0])
    w = rng.uniform(0.1, 1.0, size=dst.shape[0]).astype(np.float32)
    return np.stack([src, dst]), w


@pytest.mark.parametrize("row_normalize", [True, False], ids=["normalised", "raw"])
def test_projector_and_its_gradient_match_jax(row_normalize):
    rng = np.random.default_rng(0)
    ei, w = random_projection(rng)
    ref = JaxProjector(ei, w, 11, row_normalize=row_normalize)
    ours = SparseProjector(ei, w, 11, row_normalize=row_normalize)
    np.testing.assert_allclose(ours.as_dense(), ref.as_dense(), rtol=1e-6)
    x = rng.normal(size=(2, 3, 23, 4)).astype(np.float32)
    cot = rng.normal(size=(2, 3, 11, 4)).astype(np.float32)
    out_ref, vjp = jax.vjp(ref, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = ours(xt)
    close(out, out_ref)
    assert float(out.detach()[..., 3, :].abs().max()) == 0.0  # no edge: a zero row
    (out * torch.from_numpy(cot)).sum().backward()
    close(xt.grad, vjp(jnp.asarray(cot))[0])
    # a second run gives the same bits
    xt2 = torch.tensor(x, requires_grad=True)
    out2 = ours(xt2)
    (out2 * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(out, out2) and torch.equal(xt.grad, xt2.grad)


def test_projector_nonfinite_rows_match_jax():
    """A NaN and an inf in source row 0 (forward) and in destination row 0
    of the cotangent (backward) reach only the rows with an edge from them,
    as through ``segment_sum``: the padded slots of both tables, which
    gather row 0, add nothing."""
    rng = np.random.default_rng(8)
    ei, w = random_projection(rng)
    ei[0, ei[1] == 5] = 0  # destination 5 reads source 0 ...
    ei[0, (ei[0] == 0) & (ei[1] != 5)] = 1  # ... and no other does
    ref, ours = JaxProjector(ei, w, 11), SparseProjector(ei, w, 11)
    x = rng.normal(size=(2, 23, 3)).astype(np.float32)
    x[:, 0, 0], x[:, 0, 1] = np.nan, np.inf
    cot = rng.normal(size=(2, 11, 3)).astype(np.float32)
    cot[:, 0, 0], cot[:, 0, 2] = np.nan, -np.inf
    out_ref, vjp = jax.vjp(ref, jnp.asarray(x))
    grad_ref = np.asarray(vjp(jnp.asarray(cot))[0])
    xt = torch.tensor(x, requires_grad=True)
    out = ours(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    for mine, want in ((out.detach().numpy(), np.asarray(out_ref)), (xt.grad.numpy(), grad_ref)):
        finite = np.isfinite(want)
        assert not finite.all() and finite.any()
        np.testing.assert_array_equal(np.isnan(mine), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(mine), np.isinf(want))
        close(mine[finite], want[finite])
    assert np.isfinite(out.detach().numpy()[:, np.arange(11) != 5]).all()


def test_projector_types_and_refusals():
    rng = np.random.default_rng(1)
    ei, w = random_projection(rng)
    x = rng.normal(size=(1, 23, 3)).astype(np.float32)
    ref = JaxProjector(ei, w, 11)(jnp.asarray(x, jnp.bfloat16))
    xt = torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
    out = SparseProjector(ei, w, 11)(xt)
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    close(out, ref, 1e-6)
    out.sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dst-sorted"):
        SparseProjector(ei[:, ::-1], w[::-1], 11)


def small_graphs():
    """o8 -> ico-1 with KNN-3 both ways (JAX build; the port's copy)."""
    recipe = flagship_recipe("o8", 1)
    graph = JaxGraphCreator(recipe).create()
    return graph, port_graph(graph)


def test_projector_from_graph_and_file(tmp_path):
    jax_graph, graph = small_graphs()
    rng = np.random.default_rng(2)
    jax_graph["data"].attributes["w"] = graph["data"].attributes["w"] = rng.uniform(
        0.5, 1.5, size=(graph["data"].num_nodes, 1)).astype(np.float32)
    x = rng.normal(size=(2, graph["data"].num_nodes, 3)).astype(np.float32)
    for kw in ({"edge_weight_attribute": "edge_length"}, {"src_node_weight_attribute": "w"}, {}):
        ref = JaxProjector.from_graph(jax_graph, ("data", "hidden"), **kw)
        ours = SparseProjector.from_graph(graph, ("data", "hidden"), **kw)
        close(ours(torch.from_numpy(x)), ref(jnp.asarray(x)))
    ei, w = random_projection(rng)
    order = rng.permutation(ei.shape[1])  # the triplet form need not be sorted
    np.savez(tmp_path / "triplets.npz", src=ei[0][order], dst=ei[1][order], weights=w[order],
             num_dst=11)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(ei[1], minlength=11))])
    np.savez(tmp_path / "csr.npz", indptr=indptr, indices=ei[0], data=w)
    x = rng.normal(size=(2, 23, 3)).astype(np.float32)
    for name in ("triplets.npz", "csr.npz"):
        for norm in (True, False):
            ref = JaxProjector.from_file(tmp_path / name, row_normalize=norm)
            ours = SparseProjector.from_file(tmp_path / name, row_normalize=norm)
            assert ours.num_dst == ref.num_dst == 11
            close(ours(torch.from_numpy(x)), ref(jnp.asarray(x)))


def test_gaussian_distance_weights_match_jax():
    jax_graph, graph = small_graphs()
    for key in (("data", "hidden"), ("hidden", "data")):
        ei = graph[key].edge_index
        for kw in ({"sigma": 0.1, "norm": "l1"}, {"sigma_factor": 0.5, "norm": "l1"},
                   {"norm": "unit-max"}, {"sigma": 0.2}):
            ref = jax_gauss(jax_graph, *key, ei, **kw)
            ours = gaussian_distance_weights(graph, *key, ei, **kw)
            assert ours.shape == ref.shape and ours.dtype == np.float32
            np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
        l1 = gaussian_distance_weights(graph, *key, ei, sigma=0.1, norm="l1")[:, 0]
        np.testing.assert_allclose(np.bincount(ei[1], weights=l1), 1.0, rtol=1e-5)


def assert_same_graph(ours, ref):
    """Same nodes; per destination, the same KNN sources up to ties (equally
    distant sources: ``cKDTree`` and scikit-learn break them differently,
    ROADMAP Queue 3) and the same ``gauss_weight``s, which depend on the
    distance alone."""
    from anemoi_tpu_torch.graphs.transforms import great_circle_distance

    assert sorted(ours.nodes) == sorted(ref.nodes)
    for name in ref.nodes:
        np.testing.assert_allclose(ours[name].coords, ref[name].coords, rtol=1e-12)
    assert sorted(ours.edges) == sorted(ref.edges)
    for (src, dst), es in ref.edges.items():
        mine = ours[(src, dst)]
        np.testing.assert_array_equal(mine.edge_index[1], es.edge_index[1])
        k = int(np.bincount(es.edge_index[1]).max())
        rows = []
        for g in (mine, es):
            d = great_circle_distance(ref[src].coords[g.edge_index[0]],
                                      ref[dst].coords[g.edge_index[1]]).reshape(-1, k)
            w = np.asarray(g.attributes["gauss_weight"]).reshape(-1, k)
            rows.append((g.edge_index[0].reshape(-1, k), np.sort(d, 1), np.sort(w, 1)))
        (s_a, d_a, w_a), (s_b, d_b, w_b) = rows
        np.testing.assert_allclose(d_a, d_b, rtol=0, atol=1e-12)
        np.testing.assert_allclose(w_a, w_b, rtol=1e-6, atol=1e-7)
        differ = (np.sort(s_a, 1) != np.sort(s_b, 1)).any(1)
        assert differ.mean() < 0.25, (src, dst, int(differ.sum()))


def test_builders_match_jax():
    jax_graph, graph = small_graphs()
    trunc = {"grid": "o4", "num_nearest_neighbours": 3, "sigma": 0.5}
    assert_same_graph(builders.build_truncation_subgraph(graph, "data", trunc),
                      jax_builders.build_truncation_subgraph(jax_graph, "data", trunc))
    proj = {"num_nearest_neighbours": 4, "sigma": 0.3}
    assert_same_graph(builders.build_node_to_node_projection_subgraph(graph, "data", "hidden", proj),
                      jax_builders.build_node_to_node_projection_subgraph(
                          jax_graph, "data", "hidden", proj))
    coarse = {**proj, "grid": "o4"}
    assert_same_graph(builders.build_node_to_node_projection_subgraph(graph, "data", "c", coarse),
                      jax_builders.build_node_to_node_projection_subgraph(
                          jax_graph, "data", "c", coarse))
    smooth = {"num_nearest_neighbours": 5, "sigma": 0.2}
    assert_same_graph(builders.build_smoother_subgraph(graph, "data", smooth),
                      jax_builders.build_smoother_subgraph(jax_graph, "data", smooth))
    with pytest.raises(ValueError, match="sigma"):
        builders.build_node_to_node_projection_subgraph(graph, "data", "hidden",
                                                        {"num_nearest_neighbours": 3})
    recipe = flagship_recipe("o8", 1)
    for g_or_cfg in (graph, recipe, {}):
        ref_g = jax_graph if g_or_cfg is graph else g_or_cfg
        assert builders.get_graph_node_names(g_or_cfg) == jax_builders.get_graph_node_names(ref_g)
        for names in (["data"], ["era", "data"], ["hidden"], []):
            assert (builders.uses_fused_dataset_graph(g_or_cfg, names)
                    == jax_builders.uses_fused_dataset_graph(ref_g, names))


def test_scale_tensor_hooks_match_jax():
    arrays = {"area": (("grid",), np.arange(1.0, 6.0)),
              "var": (("variable",), np.array([1.0, 2.0, 3.0])),
              "gv": (("grid", "variable"), np.ones((5, 3))),
              "time": (("time",), np.array([0.5]))}
    ours = ScaleTensor(arrays)
    ref = JaxScaleTensor({k: (d, jnp.asarray(a)) for k, (d, a) in arrays.items()})
    for dims in ("grid", ["variable", 1], 3, ("batch",)):
        for a, b in ((ours.subset_by_dim(dims), ref.subset_by_dim(dims)),
                     (ours.without_by_dim(dims), ref.without_by_dim(dims))):
            assert sorted(a.scalers) == sorted(b.scalers)
    ours.validate((2, 1, 1, 5, 3))
    ref.validate((2, 1, 1, 5, 3))
    for st in (ours, ref):
        with pytest.raises(ValueError, match="'grid' has size 5"):
            st.validate((2, 1, 1, 4, 3))
    ours.update_scaler("var", np.array([3.0, 2.0, 1.0]))
    np.testing.assert_array_equal(ours.scalers["var"][1].numpy(), [3.0, 2.0, 1.0])
    with pytest.raises(ValueError, match="shape"):
        ours.update_scaler("var", np.ones(4))
    for st in (ours, ref):
        st.freeze(["var"])
        with pytest.raises(ValueError, match="frozen"):
            st.update_scaler("var", np.ones(3))
        st.update_scaler("var", np.ones(3), override=True)
        st.update_scaler("area", np.ones(5))
    ours.freeze()
    with pytest.raises(ValueError, match="frozen"):
        ours.update_scaler("area", np.ones(5))


G, V = 8, 2


def coarse_graphs():
    """8 grid points in 2 coarse cells of 4 (JAX's graph; the port's copy)."""
    lat = np.linspace(-1.0, 1.0, G)
    jg = JaxGraph()
    jg["data"] = JaxNodeSet(coords=np.stack([lat, np.zeros(G)], axis=1))
    jg["coarse"] = JaxNodeSet(coords=np.stack([lat[::4], np.zeros(2)], axis=1))
    es = JaxEdgeSet(edge_index=np.stack([np.arange(G), np.arange(G) // 4]))
    es.attributes["w"] = np.linspace(0.5, 1.5, G, dtype=np.float32)[:, None]
    jg[("data", "coarse")] = es
    return jg, port_graph(jg)


INNER = {"name": "WeightedMSELoss", "scalers": []}
MULTISCALE_CASES = {
    "native_only": ({"loss": INNER, "scales": []}, False),
    "identity_scale": ({"loss": INNER, "scales": [
        {"edge_index": np.stack([np.arange(G), np.arange(G)]), "weights": np.ones(G, np.float32),
         "num_coarse": G, "weight": 3.0}]}, False),
    "four_to_one": ({"loss": INNER, "native_weight": 1.0, "scales": [
        {"edge_index": np.stack([np.arange(G), np.arange(G) // 4]),
         "weights": np.ones(G, np.float32), "num_coarse": 2, "weight": 1.0}]}, False),
    "graph_grid_scaler_dropped": ({"loss": {"name": "WeightedMSELoss", "scalers": ["area", "v"]},
                                   "native_weight": 0.7, "scales": [
        {"nodes": "coarse", "weight_attribute": "w", "weight": 0.5}]}, False),
    "nan_targets": ({"loss": INNER, "scales": [
        {"nodes": "coarse", "weight": 2.0}]}, True),
}


@pytest.mark.parametrize("case", sorted(MULTISCALE_CASES))
def test_multiscale_loss_matches_jax(case):
    cfg, nans = MULTISCALE_CASES[case]
    cfg = {"name": "MultiscaleLossWrapper", **cfg}
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(2, 1, 1, G, V)).astype(np.float32)
    target = rng.normal(size=(2, 1, 1, G, V)).astype(np.float32)
    if nans:
        target[0, 0, 0, [0, 5], 1] = np.nan
    scalers = {"area": (("grid",), rng.uniform(0.5, 1.5, G).astype(np.float32)),
               "v": (("variable",), np.array([1.0, 2.0], np.float32))}
    jg, pg = coarse_graphs()
    ref_loss = jax_get_loss_function(cfg, {k: (d, jnp.asarray(a)) for k, (d, a) in
                                           scalers.items()}, graph=jg)
    ours_loss = get_loss_function(cfg, scalers, graph=pg)
    assert ours_loss.grid_scaler_names == ref_loss.grid_scaler_names == ["area"]
    assert ours_loss.name == ref_loss.name
    ref, grad = jax.value_and_grad(lambda p: ref_loss(p, jnp.asarray(target)))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    val = ours_loss(p, torch.from_numpy(target))
    val.backward()
    assert np.isfinite(float(val.detach()))
    close(val, ref)
    close(p.grad, grad)
    close(ours_loss(torch.from_numpy(pred), torch.from_numpy(target), squash=False),
          ref_loss(jnp.asarray(pred), jnp.asarray(target), squash=False))


def test_multiscale_loss_mask_and_refusal(tmp_path):
    """The JAX wrapper takes no ``mask`` (the imputer's loss mask): it
    raises on one, so the port refuses one too, and ``make_step_fns``
    refuses the multiscale loss with an imputer before any step.  Scales
    read from the graph need one."""
    from anemoi_tpu_torch.training.step import make_step_fns
    from anemoi_tpu_torch.training.trainer import AnemoiTrainer

    cfg = {"name": "MultiscaleLossWrapper", **MULTISCALE_CASES["nan_targets"][0]}
    jg, pg = coarse_graphs()
    loss, ref = get_loss_function(cfg, {}, graph=pg), jax_get_loss_function(cfg, {}, graph=jg)
    rng = np.random.default_rng(4)
    pred = rng.normal(size=(1, 1, 1, G, V)).astype(np.float32)
    mask = np.ones((1, G, V), np.float32)
    with pytest.raises(TypeError, match="mask"):
        ref(jnp.asarray(pred), jnp.asarray(pred), mask=jnp.asarray(mask))
    with pytest.raises(ValueError, match="imputer mask"):
        loss(torch.from_numpy(pred), torch.from_numpy(pred), mask=torch.from_numpy(mask))
    with pytest.raises(ValueError, match="graph"):
        get_loss_function(cfg, {})
    path = f"{PACKAGED_CONFIG_DIR}/point_wise.yaml"
    imputer = ("data.processors=[{name: InputImputer, default: mean}, "
               "{name: InputNormalizer, default: mean-std}]")
    overrides = _SMALL_DATA + _SMALL_MESH + ["model.processor.num_layers=1", imputer]
    run = with_projections(composed(path, PACKAGED_CONFIG_DIR, overrides, tmp_path, "port"))
    trainer = AnemoiTrainer(run, output_dir=run["output_dir"])
    assert trainer.interface.pre_processors["data"].has_imputer
    with pytest.raises(ValueError, match="imputer"):
        make_step_fns(trainer.interface, trainer.losses, rollout=1)


def truncation_graphs():
    jax_graph, _ = small_graphs()
    trunc = jax_builders.build_truncation_subgraph(
        jax_graph, "data", {"grid": "o4", "num_nearest_neighbours": 3, "sigma": 0.5})
    for key, es in trunc.edges.items():
        jax_graph[key] = es
    jax_graph["truncation"] = trunc["truncation"]
    return jax_graph, port_graph(jax_graph)


@pytest.mark.parametrize("form", ["arrays", "graph"])
def test_truncated_connection_matches_jax(form):
    jax_graph, graph = truncation_graphs()
    n_data, n_trunc = graph["data"].num_nodes, graph["truncation"].num_nodes
    if form == "arrays":
        rng = np.random.default_rng(5)
        down_ei, down_w = random_projection(rng, n_data, n_trunc)
        up_ei, up_w = random_projection(rng, n_trunc, n_data)
        kw = dict(down_edge_index=down_ei, down_weights=down_w, up_edge_index=up_ei,
                  up_weights=up_w, num_coarse=n_trunc, num_data=n_data)
        ref, ours = JaxTruncated(**kw, step=0), build_residual(
            {"name": "TruncatedConnection", **kw, "step": 0})
    else:
        from anemoi_tpu.models.layers.residual import build_residual as jax_build_residual

        cfg = {"name": "TruncatedConnection"}
        ref = jax_build_residual(cfg, graph=jax_graph, dataset="data")
        ours = build_residual(cfg, graph=graph, dataset="data")
        with pytest.raises(ValueError, match="source graph"):
            build_residual(cfg)
    assert isinstance(ours, TruncatedConnection)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 2, 1, n_data, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 2, 1, n_data, 3)).astype(np.float32)
    out_ref, vjp = jax.vjp(lambda a: ref(a, n_step_output=2), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = ours(xt, n_step_output=2)
    assert tuple(out.shape) == out_ref.shape
    close(out, out_ref)
    (out * torch.from_numpy(cot)).sum().backward()
    close(xt.grad, vjp(jnp.asarray(cot))[0])


def test_hierarchical_model_reads_the_truncation_graph():
    """The V-cycle builds its residual from the source graph too: the
    hierarchical model of ``tests/test_torch_hierarchical.py`` with a
    ``truncation`` set (o4, KNN-3 both ways) and ``TruncatedConnection``,
    its forward against the JAX model's (1e-4)."""
    import copy

    from test_torch_hierarchical import RECIPE, interfaces, model_config

    recipe = copy.deepcopy(RECIPE)
    recipe["nodes"].update(TRUNCATION_GRAPH["nodes"])
    recipe["edges"] = list(recipe["edges"]) + TRUNCATION_GRAPH["edges"]
    jax_graph = JaxGraphCreator(recipe).create()
    ref, ours = interfaces((jax_graph, port_graph(jax_graph)),
                           model_config("GT", residual={"name": "TruncatedConnection"}))
    assert type(ours.model.residual["data"]).__name__ == "TruncatedConnection"
    rng = np.random.default_rng(7)
    params = randomised(jax.eval_shape(ref.init_params, jax.random.PRNGKey(0)), rng)
    ours.load_state_dict(state_dict_from_jax(params), strict=True)
    x = rng.normal(size=(1, 2, 1, jax_graph["data"].num_nodes, 5)).astype(np.float32)
    want = ref.model.apply(params, {"data": jnp.asarray(x)}, ref.graph_inputs)["data"]
    close(ours.run_model({"data": torch.from_numpy(x)})["data"], want, 1e-4)


# --- trained by both trainers ---------------------------------------------
TRUNCATION_GRAPH = {
    "nodes": {"truncation": {"node_builder": {"name": "ReducedGaussianGridNodes", "grid": "o4"}}},
    "edges": [{"source_name": s, "target_name": t,
               "edge_builder": {"name": "KNNEdges", "num_nearest_neighbours": 3},
               "attributes": {"gauss_weight": {"name": "GaussianDistanceWeights", "sigma": 0.5,
                                               "norm": "l1"}}}
              for s, t in (("data", "truncation"), ("truncation", "data"))],
}
MULTISCALE_LOSS = {"name": "MultiscaleLossWrapper", "native_weight": 1.0,
                   "loss": {"name": "WeightedMSELoss", "scalers": ["area", "variable"]},
                   "scales": [{"nodes": "hidden", "weight": 0.5}]}


def with_projections(cfg):
    """``cfg`` with the truncation node set and edges in its graph recipe,
    ``residual: TruncatedConnection`` and the multiscale loss."""
    recipe = cfg["graph"]["recipe"]
    recipe["nodes"].update(TRUNCATION_GRAPH["nodes"])
    recipe["edges"] = list(recipe["edges"]) + TRUNCATION_GRAPH["edges"]
    cfg["model"]["residual"] = {"name": "TruncatedConnection"}
    cfg["training"]["loss"] = MULTISCALE_LOSS
    return cfg


def test_projections_train_as_jax_trains_them(tmp_path, monkeypatch):
    call = JaxMultiscale.__call__

    def no_mask(self, pred, target, mask=None, **kwargs):
        assert mask is None  # no imputer: the JAX step passes mask=None
        return call(self, pred, target, **kwargs)

    monkeypatch.setattr(JaxMultiscale, "__call__", no_mask)
    path = f"{PACKAGED_CONFIG_DIR}/point_wise.yaml"
    overrides = _SMALL_DATA + _SMALL_MESH + ["model.processor.num_layers=1", LR_ONLY]
    ref, ours, trainer = train_both(
        tmp_path, lambda name: with_projections(
            composed(path, PACKAGED_CONFIG_DIR, overrides, tmp_path, name)))
    assert type(trainer.interface.model.residual["data"]).__name__ == "TruncatedConnection"
    assert type(trainer.losses["data"]).__name__ == "MultiscaleLossWrapper"
    assert trainer.graph["truncation"].num_nodes == 208  # o4
    assert_records_equal(ref, ours)
