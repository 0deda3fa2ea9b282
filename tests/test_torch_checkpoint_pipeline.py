"""The port's checkpoint-loading pipeline against the JAX package's.

Every case of tests/test_checkpoint_pipeline.py on the port's state dicts:
the JAX side runs on the flax tree ``{"params": {"encoder": {"kernel"}}}``
saved as ``.msgpack``, the port on the same arrays as the state dict
``{"model.encoder.kernel"}`` saved with ``torch.save``; a flax path
``params/<component>/<leaf>`` is the port's ``model.<component>.<leaf>``.
Then a tiny flagship (o8 -> ico-1, 16 channels, 1 layer): its per-component
``transfer_report`` against a source with two more variables, and
``freeze``'s selection, mapped onto JAX's through ``state_dict_from_jax``
(each flax leaf filled with its own index, so that every port tensor names
the leaf it came from); and two float32 trainer steps loading a JAX bundle
through ``[local, weights_only, freeze]`` in both trainers, their losses
within rtol 1e-5 and the frozen weights unchanged in both.
"""

import math

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from anemoi_tpu.training import checkpoint_pipeline as jax_pipeline
from anemoi_tpu_torch.training.checkpoint_pipeline import (
    CheckpointConfigError,
    CheckpointContext,
    CheckpointIncompatibleError,
    CheckpointNotFoundError,
    CheckpointPipeline,
    CheckpointValidationError,
    ComponentCatalog,
    validate_pipeline_health,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def port_name(path) -> str:
    """A flax path (``params/encoder/kernel`` or its key tuple) -> the
    port's name (``model.encoder.kernel``)."""
    parts = path.split("/") if isinstance(path, str) else [str(p) for p in path]
    return ".".join(["model"] + parts[1:]) if parts[0] == "params" else ".".join(parts)


def as_state_dict(tree) -> dict:
    return {port_name(k): torch.from_numpy(np.asarray(v).copy())
            for k, v in flat(tree).items()}


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def mapped_report(report: dict) -> dict:
    """A JAX transfer report with the port's names."""
    return {comp: {"matched": r["matched"],
                   "shape_mismatch": [{**m, "path": port_name(m["path"])}
                                      for m in r["shape_mismatch"]],
                   "missing_in_checkpoint": [port_name(p) for p in r["missing_in_checkpoint"]],
                   "unused_in_model": [port_name(p) for p in r["unused_in_model"]]}
            for comp, r in report.items()}


@pytest.fixture
def saved(tmp_path, rng):
    params = {"params": {
        "encoder": {"kernel": rng.normal(size=(4, 8)).astype(np.float32)},
        "decoder": {"kernel": rng.normal(size=(8, 3)).astype(np.float32)},
    }}
    jax_path = tmp_path / "params.msgpack"
    jax_path.write_bytes(serialization.to_bytes(params))
    port_path = tmp_path / "params.pt"
    torch.save(as_state_dict(params), port_path)
    return params, str(jax_path), str(port_path)


def both(stages_of, jax_params, **ctx):
    """Run the same pipeline in both packages; (JAX context, port context)."""
    ref = jax_pipeline.CheckpointPipeline(stages_of("jax")).run(
        jax_pipeline.CheckpointContext(params=jax_params, **ctx))
    ours = CheckpointPipeline(stages_of("port")).run(
        CheckpointContext(params=as_state_dict(jax_params), **ctx))
    return ref, ours


def zeros_like(tree):
    return jax.tree_util.tree_map(lambda x: np.zeros_like(np.asarray(x)), tree)


def test_weights_only(saved):
    params, jax_path, port_path = saved
    paths = {"jax": jax_path, "port": port_path}
    ref, ours = both(lambda p: [{"stage": "source", "name": "local", "path": paths[p]},
                                {"stage": "loading", "name": "weights_only"}],
                     zeros_like(params))
    assert ours.metadata == {**ref.metadata, "source": port_path}
    for name, value in as_state_dict(params).items():
        assert torch.equal(ours.params[name], value)


def test_transfer_learning_partial(saved):
    params, jax_path, port_path = saved
    target = {"params": {"encoder": {"kernel": np.zeros((4, 8), np.float32)},
                         "decoder": {"kernel": np.zeros((8, 5), np.float32)},  # mismatch
                         "new_head": {"kernel": np.ones((2, 2), np.float32)}}}
    paths = {"jax": jax_path, "port": port_path}
    ref, ours = both(lambda p: [{"stage": "source", "name": "local", "path": paths[p]},
                                {"stage": "loading", "name": "transfer_learning"}], target)
    assert ours.metadata["transfer_copied"] == ref.metadata["transfer_copied"] == 1
    assert ours.metadata["transfer_skipped"] == [
        port_name(p) for p in ref.metadata["transfer_skipped"]]
    assert ours.metadata["transfer_report"] == mapped_report(ref.metadata["transfer_report"])
    assert torch.equal(ours.params["model.encoder.kernel"],
                       torch.from_numpy(params["params"]["encoder"]["kernel"]))
    assert torch.equal(ours.params["model.decoder.kernel"], torch.zeros(8, 5))
    assert torch.equal(ours.params["model.new_head.kernel"], torch.ones(2, 2))


def test_freeze_modifier(saved):
    params, jax_path, port_path = saved
    paths = {"jax": jax_path, "port": port_path}
    ref, ours = both(lambda p: [{"stage": "source", "name": "local", "path": paths[p]},
                                {"stage": "loading", "name": "weights_only"},
                                {"stage": "modifier", "name": "freeze",
                                 "submodules": ["encoder"]}], zeros_like(params))
    assert ours.trainable_mask == {port_name(k): v for k, v in flat(ref.trainable_mask).items()}
    assert ours.trainable_mask == {"model.encoder.kernel": False, "model.decoder.kernel": True}


def test_stage_order_enforced(saved):
    _, _, port_path = saved
    with pytest.raises(CheckpointConfigError, match="stage order"):
        CheckpointPipeline([{"stage": "loading", "name": "weights_only"},
                            {"stage": "source", "name": "local", "path": port_path}])


@pytest.mark.parametrize("stages,match", [
    ([{"stage": "resource", "name": "local"}], "unknown stage kind"),
    ([{"stage": "source", "name": "ftp"}], "unknown source component"),
    ([{"stage": "loading", "name": "weights_only"}], "requires a source"),
])
def test_pipeline_config_errors(stages, match):
    with pytest.raises(jax_pipeline.CheckpointConfigError, match=match) as ref:
        jax_pipeline.CheckpointPipeline(stages)
    with pytest.raises(CheckpointConfigError, match=match) as ours:
        CheckpointPipeline(stages)
    assert ours.value.details == ref.value.details
    CheckpointPipeline([{"stage": "loading", "name": "cold_start"}])  # cold start alone


def test_checkpoint_not_found_and_catalog():
    for name in ("list_sources", "list_loaders", "list_modifiers"):
        assert getattr(ComponentCatalog, name)() == getattr(jax_pipeline.ComponentCatalog,
                                                            name)()
    assert {"local", "http", "s3"} <= set(ComponentCatalog.list_sources())
    pipe = CheckpointPipeline([{"stage": "source", "name": "local",
                                "path": "/nonexistent/ckpt"}])
    with pytest.raises(CheckpointNotFoundError):
        pipe.run(CheckpointContext(params={}))


def test_transfer_report_and_strict_weights(tmp_path):
    target = {"params": {"encoder": {"kernel": np.zeros((4, 8), np.float32)},
                         "decoder": {"kernel": np.zeros((3, 3), np.float32),
                                     "extra": np.zeros(2, np.float32)}}}
    source = {"params": {"encoder": {"kernel": np.zeros((4, 4), np.float32)},
                         "decoder": {"kernel": np.zeros((3, 3), np.float32)},
                         "legacy": {"w": np.zeros(1, np.float32)}}}
    report = ComponentCatalog.transfer_report(as_state_dict(target), as_state_dict(source))
    assert report == mapped_report(jax_pipeline.ComponentCatalog.transfer_report(target, source))
    assert report["decoder"]["missing_in_checkpoint"] == ["model.decoder.extra"]
    assert report["legacy"]["unused_in_model"] == ["model.legacy.w"]

    (tmp_path / "src.msgpack").write_bytes(serialization.to_bytes(source))
    torch.save(as_state_dict(source), tmp_path / "src.pt")
    paths = {"jax": str(tmp_path / "src.msgpack"), "port": str(tmp_path / "src.pt")}
    with pytest.raises(jax_pipeline.CheckpointIncompatibleError) as ref:
        jax_pipeline.CheckpointPipeline([
            {"stage": "source", "name": "local", "path": paths["jax"]},
            {"stage": "loading", "name": "weights_only"}]).run(
            jax_pipeline.CheckpointContext(params=target))
    with pytest.raises(CheckpointIncompatibleError) as ours:
        CheckpointPipeline([{"stage": "source", "name": "local", "path": paths["port"]},
                            {"stage": "loading", "name": "weights_only"}]).run(
            CheckpointContext(params=as_state_dict(target)))
    assert ours.value.details["report"] == mapped_report(ref.value.details["report"])
    ref, ours = both(lambda p: [{"stage": "source", "name": "local", "path": paths[p]},
                                {"stage": "loading", "name": "transfer_learning"}], target)
    assert ours.metadata["transfer_copied"] == ref.metadata["transfer_copied"] == 1


def test_pipeline_health_validation():
    params = {"model.w": torch.ones(3)}
    ctx = CheckpointPipeline([{"stage": "loading", "name": "cold_start"}]).run(
        CheckpointContext(params=params))
    assert ctx.metadata["stage_0_loading"] == "cold_start: completed"
    assert validate_pipeline_health(ctx)
    with pytest.raises(CheckpointValidationError, match="did not execute"):
        validate_pipeline_health(CheckpointContext(params=params))
    bad = CheckpointContext(params=params)
    bad.metadata["stage_0_source"] = "local: failed"
    assert not validate_pipeline_health(bad, raise_on_error=False)
    srconly = CheckpointContext(params=params, loaded={"params": params})
    srconly.metadata["stage_0_source"] = "local: completed"
    with pytest.raises(CheckpointValidationError, match="loading strategy"):
        validate_pipeline_health(srconly)
    nan_ctx = CheckpointContext(params={"model.w": torch.tensor([1.0, math.nan, 3.0])})
    nan_ctx.metadata["stage_0_loading"] = "cold_start: completed"
    with pytest.raises(CheckpointValidationError, match="non-finite"):
        validate_pipeline_health(nan_ctx)
    mctx = CheckpointContext(params=params, trainable_mask={"model.v": True})
    mctx.metadata["stage_0_loading"] = "cold_start: completed"
    with pytest.raises(CheckpointValidationError, match="trainable_mask"):
        validate_pipeline_health(mctx)


# --- a tiny flagship ---------------------------------------------------
def flagship_params(variables, graph):
    """A tiny flagship's JAX parameters for ``variables`` (seeded)."""
    from anemoi_tpu.data_indices.collection import IndexCollection as JaxIndexCollection
    from anemoi_tpu.models.interface import AnemoiModelInterface as JaxInterface
    from anemoi_tpu_torch.flagship import flagship_config

    n = len(variables)
    indices = {"data": JaxIndexCollection({v: i for i, v in enumerate(variables)},
                                          forcing=["cos_lat"])}
    stats = {"data": {k: np.ones(n, np.float32) for k in ("mean", "stdev", "minimum",
                                                          "maximum")}}
    iface = JaxInterface(config=flagship_config(16, 1, 2), graph=graph, data_indices=indices,
                         statistics=stats)
    return jax.device_get(iface.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def flagship_pair():
    from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
    from anemoi_tpu_torch.flagship import VARIABLES, flagship_recipe

    graph = JaxGraphCreator(flagship_recipe("o8", 1)).create()
    return (flagship_params(VARIABLES, graph),
            flagship_params(VARIABLES[:-1] + ["sp", "msl", VARIABLES[-1]], graph))


def leaf_names(tree) -> dict:
    """port name -> the flax leaf it comes from, through state_dict_from_jax."""
    from anemoi_tpu_torch.models.port import state_dict_from_jax

    leaves = sorted(flat(tree))
    numbered = {}
    for i, path in enumerate(leaves):
        node = numbered
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.full(np.shape(flat(tree)[path]), i, np.float32)
    return {name: "/".join(leaves[int(t.flatten()[0])])
            for name, t in state_dict_from_jax(numbered).items()}


def test_flagship_transfer_report_maps_onto_jax(flagship_pair):
    from anemoi_tpu_torch.models.port import state_dict_from_jax

    target, source = flagship_pair
    ref = jax_pipeline.ComponentCatalog.transfer_report(target, source)
    ours = ComponentCatalog.transfer_report(state_dict_from_jax(target),
                                            state_dict_from_jax(source))
    names = leaf_names(target)
    component = {}  # JAX component -> the port's
    for name, leaf in names.items():
        component.setdefault(leaf.split("/")[1], set()).add(name.split(".")[1])
    assert all(len(v) == 1 for v in component.values()), component
    assert sum(r["matched"] for r in ours.values()) == sum(r["matched"] for r in ref.values())
    assert sum(r["matched"] for r in ours.values()) > 0
    for comp, r in ref.items():
        mine = ours[component[comp].pop()]
        want = sorted(m["path"] for m in r["shape_mismatch"])
        assert sorted(names[m["path"]] for m in mine["shape_mismatch"]) == want
        assert mine["matched"] >= r["matched"]
    mismatched = {names[m["path"]] for r in ours.values() for m in r["shape_mismatch"]}
    assert mismatched and mismatched == {m["path"] for r in ref.values()
                                         for m in r["shape_mismatch"]}


def test_freeze_selects_the_jax_mask(flagship_pair):
    from anemoi_tpu_torch.models.port import state_dict_from_jax

    target, _ = flagship_pair
    ref = jax_pipeline.FreezingModifier(["GraphTransformerForwardMapper"])(
        jax_pipeline.CheckpointContext(params=target))
    frozen_jax = {"/".join(k) for k, v in flat(ref.trainable_mask).items() if not v}
    ours = CheckpointPipeline([{"stage": "modifier", "name": "freeze",
                                "submodules": ["encoder"]}]).run(
        CheckpointContext(params=state_dict_from_jax(target)))
    names = leaf_names(target)
    frozen_port = {name for name, trainable in ours.trainable_mask.items() if not trainable}
    assert frozen_port and {names[n] for n in frozen_port} == frozen_jax
    assert all(n.startswith("model.encoder.") for n in frozen_port)


def test_trainer_steps_with_a_pipeline_match_jax(tmp_path):
    """A JAX bundle loaded through [local, weights_only, freeze] by both
    trainers: two float32 steps, the same losses, the frozen weights equal
    to the bundle's and the others moved, in both."""
    from anemoi_tpu.training.trainer import AnemoiTrainer as JaxTrainer
    from anemoi_tpu_torch.models.port import state_dict_from_jax
    from anemoi_tpu_torch.training._msgpack import msgpack_restore
    from anemoi_tpu_torch.training.trainer import AnemoiTrainer
    from tests.test_torch_trainer import records, tiny_config

    source = tiny_config(tmp_path, "source", max_steps=1)
    source["diagnostics"]["callbacks"] = []
    JaxTrainer(source, output_dir=source["output_dir"]).train()
    bundle = str(tmp_path / "source" / "inference")
    loaded = msgpack_restore((tmp_path / "source" / "inference" / "params.msgpack").read_bytes())

    def pipeline(frozen):
        return [{"stage": "source", "name": "local", "path": bundle},
                {"stage": "loading", "name": "weights_only"},
                {"stage": "modifier", "name": "freeze", "submodules": [frozen]}]

    runs = {}
    for label, cls, frozen in (("jax", JaxTrainer, "GraphTransformerForwardMapper"),
                               ("port", AnemoiTrainer, "encoder")):
        cfg = tiny_config(tmp_path, label, max_steps=2,
                          checkpoint_pipeline=pipeline(frozen))
        cfg["diagnostics"]["callbacks"] = []
        trainer = cls(cfg, output_dir=cfg["output_dir"])
        trainer.train()
        runs[label] = (trainer, [r["loss"] for r in records(tmp_path / label / "metrics.jsonl")
                                 if "loss" in r])
    assert len(runs["port"][1]) == 2
    np.testing.assert_allclose(runs["port"][1], runs["jax"][1], rtol=1e-5)

    port = runs["port"][0]
    assert port.ckpt_name_to_index == runs["jax"][0].ckpt_name_to_index
    before = state_dict_from_jax(loaded)
    after = {k: v.detach().cpu() for k, v in port.interface.state_dict().items()}
    encoder = [k for k in before if k.startswith("model.encoder.")]
    assert encoder and all(torch.equal(after[k], before[k]) for k in encoder)
    assert any(not torch.equal(after[k], before[k]) for k in before
               if k.startswith("model.processor."))
    jax_after = flat(jax.device_get(runs["jax"][0].state.params))
    for path, value in flat(loaded).items():
        if "GraphTransformerForwardMapper_0" in path:
            np.testing.assert_array_equal(np.asarray(jax_after[path]), value)
