"""Checkpoint migrations in the port against the JAX package's.

- the committed round-2 fixture (``tests/fixtures/inference_ckpt_r2``, one
  migration pending), copied and set to serve in float32: the port's
  ``load_inference_checkpoint`` applies the migration and its
  ``predict_step`` equals JAX's on a seeded batch (rtol/atol 3e-5);
- parameter trees saved before the processor scan (per-layer ``blocks_<i>``,
  GNN and GraphTransformer processors, as tests/test_migrations.py builds
  them) and before the hierarchical renames migrate to the same tree in
  both packages; a pre-scan bundle loads in the port and forecasts as in
  JAX (float32, rtol/atol 3e-5);
- ``cli checkpoint migrate``, ``--rollback`` and ``--create`` write the same
  ``checkpoint.json`` and script as the JAX CLI, on copies of the fixture;
  ``checkpoint inspect`` reports the same pending migrations.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from anemoi_tpu.models import migrations as jax_migrations
from anemoi_tpu.training.checkpoint import load_inference_checkpoint as jax_load
from anemoi_tpu.training.cli import main as jax_main
from anemoi_tpu_torch.models import migrations
from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint
from anemoi_tpu_torch.training.cli import main
from tests.test_migrations import build
from tests.test_models import model_config
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "inference_ckpt_r2")
TOL = 3e-5


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def assert_same_tree(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=str(k))


def fp32_copy(tmp_path, name="bundle"):
    """A copy of the fixture that serves in float32 in both packages."""
    path = tmp_path / name
    shutil.copytree(FIXTURE, path)
    bundle = json.loads((path / "checkpoint.json").read_text())
    bundle["config"]["model"]["inference_precision"] = "fp32"
    (path / "checkpoint.json").write_text(json.dumps(bundle))
    return path


def predict_both(path, seed):
    jax_iface, params = jax_load(str(path))
    port = load_inference_checkpoint(str(path), device="cpu")
    n_grid = port.model_graph.num_nodes["data"]
    nv = port.data_indices["data"].num_data_vars
    batch = np.random.default_rng(seed).normal(size=(1, 2, 1, n_grid, nv)).astype(np.float32)
    ref = np.asarray(jax_iface.predict_step(params, {"data": jnp.asarray(batch)})["data"])
    with torch.no_grad():
        ours = port.predict_step({"data": torch.from_numpy(batch)})["data"].numpy()
    return port, ours, ref


def test_fixture_has_one_migration_pending():
    bundle = json.loads(open(os.path.join(FIXTURE, "checkpoint.json")).read())
    assert [m.name for m in migrations.MIGRATOR.pending(bundle)] == \
        [m.name for m in jax_migrations.MIGRATOR.pending(bundle)] == \
        ["20260820120000_hierarchical_module_names"]
    assert [m.name for m in migrations.MIGRATOR.migrations] == \
        [m.name for m in jax_migrations.MIGRATOR.migrations]


def test_fixture_loads_and_predicts_as_jax(tmp_path):
    port, ours, ref = predict_both(fp32_copy(tmp_path), seed=0)
    assert port.metadata["migrations"] == [m.name for m in migrations.MIGRATOR.migrations]
    assert next(port.parameters()).dtype == torch.float32
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("processor", ["GNNProcessor", "GraphTransformerProcessor"])
def test_prescan_tree_migrates_alike(tiny_graph, processor):
    old = build(tiny_graph, processor, scan_layers=False)
    raw = serialization.to_state_dict(jax.device_get(old.init_params(jax.random.PRNGKey(0))))
    raw = jax.tree_util.tree_map(np.asarray, raw)
    bundle = {"config": {"model": {"processor": {"name": processor}}},
              "metadata": {"migrations": ["20260817000000_initial_format"]}}
    ref_bundle, ref = jax_migrations.MIGRATOR.migrate(json.loads(json.dumps(bundle)),
                                                      jax.tree_util.tree_map(np.copy, raw))
    ours_bundle, ours = migrations.MIGRATOR.migrate(json.loads(json.dumps(bundle)),
                                                    jax.tree_util.tree_map(np.copy, raw))
    assert ours_bundle == ref_bundle
    assert "blocks" in ours["params"][f"{processor}_0"]
    assert_same_tree(ours, ref)
    # a config that opts out of the scan keeps the per-layer tree in both
    noscan = {"config": {"model": {"processor": {"scan_layers": False}}}, "metadata": {}}
    _, kept = migrations.MIGRATOR.migrate(noscan, jax.tree_util.tree_map(np.copy, raw))
    assert_same_tree(kept, raw)


def test_hierarchical_rename_migrates_alike():
    ckpt = {"config": {"model": {
        "name": "AnemoiModelEncProcDecHierarchical",
        "trainable_parameters": {"data": 2, "hidden_2": 2, "hidden_1": 2, "hidden_3": 2},
        "encoder": {"name": "GraphTransformerForwardMapper"},
        "decoder": {"name": "GraphTransformerBackwardMapper"},
        "processor": {"name": "GraphTransformerProcessor"}}},
        "data_indices": {"data": {}, "era": {}}}
    rename = jax_migrations._hier_rename_map(ckpt)
    assert migrations._hier_rename_map(ckpt) == rename
    rng = np.random.default_rng(3)
    params = {"params": {k: {"w": rng.normal(size=(2, 3)).astype(np.float32)}
                         for k in list(rename) + ["node_attributes_data"]}}
    bundle = {**ckpt, "metadata": {"migrations": ["20260817000000_initial_format",
                                                  "20260817120000_stack_processor_scan"]}}
    _, ref = jax_migrations.MIGRATOR.migrate(dict(bundle), params)
    _, ours = migrations.MIGRATOR.migrate(dict(bundle), params)
    assert set(ours["params"]) == set(rename.values()) | {"node_attributes_data"}
    assert_same_tree(ours, ref)


@pytest.mark.parametrize("processor", ["GNNProcessor", "GraphTransformerProcessor"])
def test_prescan_bundle_loads_and_predicts_as_jax(tmp_path, tiny_graph, processor):
    """A bundle whose parameters predate the processor scan: the port
    stacks them (the params transform) before it maps the names."""
    from anemoi_tpu.training.checkpoint import save_inference_checkpoint
    from tests.test_models import NAMES, make_statistics

    mcfg = model_config(processor=processor)  # GNN mappers, as ``build``'s
    mcfg["inference_precision"] = "fp32"
    old = build(tiny_graph, processor, scan_layers=False)
    prescan = jax.device_get(old.init_params(jax.random.PRNGKey(0)))
    config = {"model": mcfg, "data": {"processors": []},
              "graph": {"save_path": str(tmp_path / "graph.npz")}}
    tiny_graph.save(str(tmp_path / "graph.npz"))
    di = {"data": {"name_to_index": NAMES, "forcing": ["cos_lat", "z"], "diagnostic": ["tp"],
                   "target": []}}
    path = tmp_path / "prescan"
    save_inference_checkpoint(str(path), prescan, config, di, {"data": make_statistics()})
    bundle = json.loads((path / "checkpoint.json").read_text())
    bundle["metadata"]["migrations"] = ["20260817000000_initial_format"]
    (path / "checkpoint.json").write_text(json.dumps(bundle))
    _, ours, ref = predict_both(path, seed=1)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    # `checkpoint migrate` would mark the stacking applied without touching
    # params.msgpack: the port's CLI refuses and leaves it to the loader;
    # the JAX CLI marks it, and the JAX loader then fails on the bundle
    before = (path / "checkpoint.json").read_text()
    assert main(["checkpoint", "migrate", str(path)]) == 1
    assert (path / "checkpoint.json").read_text() == before
    shutil.copytree(path, tmp_path / "jax_migrated")
    assert jax_main(["checkpoint", "migrate", str(tmp_path / "jax_migrated")]) == 0
    with pytest.raises(ValueError):
        jax_load(str(tmp_path / "jax_migrated"))


def run_cli(fn, argv, capsys):
    capsys.readouterr()
    rc = fn(argv)
    return rc, capsys.readouterr().out


def test_cli_migrate_and_rollback_match_jax(tmp_path, capsys):
    copies = {}
    for label, fn in (("jax", jax_main), ("port", main)):
        path = tmp_path / label
        shutil.copytree(FIXTURE, path)
        rc, out = run_cli(fn, ["checkpoint", "migrate", str(path)], capsys)
        assert rc == 0
        migrated = json.loads((path / "checkpoint.json").read_text())
        rc, inspect = run_cli(fn, ["checkpoint", "inspect", str(path)], capsys)
        assert rc == 0
        rc, back = run_cli(fn, ["checkpoint", "migrate", str(path), "--rollback",
                                "20260817000000_initial_format"], capsys)
        assert rc == 0
        rolled = json.loads((path / "checkpoint.json").read_text())
        copies[label] = (out, migrated, json.loads(inspect)["migrations_pending"], back, rolled)
    assert copies["port"] == copies["jax"]
    out, migrated, pending, back, rolled = copies["port"]
    assert out.strip() == "applied 1 migrations: ['20260820120000_hierarchical_module_names']"
    assert pending == [] and len(migrated["metadata"]["migrations"]) == 3
    assert rolled["metadata"]["migrations"] == ["20260817000000_initial_format"]
    # the committed fixture itself is read, never written
    fixture = json.loads(open(os.path.join(FIXTURE, "checkpoint.json")).read())
    assert len(fixture["metadata"]["migrations"]) == 2


def test_cli_inspect_of_the_fixture_matches_jax(capsys):
    infos = {}
    for label, fn in (("jax", jax_main), ("port", main)):
        rc, out = run_cli(fn, ["checkpoint", "inspect", FIXTURE], capsys)
        assert rc == 0
        infos[label] = json.loads(out)
    assert infos["port"].pop("params") == "params.msgpack"
    assert infos["port"] == infos["jax"]
    assert infos["port"]["migrations_pending"] == ["20260820120000_hierarchical_module_names"]


def test_cli_create_writes_the_jax_script(tmp_path, capsys):
    scripts = {}
    for label, fn, registry in (("jax", jax_main, jax_migrations.MIGRATOR),
                                ("port", main, migrations.MIGRATOR)):
        n_before = len(registry.migrations)
        rc, out = run_cli(fn, ["checkpoint", "migrate", "--create", "cli_scaffold",
                               "--scripts-dir", str(tmp_path / label)], capsys)
        assert rc == 0 and "created" in out
        assert len(registry.migrations) == n_before  # creation does not register
        (name,) = [f for f in os.listdir(tmp_path / label) if f.endswith("_cli_scaffold.py")]
        text = (tmp_path / label / name).read_text()
        # the timestamps differ by when each ran
        scripts[label] = re.sub(r"\d{14}_cli_scaffold", "<stamp>_cli_scaffold", re.sub(
            r"Created: .*", "Created: <date>", text))
    assert scripts["port"] == scripts["jax"].replace(
        "from anemoi_tpu.models.migrations", "from anemoi_tpu_torch.models.migrations")
    assert "Parent: 20260820120000_hierarchical_module_names" in scripts["port"]


def test_scaffolded_script_round_trip(tmp_path):
    """create -> load -> migrate -> rollback with the port's registry."""
    n_before = len(migrations.MIGRATOR.migrations)
    path = migrations.create_migration_script("test_roundtrip", str(tmp_path))
    text = open(path).read()
    text = text.replace("    # ... edit config / metadata here ...", '    ckpt["marker"] = 1')
    text = text.replace('    ckpt = dict(ckpt)\n    return ckpt\n\n\n# Optional',
                        '    ckpt = dict(ckpt)\n    ckpt.pop("marker", None)\n    return ckpt\n'
                        '\n\n# Optional')
    open(path, "w").write(text)
    try:
        assert migrations.load_migration_scripts(str(tmp_path)) == [
            os.path.basename(path)[:-3]]
        name = migrations.MIGRATOR.migrations[-1].name
        migrated = migrations.MIGRATOR.migrate({"config": {}, "metadata": {}})
        assert migrated["marker"] == 1 and name in migrated["metadata"]["migrations"]
        rolled = migrations.MIGRATOR.rollback_to(migrated,
                                                 migrations.MIGRATOR.migrations[-2].name)
        assert "marker" not in rolled and name not in rolled["metadata"]["migrations"]
    finally:
        migrations.MIGRATOR.migrations = migrations.MIGRATOR.migrations[:n_before]


def test_migrator_semantics_match_jax():
    """Order, idempotence and rollback of a private registry, both packages."""
    logs = {}
    for label, cls in (("jax", jax_migrations.Migrator), ("port", migrations.Migrator)):
        mig = cls()

        @mig.register("001_rename")
        def rename(ckpt):
            ckpt = dict(ckpt)
            ckpt["new_name"] = ckpt.pop("old_name")
            return ckpt

        @rename.rollback
        def rename_down(ckpt):
            ckpt = dict(ckpt)
            ckpt["old_name"] = ckpt.pop("new_name")
            return ckpt

        @mig.register("002_scale")
        def scale(ckpt):
            return {**ckpt, "value": ckpt["value"] * 2}

        with pytest.raises(AssertionError):
            mig.register("000_early")
        new = mig.migrate({"old_name": 1, "value": 10, "metadata": {}})
        again = mig.migrate(new)
        with pytest.raises(RuntimeError, match="no rollback"):
            mig.rollback_to(new, "001_rename")
        scale.rollback(lambda ckpt: {**ckpt, "value": ckpt["value"] // 2})
        back = mig.rollback_to(new, "")
        logs[label] = (new, again, back)
    assert logs["port"] == logs["jax"]
    assert logs["port"][2] == {"old_name": 1, "value": 10, "metadata": {"migrations": []}}
