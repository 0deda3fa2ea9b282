"""Versioned checkpoint migrations.

Copy of ``anemoi_tpu.models.migrations``: ordered migration steps with
forward and rollback transforms, the applied list stored in the bundle's
``metadata.migrations``, so that old bundles load on new code.  The
parameter transforms act on the JAX package's flax parameter tree as nested
dicts of numpy arrays, which ``training/_msgpack.msgpack_restore`` yields;
``training/checkpoint.load_inference_checkpoint`` runs them before
``models/port.py:state_dict_from_jax`` maps the tree to the port's names.

A migration is registered with a monotonically increasing id:

    @register_migration("1700000001_rename_mlp")
    def _m(ckpt):  # forward
        ...
    @_m.rollback
    def _m_down(ckpt):
        ...

Scripts scaffolded by :func:`create_migration_script` live in
``anemoi_tpu_torch/models/migration_scripts/`` and import the port's
``register_migration``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class Migration:
    name: str
    forward: Callable[[dict], dict]
    rollback_fn: Optional[Callable[[dict], dict]] = None
    # optional parameter-tree transform (raw state dict, ckpt bundle) -> state
    # dict; applied by ``migrate`` when params are supplied at load time.
    params_fn: Optional[Callable[[dict, dict], dict]] = None

    def rollback(self, fn: Callable[[dict], dict]) -> Callable:
        """Decorator registering the down-migration."""
        self.rollback_fn = fn
        return fn

    def params(self, fn: Callable[[dict, dict], dict]) -> Callable:
        """Decorator registering the parameter-tree transform."""
        self.params_fn = fn
        return fn


class Migrator:
    """Holds the ordered migration list and applies the missing ones."""

    def __init__(self) -> None:
        self.migrations: List[Migration] = []

    def register(self, name: str) -> Callable:
        assert not self.migrations or name > self.migrations[-1].name, (
            "migration names must be registered in increasing order "
            f"('{name}' after '{self.migrations[-1].name if self.migrations else ''}')"
        )

        def deco(fn: Callable[[dict], dict]) -> Migration:
            mig = Migration(name=name, forward=fn)
            self.migrations.append(mig)
            return mig

        return deco

    def applied(self, ckpt: dict) -> List[str]:
        return list(ckpt.get("metadata", {}).get("migrations", []))

    def pending(self, ckpt: dict) -> List[Migration]:
        done = set(self.applied(ckpt))
        return [m for m in self.migrations if m.name not in done]

    def migrate(self, ckpt: dict, params: Optional[dict] = None):
        """Apply all pending migrations in order; records the applied list.

        With ``params`` (a raw flax state dict) the registered params
        transforms run too and ``(ckpt, params)`` is returned; without,
        only the bundle is migrated and returned (save-time stamping)."""
        ckpt = dict(ckpt)
        done = list(ckpt.get("metadata", {}).get("migrations", []))
        for mig in self.pending(ckpt):
            ckpt = mig.forward(ckpt)
            if params is not None and mig.params_fn is not None:
                params = mig.params_fn(params, ckpt)
            done.append(mig.name)
        meta = dict(ckpt.get("metadata", {}))  # after: migrations may edit it
        meta["migrations"] = done
        ckpt["metadata"] = meta
        return ckpt if params is None else (ckpt, params)

    def rollback_to(self, ckpt: dict, target: str) -> dict:
        """Undo migrations applied after ``target`` (inclusive order)."""
        ckpt = dict(ckpt)
        meta = dict(ckpt.get("metadata", {}))
        done = list(meta.get("migrations", []))
        by_name = {m.name: m for m in self.migrations}
        while done and done[-1] > target:
            name = done.pop()
            mig = by_name.get(name)
            if mig is None or mig.rollback_fn is None:
                raise RuntimeError(f"migration '{name}' has no rollback")
            ckpt = mig.rollback_fn(ckpt)
        meta["migrations"] = done
        ckpt["metadata"] = meta
        return ckpt


# The framework-global migrator; future format changes register here.
MIGRATOR = Migrator()
register_migration = MIGRATOR.register


@register_migration("20260817000000_initial_format")
def _initial(ckpt: dict) -> dict:
    """Format version stamp for round-1 checkpoints (no-op transform)."""
    meta = dict(ckpt.get("metadata", {}))
    meta.setdefault("format_version", 1)
    ckpt = dict(ckpt)
    ckpt["metadata"] = meta
    return ckpt


@_initial.rollback
def _initial_down(ckpt: dict) -> dict:
    meta = dict(ckpt.get("metadata", {}))
    meta.pop("format_version", None)
    ckpt = dict(ckpt)
    ckpt["metadata"] = meta
    return ckpt


# ----------------------------------------------------------------------
# 20260817120000: processors moved from per-layer modules (blocks_0,
# blocks_1, ...) to an nn.scan over stacked parameters (blocks/block/...,
# leading axis = layer).  Checkpoints saved before the scan refactor carry
# the per-layer layout; this stacks them into the scan layout.
#
# GNN processors keep blocks_0 as a standalone module even under scan
# (its edge-embedding input width differs), so only blocks_1.. are
# stacked for them; all other processors stack every layer.
# ----------------------------------------------------------------------

_KEEP_FIRST_PREFIXES = ("GNNProcessor",)
_STACK_PREFIXES = (
    "GNNProcessor",
    "GraphTransformerProcessor",
    "TransformerProcessor",
    "PointWiseMLPProcessor",
)


def _stack_trees(trees: List[dict]):
    """Stack identically-structured nested dicts of arrays on a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        assert all(sorted(t.keys()) == sorted(first.keys()) for t in trees)
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees], axis=0)


def _stack_blocks(module: dict, keep_first: bool) -> dict:
    nums = sorted(
        int(k.split("_", 1)[1]) for k in module if k.startswith("blocks_")
    )
    assert nums == list(range(len(nums))), f"non-consecutive blocks: {nums}"
    start = 1 if keep_first else 0
    stacked = _stack_trees([module[f"blocks_{i}"] for i in range(start, len(nums))])
    new = {k: v for k, v in module.items() if not k.startswith("blocks_")}
    if keep_first:
        new["blocks_0"] = module["blocks_0"]
    new["blocks"] = {"block": stacked}
    return new


@register_migration("20260817120000_stack_processor_scan")
def _stack_scan(ckpt: dict) -> dict:
    return ckpt  # bundle unchanged; the work is in the params transform


@_stack_scan.params
def _stack_scan_params(params: dict, ckpt: dict) -> dict:
    def has_explicit_noscan(cfg) -> bool:
        if isinstance(cfg, dict):
            if cfg.get("scan_layers") is False:
                return True
            return any(has_explicit_noscan(v) for v in cfg.values())
        return False

    # a checkpoint whose config explicitly opts out of nn.scan will be
    # rebuilt with per-layer modules — leave its params per-layer too
    if has_explicit_noscan(ckpt.get("config", {}).get("model", {})):
        return params

    def walk(tree: dict, name: str = "") -> dict:
        if not isinstance(tree, dict):
            return tree
        is_prescan_proc = (
            name.rsplit("_", 1)[0] in _STACK_PREFIXES
            and "blocks_1" in tree
            and "blocks" not in tree
        )
        if is_prescan_proc:
            keep_first = name.rsplit("_", 1)[0] in _KEEP_FIRST_PREFIXES
            tree = _stack_blocks(tree, keep_first=keep_first)
        return {k: walk(v, k) for k, v in tree.items()}

    return walk(params)


@_stack_scan.rollback
def _stack_scan_down(ckpt: dict) -> dict:
    return ckpt


# ----------------------------------------------------------------------
# 20260820120000: the hierarchical model's sub-modules moved from flax
# auto-names (GraphTransformerForwardMapper_0, _1, ... in call order) to
# stable explicit names (encoder_<ds>, down_<level>, proc_down_<level>,
# processor, up_<level>, proc_up_<level>, decoder_<ds>) so reference
# checkpoints port deterministically.  This renames old hierarchical
# checkpoints into the explicit layout.
# ----------------------------------------------------------------------


def _hier_rename_map(ckpt: dict) -> Dict[str, str]:
    """old auto-name -> new explicit name for one hierarchical checkpoint."""
    mcfg = ckpt.get("config", {}).get("model", {})
    datasets = sorted(ckpt.get("data_indices", {}).keys()) or ["data"]
    levels = list(mcfg.get("hidden_names") or [])
    if not levels:
        # hidden_names may be inferred from the graph at build time; the
        # trainable_parameters table carries the same level keys
        levels = sorted(
            (k for k in (mcfg.get("trainable_parameters") or {})
             if str(k).startswith("hidden")),
            key=lambda s: int(s.split("_")[1]) if "_" in s else 1,
        )
    if not levels:
        return {}
    L, ren = len(levels), {}
    enc_cls = str(mcfg.get("encoder", {}).get("name", "GraphTransformerForwardMapper"))
    dec_cls = str(mcfg.get("decoder", {}).get("name", "GraphTransformerBackwardMapper"))
    proc_cls = str(mcfg.get("processor", {}).get("name", "GraphTransformerProcessor"))
    # encoders per sorted dataset, then one down-mapper per non-deepest level
    for j, ds in enumerate(datasets):
        ren[f"{enc_cls}_{j}"] = f"encoder_{ds}"
    for i in range(L - 1):
        ren[f"{enc_cls}_{len(datasets) + i}"] = f"down_{levels[i]}"
    # processors: down the levels (deepest = main), then back up
    for i in range(L):
        ren[f"{proc_cls}_{i}"] = (
            "processor" if i == L - 1 else f"proc_down_{levels[i]}"
        )
    for j, i in enumerate(range(L - 2, -1, -1)):
        ren[f"{proc_cls}_{L + j}"] = f"proc_up_{levels[i]}"
    # up-mappers (decoder class) in up-loop order, then final decoders
    for j, i in enumerate(range(L - 2, -1, -1)):
        ren[f"{dec_cls}_{j}"] = f"up_{levels[i + 1]}"
    for j, ds in enumerate(datasets):
        ren[f"{dec_cls}_{L - 1 + j}"] = f"decoder_{ds}"
    return ren


def _is_hierarchical(ckpt: dict) -> bool:
    return "Hierarchical" in str(
        ckpt.get("config", {}).get("model", {}).get("name", "")
    )


@register_migration("20260820120000_hierarchical_module_names")
def _hier_names(ckpt: dict) -> dict:
    return ckpt  # bundle unchanged; the params transform does the work


@_hier_names.params
def _hier_names_params(params: dict, ckpt: dict) -> dict:
    if not _is_hierarchical(ckpt):
        return params
    ren = _hier_rename_map(ckpt)
    container = params.get("params", params)
    renamed = {ren.get(k, k): v for k, v in container.items()}
    if "params" in params:
        return {**params, "params": renamed}
    return renamed


@_hier_names.rollback
def _hier_names_down(ckpt: dict) -> dict:
    return ckpt


# ----------------------------------------------------------------------
# Timestamped migration scripts: standalone scripts live in
# anemoi_tpu_torch/models/migration_scripts/ and are imported in name order
# below, AFTER the built-in migrations above, so that a script's
# registration order is its timestamp order.
# ----------------------------------------------------------------------

_SCRIPT_TEMPLATE = '''"""Migration: {label}

Created: {date}
Parent: {parent}
Signature: {signature}
"""

from anemoi_tpu_torch.models.migrations import register_migration


@register_migration("{name}")
def forward(ckpt: dict) -> dict:
    """Transform the checkpoint bundle to the new format."""
    ckpt = dict(ckpt)
    # ... edit config / metadata here ...
    return ckpt


@forward.rollback
def rollback(ckpt: dict) -> dict:
    """Undo ``forward`` (required for `checkpoint migrate --rollback`)."""
    ckpt = dict(ckpt)
    return ckpt


# Optional: transform the raw parameter tree at load time.
# @forward.params
# def params(params: dict, ckpt: dict) -> dict:
#     return params
'''


def scripts_dir() -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "migration_scripts")


def create_migration_script(label: str, directory: Optional[str] = None) -> str:
    """Scaffold a timestamped migration script: the filename/registration
    name is ``<UTC timestamp>_<label>``, the docstring records the parent
    migration and a lineage signature (sha256 over the ordered names up to
    the parent) so tampering with migration order is detectable."""
    import hashlib
    import os
    import re
    import time

    assert re.fullmatch(r"[a-z0-9_]+", label), (
        "migration label must be lowercase [a-z0-9_]"
    )
    directory = directory or scripts_dir()
    os.makedirs(directory, exist_ok=True)
    init = os.path.join(directory, "__init__.py")
    if not os.path.exists(init):
        with open(init, "w") as f:
            f.write("")
    stamp = time.strftime("%Y%m%d%H%M%S", time.gmtime())
    name = f"{stamp}_{label}"
    parent = MIGRATOR.migrations[-1].name if MIGRATOR.migrations else "<none>"
    lineage = ",".join(m.name for m in MIGRATOR.migrations)
    signature = hashlib.sha256(lineage.encode()).hexdigest()[:16]
    path = os.path.join(directory, f"{name}.py")
    assert not os.path.exists(path), f"{path} already exists"
    with open(path, "w") as f:
        f.write(
            _SCRIPT_TEMPLATE.format(
                label=label, name=name, parent=parent, signature=signature,
                date=time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime()),
            )
        )
    return path


def load_migration_scripts(directory: Optional[str] = None) -> List[str]:
    """Import every script in the scripts directory in name (= timestamp)
    order, registering its migrations; returns the loaded names."""
    import importlib.util
    import os

    directory = directory or scripts_dir()
    if not os.path.isdir(directory):
        return []
    loaded = []
    registered = {m.name for m in MIGRATOR.migrations}
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        name = fname[:-3]
        if name in registered:
            continue
        spec = importlib.util.spec_from_file_location(
            f"anemoi_tpu_torch.models.migration_scripts.{name}",
            os.path.join(directory, fname),
        )
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        loaded.append(name)
    return loaded


load_migration_scripts()
