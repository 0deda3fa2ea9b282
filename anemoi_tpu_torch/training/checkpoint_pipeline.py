"""Composable checkpoint-loading pipeline.

Port of ``anemoi_tpu.training.checkpoint_pipeline``:

    Source -> LoadingStrategy -> Modifier*

over a :class:`CheckpointContext` ``{params, opt_state, step, metadata}``.
Strategies: cold start, weights only (strict), warm start and transfer
learning (a tensor copied where name and shape match); the ``freeze``
modifier marks parameters whose updates the trainer zeroes.

The port works on the model's state dict (anemoi-core names,
``model.``-prefixed, as ``AnemoiModelInterface.state_dict`` holds them), not
on a flax tree: ``params`` is ``{name: tensor}``, a component is the first
name after ``model.`` (``encoder``, ``processor``, ``decoder``,
``node_attributes``, ...) and ``freeze``'s substrings match the dotted
names.  The ``local`` source reads the port's bundles (``params.pt``) and
the JAX package's (``params.msgpack``: its pending migrations applied, then
``models/port.py:state_dict_from_jax``), a state dict or training
checkpoint saved with ``torch.save``, or a flax ``.msgpack`` of a model.
Stage configs name their component by ``name`` from :data:`SOURCES`,
:data:`STRATEGIES` and :data:`MODIFIERS`.
The ``http`` and ``s3`` sources download into a cache directory first
(``s3`` needs boto3, imported when it runs).

Config (``training.checkpoint_pipeline``)::

    [{"stage": "source", "name": "local", "path": ...},
     {"stage": "loading", "name": "transfer_learning"},
     {"stage": "modifier", "name": "freeze", "submodules": ["encoder"]}]
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

LOGGER = logging.getLogger(__name__)


# the pipeline's components by stage kind: name -> class
SOURCES: Dict[str, Callable] = {}
STRATEGIES: Dict[str, Callable] = {}
MODIFIERS: Dict[str, Callable] = {}


def _register(table: Dict[str, Callable], name: str) -> Callable:
    def deco(cls):
        table[name] = cls
        return cls

    return deco


# --- structured exceptions ---------------------------------------------
class CheckpointError(Exception):
    """Base checkpoint error carrying structured details."""

    def __init__(self, message: str, details: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.details = dict(details or {})

    def __str__(self) -> str:  # message + compact details, greppable
        base = super().__str__()
        if self.details:
            extras = ", ".join(f"{k}={v!r}" for k, v in self.details.items())
            return f"{base} ({extras})"
        return base


class CheckpointNotFoundError(CheckpointError):
    """The requested checkpoint path/URL/object does not exist."""


class CheckpointLoadError(CheckpointError):
    """The checkpoint exists but could not be deserialised."""


class CheckpointIncompatibleError(CheckpointError):
    """The checkpoint does not fit the target model (strict loading)."""


class CheckpointConfigError(CheckpointError):
    """The pipeline configuration itself is invalid (bad stage order,
    unknown component, missing required stage)."""


class CheckpointSourceError(CheckpointError):
    """A source stage failed to fetch (network/credentials/IO)."""


class CheckpointValidationError(CheckpointError):
    """Post-run pipeline health check failed; ``details['issues']`` lists
    each problem."""


def component_of(name: str) -> str:
    """``model.encoder.data.proc...`` -> ``encoder``."""
    parts = name.split(".")
    return parts[1] if parts[0] == "model" and len(parts) > 1 else parts[0]


class ComponentCatalog:
    """The component tables as the catalog of the pipeline, and the
    per-component transfer report."""

    @staticmethod
    def list_sources() -> List[str]:
        return sorted(SOURCES)

    @staticmethod
    def list_loaders() -> List[str]:
        return sorted(STRATEGIES)

    @staticmethod
    def list_modifiers() -> List[str]:
        return sorted(MODIFIERS)

    @staticmethod
    def transfer_report(target_params: Dict[str, torch.Tensor],
                        source_params: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
        """For each top-level component of the target state dict: how many
        tensors match the checkpoint's exactly, which differ in shape, which
        the checkpoint lacks, and which checkpoint tensors have no target."""
        report: Dict[str, Dict[str, Any]] = {}

        def entry(comp: str) -> Dict[str, Any]:
            return report.setdefault(comp, {"matched": 0, "shape_mismatch": [],
                                            "missing_in_checkpoint": [],
                                            "unused_in_model": []})

        for name, value in target_params.items():
            comp = entry(component_of(name))
            sv = source_params.get(name)
            if sv is None:
                comp["missing_in_checkpoint"].append(name)
            elif tuple(sv.shape) != tuple(value.shape):
                comp["shape_mismatch"].append({"path": name, "model": list(value.shape),
                                               "checkpoint": list(sv.shape)})
            else:
                comp["matched"] += 1
        for name in source_params:
            if name not in target_params:
                entry(component_of(name))["unused_in_model"].append(name)
        return report


@dataclass
class CheckpointContext:
    """State threaded through the pipeline."""

    params: Dict[str, torch.Tensor]  # the target model's state dict
    opt_state: Any = None
    step: int = 0
    loaded: Optional[Dict] = None  # what the source read: params[, opt_state, step]
    trainable_mask: Optional[Dict[str, bool]] = None  # name -> trainable
    metadata: Dict = field(default_factory=dict)


# --- sources -----------------------------------------------------------
def _bundle_state_dict(directory: str, bundle: Optional[dict]) -> Dict[str, torch.Tensor]:
    """The state dict of a bundle directory of either package."""
    torch_params = os.path.join(directory, "params.pt")
    if os.path.exists(torch_params):
        return torch.load(torch_params, map_location="cpu", weights_only=True)
    path = os.path.join(directory, "params.msgpack")
    if not os.path.exists(path):
        raise CheckpointNotFoundError(
            "directory is not an inference bundle (no params.pt or params.msgpack)",
            {"path": directory})
    from anemoi_tpu_torch.models.migrations import MIGRATOR

    raw = _read_msgpack(path)
    datasets = ("data",)
    if bundle is not None:
        bundle, raw = MIGRATOR.migrate(bundle, raw)
        datasets = tuple(sorted(bundle.get("data_indices") or {"data": None}))
    return _from_jax(raw, datasets, path)


def _read_msgpack(path: str):
    from anemoi_tpu_torch.training._msgpack import msgpack_restore

    with open(path, "rb") as f:
        blob = f.read()
    try:
        return msgpack_restore(blob)
    except Exception as err:
        raise CheckpointLoadError("could not deserialise checkpoint",
                                  {"path": path, "error": str(err)}) from err


def _from_jax(tree, datasets, path: str) -> Dict[str, torch.Tensor]:
    from anemoi_tpu_torch.models.port import state_dict_from_jax

    try:
        return state_dict_from_jax(tree, datasets)
    except Exception as err:
        raise CheckpointLoadError("the flax tree does not map to the port's names",
                                  {"path": path, "error": str(err)}) from err


def _load_file(path: str) -> Dict[str, Any]:
    """A file checkpoint: a ``torch.save`` of a state dict or of the
    trainer's checkpoint (``model``, ``optimizer``, ``step``), or the flax
    ``.msgpack`` of a model of one dataset ``data``."""
    if path.endswith(".msgpack"):
        return {"params": _from_jax(_read_msgpack(path), ("data",), path)}
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as err:
        raise CheckpointLoadError("could not deserialise checkpoint",
                                  {"path": path, "error": str(err)}) from err
    if isinstance(payload, dict) and "model" in payload and "step" in payload:
        return {"params": payload["model"], "opt_state": payload.get("optimizer"),
                "step": int(payload["step"])}
    return {"params": payload}


@_register(SOURCES, "local")
class LocalSource:
    """A bundle directory of either package, or a checkpoint file."""

    def __init__(self, path: str):
        self.path = path

    def __call__(self, ctx: CheckpointContext) -> CheckpointContext:
        path = self.path
        if not os.path.exists(path):
            raise CheckpointNotFoundError("checkpoint path does not exist", {"path": path})
        if os.path.isdir(path):  # inference bundle directory
            bundle = None
            meta_path = os.path.join(path, "checkpoint.json")
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    bundle = json.load(f)
                # the variable order the bundle recorded, for CheckVariableOrder
                n2i = {ds: di.get("name_to_index")
                       for ds, di in bundle.get("data_indices", {}).items()}
                if any(n2i.values()):
                    ctx.metadata["name_to_index"] = n2i
                # the bundle's metadata (provenance, variables_metadata) for
                # the compatibility checks
                if bundle.get("metadata"):
                    ctx.metadata["bundle_metadata"] = bundle["metadata"]
            ctx.loaded = {"params": _bundle_state_dict(path, bundle)}
        else:
            ctx.loaded = _load_file(path)
        ctx.metadata["source"] = self.path
        return ctx


def _cache_dir(cache_dir: Optional[str]) -> str:
    return cache_dir or os.path.join(tempfile.gettempdir(), "anemoi_tpu_torch_ckpt_cache")


@_register(SOURCES, "http")
class HTTPSource:
    """Download a checkpoint file over HTTP into the cache, then load it."""

    def __init__(self, url: str, cache_dir: Optional[str] = None):
        self.url = url
        self.cache_dir = _cache_dir(cache_dir)

    def __call__(self, ctx: CheckpointContext) -> CheckpointContext:
        import urllib.request

        os.makedirs(self.cache_dir, exist_ok=True)
        local = os.path.join(self.cache_dir, os.path.basename(self.url))
        if not os.path.exists(local):
            try:
                urllib.request.urlretrieve(self.url, local)  # noqa: S310
            except OSError as err:
                raise CheckpointSourceError("download failed",
                                            {"url": self.url, "error": str(err)}) from err
        return LocalSource(local)(ctx)


@_register(SOURCES, "s3")
class S3Source:
    """Download a checkpoint object from S3 (boto3) into the cache."""

    def __init__(self, bucket: str, key: str, cache_dir: Optional[str] = None):
        self.bucket, self.key, self.cache_dir = bucket, key, _cache_dir(cache_dir)

    def __call__(self, ctx: CheckpointContext) -> CheckpointContext:
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise ImportError("the s3 checkpoint source needs the boto3 package") from e
        os.makedirs(self.cache_dir, exist_ok=True)
        local = os.path.join(self.cache_dir, os.path.basename(self.key))
        if not os.path.exists(local):
            boto3.client("s3").download_file(self.bucket, self.key, local)
        return LocalSource(local)(ctx)


# --- loading strategies ------------------------------------------------
@_register(STRATEGIES, "cold_start")
class ColdStart:
    def __call__(self, ctx: CheckpointContext) -> CheckpointContext:
        return ctx  # keep the freshly initialised parameters


@_register(STRATEGIES, "weights_only")
class WeightsOnly:
    """Load the weights; the optimizer starts afresh."""

    def __init__(self, strict: bool = True):
        self.strict = strict

    def __call__(self, ctx: CheckpointContext) -> CheckpointContext:
        if ctx.loaded is None:
            raise CheckpointConfigError("weights_only needs a source stage first")
        if self.strict:
            report = ComponentCatalog.transfer_report(ctx.params, ctx.loaded["params"])
            bad = {comp: r for comp, r in report.items()
                   if r["shape_mismatch"] or r["missing_in_checkpoint"]}
            if bad:
                raise CheckpointIncompatibleError(
                    "checkpoint does not fit the model (use transfer_learning for partial "
                    "loads)", {"report": bad})
        ctx.params = dict(ctx.loaded["params"])
        ctx.metadata["loading"] = "weights_only"
        return ctx


@_register(STRATEGIES, "warm_start")
class WarmStart:
    """Load the weights, the optimizer state and the step, where the
    checkpoint has them."""

    def __call__(self, ctx: CheckpointContext) -> CheckpointContext:
        if ctx.loaded is None:
            raise CheckpointConfigError("warm_start needs a source stage first")
        ctx.params = dict(ctx.loaded["params"])
        if "opt_state" in ctx.loaded:
            ctx.opt_state = ctx.loaded["opt_state"]
        ctx.step = int(ctx.loaded.get("step", ctx.step))
        ctx.metadata["loading"] = "warm_start"
        return ctx


@_register(STRATEGIES, "transfer_learning")
class TransferLearning:
    """Partial load: copy the tensors whose name AND shape match; the rest
    keep their fresh initialisation."""

    def __call__(self, ctx: CheckpointContext) -> CheckpointContext:
        if ctx.loaded is None:
            raise CheckpointConfigError("transfer_learning needs a source stage first")
        source = ctx.loaded["params"]
        copied, skipped, merged = 0, [], {}
        for name, value in ctx.params.items():
            sv = source.get(name)
            if sv is not None and tuple(sv.shape) == tuple(value.shape):
                merged[name] = sv
                copied += 1
            else:
                merged[name] = value
                skipped.append(name)
        ctx.params = merged
        ctx.metadata["loading"] = "transfer_learning"
        ctx.metadata["transfer_copied"] = copied
        ctx.metadata["transfer_skipped"] = skipped
        ctx.metadata["transfer_report"] = ComponentCatalog.transfer_report(merged, source)
        return ctx


# --- modifiers ---------------------------------------------------------
@_register(MODIFIERS, "freeze")
class FreezingModifier:
    """Freeze the parameters whose name contains one of ``submodules``:
    ``trainable_mask`` (name -> trainable), whose frozen entries the trainer
    gives a zero update (``Optimizer.freeze``)."""

    def __init__(self, submodules: List[str]):
        self.submodules = list(submodules)

    def __call__(self, ctx: CheckpointContext) -> CheckpointContext:
        ctx.trainable_mask = {name: not any(sub in name for sub in self.submodules)
                              for name in ctx.params}
        ctx.metadata["frozen_submodules"] = self.submodules
        return ctx


class CheckpointPipeline:
    """Ordered stages applied to a context; sources before strategies
    before modifiers."""

    ORDER = {"source": 0, "loading": 1, "modifier": 2}
    TABLES = {"source": SOURCES, "loading": STRATEGIES, "modifier": MODIFIERS}

    def __init__(self, stage_configs: List[dict]):
        self.stages = []
        kinds = []
        last = -1
        for i, cfg in enumerate(stage_configs):
            cfg = dict(cfg)
            kind = cfg.pop("stage", None)
            if kind not in self.ORDER:
                raise CheckpointConfigError(f"unknown stage kind '{kind}'",
                                            {"position": i, "valid": sorted(self.ORDER)})
            if self.ORDER[kind] < last:
                raise CheckpointConfigError(
                    f"invalid stage order: '{kind}' cannot follow a later stage (sources -> "
                    "loading -> modifiers)",
                    {"position": i, "stages": [c.get("stage") for c in stage_configs]})
            last = self.ORDER[kind]
            table = self.TABLES[kind]
            name = cfg.pop("name", None)
            if name not in table:
                raise CheckpointConfigError(f"unknown {kind} component '{name}'",
                                            {"available": sorted(table)})
            kinds.append(kind)
            self.stages.append((kind, str(name), table[name](**cfg)))
        # a strategy other than cold_start needs a source stage
        needs_source = any(c.get("stage") == "loading" and c.get("name") != "cold_start"
                           for c in stage_configs)
        if needs_source and "source" not in kinds:
            raise CheckpointConfigError("loading strategy requires a source stage before it",
                                        {"stages": [c.get("stage") for c in stage_configs]})

    def run(self, ctx: CheckpointContext) -> CheckpointContext:
        for i, (kind, name, stage) in enumerate(self.stages):
            marker = f"stage_{i}_{kind}"
            try:
                ctx = stage(ctx)
            except Exception:
                ctx.metadata[marker] = f"{name}: failed"
                raise
            ctx.metadata[marker] = f"{name}: completed"
        return ctx


def validate_pipeline_health(ctx: CheckpointContext, *, raise_on_error: bool = True) -> bool:
    """Check that a finished pipeline left the context in a sane state:
    every ``stage_<i>_*`` marker records completion, a source stage implies
    a loaded payload and a loading strategy, no parameter is non-finite,
    and a trainable mask names exactly the parameters."""
    issues: List[str] = []
    markers = {k: v for k, v in ctx.metadata.items() if k.startswith("stage_")}
    if not ctx.metadata:
        issues.append("context metadata is empty; pipeline did not execute")
    for key, value in markers.items():
        if not isinstance(value, str):
            issues.append(f"stage entry {key!r} has non-string value {value!r}")
        elif "failed" in value:
            issues.append(f"stage {key!r} did not complete: {value}")
    if any("_source" in k for k in markers):
        if ctx.loaded is None and "loading" not in ctx.metadata:
            issues.append("a source stage executed but nothing was loaded")
        if not any("_loading" in k for k in markers):
            issues.append("a source stage executed without a loading strategy")
    if ctx.params is not None:
        bad = [name for name, t in ctx.params.items()
               if torch.is_tensor(t) and t.is_floating_point() and not bool(t.isfinite().all())]
        if bad:
            issues.append(f"non-finite params after loading: {bad[:5]}")
    if ctx.trainable_mask is not None and set(ctx.trainable_mask) != set(ctx.params or {}):
        issues.append("trainable_mask tree structure does not match params")
    if not issues:
        return True
    if raise_on_error:
        raise CheckpointValidationError("pipeline health check failed", {"issues": issues})
    LOGGER.warning("pipeline health check found %d issue(s): %s", len(issues), issues)
    return False
