"""Checkpoints: the training state, and self-contained inference bundles.

Port of ``anemoi_tpu.training.checkpoint``.

- :class:`CheckpointManager` keeps the latest ``max_to_keep`` training
  checkpoints, each ``ckpt_<step>.pt``: a ``torch.save`` of the interface's
  float32 master weights, the optimizer's state (``torch.optim`` numbers its
  state by parameter order, and the trainer builds the optimizer from
  ``interface.parameters()`` in one fixed order), its update count and the
  step.  :meth:`CheckpointManager.restore` continues a run bit for bit on
  the CPU.
- :func:`save_inference_checkpoint` writes the JAX package's bundle layout:
  ``checkpoint.json`` (``config``, ``data_indices``, ``metadata`` with
  ``format_version``, ``migrations`` and ``provenance``),
  ``statistics.npz`` (``<dataset>|<statistic>``) and, in place of flax's
  ``params.msgpack``, ``params.pt``: the model's state dict with
  anemoi-core names in float32.  The bundle's ``config`` is the run's
  whole config, so a transport model's carries ``training.transport``: the
  objective, sampler, sampling steps, tendency and EDM settings that
  ``predict`` reads (``inference.transport_settings``), as the JAX bundle
  carries them.
- :func:`load_inference_checkpoint` reads the port's bundles and the JAX
  package's (``params.msgpack``, decoded by ``_msgpack.py`` and converted by
  ``models/port.py:state_dict_from_jax``), re-basing a bundle trained on
  model shards to the serving ranks (:func:`rebase_sharding`).  Migrations
  pending in a bundle (``models/migrations.py``) are applied as it loads,
  to the bundle and to the flax parameter tree, before the tree is mapped
  to the port's names, as the JAX package's loader applies them;
  ``cli checkpoint migrate`` writes them into the bundle.
"""

from __future__ import annotations

import json
import logging
import os
import platform
import re
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from anemoi_tpu_torch.models.migrations import MIGRATOR

# the registered migrations, in order; a bundle written now has applied them all
MIGRATION_NAMES = tuple(m.name for m in MIGRATOR.migrations)
FORMAT_VERSION = 1
LOGGER = logging.getLogger(__name__)
_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Save and restore the training state; keeps the latest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> list:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _CKPT.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, write: bool = True) -> None:
        """Save ``state``.  With ZeRO every rank must call it (the optimizer
        state is gathered first, JAX ``fetch_replicated``); only the one
        with ``write`` (rank 0) writes."""
        payload = {
            "step": int(state.step),
            "model": {k: v.detach().cpu() for k, v in state.interface.state_dict().items()},
            "optimizer": state.optimizer.state_dict(),
            "optimizer_count": int(state.optimizer.count),
        }
        if not write:
            return
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[: -self.max_to_keep] if self.max_to_keep > 0 else []:
            os.remove(self._path(old))

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place; returns it, or None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = torch.load(self._path(step), map_location=state.interface.device,
                             weights_only=True)
        state.interface.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.optimizer.count = int(payload["optimizer_count"])
        state.step = int(payload["step"])
        return state


def provenance() -> Dict[str, Any]:
    info = {
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "packages": {"torch": torch.__version__, "numpy": np.__version__},
    }
    if torch.cuda.is_available():
        info["devices"] = {"backend": "cuda", "count": torch.cuda.device_count(),
                           "kind": torch.cuda.get_device_name(0)}
    return info


def save_inference_checkpoint(
    path: str,
    state_dict: Dict[str, torch.Tensor],
    config: dict,
    data_indices_config: Dict[str, dict],
    statistics: Dict[str, Dict[str, np.ndarray]],
    metadata: Optional[dict] = None,
) -> None:
    """Write a self-contained inference bundle.  ``state_dict``: the
    model's parameters with anemoi-core names (``model.``-prefixed, as the
    interface holds them), saved in float32."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().float().cpu() for k, v in state_dict.items()},
               os.path.join(path, "params.pt"))
    np.savez(
        os.path.join(path, "statistics.npz"),
        **{f"{ds}|{key}": arr for ds, stats in statistics.items() for key, arr in stats.items()},
    )
    md = dict(metadata or {})
    md.setdefault("provenance", provenance())
    md.setdefault("format_version", FORMAT_VERSION)
    bundle = MIGRATOR.migrate({"config": config, "data_indices": data_indices_config,
                               "metadata": md})
    with open(os.path.join(path, "checkpoint.json"), "w") as f:
        json.dump(bundle, f, default=str)


def pending_migrations(bundle: dict) -> list:
    return [m.name for m in MIGRATOR.pending(bundle)]


def rebase_sharding(config: dict, mesh=None) -> dict:
    """Reconcile a bundle's ``shard_strategy`` / ``num_model_shards`` (how it
    was trained, not part of its math) with the serving ranks (JAX
    ``load_inference_checkpoint``): without a model group of more than one
    rank it serves on one device, with a warning; with one, the shards
    re-base to that group's size."""
    mcfg = config.setdefault("model", {})
    shards = int(mcfg.get("num_model_shards", 1))
    if str(mcfg.get("shard_strategy", "none")) == "none" and shards <= 1:
        return config
    size = mesh.size("model") if mesh is not None else 1
    if size <= 1:
        LOGGER.warning("checkpoint was trained with shard_strategy=%s (num_model_shards=%s) but "
                       "no model group is active; serving on one device. For sharded serving, "
                       "load the bundle with the mesh of the serving ranks.",
                       mcfg.get("shard_strategy", "none"), shards)
        mcfg["shard_strategy"] = "none"
        mcfg.pop("num_model_shards", None)
    else:
        if shards != size:
            LOGGER.warning("re-basing num_model_shards %s -> %s to match the active model group",
                           shards, size)
        mcfg["num_model_shards"] = size
    return config


def load_inference_checkpoint(path: str, device: torch.device | str | None = None, mesh=None):
    """Rebuild the ``AnemoiModelInterface`` of a bundle (the port's or the
    JAX package's) on ``device`` (default: the CUDA card), serving in the
    config's ``inference_precision``: the float32 parameters are cast once,
    as they load.  With a ``mesh`` (``parallel/mesh.py``) whose model group
    has more than one rank the bundle serves sharded over it
    (:func:`rebase_sharding`)."""
    from anemoi_tpu_torch.data_indices.collection import IndexCollection
    from anemoi_tpu_torch.graphs.create import GraphCreator
    from anemoi_tpu_torch.graphs.graph import Graph
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface

    with open(os.path.join(path, "checkpoint.json")) as f:
        bundle = json.load(f)
    torch_params = os.path.join(path, "params.pt")
    raw_params = None
    if os.path.exists(torch_params):
        bundle = MIGRATOR.migrate(bundle)
    else:
        from anemoi_tpu_torch.training._msgpack import msgpack_restore

        with open(os.path.join(path, "params.msgpack"), "rb") as f:
            raw_params = msgpack_restore(f.read())
        # pending format migrations, on the bundle and on the flax tree,
        # before the tree is mapped to the port's names
        bundle, raw_params = MIGRATOR.migrate(bundle, raw_params)
    stats_flat = np.load(os.path.join(path, "statistics.npz"))
    statistics: Dict[str, Dict[str, np.ndarray]] = {}
    for key in stats_flat.files:
        ds, stat = key.split("|")
        statistics.setdefault(ds, {})[stat] = stats_flat[key]
    data_indices = {
        ds: IndexCollection(
            {k: int(v) for k, v in di["name_to_index"].items()},
            forcing=di.get("forcing"), diagnostic=di.get("diagnostic"), target=di.get("target"),
        )
        for ds, di in bundle["data_indices"].items()
    }
    config = rebase_sharding(bundle["config"], mesh)
    graph_cfg = config.get("graph", {})
    graph_path = graph_cfg.get("save_path")
    if graph_path and os.path.exists(graph_path):
        graph = Graph.load(graph_path)
    else:
        graph = GraphCreator(graph_cfg.get("recipe", graph_cfg)).create()
    iface = AnemoiModelInterface(
        config=config, graph=graph, data_indices=data_indices, statistics=statistics,
        metadata=bundle.get("metadata"), device=device, mesh=mesh, initialise=False,
    )
    if raw_params is None:
        state_dict = torch.load(torch_params, map_location="cpu", weights_only=True)
    else:
        from anemoi_tpu_torch.models.port import state_dict_from_jax

        state_dict = state_dict_from_jax(raw_params, sorted(data_indices))
    iface.load_state_dict(state_dict, strict=True)
    return iface
