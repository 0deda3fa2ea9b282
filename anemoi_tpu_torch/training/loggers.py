"""Experiment loggers.

Port of ``anemoi_tpu.training.loggers``: the common interface; the JSONL
file logger, which is always on (``experiment.jsonl`` in the run
directory); ``mlflow_offline``, which writes MLflow's FileStore layout under
``<output_dir>/mlruns`` with no mlflow package (``training/mlflow_store.py``:
provenance tags, a system-metrics monitor, ``cli mlflow sync`` pushes it to
a server later); and the ``mlflow`` and ``wandb`` loggers, which import
their packages when they are built and raise ``ImportError`` naming the
package where it is missing.  As in the JAX package, ``build_loggers``
falls back from ``mlflow`` to ``mlflow_offline`` when mlflow is missing,
and logs and skips ``wandb``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

LOGGER = logging.getLogger(__name__)


class BaseLogger:
    def log_params(self, params: Dict[str, Any]) -> None: ...

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None: ...

    def finalize(self) -> None: ...


class JsonlLogger(BaseLogger):
    def __init__(self, output_dir: str, filename: str = "experiment.jsonl", **_):
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(os.path.join(output_dir, filename), "a")

    def log_params(self, params):
        self._f.write(json.dumps({"type": "params", "params": params}, default=str) + "\n")
        self._f.flush()

    def log_metrics(self, metrics, step):
        self._f.write(
            json.dumps({"type": "metrics", "step": step, "time": time.time(), **metrics},
                       default=float)
            + "\n"
        )
        self._f.flush()

    def finalize(self):
        self._f.close()


class MLflowLogger(BaseLogger):
    """The mlflow package's client (online, or a ``file://`` store with
    ``offline``)."""

    def __init__(self, output_dir: str, tracking_uri: Optional[str] = None,
                 experiment: str = "anemoi-tpu", run_name: Optional[str] = None,
                 offline: bool = False, **_):
        try:
            import mlflow  # type: ignore
        except ImportError as e:
            raise ImportError("MLflowLogger needs the mlflow package; the mlflow_offline "
                              "logger writes the same runs without it") from e
        self.mlflow = mlflow
        uri = tracking_uri or (f"file://{os.path.abspath(output_dir)}/mlruns" if offline else None)
        if uri:
            mlflow.set_tracking_uri(uri)
        mlflow.set_experiment(experiment)
        self._run = mlflow.start_run(run_name=run_name)

    def log_params(self, params):
        flat = _flatten(params)
        for i in range(0, len(flat), 90):  # mlflow caps the params of one call
            self.mlflow.log_params(dict(list(flat.items())[i : i + 90]))

    def log_metrics(self, metrics, step):
        self.mlflow.log_metrics({k.replace("/", "."): float(v) for k, v in metrics.items()},
                                step=step)

    def finalize(self):
        self.mlflow.end_run()


class OfflineMLflowLogger(BaseLogger):
    """MLflow FileStore runs under ``<output_dir>/mlruns`` with no mlflow
    package; ``cli mlflow sync`` pushes them to a tracking server."""

    def __init__(self, output_dir: str, experiment: str = "anemoi-tpu",
                 run_name: Optional[str] = None, system_metrics: bool = True,
                 system_metrics_interval_s: float = 30.0, **_):
        from anemoi_tpu_torch.training.checkpoint import provenance
        from anemoi_tpu_torch.training.mlflow_store import OfflineMLflowRun, SystemMetricsMonitor

        self.run = OfflineMLflowRun(os.path.join(output_dir, "mlruns"), experiment=experiment,
                                    run_name=run_name)
        # the provenance an inference bundle records, as run tags
        prov = provenance()
        for key, value in {
            "provenance.python": prov.get("python"),
            "provenance.platform": prov.get("platform"),
            **{f"provenance.pkg.{name}": ver for name, ver in prov.get("packages", {}).items()},
            **{f"provenance.device.{k}": v for k, v in (prov.get("devices") or {}).items()},
        }.items():
            if value is not None:
                self.run.set_tag(key, str(value))
        self.monitor = None
        if system_metrics:
            self.monitor = SystemMetricsMonitor(self.run.log_metrics,
                                                interval_s=system_metrics_interval_s)
            self.monitor.start()

    def log_params(self, params):
        self.run.log_params(_flatten(params))

    def log_metrics(self, metrics, step):
        self.run.log_metrics({k: float(v) for k, v in metrics.items()}, step)

    def finalize(self):
        if self.monitor is not None:
            self.monitor.stop()
        self.run.finalize()


class WandbLogger(BaseLogger):
    """The wandb package's client (offline by default)."""

    def __init__(self, output_dir: str, project: str = "anemoi-tpu",
                 run_name: Optional[str] = None, offline: bool = True, **_):
        try:
            import wandb  # type: ignore
        except ImportError as e:
            raise ImportError("WandbLogger needs the wandb package") from e
        self.wandb = wandb
        self._run = wandb.init(project=project, name=run_name, dir=output_dir,
                               mode="offline" if offline else "online")

    def log_params(self, params):
        self._run.config.update(_flatten(params), allow_val_change=True)

    def log_metrics(self, metrics, step):
        self._run.log(metrics, step=step)

    def finalize(self):
        self._run.finish()


def _flatten(d: Dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


LOGGERS = {"jsonl": JsonlLogger, "mlflow": MLflowLogger, "mlflow_offline": OfflineMLflowLogger,
           "wandb": WandbLogger}


def build_loggers(configs, output_dir: str):
    """The configured loggers; always includes the JSONL logger."""
    loggers = [JsonlLogger(output_dir)]
    for cfg in configs or []:
        cfg = dict(cfg)
        name = cfg.pop("name")
        if name == "jsonl":
            continue
        if name not in LOGGERS:
            raise KeyError(f"Unknown experiment logger '{name}'. Known: {sorted(LOGGERS)}")
        try:
            loggers.append(LOGGERS[name](output_dir=output_dir, **cfg))
        except ImportError as err:
            if name != "mlflow":
                LOGGER.warning("Logger '%s' unavailable: %s", name, err)
                continue
            # no mlflow client: the FileStore logger, which `mlflow sync` pushes later
            LOGGER.warning("mlflow package unavailable (%s); using the offline FileStore "
                           "logger", err)
            cfg.pop("tracking_uri", None)
            cfg.pop("offline", None)
            loggers.append(OfflineMLflowLogger(output_dir=output_dir, **cfg))
    return loggers
