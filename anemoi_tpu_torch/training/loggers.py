"""Experiment loggers.

Port of ``anemoi_tpu.training.loggers``: the common interface and the JSONL
file logger, which is always on (``experiment.jsonl`` in the run directory).
The MLflow (online and offline) and Weights & Biases loggers are not ported
and raise ``NotImplementedError`` (``ROADMAP.md`` Queue 1, item 10).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


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


class _NotPorted(BaseLogger):
    def __init__(self, output_dir: str, **_):
        raise NotImplementedError(
            f"the {self.kind} logger is not ported to anemoi_tpu_torch (ROADMAP.md Queue 1, "
            "item 10); the jsonl logger is always on"
        )


class MLflowLogger(_NotPorted):
    kind = "mlflow"


class OfflineMLflowLogger(_NotPorted):
    kind = "mlflow_offline"


class WandbLogger(_NotPorted):
    kind = "wandb"


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
        loggers.append(LOGGERS[name](output_dir=output_dir, **cfg))
    return loggers
