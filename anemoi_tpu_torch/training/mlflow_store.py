"""MLflow offline store, server sync, and system-metrics monitoring.

Port of ``anemoi_tpu.training.mlflow_store``, without the mlflow package:

- :class:`OfflineMLflowRun` writes MLflow's *FileStore* layout
  (``mlruns/<exp_id>/<run_id>/{meta.yaml,metrics/,params/,tags/}``), which a
  real ``mlflow ui --backend-store-uri`` reads directly.
- :func:`sync_offline_run` pushes an offline run to a tracking server over
  the MLflow REST API with plain urllib (and an optional bearer token).
- :class:`SystemMetricsMonitor` samples the CPU, the host's and the
  process's memory (``/proc``) and, once the process uses the card, the
  card's memory (``torch.cuda``) on a background thread.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Any, Dict, List, Optional

import torch

LOGGER = logging.getLogger(__name__)

_ACTIVE = "active"
_FINISHED = "FINISHED"


def _now_ms() -> int:
    return int(time.time() * 1000)


def _sanitize(key: str) -> str:
    """MLflow FileStore keys become file names: no separators."""
    return key.replace("/", ".").replace(os.sep, ".")


class OfflineMLflowRun:
    """One run in an MLflow FileStore-compatible directory tree."""

    def __init__(
        self,
        root: str,
        experiment: str = "anemoi-tpu",
        run_name: Optional[str] = None,
        tags: Optional[Dict[str, str]] = None,
    ) -> None:
        self.root = os.path.abspath(root)
        self.experiment = experiment
        self.experiment_id = self._ensure_experiment(experiment)
        self.run_id = uuid.uuid4().hex
        self.run_dir = os.path.join(self.root, self.experiment_id, self.run_id)
        for sub in ("metrics", "params", "tags"):
            os.makedirs(os.path.join(self.run_dir, sub), exist_ok=True)
        self._start = _now_ms()
        self.run_name = run_name or f"run-{self.run_id[:8]}"
        self._write_meta(status="RUNNING", end_time=None)
        self.set_tag("mlflow.runName", self.run_name)
        for k, v in (tags or {}).items():
            self.set_tag(k, v)

    # -- store layout ---------------------------------------------------
    def _ensure_experiment(self, name: str) -> str:
        """Find or create the experiment directory; ids are stringified ints
        like the FileStore's."""
        os.makedirs(self.root, exist_ok=True)
        taken = []
        for entry in os.listdir(self.root):
            meta = os.path.join(self.root, entry, "meta.yaml")
            if not os.path.exists(meta):
                continue
            fields = _read_simple_yaml(meta)
            if fields.get("name") == name:
                return entry
            try:
                taken.append(int(entry))
            except ValueError:
                pass
        exp_id = str(max(taken) + 1 if taken else 1)
        exp_dir = os.path.join(self.root, exp_id)
        os.makedirs(exp_dir, exist_ok=True)
        with open(os.path.join(exp_dir, "meta.yaml"), "w") as f:
            f.write(
                f"artifact_location: file://{exp_dir}\n"
                f"experiment_id: '{exp_id}'\n"
                f"lifecycle_stage: {_ACTIVE}\n"
                f"name: {name}\n"
            )
        return exp_id

    def _write_meta(self, status: str, end_time: Optional[int]) -> None:
        with open(os.path.join(self.run_dir, "meta.yaml"), "w") as f:
            f.write(
                f"artifact_uri: file://{self.run_dir}/artifacts\n"
                f"end_time: {end_time if end_time is not None else 'null'}\n"
                f"entry_point_name: ''\n"
                f"experiment_id: '{self.experiment_id}'\n"
                f"lifecycle_stage: {_ACTIVE}\n"
                f"run_id: {self.run_id}\n"
                f"run_name: {self.run_name}\n"
                f"run_uuid: {self.run_id}\n"
                f"experiment_name: {self.experiment}\n"
                f"source_type: 4\n"
                f"start_time: {self._start}\n"
                # MLflow RunStatus enum: RUNNING=1, FINISHED=3
                f"status: {1 if end_time is None else 3}\n"
                f"user_id: {os.environ.get('USER', 'anemoi')}\n"
            )

    # -- logging --------------------------------------------------------
    def log_param(self, key: str, value: Any) -> None:
        path = os.path.join(self.run_dir, "params", _sanitize(key))
        with open(path, "w") as f:
            f.write(str(value))

    def log_params(self, params: Dict[str, Any]) -> None:
        for k, v in params.items():
            self.log_param(k, v)

    def set_tag(self, key: str, value: str) -> None:
        with open(os.path.join(self.run_dir, "tags", _sanitize(key)), "w") as f:
            f.write(str(value))

    def log_metric(self, key: str, value: float, step: int = 0) -> None:
        path = os.path.join(self.run_dir, "metrics", _sanitize(key))
        with open(path, "a") as f:
            f.write(f"{_now_ms()} {float(value)} {int(step)}\n")

    def log_metrics(self, metrics: Dict[str, float], step: int = 0) -> None:
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def finalize(self) -> None:
        self._write_meta(status=_FINISHED, end_time=_now_ms())


def _read_simple_yaml(path: str) -> Dict[str, str]:
    """meta.yaml files here are flat key: value lines."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, _, v = line.partition(":")
            out[k.strip()] = v.strip().strip("'\"")
    return out


def read_offline_run(run_dir: str) -> Dict[str, Any]:
    """Parse one offline run directory back into dicts (also used by sync)."""
    meta = _read_simple_yaml(os.path.join(run_dir, "meta.yaml"))
    params = {}
    for name in sorted(os.listdir(os.path.join(run_dir, "params"))):
        with open(os.path.join(run_dir, "params", name)) as f:
            params[name] = f.read()
    tags = {}
    for name in sorted(os.listdir(os.path.join(run_dir, "tags"))):
        with open(os.path.join(run_dir, "tags", name)) as f:
            tags[name] = f.read()
    metrics: List[Dict[str, Any]] = []
    mdir = os.path.join(run_dir, "metrics")
    for name in sorted(os.listdir(mdir)):
        with open(os.path.join(mdir, name)) as f:
            for line in f:
                ts, value, step = line.split()
                metrics.append(
                    {"key": name, "value": float(value),
                     "timestamp": int(ts), "step": int(step)}
                )
    return {"meta": meta, "params": params, "tags": tags, "metrics": metrics}


# ----------------------------------------------------------------------
# REST sync: offline run -> tracking server
# ----------------------------------------------------------------------
class MLflowRestClient:
    """Minimal MLflow REST client over urllib (no mlflow dependency)."""

    def __init__(self, tracking_uri: str, token: Optional[str] = None,
                 timeout: float = 30.0) -> None:
        self.base = tracking_uri.rstrip("/")
        self.token = token
        self.timeout = timeout

    def _call(self, endpoint: str, payload: Dict[str, Any],
              method: str = "POST") -> Dict[str, Any]:
        url = f"{self.base}/api/2.0/mlflow/{endpoint}"
        data = json.dumps(payload).encode()
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode() or "{}")

    def get_or_create_experiment(self, name: str) -> str:
        try:
            out = self._call("experiments/create", {"name": name})
            return out["experiment_id"]
        except urllib.error.HTTPError:
            from urllib.parse import quote

            out = self._call(
                f"experiments/get-by-name?experiment_name={quote(name)}",
                {}, method="GET",
            )
            return out["experiment"]["experiment_id"]

    def create_run(self, experiment_id: str, run_name: str,
                   start_time: int, tags: Dict[str, str]) -> str:
        out = self._call(
            "runs/create",
            {
                "experiment_id": experiment_id,
                "run_name": run_name,
                "start_time": start_time,
                "tags": [{"key": k, "value": v} for k, v in tags.items()],
            },
        )
        return out["run"]["info"]["run_id"]

    def log_batch(self, run_id: str, metrics: List[Dict[str, Any]],
                  params: Dict[str, str]) -> None:
        # the REST contract caps a batch at 1000 metrics / 100 params:
        # paginate BOTH so nothing is silently dropped
        param_items = [{"key": k, "value": str(v)[:500]} for k, v in params.items()]
        n_batches = max(
            -(-len(metrics) // 1000), -(-len(param_items) // 100), 1
        )
        for i in range(n_batches):
            payload: Dict[str, Any] = {"run_id": run_id}
            m = metrics[i * 1000 : (i + 1) * 1000]
            p = param_items[i * 100 : (i + 1) * 100]
            if m:
                payload["metrics"] = m
            if p:
                payload["params"] = p
            self._call("runs/log-batch", payload)

    def search_runs(self, experiment_id: str, filter_string: str = "",
                    max_results: int = 100) -> List[Dict[str, Any]]:
        out = self._call(
            "runs/search",
            {
                "experiment_ids": [experiment_id],
                "filter": filter_string,
                "max_results": max_results,
                "order_by": ["attributes.start_time DESC"],
            },
        )
        return out.get("runs", [])

    def terminate_run(self, run_id: str, end_time: Optional[int]) -> None:
        self._call(
            "runs/update",
            {"run_id": run_id, "status": "FINISHED",
             "end_time": end_time or _now_ms()},
        )


def sync_offline_run(
    run_dir: str,
    tracking_uri: str,
    experiment: Optional[str] = None,
    token: Optional[str] = None,
) -> str:
    """Push one offline FileStore run directory to a tracking server.

    Returns the server-side run id (``cli mlflow sync``)."""
    data = read_offline_run(run_dir)
    client = MLflowRestClient(tracking_uri, token=token)
    exp_name = experiment or data["meta"].get("experiment_name", "anemoi-tpu")
    exp_id = client.get_or_create_experiment(exp_name)
    run_id = client.create_run(
        exp_id,
        run_name=data["meta"].get("run_name", "synced-run"),
        start_time=int(data["meta"].get("start_time", _now_ms())),
        tags={**data["tags"], "anemoi.synced_from": run_dir},
    )
    client.log_batch(run_id, data["metrics"], data["params"])
    end = data["meta"].get("end_time")
    client.terminate_run(run_id, int(end) if end not in (None, "null", "") else None)
    return run_id


# ----------------------------------------------------------------------
# system metrics
# ----------------------------------------------------------------------
def _read_proc_stat() -> tuple:
    with open("/proc/stat") as f:
        parts = f.readline().split()[1:]
    vals = [int(x) for x in parts]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
    return sum(vals), idle


def sample_system_metrics() -> Dict[str, float]:
    """One sample of host metrics (``/proc``) and, where this process has
    initialised CUDA, the card's memory (``torch.cuda``)."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        out["sys/process_rss_mib"] = rss_pages * os.sysconf("SC_PAGE_SIZE") / 2**20
    except OSError:  # pragma: no cover
        pass
    try:
        mem: Dict[str, int] = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                mem[k] = int(v.split()[0])
        out["sys/host_mem_used_pct"] = 100.0 * (
            1.0 - mem.get("MemAvailable", 0) / max(mem.get("MemTotal", 1), 1)
        )
    except OSError:  # pragma: no cover
        pass
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out["sys/device_mem_in_use_mib"] = torch.cuda.memory_allocated() / 2**20
        out["sys/device_mem_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        out["sys/device_mem_reserved_mib"] = torch.cuda.memory_reserved() / 2**20
    return out


class SystemMetricsMonitor:
    """Background sampler: CPU %, RSS, host and card memory -> a log callback."""

    def __init__(self, log_fn, interval_s: float = 10.0) -> None:
        self._log_fn = log_fn
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._samples = 0

    def _loop(self) -> None:
        total0, idle0 = _read_proc_stat()
        while not self._stop.wait(self.interval_s):
            metrics = sample_system_metrics()
            total1, idle1 = _read_proc_stat()
            dt, di = total1 - total0, idle1 - idle0
            total0, idle0 = total1, idle1
            if dt > 0:
                metrics["sys/cpu_util_pct"] = 100.0 * (1.0 - di / dt)
            self._samples += 1
            try:
                self._log_fn(metrics, self._samples)
            except Exception:  # pragma: no cover - never kill training
                LOGGER.exception("system metrics logging failed")

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="system-metrics", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1.0)
