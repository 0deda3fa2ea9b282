"""Commit-keyed store of training-speed results.

Port of ``anemoi_tpu.training.benchmark_store``: push metric values keyed
by git commit, retrieve them, and compare a new run against the latest
ancestor commit that has stored results.  The store is a plain JSON
directory (one file per commit) so it can live in CI artifacts or a shared
filesystem; :class:`RemoteBenchmarkStore` shares it through an MLflow
tracking server (``training/mlflow_store.MLflowRestClient``), and
:func:`open_benchmark_store` picks the remote store when
``ANEMOI_TPU_BENCHMARK_URI`` names a server and falls back to the local one
when that server cannot be reached.  ``cli profile --benchmark-store DIR``
pushes its numeric results here.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional


def current_commit(repo: str = ".") -> str:
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=repo, capture_output=True, text=True,
                check=True,
            ).stdout.strip()
        )
    except Exception:
        return "unknown"


def commit_ancestry(repo: str = ".", limit: int = 200) -> List[str]:
    try:
        out = subprocess.run(
            ["git", "log", f"-{limit}", "--format=%H"], cwd=repo,
            capture_output=True, text=True, check=True,
        ).stdout
        return out.split()
    except Exception:
        return []


class BenchmarkStore:
    def __init__(self, directory: str, repo: str = ".") -> None:
        self.directory = directory
        self.repo = repo
        os.makedirs(directory, exist_ok=True)

    def _path(self, commit: str) -> str:
        return os.path.join(self.directory, f"{commit}.json")

    def push(self, metrics: Dict[str, float], commit: Optional[str] = None) -> str:
        commit = commit or current_commit(self.repo)
        existing = self.get(commit) or {}
        existing.update(metrics)
        with open(self._path(commit), "w") as f:
            json.dump(existing, f, indent=1, sort_keys=True)
        return commit

    def get(self, commit: str) -> Optional[Dict[str, float]]:
        path = self._path(commit)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def find_latest_shared_commit(
        self, exclude_head: bool = True, required_keys=None
    ) -> Optional[str]:
        """Most recent ancestor commit with stored results.

        With ``required_keys``, ancestors whose stored file lacks ALL of the
        requested metric keys are skipped: a sweep run that stored only
        config-tagged keys (e.g. ``o96-...-block.256,256,256/step_time_ms``)
        must not shadow the older flagship series it didn't touch.
        """
        ancestry = commit_ancestry(self.repo)
        if exclude_head and ancestry:
            ancestry = ancestry[1:]
        required = set(required_keys) if required_keys else None
        for commit in ancestry:
            if not os.path.exists(self._path(commit)):
                continue
            if required is None:
                return commit
            data = BenchmarkStore.get(self, commit) or {}
            if required & set(data):
                return commit
        return None

    def compare(
        self, metrics: Dict[str, float], higher_is_better: bool = True
    ) -> Dict[str, Dict[str, float]]:
        """Compare metrics against stored ancestor values, per key.

        Each key's baseline is taken from the MOST RECENT ancestor that stored
        that key — different keys may resolve to different commits, so a
        tagged-sweep commit in between never turns the comparison into a
        no-op.
        """
        # Remote stores mirror probed ancestors into the local cache here, so
        # the per-key walk below only touches local files.
        self.find_latest_shared_commit(required_keys=set(metrics))
        ancestry = commit_ancestry(self.repo)
        if ancestry:
            ancestry = ancestry[1:]  # exclude HEAD: compare against ancestors
        remaining = set(metrics)
        baselines: Dict[str, tuple] = {}
        for commit in ancestry:
            if not remaining:
                break
            if not os.path.exists(self._path(commit)):
                continue
            data = BenchmarkStore.get(self, commit) or {}
            for k in list(remaining):
                if k in data:
                    baselines[k] = (data[k], commit)
                    remaining.discard(k)
        out = {}
        for k, v in metrics.items():
            b, bc = baselines.get(k, (None, None))
            ratio = (v / b) if (b not in (None, 0)) else None
            out[k] = {"value": v, "baseline": b, "ratio": ratio, "baseline_commit": bc}
        return out


class RemoteBenchmarkStore(BenchmarkStore):
    """MLflow-server-backed benchmark store so multiple machines share
    baselines.

    Each commit's metrics live in ONE MLflow run of the benchmark experiment,
    tagged ``commit=<sha>``; push/fetch go through the existing REST client
    (`mlflow_store.MLflowRestClient`, no mlflow package needed).  Fetched
    results are mirrored into the local JSON directory, so `compare`/
    `find_latest_shared_commit` (ancestry walk) work unchanged and the local
    cache keeps working offline.
    """

    def __init__(
        self,
        directory: str,
        tracking_uri: str,
        repo: str = ".",
        experiment: str = "anemoi-tpu-benchmarks",
        token: Optional[str] = None,
    ) -> None:
        super().__init__(directory, repo=repo)
        from anemoi_tpu_torch.training.mlflow_store import MLflowRestClient

        self.client = MLflowRestClient(tracking_uri, token=token)
        self.experiment_id = self.client.get_or_create_experiment(experiment)

    def _local_push(self, metrics: Dict[str, float], commit: str) -> None:
        existing = BenchmarkStore.get(self, commit) or {}
        existing.update(metrics)
        with open(self._path(commit), "w") as f:
            json.dump(existing, f, indent=1, sort_keys=True)

    def push(self, metrics: Dict[str, float], commit: Optional[str] = None) -> str:
        commit = commit or current_commit(self.repo)
        self._local_push(metrics, commit)  # local mirror first
        import time

        run_id = self._find_run(commit)
        if run_id is None:
            run_id = self.client.create_run(
                self.experiment_id,
                run_name=commit[:12],
                start_time=int(time.time() * 1000),
                tags={"commit": commit},
            )
        payload = [
            {"key": k, "value": float(v), "timestamp": int(time.time() * 1000),
             "step": 0}
            for k, v in metrics.items()
            if isinstance(v, (int, float))
        ]
        self.client.log_batch(run_id, payload, {})
        return commit

    def _find_run(self, commit: str) -> Optional[str]:
        runs = self.client.search_runs(
            self.experiment_id, f"tags.commit = '{commit}'", max_results=1
        )
        return runs[0]["info"]["run_id"] if runs else None

    def find_latest_shared_commit(
        self, exclude_head: bool = True, required_keys=None
    ) -> Optional[str]:
        """Local cache first; on a fresh machine, probe the remote for each
        ancestor (mirroring hits locally) up to a bounded depth."""
        local = super().find_latest_shared_commit(exclude_head, required_keys)
        if local is not None:
            return local
        ancestry = commit_ancestry(self.repo)
        if exclude_head and ancestry:
            ancestry = ancestry[1:]
        required = set(required_keys) if required_keys else None
        for commit in ancestry[:25]:
            data = self.get(commit)  # probes remote + mirrors into local cache
            if data is None:
                continue
            if required is not None and not (required & set(data)):
                continue
            return commit
        return None

    def get(self, commit: str) -> Optional[Dict[str, float]]:
        local = BenchmarkStore.get(self, commit)
        if local is not None:
            return local
        runs = self.client.search_runs(
            self.experiment_id, f"tags.commit = '{commit}'", max_results=1
        )
        if not runs:
            return None
        metrics = {
            m["key"]: m["value"]
            for m in runs[0].get("data", {}).get("metrics", [])
        }
        if metrics:  # mirror into the local cache for future offline runs
            self._local_push(metrics, commit)
        return metrics or None


def open_benchmark_store(directory: str, repo: str = ".") -> BenchmarkStore:
    """Store factory: remote (shared) when ANEMOI_TPU_BENCHMARK_URI points at
    an MLflow tracking server, local JSON otherwise (also when that server
    cannot be reached).  ``ANEMOI_TPU_BENCHMARK_TOKEN``: its bearer token."""

    uri = os.environ.get("ANEMOI_TPU_BENCHMARK_URI")
    if uri:
        try:
            return RemoteBenchmarkStore(
                directory, uri, repo=repo,
                token=os.environ.get("ANEMOI_TPU_BENCHMARK_TOKEN"),
            )
        except Exception as err:  # unreachable server: degrade to local
            import logging

            logging.getLogger(__name__).warning(
                "Remote benchmark store %s unavailable (%s); using local", uri, err
            )
    return BenchmarkStore(directory, repo=repo)
