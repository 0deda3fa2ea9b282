"""The port's profiler, benchmark store, offline MLflow store and loggers
against the JAX package's, on the CPU.

- ``profile_training`` on the tiny example trainer of both packages (3
  steps): the same report sections and keys (``torch`` where JAX reports
  ``jax``), a ``torch.profiler`` trace with ``--trace``;
- the benchmark store on a temporary git repository of four commits:
  ``push``, ``get``, ``find_latest_shared_commit`` and ``compare`` give
  what JAX's store gives;
- the remote benchmark store, ``sync_offline_run`` and its pagination
  against a stub MLflow server on 127.0.0.1: the same REST calls and
  payloads as JAX's (timestamps aside);
- an offline run written by both packages: the same files and contents,
  times, ids and paths aside; ``build_loggers`` falls back from ``mlflow``
  to the offline logger as JAX's does; the system-metrics monitor samples.
"""

import json
import os
import subprocess
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from anemoi_tpu.training import benchmark_store as jax_bench
from anemoi_tpu.training import mlflow_store as jax_mlflow
from anemoi_tpu_torch.training import benchmark_store, mlflow_store
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


# --- profiler ------------------------------------------------------------
def key_tree(d):
    return {k: key_tree(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_profile_training_reports_match_jax(tmp_path):
    from anemoi_tpu.training.profiler import profile_training as jax_profile
    from anemoi_tpu.training.trainer import AnemoiTrainer as JaxTrainer
    from anemoi_tpu_torch.training.profiler import profile_training
    from anemoi_tpu_torch.training.trainer import AnemoiTrainer
    from tests.test_torch_trainer import tiny_config

    reports, results = {}, {}
    for label, cls, fn, trace in (("jax", JaxTrainer, jax_profile, False),
                                  ("port", AnemoiTrainer, profile_training, True)):
        cfg = tiny_config(tmp_path, label)
        out = fn(cls(cfg, output_dir=cfg["output_dir"]), num_steps=3, trace=trace)
        with open(out["report"]) as f:
            reports[label] = json.load(f)
        results[label] = out
    ref, ours = reports["jax"], reports["port"]
    ref["system"]["torch"] = ref["system"].pop("jax")
    assert key_tree(ours) == key_tree(ref)
    assert ours["config"] == ref["config"] and ours["speed"]["num_steps"] == 2
    for phase in ("dataloader", "transfer", "train_step"):
        assert ours["time"][phase]["count"] == 3
    assert abs(sum(v["pct"] for v in ours["time"].values()) - 100.0) < 1.0
    assert ours["memory"]["host_vmrss_kb"] > 0
    assert sorted(results["port"]) == sorted(list(results["jax"]) + ["trace"])
    with open(results["port"]["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)


# --- benchmark store -----------------------------------------------------
@pytest.fixture(scope="module")
def git_repo(tmp_path_factory):
    repo = tmp_path_factory.mktemp("repo")
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@t", "-C", str(repo)]
    subprocess.run(git + ["init", "-q"], check=True)
    for i in range(4):
        subprocess.run(git + ["commit", "-q", "--allow-empty", "-m", f"c{i}"], check=True)
    return str(repo)


def store_story(module, directory, repo):
    """push / get / find / compare, as tests/test_benchmark_store.py runs them."""
    store = module.BenchmarkStore(directory, repo=repo)
    ancestry = module.commit_ancestry(repo)
    head = store.push({"throughput": 100.0})
    out = [head == ancestry[0], store.get(head)]
    store.push({"memory": 5.0}, commit=head)
    out.append(store.get(head))
    out.append(store.compare({"x": 1.0}))
    near, far = ancestry[1], ancestry[2]
    store.push({"grid_points_per_s": 1000.0, "step_time_ms": 100.0}, commit=far)
    store.push({"tagged/step_time_ms": 90.0}, commit=near)
    out += [store.find_latest_shared_commit() == near,
            store.find_latest_shared_commit(required_keys={"grid_points_per_s"}) == far]
    cmp = store.compare({"grid_points_per_s": 1200.0, "step_time_ms": 95.0})
    out.append({k: {**v, "baseline_commit": ancestry.index(v["baseline_commit"])}
                for k, v in cmp.items()})
    return out, sorted(os.listdir(directory))


def test_benchmark_store_matches_jax(tmp_path, git_repo):
    assert benchmark_store.current_commit(git_repo) == jax_bench.current_commit(git_repo)
    assert benchmark_store.commit_ancestry(git_repo) == jax_bench.commit_ancestry(git_repo)
    ours = store_story(benchmark_store, str(tmp_path / "port"), git_repo)
    assert ours == store_story(jax_bench, str(tmp_path / "jax"), git_repo)
    story = ours[0]
    assert story[:3] == [True, {"throughput": 100.0}, {"throughput": 100.0, "memory": 5.0}]
    assert story[-1]["grid_points_per_s"]["ratio"] == pytest.approx(1.2)
    assert story[-1]["grid_points_per_s"]["baseline_commit"] == 2


class _Stub(BaseHTTPRequestHandler):
    """Enough of the MLflow REST surface for sync and the remote store."""

    calls: list = []
    runs: dict = {}

    def log_message(self, *a):
        pass

    def _reply(self, payload):
        body = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        payload = json.loads(self.rfile.read(n) or b"{}")
        type(self).calls.append((self.path, payload, self.headers.get("Authorization")))
        runs = type(self).runs
        if self.path.endswith("experiments/create"):
            self._reply({"experiment_id": "7"})
        elif self.path.endswith("runs/create"):
            rid = f"run{len(runs)}"
            runs[rid] = {"tags": {t["key"]: t["value"] for t in payload.get("tags", [])},
                         "metrics": {}}
            self._reply({"run": {"info": {"run_id": rid}}})
        elif self.path.endswith("runs/log-batch"):
            for m in payload.get("metrics", []):
                runs.get(payload["run_id"], {"metrics": {}})["metrics"][m["key"]] = m["value"]
            self._reply({})
        elif self.path.endswith("runs/search"):
            self._reply({"runs": [
                {"info": {"run_id": rid},
                 "data": {"metrics": [{"key": k, "value": v} for k, v in run["metrics"].items()]}}
                for rid, run in runs.items()
                if f"'{run['tags'].get('commit', '')}'" in payload.get("filter", "")]})
        else:
            self._reply({})

    do_GET = do_POST


@pytest.fixture()
def stub():
    _Stub.calls, _Stub.runs = [], {}
    srv = HTTPServer(("127.0.0.1", 0), _Stub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


def without_times(calls):
    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()
                    if k not in ("timestamp", "start_time", "end_time")}
        if isinstance(x, list):
            return [clean(v) for v in x]
        return x

    return [(path, clean(payload), auth) for path, payload, auth in calls]


def remote_story(module, directory, uri, repo):
    ancestry = module.commit_ancestry(repo)
    a = module.RemoteBenchmarkStore(os.path.join(directory, "a"), uri, repo=repo)
    a.push({"grid_points_per_s": 1000.0, "step_time_ms": 50.0}, commit=ancestry[1])
    b = module.RemoteBenchmarkStore(os.path.join(directory, "b"), uri, repo=repo)
    fetched = b.get(ancestry[1])
    a.push({"loss": 1.5}, commit=ancestry[1])
    cmp = b.compare({"grid_points_per_s": 1100.0})
    return fetched, len(_Stub.runs), cmp, os.path.exists(
        os.path.join(directory, "b", f"{ancestry[1]}.json"))


def test_remote_benchmark_store_matches_jax(tmp_path, stub, git_repo):
    ref = remote_story(jax_bench, str(tmp_path / "jax"), stub, git_repo)
    ref_calls = without_times(_Stub.calls)
    _Stub.calls, _Stub.runs = [], {}
    ours = remote_story(benchmark_store, str(tmp_path / "port"), stub, git_repo)
    assert ours == ref
    assert without_times(_Stub.calls) == ref_calls
    assert ours[0] == {"grid_points_per_s": 1000.0, "step_time_ms": 50.0} and ours[1] == 1
    assert ours[2]["grid_points_per_s"]["ratio"] == pytest.approx(1.1) and ours[3]


def test_open_benchmark_store_fallback(tmp_path, monkeypatch, git_repo):
    monkeypatch.delenv("ANEMOI_TPU_BENCHMARK_URI", raising=False)
    store = benchmark_store.open_benchmark_store(str(tmp_path / "s"), repo=git_repo)
    assert type(store) is benchmark_store.BenchmarkStore
    monkeypatch.setenv("ANEMOI_TPU_BENCHMARK_URI", "http://127.0.0.1:1")  # nothing listens
    store = benchmark_store.open_benchmark_store(str(tmp_path / "s"), repo=git_repo)
    assert type(store) is benchmark_store.BenchmarkStore


# --- offline MLflow ------------------------------------------------------
def make_run(module, root, n_params=2):
    run = module.OfflineMLflowRun(str(root), experiment="exp", run_name="r1",
                                  tags={"git": "abc"})
    run.log_params({"model.num_channels": 16, "training.lr.rate": 1e-3,
                    **{f"cfg.k{i}": i for i in range(n_params - 2)}})
    for v, s in ((1.0, 0), (0.5, 1)):
        run.log_metric("train/loss", v, step=s)
    run.log_metric("val/mse/data/sfc/1", 0.25, step=3)
    run.finalize()
    return run


def tree_contents(run):
    """Every file of a run, its times, ids and absolute paths taken out."""
    out = {}
    for dirpath, _, files in os.walk(run.run_dir):
        for name in files:
            path = os.path.join(dirpath, name)
            text = open(path).read()
            if name == "meta.yaml":
                text = "\n".join(line for line in text.splitlines()
                                 if not line.startswith(("artifact_uri", "run_id", "run_uuid",
                                                         "start_time", "end_time", "user_id")))
            elif os.path.basename(dirpath) == "metrics":
                text = [line.split()[1:] for line in text.splitlines()]
            out[os.path.relpath(path, run.run_dir)] = text
    return out


def test_offline_run_files_match_jax(tmp_path):
    ref = make_run(jax_mlflow, tmp_path / "jax")
    ours = make_run(mlflow_store, tmp_path / "port")
    assert tree_contents(ours) == tree_contents(ref)
    assert ours.experiment_id == ref.experiment_id
    data = mlflow_store.read_offline_run(ours.run_dir)
    want = jax_mlflow.read_offline_run(ref.run_dir)
    for d in (data, want):
        for m in d["metrics"]:
            m.pop("timestamp")
        d["meta"] = {k: v for k, v in d["meta"].items()
                     if k in ("experiment_id", "lifecycle_stage", "run_name", "status",
                              "experiment_name")}
    assert data == want
    assert data["tags"]["mlflow.runName"] == "r1" and data["params"]["model.num_channels"] == "16"
    assert [m["key"] for m in data["metrics"]][-1] == "val.mse.data.sfc.1"
    run2 = mlflow_store.OfflineMLflowRun(str(tmp_path / "port"), experiment="exp")
    assert run2.experiment_id == ours.experiment_id
    assert mlflow_store.OfflineMLflowRun(str(tmp_path / "port"),
                                         experiment="other").experiment_id != ours.experiment_id


@pytest.mark.parametrize("n_params", [2, 250])
def test_sync_matches_jax(tmp_path, stub, n_params):
    """The same REST calls as JAX's sync, paginated beyond 100 params."""
    run = make_run(mlflow_store, tmp_path / "mlruns", n_params)
    assert jax_mlflow.sync_offline_run(run.run_dir, stub, token="sekrit") == "run0"
    ref = without_times(_Stub.calls)
    _Stub.calls, _Stub.runs = [], {}
    assert mlflow_store.sync_offline_run(run.run_dir, stub, token="sekrit") == "run0"
    ours = without_times(_Stub.calls)
    assert ours == ref
    assert all(auth == "Bearer sekrit" for _, _, auth in ours)
    batches = [pl for path, pl, _ in ours if path.endswith("log-batch")]
    assert len({p["key"] for pl in batches for p in pl.get("params", [])}) == n_params
    assert all(len(pl.get("params", [])) <= 100 for pl in batches)
    assert next(pl for p, pl, _ in ours if p.endswith("experiments/create"))["name"] == "exp"


def test_system_metrics_sample_and_monitor():
    sample = mlflow_store.sample_system_metrics()
    ref = jax_mlflow.sample_system_metrics()
    assert sorted(sample) == sorted(ref)  # no card here: host figures only
    assert sample["sys/process_rss_mib"] > 1.0
    assert 0.0 <= sample["sys/host_mem_used_pct"] <= 100.0
    seen = []
    mon = mlflow_store.SystemMetricsMonitor(lambda m, s: seen.append((m, s)), interval_s=0.05)
    mon.start()
    time.sleep(0.3)
    mon.stop()
    assert seen and "sys/cpu_util_pct" in seen[0][0] and seen[0][1] == 1


def test_offline_logger_via_build_loggers(tmp_path):
    from anemoi_tpu.training.loggers import OfflineMLflowLogger as JaxOffline
    from anemoi_tpu.training.loggers import build_loggers as jax_build
    from anemoi_tpu_torch.training.loggers import OfflineMLflowLogger, build_loggers

    runs = {}
    for label, build, cls in (("jax", jax_build, JaxOffline),
                              ("port", build_loggers, OfflineMLflowLogger)):
        loggers = build([{"name": "mlflow", "experiment": "exp", "system_metrics": False}],
                        str(tmp_path / label))
        (offline,) = [lg for lg in loggers if isinstance(lg, cls)]
        offline.log_params({"a": {"b": 1}})
        offline.log_metrics({"train/loss": 2.0}, step=1)
        offline.finalize()
        runs[label] = mlflow_store.read_offline_run(offline.run.run_dir)
    assert runs["port"]["params"] == runs["jax"]["params"] == {"a.b": "1"}
    assert [(m["key"], m["value"], m["step"]) for m in runs["port"]["metrics"]] == \
        [(m["key"], m["value"], m["step"]) for m in runs["jax"]["metrics"]]
    tags = runs["port"]["tags"]
    assert tags["provenance.pkg.torch"] and tags["provenance.python"]
    for name in ("mlflow", "wandb"):  # the packages are missing here
        with pytest.raises(ImportError, match=name):
            __import__("anemoi_tpu_torch.training.loggers", fromlist=["LOGGERS"]).LOGGERS[
                name](output_dir=str(tmp_path))
