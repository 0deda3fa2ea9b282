"""``anemoi-tpu-torch-training``: the port's training CLI.

Port of ``anemoi_tpu.training.cli`` with the same arguments:

    train <config.yaml|json> [a.b.c=value ...] [--output-dir DIR]
    evaluate <config.yaml|json> [a.b.c=value ...] [--output-dir DIR] [--rollout N]
    predict <bundle> [--config C.yaml] [--steps N] [--start-index I]
                     [--output F.npz] [--seed S] [--platform cpu] [--aot-cache DIR]
    validate <config.yaml|json> [a.b.c=value ...]
    config list
    config generate <config.yaml|json> [a.b.c=value ...] [--output F.yaml]
    checkpoint inspect <bundle>
    checkpoint migrate <bundle> [--rollback TARGET]
    checkpoint migrate --create LABEL [--scripts-dir DIR]
    mlflow login --uri URI [--token T]
    mlflow sync <run_dir|mlruns> [--uri URI] [--experiment NAME]
    profile <config.yaml|json> [a.b.c=value ...] [--output-dir DIR] [--steps N]
            [--trace] [--benchmark-store DIR]

Configs are YAML (or JSON) files composed with their ``defaults:`` by
``utils/config.py:load_config``, searched in the file's folder and then in
the packaged presets (``anemoi_tpu_torch/config``, which ``config list``
lists).  ``config generate`` prints or writes the composed config as YAML.
``hardware.platform=cpu`` (train, evaluate) or ``--platform cpu`` (predict)
runs on the CPU; otherwise the CUDA card, which must be visible.
``predict`` samples a transport bundle's generative forecast, its noise
drawn from a ``torch.Generator`` seeded with ``--seed``; ``evaluate``
refuses a model that the deterministic rollout cannot run (an ensemble that
draws noise, a transport model) before any step and returns 1.  Configs
are checked by ``validate`` (``schemas.py``: plain functions, no pydantic),
and by ``train`` before anything is built unless ``config_validation`` is
false: a refused field is printed and the command returns 1.  ``checkpoint
migrate`` applies a bundle's pending migrations to its ``checkpoint.json``
(``models/migrations.py``; ``load_inference_checkpoint`` applies them to
the parameters as it loads), rolls them back to ``--rollback TARGET``, or
scaffolds a timestamped migration script (``--create``).  ``mlflow login``
stores a tracking server's URI and token in
``~/.config/anemoi_tpu/mlflow.json``; ``mlflow sync`` pushes the offline
runs of the ``mlflow_offline`` logger to a server over its REST API.
``profile`` runs ``--steps`` training steps under ``training/profiler.py``
(``--trace``: a ``torch.profiler`` trace) and with ``--benchmark-store``
pushes the numeric results into a commit-keyed store
(``training/benchmark_store.py``) and prints the comparison with the
latest ancestor commit's.

More than one rank: ``train``, ``evaluate`` and ``predict`` join the world a
launcher describes (``torchrun``, or the JAX package's ``ANEMOI_TPU_*``
environment; ``parallel/distributed.py``).  ``train`` with
``hardware.num_devices: N`` > 1 and no launcher starts its own N local
ranks (``parallel/distributed.spawn``, the counterpart of the JAX CLI's
``hardware.num_virtual_devices``), after building the CUDA kernels once in
the parent when it runs on the card; each rank's device and backend follow
the rule of ``parallel/distributed.py``.  ``predict`` under a launcher
serves the bundle over the ranks' model group and rank 0 writes the
forecast.

    python -m anemoi_tpu_torch.training.cli train anemoi_tpu_torch/config/example_o96_gt.yaml \
        hardware.platform=cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

MLFLOW_AUTH = os.path.join("~", ".config", "anemoi_tpu", "mlflow.json")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="anemoi-tpu-torch-training")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="Train a model from a YAML or JSON config")
    p_train.add_argument("config", help="YAML or JSON config path")
    p_train.add_argument("overrides", nargs="*", help="a.b.c=value overrides")
    p_train.add_argument("--output-dir", default=None)

    p_val = sub.add_parser("validate", help="Validate a config without training")
    p_val.add_argument("config")
    p_val.add_argument("overrides", nargs="*")

    p_eval = sub.add_parser("evaluate", help="Validation pass from the latest checkpoint")
    p_eval.add_argument("config")
    p_eval.add_argument("overrides", nargs="*")
    p_eval.add_argument("--output-dir", default=None)
    p_eval.add_argument("--rollout", type=int, default=None)

    p_cfg = sub.add_parser("config", help="List the packaged presets / dump composed configs")
    cfg_sub = p_cfg.add_subparsers(dest="config_command", required=True)
    p_cfg_gen = cfg_sub.add_parser("generate", help="Dump the fully composed config")
    p_cfg_gen.add_argument("config")
    p_cfg_gen.add_argument("overrides", nargs="*")
    p_cfg_gen.add_argument("--output", default=None)
    cfg_sub.add_parser("list", help="List the packaged config files")

    p_ckpt = sub.add_parser("checkpoint", help="Inspect or migrate checkpoints")
    ckpt_sub = p_ckpt.add_subparsers(dest="checkpoint_command", required=True)
    p_ck_insp = ckpt_sub.add_parser("inspect", help="Summarise an inference checkpoint")
    p_ck_insp.add_argument("checkpoint")
    p_ck_mig = ckpt_sub.add_parser("migrate", help="Apply pending migrations")
    p_ck_mig.add_argument("checkpoint", nargs="?", default=None)
    p_ck_mig.add_argument("--create", default=None, metavar="LABEL",
                          help="Scaffold a timestamped migration script instead")
    p_ck_mig.add_argument("--scripts-dir", default=None,
                          help="Directory for --create (default: the packaged scripts)")
    p_ck_mig.add_argument("--rollback", default=None, metavar="TARGET",
                          help="Roll the checkpoint back to migration TARGET")

    p_pred = sub.add_parser("predict", help="Autoregressive forecast from an inference checkpoint")
    p_pred.add_argument("checkpoint", help="Inference checkpoint directory")
    p_pred.add_argument("--config", default=None,
                        help="Config with data.datasets for the initial conditions "
                             "(default: the checkpoint's bundled config)")
    p_pred.add_argument("--steps", type=int, default=4)
    p_pred.add_argument("--start-index", type=int, default=0)
    p_pred.add_argument("--output", default="forecast.npz")
    p_pred.add_argument("--seed", type=int, default=0,
                        help="Seed of the torch.Generator that draws a generative (transport) "
                             "forecast's noise; unused by other models")
    p_pred.add_argument("--platform", default=None,
                        help="cpu to serve on the CPU; default: the CUDA card")
    p_pred.add_argument("--aot-cache", default=None, help="accepted; no effect")

    p_mlf = sub.add_parser("mlflow", help="Offline-run sync and server login")
    mlf_sub = p_mlf.add_subparsers(dest="mlflow_command", required=True)
    p_mlf_login = mlf_sub.add_parser("login", help="Store a tracking server URI and token")
    p_mlf_login.add_argument("--uri", required=True)
    p_mlf_login.add_argument("--token", default=None)
    p_mlf_sync = mlf_sub.add_parser("sync", help="Push offline FileStore runs to a server")
    p_mlf_sync.add_argument("run_dir", help="Offline run directory (or mlruns root)")
    p_mlf_sync.add_argument("--uri", default=None, help="Tracking server (default: the login)")
    p_mlf_sync.add_argument("--experiment", default=None)

    p_prof = sub.add_parser("profile", help="Short profiled run with speed and memory reports")
    p_prof.add_argument("config")
    p_prof.add_argument("overrides", nargs="*")
    p_prof.add_argument("--output-dir", default=None)
    p_prof.add_argument("--steps", type=int, default=20)
    p_prof.add_argument("--trace", action="store_true")
    p_prof.add_argument("--benchmark-store", default=None,
                        help="Push the results into this commit-keyed store directory")
    return parser


def _migrate(args) -> int:
    from anemoi_tpu_torch.models.migrations import MIGRATOR, create_migration_script

    if args.create:
        print(f"created {create_migration_script(args.create, args.scripts_dir)}")
        return 0
    if not args.checkpoint:
        print("error: checkpoint path required (or use --create LABEL)")
        return 2
    path = os.path.join(args.checkpoint, "checkpoint.json")
    with open(path) as f:
        bundle = json.load(f)
    if args.rollback:
        before = MIGRATOR.applied(bundle)
        bundle = MIGRATOR.rollback_to(bundle, args.rollback)
        undone = [n for n in before if n not in MIGRATOR.applied(bundle)]
        message = f"rolled back {len(undone)} migrations: {undone}"
    else:
        pending = [m.name for m in MIGRATOR.pending(bundle)]
        reshaped = _reshaped_by_migration(args.checkpoint, bundle)
        if reshaped:
            # marked applied, they would never run on params.msgpack, which
            # this CLI does not write: leave them to the loader
            print(f"error: migrations {reshaped} change the parameter tree of "
                  f"{args.checkpoint}; load_inference_checkpoint applies them as it loads")
            return 1
        bundle = MIGRATOR.migrate(bundle)
        message = f"applied {len(pending)} migrations: {pending}"
    with open(path, "w") as f:
        json.dump(bundle, f, default=str)
    print(message)
    return 0


def _reshaped_by_migration(path: str, bundle: dict) -> list:
    """The pending migrations whose parameter transforms would change the
    keys or shapes of the bundle's flax tree (``params.msgpack``)."""
    from anemoi_tpu_torch.models.migrations import MIGRATOR
    from anemoi_tpu_torch.training._msgpack import msgpack_restore

    transforms = [m.name for m in MIGRATOR.pending(bundle) if m.params_fn is not None]
    msgpack = os.path.join(path, "params.msgpack")
    if not transforms or not os.path.exists(msgpack):
        return []
    with open(msgpack, "rb") as f:
        raw = msgpack_restore(f.read())

    def layout(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            out.update(layout(v, prefix + (k,)) if isinstance(v, dict)
                       else {prefix + (k,): tuple(getattr(v, "shape", ()))})
        return out

    before = layout(raw)
    _, migrated = MIGRATOR.migrate(json.loads(json.dumps(bundle)), raw)
    return transforms if layout(migrated) != before else []


def _mlflow(args) -> int:
    auth_path = os.path.expanduser(MLFLOW_AUTH)
    if args.mlflow_command == "login":
        os.makedirs(os.path.dirname(auth_path), exist_ok=True)
        with open(auth_path, "w") as f:
            json.dump({"uri": args.uri, "token": args.token}, f)
        os.chmod(auth_path, 0o600)
        print(f"Saved tracking server login to {auth_path}")
        return 0
    from anemoi_tpu_torch.training.mlflow_store import sync_offline_run

    auth = {}
    if os.path.exists(auth_path):
        with open(auth_path) as f:
            auth = json.load(f)
    uri = args.uri or auth.get("uri")
    if not uri:
        print("No tracking URI: pass --uri or run `mlflow login` first")
        return 1
    # one run directory, or an mlruns root of experiments
    if os.path.exists(os.path.join(args.run_dir, "meta.yaml")) and os.path.isdir(
            os.path.join(args.run_dir, "metrics")):
        run_dirs = [args.run_dir]
    else:
        run_dirs = [os.path.join(args.run_dir, exp, run)
                    for exp in sorted(os.listdir(args.run_dir))
                    if os.path.isdir(os.path.join(args.run_dir, exp))
                    for run in sorted(os.listdir(os.path.join(args.run_dir, exp)))
                    if os.path.isdir(os.path.join(args.run_dir, exp, run, "metrics"))]
    for rd in run_dirs:
        run_id = sync_offline_run(rd, uri, experiment=args.experiment, token=auth.get("token"))
        print(f"synced {rd} -> {uri} run {run_id}")
    return 0


def _profile(conf: dict, args) -> int:
    from anemoi_tpu_torch.training.profiler import profile_training
    from anemoi_tpu_torch.training.trainer import AnemoiTrainer

    trainer = AnemoiTrainer(conf, output_dir=args.output_dir)
    result = profile_training(trainer, num_steps=args.steps, trace=args.trace)
    print(f"profile: {result}")
    if args.benchmark_store:
        from anemoi_tpu_torch.training.benchmark_store import BenchmarkStore

        numbers = {k: v for k, v in result.items() if isinstance(v, (int, float))}
        store = BenchmarkStore(args.benchmark_store)
        commit = store.push(numbers)
        print(f"benchmark store: commit={commit[:12]} {store.compare(numbers)}")
    for lg in trainer.loggers:
        lg.finalize()
    return 0


def _inspect(path: str) -> int:
    from anemoi_tpu_torch.training.checkpoint import pending_migrations

    with open(os.path.join(path, "checkpoint.json")) as f:
        bundle = json.load(f)
    meta = bundle.get("metadata", {})
    info = {
        "format_version": meta.get("format_version"),
        "migrations_applied": meta.get("migrations", []),
        "migrations_pending": pending_migrations(bundle),
        "datasets": list(bundle.get("data_indices", {})),
        "model": bundle.get("config", {}).get("model", {}).get("name"),
        "num_params": meta.get("num_params"),
        "provenance": meta.get("provenance"),
        "params": "params.pt" if os.path.exists(os.path.join(path, "params.pt"))
        else "params.msgpack",
    }
    print(json.dumps(info, indent=1))
    return 0


def _evaluate(conf: dict, output_dir, rollout) -> int:
    from anemoi_tpu_torch.training.metrics import make_rollout_eval_fn
    from anemoi_tpu_torch.training.trainer import AnemoiTrainer

    conf.setdefault("training", {})["resume"] = True
    trainer = AnemoiTrainer(conf, output_dir=output_dir)
    rollout = rollout or trainer.rollout_schedule.maximum
    try:  # refuses a model the deterministic rollout cannot run, before any step
        fn = make_rollout_eval_fn(trainer.interface, rollout)
    except ValueError as err:
        print(f"evaluate: {err}")
        return 1
    trainer.datamodule.set_rollout(rollout)
    val = trainer.validate(rollout)
    agg: dict = {}
    for i, batch_np in enumerate(trainer.datamodule.val_batches()):
        for k, v in fn(trainer.put_batch(batch_np)).items():
            agg.setdefault(k, []).append(float(v))
        if i >= 4:
            break
    metrics = {k: sum(v) / len(v) for k, v in agg.items()}
    for lg in trainer.loggers:
        lg.finalize()
    print(f"evaluation: {val} {metrics}")
    return 0


def _train(conf: dict, output_dir) -> dict:
    from anemoi_tpu_torch.training.trainer import AnemoiTrainer

    return AnemoiTrainer(conf, output_dir=output_dir).train()


def _train_rank(conf: dict, output_dir) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    return _train(conf, output_dir)


def _train_local_ranks(conf: dict, output_dir, world: int, platform) -> int:
    """``train`` on ``world`` local ranks started here; the kernels are built
    once first, so that the ranks do not race on the build directory."""
    from anemoi_tpu_torch.parallel.distributed import spawn

    if platform is None or str(platform).lower() not in ("cpu",):
        from anemoi_tpu_torch.kernels.build import build_all

        build_all()
    results = spawn(_train_rank, world, args=(conf, output_dir), platform=platform)
    print(f"training done: {results[0]}")
    return 0


def _config_list() -> int:
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    for dirpath, _, files in sorted(os.walk(PACKAGED_CONFIG_DIR)):
        for f in sorted(files):
            if f.endswith(".yaml"):
                print(os.path.relpath(os.path.join(dirpath, f), PACKAGED_CONFIG_DIR))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = _parser().parse_args(argv)

    if args.command == "mlflow":
        return _mlflow(args)
    if args.command == "config" and args.config_command == "list":
        return _config_list()
    if args.command == "checkpoint":
        if args.checkpoint_command == "migrate":
            return _migrate(args)
        return _inspect(args.checkpoint)
    if args.command == "predict":
        from anemoi_tpu_torch.inference import run_forecast_cli

        return run_forecast_cli(args)

    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, dump_yaml, load_config

    conf = load_config(args.config, overrides=list(args.overrides),
                       search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    if args.command == "config":  # generate (list handled above)
        text = dump_yaml(conf)
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
            print(f"composed config -> {args.output}")
        else:
            print(text, end="")
        return 0
    if args.command == "validate" or (args.command == "train"
                                      and conf.get("config_validation", True)):
        from anemoi_tpu_torch.training.schemas import ConfigValidationError, validate_config

        try:
            validate_config(conf)
        except ConfigValidationError as err:
            print(f"config invalid: {err}")
            return 1
    if args.command == "validate":
        print("config OK")
        return 0
    if args.command == "train":
        hw = dict(conf.get("hardware") or {})
        world = int(hw.get("num_devices", 1))
        from anemoi_tpu_torch.parallel.distributed import _env_contract

        if world > 1 and _env_contract() is None:
            return _train_local_ranks(conf, args.output_dir, world, hw.get("platform"))
        result = _train(conf, args.output_dir)
        print(f"training done: {result}")
        return 0
    if args.command == "evaluate":
        return _evaluate(conf, args.output_dir, args.rollout)
    if args.command == "profile":
        return _profile(conf, args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
