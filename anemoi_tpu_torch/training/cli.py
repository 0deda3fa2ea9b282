"""``anemoi-tpu-torch-training``: the port's training CLI.

Port of ``anemoi_tpu.training.cli`` with the same arguments:

    train <config.yaml|json> [a.b.c=value ...] [--output-dir DIR]
    evaluate <config.yaml|json> [a.b.c=value ...] [--output-dir DIR] [--rollout N]
    predict <bundle> [--config C.yaml] [--steps N] [--start-index I]
                     [--output F.npz] [--seed S] [--platform cpu] [--aot-cache DIR]
    config list
    config generate <config.yaml|json> [a.b.c=value ...] [--output F.yaml]
    checkpoint inspect <bundle>

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
are not schema-validated (``schemas.py`` needs pydantic and is not ported).
The subcommands ``validate``, ``mlflow``, ``profile`` and ``checkpoint
migrate`` are not ported: they print so and return 2.

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

NOT_PORTED = 2


def _not_ported(what: str) -> int:
    print(f"{what}: not ported to anemoi_tpu_torch")
    return NOT_PORTED


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="anemoi-tpu-torch-training")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="Train a model from a YAML or JSON config")
    p_train.add_argument("config", help="YAML or JSON config path")
    p_train.add_argument("overrides", nargs="*", help="a.b.c=value overrides")
    p_train.add_argument("--output-dir", default=None)

    p_val = sub.add_parser("validate", help="(not ported)")
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

    p_ckpt = sub.add_parser("checkpoint", help="Inspect checkpoints")
    ckpt_sub = p_ckpt.add_subparsers(dest="checkpoint_command", required=True)
    p_ck_insp = ckpt_sub.add_parser("inspect", help="Summarise an inference checkpoint")
    p_ck_insp.add_argument("checkpoint")
    p_ck_mig = ckpt_sub.add_parser("migrate", help="(not ported)")
    p_ck_mig.add_argument("checkpoint", nargs="?", default=None)
    p_ck_mig.add_argument("--create", default=None, metavar="LABEL")
    p_ck_mig.add_argument("--scripts-dir", default=None)
    p_ck_mig.add_argument("--rollback", default=None, metavar="TARGET")

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

    p_mlf = sub.add_parser("mlflow", help="(not ported)")
    p_mlf.add_argument("rest", nargs="*")

    p_prof = sub.add_parser("profile", help="(not ported)")
    p_prof.add_argument("rest", nargs="*")
    return parser


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

    if args.command in ("validate", "mlflow", "profile"):
        return _not_ported(args.command)
    if args.command == "config" and args.config_command == "list":
        return _config_list()
    if args.command == "checkpoint":
        if args.checkpoint_command == "migrate":
            return _not_ported("checkpoint migrate")
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
    return 1


if __name__ == "__main__":
    sys.exit(main())
