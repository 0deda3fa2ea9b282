"""Config validation without pydantic.

Port of ``anemoi_tpu.training.schemas`` as plain functions over the
composed config dict (``cli validate``): the same fields, defaults, bounds
and cross-field checks, with pydantic's lax coercion of scalars (an int
field takes ``3``, ``3.0`` or ``"3"``, a bool field ``true``, ``1`` or
``"yes"``), and component names checked against the port's own tables
(models, mappers, processors, boundings, residuals, noise injectors,
preprocessors, losses, scalers, graph builders and attributes).  The first
refusal raises :class:`ConfigValidationError`, a ``ValueError`` whose
``path`` is the field's location as the JAX package's ``ValidationError``
reports it (``("model", "processor", "name")``), checked in pydantic's
order (the fields of each section in declaration order, a section's
cross-field check after its fields).

Where the port runs less or more than the JAX package, its tables say so:
``hardware.platform`` is ``cpu``, ``gpu`` or ``cuda``; the optimizers are
the port's (``adamw``, ``adam``, ``ademamix``); the residuals include
``SpectralOrnsteinConnection``, which the port builds by name.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

Path = Tuple[Any, ...]

PLATFORMS = ("cpu", "gpu", "cuda")
PRECISIONS = ("fp32", "bf16", "bfloat16", "16-mixed")
SHARD_STRATEGIES = ("none", "gspmd", "edges", "heads")
MLP_IMPLEMENTATIONS = ("mlp", "glu", "swiglu", "geglu", "reglu")
REMAT_POLICIES = (None, "full", "save_attention", "save_attention_mlp", "dots")
DATASET_KINDS = ("synthetic", "npy", "zarr", "trajectory")
RESIDUALS = ("SkipConnection", "NoResidualConnection", "TruncatedConnection",
             "ScalarOrnsteinConnection", "SpectralOrnsteinConnection")
_MISSING = object()


class ConfigValidationError(ValueError):
    """A refused config field: ``path`` (a tuple of keys and indices) and
    what is wrong with it."""

    def __init__(self, path: Path, message: str) -> None:
        self.path = tuple(path)
        self.message = message
        super().__init__(f"{'.'.join(map(str, self.path)) or '<config>'}: {message}")


def _registries() -> Dict[str, Any]:
    # imported lazily: validation must not drag model code in at import time
    from anemoi_tpu_torch.graphs.edges import EDGE_ATTRIBUTES, EDGE_BUILDERS
    from anemoi_tpu_torch.graphs.nodes import NODE_ATTRIBUTES, NODE_BUILDERS
    from anemoi_tpu_torch.models.encoder_processor_decoder import COMPONENTS
    from anemoi_tpu_torch.models.interface import MODELS
    from anemoi_tpu_torch.models.layers.bounding import BOUNDINGS
    from anemoi_tpu_torch.models.layers.ensemble import INJECTORS
    from anemoi_tpu_torch.preprocessing.processors import PROCESSORS
    from anemoi_tpu_torch.training.losses import base as losses
    from anemoi_tpu_torch.training.losses.scalers import SCALERS

    def role(part):
        return {name for name, entry in COMPONENTS.items() if entry[0] == part}

    return {
        "model": set(MODELS), "encoder": role("encoder"), "decoder": role("decoder"),
        "processor": role("processor"), "bounding": set(BOUNDINGS), "residual": set(RESIDUALS),
        "noise injector": set(INJECTORS), "preprocessor": set(PROCESSORS),
        "loss": set(losses.LOSSES), "scaler": set(SCALERS), "node builder": set(NODE_BUILDERS),
        "node attribute": set(NODE_ATTRIBUTES), "edge builder": set(EDGE_BUILDERS),
        "edge attribute": set(EDGE_ATTRIBUTES),
    }


# --- scalars, with pydantic's lax coercion ------------------------------
def _int(v, path: Path):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if v.is_integer():
            return int(v)
        raise ConfigValidationError(path, "Input should be a valid integer, got a number with "
                                          "a fractional part")
    if isinstance(v, str):
        try:
            return int(v.strip())
        except ValueError:
            pass
    raise ConfigValidationError(path, "Input should be a valid integer")


def _float(v, path: Path):
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            pass
    raise ConfigValidationError(path, "Input should be a valid number")


_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _bool(v, path: Path):
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.strip().lower() in _TRUE | _FALSE:
        return v.strip().lower() in _TRUE
    raise ConfigValidationError(path, "Input should be a valid boolean")


def _str(v, path: Path):
    if isinstance(v, str):
        return v
    raise ConfigValidationError(path, "Input should be a valid string")


def _dict(v, path: Path):
    if isinstance(v, dict):
        return v
    raise ConfigValidationError(path, "Input should be a valid dictionary")


def _list(v, path: Path):
    if isinstance(v, (list, tuple)):
        return list(v)
    raise ConfigValidationError(path, "Input should be a valid list")


class _Section:
    """The fields of one config section, read in declaration order."""

    def __init__(self, cfg, path: Path) -> None:
        self.cfg = _dict(cfg, path)
        self.path = path

    def field(self, key: str, kind: Callable, default=_MISSING, optional: bool = False,
              ge=None, gt=None, lt=None, item: Optional[Callable] = None):
        path = self.path + (key,)
        if key not in self.cfg:
            if default is _MISSING:
                raise ConfigValidationError(path, "Field required")
            return default
        v = self.cfg[key]
        if v is None and optional:
            return None
        v = kind(v, path)
        for bound, ok, word in ((ge, lambda x, b: x >= b, "greater than or equal to"),
                                (gt, lambda x, b: x > b, "greater than"),
                                (lt, lambda x, b: x < b, "less than")):
            if bound is not None and not ok(v, bound):
                raise ConfigValidationError(path, f"Input should be {word} {bound}")
        if item is not None:
            v = [item(x, path + (i,)) for i, x in enumerate(v)] if isinstance(v, list) else \
                {k: item(x, path + (k,)) for k, x in v.items()}
        return v

    def error(self, key: Optional[str], message: str):
        return ConfigValidationError(self.path + ((key,) if key else ()), message)


def _check(section: _Section, key: Optional[str], ok: bool, message: str) -> None:
    if not ok:
        raise section.error(key, message)


def _registered(kind: str, name, path: Path) -> None:
    reg = _registries()[kind]
    if name not in reg:
        raise ConfigValidationError(path, f"unknown {kind} '{name}'. Known: "
                                          f"{', '.join(sorted(reg))}")


# --- sections ------------------------------------------------------------
def _component(cfg, path: Path, role: str, default_name: str) -> None:
    s = _Section(cfg, path)
    name = s.field("name", _str, default_name)
    if "name" in s.cfg:
        _registered(role, name, path + ("name",))
    if role == "processor":
        s.field("num_layers", _int, 16, ge=1)
    s.field("num_heads", _int, 16, ge=1)
    s.field("mlp_hidden_ratio", _float, 4.0, gt=0)
    if role == "encoder":
        s.field("qk_norm", _bool, False)
        qknt = s.field("qk_norm_type", _str, "layernorm")
        _check(s, "qk_norm_type", qknt in ("layernorm", "rmsnorm"),
               f"unknown qk_norm_type '{qknt}'")
    if role == "processor":
        s.field("window_size", _int, None, optional=True, ge=1)
        s.field("qk_norm", _bool, False)
        impl = s.field("mlp_implementation", _str, "mlp")
        _check(s, "mlp_implementation", impl in MLP_IMPLEMENTATIONS,
               f"unknown mlp_implementation '{impl}'")
        s.field("gradient_checkpointing", _bool, True)
        policy = s.field("remat_policy", _str, "save_attention", optional=True)
        _check(s, "remat_policy", policy in REMAT_POLICIES, f"unknown remat_policy '{policy}'")
        s.field("scan_layers", _bool, True)
    if role == "decoder":
        s.field("initialise_data_extractor_zero", _bool, False)
    s.field("trainable_size", _int, 0, ge=0)


def _model(cfg, path: Path) -> None:
    s = _Section(cfg, path)
    name = s.field("name", _str, "AnemoiModelEncProcDec")
    if "name" in s.cfg:
        _registered("model", name, path + ("name",))
    for key in ("num_channels", "n_step_input", "n_step_output"):
        s.field(key, _int, 1, ge=1)
    s.field("latent_skip", _bool, True)
    backend = s.field("graph_attention_backend", _str, "padded")
    _check(s, "graph_attention_backend", backend in ("segment", "padded", "paged"),
           f"unknown graph_attention_backend '{backend}'")
    strategy = s.field("shard_strategy", _str, "none")
    _check(s, "shard_strategy", strategy in SHARD_STRATEGIES,
           f"unknown shard_strategy '{strategy}' (none|gspmd|edges|heads)")
    s.field("num_model_shards", _int, 1, ge=1)
    s.field("bucketed_gathers", _bool, True)
    s.field("paged_mappers", _bool, True)
    for key in ("paged_block", "paged_mapper_block"):
        block = s.field(key, _list, None, optional=True, item=_int)
        _check(s, key, block is None or (len(block) == 3 and all(x > 0 for x in block)),
               "paged block must be [block_dst, page, r] positive ints")
    s.field("paged_fused_bwd", _bool, False)
    s.field("paged_mapper_fused_bwd", _bool, None, optional=True)
    s.field("halo_overlap", _bool, True)
    precision = s.field("inference_precision", _str, "bf16")
    _check(s, "inference_precision", precision in PRECISIONS,
           f"unknown inference_precision '{precision}'")
    s.field("gspmd_paged_upgrade", _bool, True)
    s.field("level_channel_ratio", _int, 1, ge=1)
    s.field("level_process_num_layers", _int, None, optional=True, ge=1)
    s.field("fcstep_input", _bool, True)
    s.field("noise_channels", _int, None, optional=True, ge=2)
    s.field("noise_cond_dim", _int, None, optional=True, ge=1)
    s.field("noise_max_period", _float, None, optional=True)
    s.field("conditional_mappers", _bool, None, optional=True)
    for role, default in (("encoder", "GraphTransformerForwardMapper"),
                          ("processor", "GraphTransformerProcessor"),
                          ("decoder", "GraphTransformerBackwardMapper")):
        if role in s.cfg:
            _component(s.cfg[role], path + (role,), role, default)
    trainable = s.field("trainable_parameters", _dict, None, optional=True, item=_int)
    for k, size in (trainable or {}).items():
        _check(s, "trainable_parameters", size >= 0, f"trainable_parameters[{k}] must be >= 0")
    bounding = s.field("bounding", _list, None, optional=True, item=_dict)
    for entry in bounding or []:
        _registered("bounding", entry.get("name", "?"), path + ("bounding",))
    for key, kind in (("residual", "residual"), ("noise_injector", "noise injector")):
        value = s.field(key, _dict, None, optional=True)
        if value and "name" in value:
            _registered(kind, value["name"], path + (key,))


def _training(cfg, path: Path) -> None:
    s = _Section(cfg, path)
    s.field("max_epochs", _int, 1, ge=1)
    s.field("max_steps", _int, None, optional=True, ge=1)
    if "lr" in s.cfg:
        lr = _Section(s.cfg["lr"], path + ("lr",))
        lr.field("rate", _float, 1e-4, gt=0)
        lr.field("min", _float, 3e-7, ge=0)
        lr.field("warmup", _int, 1000, ge=0)
        lr.field("iterations", _int, 300000, ge=1)
    if "rollout" in s.cfg:
        ro = _Section(s.cfg["rollout"], path + ("rollout",))
        start = ro.field("start", _int, 1, ge=1)
        ro.field("epoch_increment", _int, 0, ge=0)
        maximum = ro.field("max", _int, 1, ge=1)
        _check(ro, None, maximum >= start, "rollout.max must be >= rollout.start")
    if "gradient_clip" in s.cfg:
        clip = _Section(s.cfg["gradient_clip"], path + ("gradient_clip",))
        clip.field("val", _float, 32.0, gt=0)
        alg = clip.field("algorithm", _str, "value")
        _check(clip, "algorithm", alg in ("value", "norm"),
               f"unknown gradient_clip.algorithm '{alg}'")
    if "optimizer" in s.cfg:
        from anemoi_tpu_torch.training.optimizers import OPTIMIZERS

        opt = _Section(s.cfg["optimizer"], path + ("optimizer",))
        name = opt.field("name", _str, "adamw")
        _check(opt, "name", name in OPTIMIZERS, f"unknown optimizer '{name}'")
        opt.field("b1", _float, 0.9, gt=0, lt=1)
        opt.field("b2", _float, 0.95, gt=0, lt=1)
        opt.field("weight_decay", _float, 0.0, ge=0)
        opt.field("zero", _bool, False)
    loss = s.field("loss", _dict, None, optional=True)
    if loss and "name" in loss:
        _registered("loss", loss["name"], path + ("loss",))
        for member in loss.get("losses") or []:  # CombinedLoss members
            if isinstance(member, dict) and "name" in member:
                _registered("loss", member["name"], path + ("loss",))
    for scaler in (s.field("scalers", _dict, None, optional=True) or {}).values():
        if isinstance(scaler, dict) and "name" in scaler:
            _registered("scaler", scaler["name"], path + ("scalers",))
    precision = s.field("precision", _str, "fp32")
    _check(s, "precision", precision in PRECISIONS, f"unknown precision '{precision}'")
    s.field("fp32_head", _bool, False)
    task = s.field("task", _str, "forecaster")
    _check(s, "task", task in ("forecaster", "autoencoder", "temporal_downscaler", "transport"),
           f"unknown task '{task}'")
    s.field("ensemble_size", _int, 1, ge=1)
    s.field("validation_rollout", _int, 0, ge=0)
    for key in ("precompile_rollouts", "remat_rollout"):
        s.field(key, _bool, True)
    s.field("remat_policy", _str, None, optional=True)
    s.field("donate_state", _bool, False)
    transport = s.field("transport", _dict, None, optional=True)
    if transport and "objective" in transport:
        _check(s, "transport", transport["objective"] in ("edm", "interpolant"),
               f"unknown transport objective '{transport['objective']}'")


def _graph(cfg, path: Path) -> None:
    s = _Section(cfg, path)
    recipe = s.field("recipe", _dict, None, optional=True)
    if recipe is not None:
        r = _Section(recipe, path + ("recipe",))
        nodes = r.field("nodes", _dict, None, optional=True, item=_dict)
        for ncfg in (nodes or {}).values():
            builder = ncfg.get("node_builder") or {}
            if "name" in builder:
                _registered("node builder", builder["name"], path + ("recipe", "nodes"))
            for attr in (ncfg.get("attributes") or {}).values():
                if "name" in attr:
                    _registered("node attribute", attr["name"], path + ("recipe", "nodes"))
        edges = r.field("edges", _list, None, optional=True, item=_dict)
        for entry in edges or []:
            builder = entry.get("edge_builder") or {}
            if "name" in builder:
                _registered("edge builder", builder["name"], path + ("recipe", "edges"))
            for attr in (entry.get("attributes") or {}).values():
                if "name" in attr:
                    _registered("edge attribute", attr["name"], path + ("recipe", "edges"))
        r.field("post_processors", _list, None, optional=True, item=_dict)
    s.field("save_path", _str, None, optional=True)
    s.field("load_path", _str, None, optional=True)


def _hardware(cfg, path: Path) -> None:
    s = _Section(cfg, path)
    n_dev = s.field("num_devices", _int, None, optional=True, ge=1)
    per_model = s.field("num_devices_per_model", _int, 1, ge=1)
    per_ens = s.field("num_devices_per_ensemble", _int, 1, ge=1)
    platform = s.field("platform", _str, None, optional=True)
    _check(s, "platform", platform is None or platform in PLATFORMS,
           f"unknown platform '{platform}' ({'|'.join(PLATFORMS)})")
    s.field("num_virtual_devices", _int, None, optional=True, ge=1)
    if n_dev is not None:
        per = per_model * per_ens
        _check(s, None, n_dev % per == 0,
               f"num_devices ({n_dev}) must be divisible by num_devices_per_model x "
               f"num_devices_per_ensemble ({per})")


def _dataloader(cfg, path: Path) -> None:
    s = _Section(cfg, path)
    s.field("batch_size", _int, 1, ge=1)
    s.field("validation_fraction", _float, 0.15, ge=0.0, lt=1.0)
    s.field("shard_grid", _bool, True)
    s.field("prefetch", _int, 2, ge=0)


def _diagnostics(cfg, path: Path) -> None:
    s = _Section(cfg, path)
    s.field("log_interval", _int, 10, ge=1)
    s.field("checkpoint_interval", _int, 500, ge=1)
    s.field("callbacks", _list, None, optional=True, item=_dict)
    s.field("loggers", _list, None, optional=True, item=_dict)


def _data(cfg, path: Path) -> None:
    s = _Section(cfg, path)
    for name, ds in s.field("datasets", _dict, item=_dict).items():
        dss = _Section(ds, path + ("datasets", name))
        kind = dss.field("kind", _str, "synthetic")
        _check(dss, "kind", kind in DATASET_KINDS, f"unknown dataset kind '{kind}'")
    lists = {key: s.field(key, _list, None, optional=True, item=_str)
             for key in ("forcing", "diagnostic", "target")}
    processors = s.field("processors", _list, None, optional=True, item=_dict)
    for entry in processors or []:
        _registered("preprocessor", entry.get("name", "?"), path + ("processors",))
    f, d, t = (set(lists[k] or []) for k in ("forcing", "diagnostic", "target"))
    _check(s, None, f.isdisjoint(d), f"forcing/diagnostic overlap: {f & d}")
    _check(s, None, d.isdisjoint(t), f"diagnostic/target overlap: {d & t}")


SECTIONS = (("data", _data), ("model", _model), ("training", _training), ("graph", _graph),
            ("hardware", _hardware), ("dataloader", _dataloader),
            ("diagnostics", _diagnostics))


def validate_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Check a composed config; returns it, or raises
    :class:`ConfigValidationError` at the first refused field."""
    _dict(config, ())
    if "data" not in config:
        raise ConfigValidationError(("data",), "Field required")
    for key, check in SECTIONS:
        if key in config:
            check(config[key], (key,))
    return config
