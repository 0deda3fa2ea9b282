"""Variable names, groups and levels.

The port's copy of the part of ``anemoi_tpu.utils.variables_metadata`` that
the loss scalers use: :func:`crack_variable_name`, :class:`VariableMetadata`
(param, level and surface flag from a dataset's per-variable metadata,
mars keys or plain keys) and :class:`ExtractVariableGroupAndLevel`, which
resolves a variable's group from ``training.variable_groups``,
:func:`check_loss_variable_units_compatibility`, which a loss that scores
one variable against another runs, and the checkpoint-versus-dataset checks
that the trainer runs after a checkpoint pipeline loads weights
(:func:`extract_variables_metadata_from_checkpoint`,
:func:`check_variables_metadata_compatibility`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

LOGGER = logging.getLogger(__name__)

GROUP_SPEC = Union[str, List[str], bool, dict]

# mars levtypes that denote surface/single-level fields
_SURFACE_LEVTYPES = {"sfc", "o2d", "surface"}


def crack_variable_name(variable_name: str) -> Tuple[str, Optional[int]]:
    """``q_850`` -> ``("q", 850)``; names without a numeric suffix give
    ``(name, None)``."""
    head, _, tail = variable_name.rpartition("_")
    if head and tail.isdigit():
        return head, int(tail)
    return variable_name, None


@dataclass
class VariableMetadata:
    """Per-variable metadata: param, level, surface flag, units."""

    name: str
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, name: str, data: Optional[dict]) -> "VariableMetadata":
        return cls(name=name, raw=dict(data or {}))

    @property
    def _mars(self) -> dict:
        return self.raw.get("mars", {}) or {}

    @property
    def param(self) -> str:
        p = self._mars.get("param") or self.raw.get("param")
        return str(p) if p is not None else crack_variable_name(self.name)[0]

    @property
    def level(self) -> Optional[int]:
        lvl = self._mars.get("levelist", self.raw.get("level"))
        return None if lvl is None else int(lvl)

    @property
    def is_surface_level(self) -> bool:
        levtype = self._mars.get("levtype", self.raw.get("levtype"))
        if levtype is not None:
            return str(levtype) in _SURFACE_LEVTYPES
        return self.level is None

    @property
    def units(self) -> Optional[str]:
        return self.raw.get("units")

    @property
    def processing(self) -> Optional[list]:
        """Accumulation or processing period descriptors, if recorded."""
        return self.raw.get("process", self.raw.get("processing"))

    def incompatibility(self, other: "VariableMetadata") -> Optional[str]:
        """Why the two disagree on units or processing period (where both
        record them), or None."""
        if self.units and other.units and self.units != other.units:
            return f"units differ: {self.units!r} vs {other.units!r}"
        if (self.processing is not None and other.processing is not None
                and self.processing != other.processing):
            return f"processing differs: {self.processing!r} vs {other.processing!r}"
        return None

    def __getattr__(self, key: str):
        # complex variable_groups specs match arbitrary metadata keys
        raw = object.__getattribute__(self, "raw")
        if key in raw:
            return raw[key]
        mars = raw.get("mars") or {}
        if key in mars:
            return mars[key]
        raise AttributeError(key)


class ExtractVariableGroupAndLevel:
    """(group, param, level) of a variable from ``variable_groups`` and the
    dataset's optional per-variable metadata.

    Group specs: simple, ``{"pl": ["q", "t"], "default": "sfc"}`` (the
    variable's param is matched against the list), or complex, ``{"pl":
    {"levtype": "pl"}}`` (every key/value is matched against the variable's
    metadata; only ``{"param": ...}`` works without metadata)."""

    def __init__(
        self,
        variable_groups: Dict[str, GROUP_SPEC],
        metadata_variables: Optional[Dict[str, Union[dict, VariableMetadata]]] = None,
    ) -> None:
        variable_groups = dict(variable_groups or {"default": "sfc"})
        if "default" not in variable_groups:
            raise ValueError("Default group not defined in variable_groups")
        self.default_group = variable_groups.pop("default")
        self.variable_groups = variable_groups
        self.metadata_variables: Dict[str, VariableMetadata] = {
            name: val if isinstance(val, VariableMetadata) else VariableMetadata(name, dict(val or {}))
            for name, val in (metadata_variables or {}).items()
        }

    def _is_metadata_trusted(self, variable_name: str) -> bool:
        """Vertical-level variables carry a level, surface ones do not."""
        meta = self.metadata_variables.get(variable_name)
        if meta is None:
            return False
        return (not meta.is_surface_level) ^ (meta.level is None)

    def get_param(self, variable_name: str) -> str:
        if self._is_metadata_trusted(variable_name):
            return self.metadata_variables[variable_name].param
        return crack_variable_name(variable_name)[0]

    def get_level(self, variable_name: str) -> Optional[int]:
        if self._is_metadata_trusted(variable_name):
            return self.metadata_variables[variable_name].level
        return crack_variable_name(variable_name)[1]

    def get_group(self, variable_name: str) -> str:
        for group_name, spec in self.variable_groups.items():
            if isinstance(spec, (list, str)):
                params = spec if isinstance(spec, list) else [spec]
                if self.get_param(variable_name) in params:
                    return group_name
            elif isinstance(spec, dict):
                if variable_name not in self.metadata_variables:
                    if set(spec.keys()) != {"param"}:
                        raise ValueError(
                            f"Variable {variable_name} not found in metadata; complex "
                            f"variable_groups specs other than {{'param': ...}} need metadata."
                        )
                    params = spec["param"] if isinstance(spec["param"], list) else [spec["param"]]
                    if self.get_param(variable_name) in params:
                        return group_name
                else:
                    meta = self.metadata_variables[variable_name]
                    if all(
                        getattr(meta, key, None) in (val if isinstance(val, list) else [val])
                        for key, val in spec.items()
                    ):
                        return group_name
        return self.default_group

    def get_group_and_level(self, variable_name: str) -> Tuple[str, str, Optional[int]]:
        return (
            self.get_group(variable_name),
            self.get_param(variable_name),
            self.get_level(variable_name),
        )


def extract_variables_metadata_from_checkpoint(
    metadata: dict, dataset_names
) -> Optional[Dict[str, dict]]:
    """The per-dataset ``variables_metadata`` of a bundle's metadata."""
    dataset_meta = (metadata or {}).get("dataset", {})
    out = {}
    for name in dataset_names:
        vm = (dataset_meta.get(name) or {}).get("variables_metadata")
        if vm is not None:
            out[name] = vm
    return out or None


def check_variables_metadata_compatibility(
    ckpt_variables_metadata: Optional[Dict[str, dict]],
    dataset_metadata: Dict[str, dict],
) -> None:
    """Units and processing period of a checkpoint's variables against the
    dataset's: ``ValueError`` on a mismatch; a warning, and no check, where
    either side has no metadata."""
    if ckpt_variables_metadata is None:
        LOGGER.warning("Checkpoint has no variables_metadata; skipping unit compatibility check.")
        return
    for dataset_name, ckpt_vm in ckpt_variables_metadata.items():
        ds_vm = (dataset_metadata.get(dataset_name) or {}).get("variables_metadata")
        if ds_vm is None:
            LOGGER.warning("Dataset %r has no variables_metadata; skipping unit compatibility "
                           "check.", dataset_name)
            continue
        for name, data in ckpt_vm.items():
            if name not in ds_vm:
                continue
            reason = VariableMetadata.from_dict(name, data).incompatibility(
                VariableMetadata.from_dict(name, ds_vm[name]))
            if reason is not None:
                raise ValueError(f"Variable compatibility check failed for dataset "
                                 f"{dataset_name!r}, variable {name!r}: {reason}")


def check_loss_variable_units_compatibility(
    predicted_variables: List[str],
    target_variables: List[str],
    variables_metadata: Optional[Dict[str, dict]],
) -> None:
    """Raise ``ValueError`` where a loss scores a predicted variable against
    a target variable whose units (or processing period) differ; pairs
    without metadata are skipped with a warning."""
    if variables_metadata is None:
        LOGGER.warning("No variables_metadata available; skipping loss variable unit check.")
        return
    if len(predicted_variables) != len(target_variables):
        raise ValueError("predicted and target variable lists differ in length")
    for pred, target in zip(predicted_variables, target_variables):
        if pred == target:
            continue
        if pred not in variables_metadata or target not in variables_metadata:
            LOGGER.warning("Variable pair (%s, %s) missing metadata; skipping unit check.",
                           pred, target)
            continue
        a = VariableMetadata.from_dict(pred, variables_metadata[pred])
        b = VariableMetadata.from_dict(pred, variables_metadata[target])
        reason = a.incompatibility(b)
        if reason is not None:
            raise ValueError(f"Loss variable mismatch: predicted {pred!r} and target "
                             f"{target!r} are not compatible: {reason}")
