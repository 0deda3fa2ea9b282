"""Loss framework: named, dimension-tagged scalers and a weighted reduction.

Port of ``anemoi_tpu.training.losses.base`` (``ScaleTensor``, ``BaseLoss``,
``get_loss_function``).  A :class:`ScaleTensor` holds named scalers, each
bound to named dimensions of the prediction ``[batch, time, ensemble, grid,
variable]``; ``scale()`` multiplies them in with broadcasting.  A loss is
the scaler-weighted mean of a pointwise error; NaN targets drop out.

The leaves and ``CombinedLoss`` are in ``leaves.py``, the spectral losses
in ``spectral.py``, the wrappers ``LossVariableMapper`` and
``TimeAggregateLossWrapper`` in ``wrappers.py``.  ``MultiscaleLossWrapper``
raises ``NotImplementedError`` (it needs the sparse projector).  The
``ScaleTensor`` hooks that only it uses (``update_scaler``, ``freeze``,
``validate``, the by-dimension selections) are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# canonical prediction layout
DIMS = {"batch": 0, "time": 1, "ensemble": 2, "grid": 3, "variable": 4}
LOSSES: Dict[str, Callable] = {}  # name -> loss class, filled by leaves.py, spectral.py, wrappers.py
WRAPPERS = ("LossVariableMapper", "TimeAggregateLossWrapper")


def register_loss(name: str):
    def deco(cls):
        LOSSES[name] = cls
        return cls

    return deco


def _float32(array) -> torch.Tensor:
    if not isinstance(array, torch.Tensor):
        array = np.asarray(array)
    return torch.as_tensor(array, dtype=torch.float32)


class ScaleTensor:
    """Named scalers bound to named dims of ``[B, T, E, G, V]`` tensors.
    Arrays are kept as float32 tensors; :meth:`to` moves them to a device."""

    def __init__(self, scalers: Optional[Dict[str, Tuple[Tuple[str, ...], object]]] = None):
        self.scalers: Dict[str, Tuple[Tuple[str, ...], torch.Tensor]] = {
            name: (tuple(dims), _float32(arr)) for name, (dims, arr) in (scalers or {}).items()
        }

    def add_scaler(self, dims, array, name: str) -> "ScaleTensor":
        dims = (dims,) if isinstance(dims, str) else tuple(dims)
        for d in dims:
            if d not in DIMS:
                raise ValueError(f"Unknown dim '{d}' (valid: {sorted(DIMS)})")
        array = _float32(array)
        if array.dim() != len(dims):
            raise ValueError(f"scaler '{name}' has {array.dim()} axes for dims {dims}")
        if name in self.scalers:
            # same-name add composes multiplicatively on matching dims
            old_dims, old = self.scalers[name]
            if old_dims != dims:
                raise ValueError(f"scaler '{name}' exists with dims {old_dims}, got {dims}")
            array = old * array.to(old.device)
        self.scalers[name] = (dims, array)
        return self

    def subset(self, names: Sequence[str]) -> "ScaleTensor":
        return self._of({n: self.scalers[n] for n in names if n in self.scalers})

    def without(self, names: Sequence[str]) -> "ScaleTensor":
        drop = set(names)
        return self._of({n: s for n, s in self.scalers.items() if n not in drop})

    @staticmethod
    def _of(scalers) -> "ScaleTensor":
        out = ScaleTensor()
        out.scalers = dict(scalers)
        return out

    def to(self, device) -> "ScaleTensor":
        """Move every scaler to ``device`` (in place); returns self."""
        self.scalers = {n: (dims, a.to(device)) for n, (dims, a) in self.scalers.items()}
        return self

    @staticmethod
    def _broadcast(dims: Tuple[str, ...], array: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        for axis_name, size in zip(dims, array.shape):
            shape[DIMS[axis_name]] = size
        return array.to(device=x.device, dtype=x.dtype).reshape(shape)

    def scale(self, x: torch.Tensor) -> torch.Tensor:
        for dims, array in self.scalers.values():
            x = x * self._broadcast(dims, array, x)
        return x

    def combined_weight(self, x: torch.Tensor) -> torch.Tensor:
        """The product of all scalers broadcast to ``x``'s shape."""
        w = torch.ones((1,) * x.dim(), dtype=x.dtype, device=x.device)
        for dims, array in self.scalers.values():
            w = w * self._broadcast(dims, array, x)
        return w.expand(x.shape)

    def __contains__(self, name: str) -> bool:
        return name in self.scalers

    def __repr__(self) -> str:
        parts = [f"{n}:{dims}{tuple(a.shape)}" for n, (dims, a) in self.scalers.items()]
        return f"ScaleTensor({', '.join(parts)})"


class BaseLoss:
    """Scaler-weighted loss with NaN masking: the pointwise error times every
    scaler, NaN targets out of both numerator and denominator, the weighted
    mean (``squash``) or the per-variable weighted mean (``squash=False``)."""

    def __init__(self, scalers: Optional[ScaleTensor] = None, ignore_nans: bool = True):
        self.scalers = scalers or ScaleTensor()
        self.ignore_nans = ignore_nans

    def error(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def to(self, device) -> "BaseLoss":
        self.scalers.to(device)
        return self

    def __call__(
        self,
        pred: torch.Tensor,  # [B, T, E, G, V]
        target: torch.Tensor,
        squash: bool = True,
        scaler_subset: Optional[Sequence[str]] = None,
        without_scalers: Optional[Sequence[str]] = None,
        mask: Optional[torch.Tensor] = None,  # [B, G, V] imputer loss mask
    ) -> torch.Tensor:
        scalers = self.scalers
        if scaler_subset is not None:
            scalers = scalers.subset(scaler_subset)
        if without_scalers is not None:
            scalers = scalers.without(without_scalers)

        if self.ignore_nans:
            # zero-fill both operands before the error: masking the error
            # afterwards still multiplies a zero cotangent by the NaN
            # derivative (0 * NaN = NaN) and poisons every gradient
            valid = ~torch.isnan(target)
            zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
            pred = torch.where(valid, pred, zero)
            target = torch.where(valid, target, zero.to(target.dtype))
            err = self.error(pred, target) * valid.to(pred.dtype)
        else:
            err = self.error(pred, target)
            valid = torch.ones_like(err, dtype=torch.bool)

        weighted = scalers.scale(err)
        weight = scalers.combined_weight(err) * valid.to(err.dtype)
        if mask is not None:
            # zero weight where an imputed input that is also an output was
            # NaN; mask [B, G, V] broadcast over time and ensemble
            m = mask.reshape(
                mask.shape[0], *([1] * (err.dim() - 3)), mask.shape[-2], mask.shape[-1]
            ).to(err.dtype)
            weighted = weighted * m
            weight = weight * m

        if squash:
            return weighted.sum() / weight.sum().clamp_min(1e-12)
        axes = tuple(range(err.dim() - 1))  # all but the variable dim
        return weighted.sum(axes) / weight.sum(axes).clamp_min(1e-12)

    @property
    def name(self) -> str:
        return self.__class__.__name__.lower()


def get_loss_function(
    config: dict,
    scalers: Optional[Dict[str, Tuple[Tuple[str, ...], object]]] = None,
    data_indices=None,
    variables_metadata: Optional[dict] = None,
) -> BaseLoss:
    """Build a loss from ``{"name": "WeightedMSELoss", "scalers": [...],
    ...}``, attaching the named subset (``"*"`` = all) of pre-built
    ``scalers``.  A wrapper's config holds the wrapped loss under ``loss``;
    a ``scalers`` list on the wrapper goes to the wrapped loss.
    ``LossVariableMapper`` needs ``data_indices``, and checks the units of
    each predicted/target pair it maps against ``variables_metadata``."""
    cfg = dict(config)
    name = cfg.pop("name", "WeightedMSELoss")
    if name in WRAPPERS:
        inner_cfg = dict(cfg.pop("loss", {"name": "WeightedMSELoss"}))
        wrapper_scalers = cfg.pop("scalers", None)
        if wrapper_scalers is not None and "scalers" not in inner_cfg:
            inner_cfg["scalers"] = wrapper_scalers
        inner = get_loss_function(inner_cfg, scalers, data_indices=data_indices,
                                  variables_metadata=variables_metadata)
        if name == "TimeAggregateLossWrapper":
            return LOSSES[name](inner, **cfg)
        if data_indices is None:
            raise ValueError("LossVariableMapper needs data_indices")
        wrapped = LOSSES[name](inner, data_indices, **cfg)
        if wrapped.predicted_variables != wrapped.target_variables:
            from anemoi_tpu_torch.utils.variables_metadata import (
                check_loss_variable_units_compatibility,
            )

            check_loss_variable_units_compatibility(
                wrapped.predicted_variables, wrapped.target_variables, variables_metadata)
        return wrapped
    if name not in LOSSES:  # MultiscaleLossWrapper
        raise NotImplementedError(f"loss '{name}' is not ported to anemoi_tpu_torch")
    wanted = cfg.pop("scalers", ["*"])
    available = scalers or {}
    if "*" in wanted:
        wanted = list(available)
    st = ScaleTensor()
    for scaler_name in wanted:
        if scaler_name in available:
            dims, arr = available[scaler_name]
            st.add_scaler(dims, arr, scaler_name)
    return LOSSES[name](scalers=st, **cfg)
