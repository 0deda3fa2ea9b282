"""Loss framework: named, dimension-tagged scalers and a weighted reduction.

Port of ``anemoi_tpu.training.losses.base`` (``ScaleTensor``, ``BaseLoss``,
``get_loss_function``).  A :class:`ScaleTensor` holds named scalers, each
bound to named dimensions of the prediction ``[batch, time, ensemble, grid,
variable]``; ``scale()`` multiplies them in with broadcasting.  A loss is
the scaler-weighted mean of a pointwise error; NaN targets drop out.

The leaves and ``CombinedLoss`` are in ``leaves.py``, the spectral losses
in ``spectral.py``, the wrappers ``LossVariableMapper`` and
``TimeAggregateLossWrapper`` in ``wrappers.py``, ``MultiscaleLossWrapper``
in ``multiscale.py``.

Under model shards each rank scores its grid rows (:func:`grid_sharded`),
so that the ranks' values add up to the loss of the whole grid: a sum over
rows cuts the grid-bound scalers to the rows and sums the weighted mean's
denominator over the model group; the RMSE also sums its numerator before
the root; a loss that mixes grid rows gathers them whole
(:class:`WholeGridLoss`) and each rank takes ``1 / S`` of its value.  Along an ensemble group the training
step hands every loss the members of all the group's ranks
(:func:`gather_members`), so a CRPS sees the whole ensemble.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import copy

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
        self._frozen: set = set()

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

    def update_scaler(self, name: str, array, override: bool = False) -> "ScaleTensor":
        """Replace an existing scaler's values (same shape); a frozen scaler
        refuses unless ``override``."""
        if name not in self.scalers:
            raise KeyError(f"unknown scaler '{name}'")
        if name in self._frozen and not override:
            raise ValueError(f"scaler '{name}' is frozen (pass override=True)")
        dims, old = self.scalers[name]
        array = _float32(array).to(old.device)
        if array.shape != old.shape:
            raise ValueError(f"updating scaler '{name}': shape {tuple(array.shape)} != "
                             f"{tuple(old.shape)}")
        self.scalers[name] = (dims, array)
        return self

    def freeze(self, names: Optional[Sequence[str]] = None) -> "ScaleTensor":
        """Make scalers (default: all) refuse :meth:`update_scaler`."""
        self._frozen.update(names if names is not None else self.scalers)
        return self

    def validate(self, shape: Sequence[int]) -> None:
        """Raise unless every scaler broadcasts against a ``[B, T, E, G, V]``
        tensor of ``shape``: each bound dim matches or is 1."""
        for name, (dims, array) in self.scalers.items():
            for d, size in zip(dims, array.shape):
                want = shape[DIMS[d]]
                if size not in (1, want):
                    raise ValueError(f"scaler '{name}' dim '{d}' has size {size}, tensor has "
                                     f"{want}")

    @staticmethod
    def _dims_set(dimensions) -> set:
        if isinstance(dimensions, (int, str)):
            dimensions = [dimensions]
        return {n for n in DIMS if n in dimensions or DIMS[n] in dimensions}

    def subset_by_dim(self, dimensions) -> "ScaleTensor":
        """The scalers bound to any of ``dimensions`` (names or axis indices)."""
        keep = self._dims_set(dimensions)
        return self._of({n: s for n, s in self.scalers.items() if set(s[0]) & keep})

    def without_by_dim(self, dimensions) -> "ScaleTensor":
        """The scalers bound to none of ``dimensions``."""
        drop = self._dims_set(dimensions)
        return self._of({n: s for n, s in self.scalers.items() if not set(s[0]) & drop})

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

    def slice_grid(self, rows: slice, num_points: int) -> "ScaleTensor":
        """A copy with every grid-bound scaler of ``num_points`` rows cut to
        ``rows`` (scalers of size 1 there broadcast as before)."""
        out = ScaleTensor()
        for name, (dims, array) in self.scalers.items():
            if "grid" in dims and array.shape[dims.index("grid")] == num_points:
                array = array.narrow(dims.index("grid"), rows.start, rows.stop - rows.start)
            out.scalers[name] = (dims, array)
        out._frozen = set(self._frozen)
        return out

    def __contains__(self, name: str) -> bool:
        return name in self.scalers

    def __repr__(self) -> str:
        parts = [f"{n}:{dims}{tuple(a.shape)}" for n, (dims, a) in self.scalers.items()]
        return f"ScaleTensor({', '.join(parts)})"


class BaseLoss:
    """Scaler-weighted loss with NaN masking: the pointwise error times every
    scaler, NaN targets out of both numerator and denominator, the weighted
    mean (``squash``) or the per-variable weighted mean (``squash=False``)."""

    # how a rank scores its rows of a grid split over a model group
    # (:func:`grid_sharded`); None: "rows" for the plain weighted mean
    grid_route: Optional[str] = None

    def __init__(self, scalers: Optional[ScaleTensor] = None, ignore_nans: bool = True):
        self.scalers = scalers or ScaleTensor()
        self.ignore_nans = ignore_nans
        self.grid_group = None  # the model group whose grid rows share the denominator

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

        axes = None if squash else tuple(range(err.dim() - 1))  # all but the variable dim
        den = weight.sum() if squash else weight.sum(axes)
        group = getattr(self, "grid_group", None)
        if group is not None:
            from anemoi_tpu_torch.parallel.distributed import all_reduce

            den = all_reduce(den.detach().clone(), group)
        return (weighted.sum() if squash else weighted.sum(axes)) / den.clamp_min(1e-12)

    @property
    def name(self) -> str:
        return self.__class__.__name__.lower()


class _GatherMembers(torch.autograd.Function):
    """All-gather along the member dim whose backward keeps the rank's own
    members' gradient (anemoi-core's ``gather_ensemble_members``, whose
    backward is the split): every rank computes the same loss from the
    gathered members, so each rank's share of the parameters' gradient
    comes through its own members, and the training step sums the shares
    over the ensemble group."""

    @staticmethod
    def forward(ctx, pred, group, dim):
        from anemoi_tpu_torch.parallel.distributed import all_gather

        parts = all_gather(pred, group)
        ctx.dim, ctx.size = dim, pred.shape[dim]
        ctx.index = torch.distributed.get_rank(group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def gather_members(pred: torch.Tensor, group, dim: int = DIMS["ensemble"]) -> torch.Tensor:
    """``pred`` with the members of every rank of the ensemble ``group``
    along ``dim``, in rank order (a no-op without a group).  Collective."""
    if group is None:
        return pred
    return _GatherMembers.apply(pred, group, dim)


class WholeGridLoss:
    """A loss that is no sum over grid rows (a spectral or multiscale loss)
    on a rank's rows of a grid split over the model ``group``: the rows of
    the prediction, the target and the imputer's mask are gathered whole
    (``parallel/rows.gather_blocks``, whose backward sums every rank's
    cotangent onto the rows' owner), the loss runs on the whole grid with
    its own scalers, and each rank returns ``1 / S`` of it, so that the
    model group's values add up to the loss and the gradients to its
    gradient."""

    grid_route = "whole"

    def __init__(self, loss: "BaseLoss", num_points: int, group):
        import torch.distributed as dist

        self.loss, self.num_points, self.group = loss, int(num_points), group
        self.num_shards = 1 if group is None else dist.get_world_size(group)
        self.index = 0 if group is None else dist.get_rank(group)

    @property
    def scalers(self) -> ScaleTensor:
        return self.loss.scalers

    @property
    def name(self) -> str:
        return self.loss.name

    def to(self, device) -> "WholeGridLoss":
        self.loss.to(device)
        return self

    def _whole(self, x: Optional[torch.Tensor], dim: int) -> Optional[torch.Tensor]:
        from anemoi_tpu_torch.parallel.rows import gather_blocks

        if x is None:
            return None
        return gather_blocks(x, dim, self.group, self.num_points, self.num_shards, self.index)

    def __call__(self, pred, target, squash: bool = True, mask=None, **kwargs):
        grid = DIMS["grid"]
        value = self.loss(self._whole(pred, grid), self._whole(target, grid), squash=squash,
                          mask=self._whole(mask, 1), **kwargs)
        return value / self.num_shards


def grid_sharded(loss: "BaseLoss", rows: slice, num_points: int, group):
    """A copy of ``loss`` that scores a rank's ``rows`` of a grid of
    ``num_points`` split over the model ``group``, its value the rank's
    share of the whole grid's loss (the group's values add up to it), by
    the loss's route (``grid_route``):

    - ``rows``: a sum over grid rows (the pointwise leaves, ``KernelCRPS``):
      the grid-bound scalers cut to the rows, the weighted mean's
      denominator summed over the group;
    - ``reduce`` (``WeightedRMSELoss``): the same, with the numerator summed
      over the group before the root;
    - ``inner``: a wrapper (``LossVariableMapper``,
      ``TimeAggregateLossWrapper``) or ``CombinedLoss``: each loss inside
      takes its own route;
    - ``whole``: any other loss (the spectral losses,
      ``MultiscaleLossWrapper``): :class:`WholeGridLoss`."""
    members = getattr(loss, "members", None)
    inner = getattr(loss, "loss", None) if type(loss).__name__ in WRAPPERS else None
    route = getattr(type(loss), "grid_route", None)
    if route is None:
        route = "rows" if type(loss).__call__ is BaseLoss.__call__ else "whole"
    if members is None and inner is None and route == "whole":
        return WholeGridLoss(loss, num_points, group)
    out = copy.copy(loss)
    if inner is not None:
        out.loss = grid_sharded(inner, rows, num_points, group)
        return out
    out.scalers = loss.scalers.slice_grid(rows, num_points)
    out.grid_group = group
    if members is not None:
        out.members = [grid_sharded(m, rows, num_points, group) for m in members]
    return out


def get_loss_function(
    config: dict,
    scalers: Optional[Dict[str, Tuple[Tuple[str, ...], object]]] = None,
    graph=None,
    dataset: str = "data",
    data_indices=None,
    variables_metadata: Optional[dict] = None,
) -> BaseLoss:
    """Build a loss from ``{"name": "WeightedMSELoss", "scalers": [...],
    ...}``, attaching the named subset (``"*"`` = all) of pre-built
    ``scalers``.  A wrapper's config holds the wrapped loss under ``loss``;
    a ``scalers`` list on the wrapper goes to the wrapped loss.
    ``MultiscaleLossWrapper`` reads its projections from ``graph`` (the
    ``dataset -> nodes`` edge sets); ``LossVariableMapper`` needs
    ``data_indices``, and checks the units of each predicted/target pair it
    maps against ``variables_metadata``."""
    cfg = dict(config)
    name = cfg.pop("name", "WeightedMSELoss")
    if name == "MultiscaleLossWrapper":
        from anemoi_tpu_torch.training.losses.multiscale import build_multiscale_loss

        return build_multiscale_loss(config, scalers, graph=graph, dataset=dataset)
    if name in WRAPPERS:
        inner_cfg = dict(cfg.pop("loss", {"name": "WeightedMSELoss"}))
        wrapper_scalers = cfg.pop("scalers", None)
        if wrapper_scalers is not None and "scalers" not in inner_cfg:
            inner_cfg["scalers"] = wrapper_scalers
        inner = get_loss_function(inner_cfg, scalers, graph=graph, dataset=dataset,
                                  data_indices=data_indices,
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
    if name not in LOSSES:
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


def variable_scaling_summary(loss: BaseLoss, data_indices) -> Dict[str, float]:
    """Effective per-variable loss weight: the product of every
    variable-dim scaler attached to the loss, keyed by model-output variable
    name (as the JAX package's ``variable_scaling_summary``)."""
    names = data_indices.model.output.ordered_names
    total = np.ones(len(names), dtype=np.float64)
    st = getattr(loss, "scalers", None)
    for dims, arr in (st.scalers.values() if st is not None else ()):
        if "variable" in dims:
            a = arr.detach().cpu().numpy().astype(np.float64).reshape(-1)
            if len(a) == len(names):
                total *= a
    return {name: float(total[i]) for i, name in enumerate(names)}
