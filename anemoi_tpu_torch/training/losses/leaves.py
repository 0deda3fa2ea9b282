"""Leaf losses.

Port of ``anemoi_tpu.training.losses.leaves``: pointwise errors (MSE, MAE,
RMSE, Huber, log-cosh) in ``BaseLoss``'s scaler-weighted reduction, the
ensemble's ``KernelCRPS`` and the weighted sum ``CombinedLoss``.
"""

from __future__ import annotations

import math

import torch

from anemoi_tpu_torch.training.losses.base import BaseLoss, get_loss_function, register_loss


@register_loss("WeightedMSELoss")
class WeightedMSELoss(BaseLoss):
    def error(self, pred, target):
        return (pred - target) ** 2


@register_loss("WeightedMAELoss")
class WeightedMAELoss(BaseLoss):
    def error(self, pred, target):
        return (pred - target).abs()


@register_loss("WeightedRMSELoss")
class WeightedRMSELoss(WeightedMSELoss):
    """The square root of the weighted MSE.  On a rank's grid rows
    (``grid_group`` set) the MSE shares are summed over the model group
    before the root, and each rank returns ``1 / S`` of the whole grid's
    value."""

    grid_route = "reduce"

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        mse = super().__call__(pred, target, squash=squash, **kwargs)
        group = self.grid_group
        if group is None:
            return torch.sqrt(mse)
        import torch.distributed as dist

        from anemoi_tpu_torch.parallel.rows import all_reduce_sum

        return torch.sqrt(all_reduce_sum(mse, group)) / dist.get_world_size(group)


@register_loss("WeightedHuberLoss")
class WeightedHuberLoss(BaseLoss):
    def __init__(self, scalers=None, ignore_nans: bool = True, delta: float = 1.0):
        super().__init__(scalers, ignore_nans)
        self.delta = delta

    def error(self, pred, target):
        diff = (pred - target).abs()
        quad = torch.clamp(diff, max=self.delta)
        return 0.5 * quad**2 + self.delta * (diff - quad)


@register_loss("WeightedLogCoshLoss")
class WeightedLogCoshLoss(BaseLoss):
    def error(self, pred, target):
        # log(cosh(d)) on |d|: d + log1p(exp(-2d)) overflows for d << 0
        a = (pred - target).abs()
        return a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0)


@register_loss("KernelCRPS")
class KernelCRPS(BaseLoss):
    """The (almost-)fair kernel CRPS over the ensemble dim:
    ``E|X - y| - 0.5 * E|X - X'|``, the spread term over member pairs summed
    over ``M (M - 1)`` (``fair``) or averaged over ``M * M``.  ``pred [B, T,
    M, G, V]`` against a single-truth ``target [B, T, 1, G, V]``; the error
    is ensemble-reduced (``[B, T, 1, G, V]``)."""

    grid_route = "rows"

    def __init__(self, scalers=None, ignore_nans: bool = True, fair: bool = True):
        super().__init__(scalers, ignore_nans)
        self.fair = fair

    def error(self, pred, target):
        m = pred.shape[2]
        skill = (pred - target).abs().mean(dim=2, keepdim=True)
        if m == 1:
            return skill
        diff = (pred[:, :, :, None] - pred[:, :, None, :]).abs()  # [B, T, M, M, G, V]
        spread = diff.sum(dim=(2, 3)) / (m * (m - 1)) if self.fair else diff.mean(dim=(2, 3))
        return skill - 0.5 * spread[:, :, None]

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        if target.shape[2] != 1:
            raise ValueError("KernelCRPS expects a single-truth target with ensemble dim 1, "
                             f"got {tuple(target.shape)}")
        return super().__call__(pred, target, squash=squash, **kwargs)


@register_loss("CombinedLoss")
class CombinedLoss(BaseLoss):
    """The weighted sum of member losses.  ``losses``: member configs (or
    built losses); each member selects its own scalers, by its ``scalers``
    list, among those this loss was given."""

    def __init__(self, losses, loss_weights=None, scalers=None, ignore_nans: bool = True):
        super().__init__(scalers, ignore_nans)
        available = dict(scalers.scalers) if scalers else {}
        self.members = [cfg if isinstance(cfg, BaseLoss) else get_loss_function(dict(cfg), available)
                        for cfg in losses]
        self.weights = list(loss_weights) if loss_weights else [1.0] * len(self.members)

    def to(self, device) -> "CombinedLoss":
        super().to(device)
        for member in self.members:
            member.to(device)
        return self

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        total = 0.0
        for w, loss in zip(self.weights, self.members):
            total = total + w * loss(pred, target, squash=squash, **kwargs)
        return total
