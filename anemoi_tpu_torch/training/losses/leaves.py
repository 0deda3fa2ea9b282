"""Leaf losses.

Port of ``anemoi_tpu.training.losses.leaves``: ``WeightedMSELoss``.  The
other leaves (MAE, RMSE, Huber, LogCosh, KernelCRPS, CombinedLoss) are not
ported; ``get_loss_function`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

from anemoi_tpu_torch.training.losses.base import BaseLoss, register_loss


@register_loss("WeightedMSELoss")
class WeightedMSELoss(BaseLoss):
    def error(self, pred, target):
        return (pred - target) ** 2
