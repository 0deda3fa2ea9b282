"""Leaf losses.

Port of ``anemoi_tpu.training.losses.leaves``: ``WeightedMSELoss`` and the
ensemble's ``KernelCRPS``.  The other leaves (MAE, RMSE, Huber, LogCosh,
CombinedLoss) are not ported; ``get_loss_function`` raises
``NotImplementedError`` for them.
"""

from __future__ import annotations

from anemoi_tpu_torch.training.losses.base import BaseLoss, register_loss


@register_loss("WeightedMSELoss")
class WeightedMSELoss(BaseLoss):
    def error(self, pred, target):
        return (pred - target) ** 2


@register_loss("KernelCRPS")
class KernelCRPS(BaseLoss):
    """The (almost-)fair kernel CRPS over the ensemble dim:
    ``E|X - y| - 0.5 * E|X - X'|``, the spread term over member pairs summed
    over ``M (M - 1)`` (``fair``) or averaged over ``M * M``.  ``pred [B, T,
    M, G, V]`` against a single-truth ``target [B, T, 1, G, V]``; the error
    is ensemble-reduced (``[B, T, 1, G, V]``)."""

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
