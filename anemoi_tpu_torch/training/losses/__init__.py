from anemoi_tpu_torch.training.losses.base import BaseLoss, ScaleTensor, get_loss_function
from anemoi_tpu_torch.training.losses import leaves  # noqa: F401  (registers the leaf losses)

__all__ = ["BaseLoss", "ScaleTensor", "get_loss_function"]
