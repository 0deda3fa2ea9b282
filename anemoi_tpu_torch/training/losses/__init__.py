from anemoi_tpu_torch.training.losses.base import BaseLoss, ScaleTensor, get_loss_function
from anemoi_tpu_torch.training.losses import leaves  # noqa: F401  (registers the leaf losses)
from anemoi_tpu_torch.training.losses import spectral  # noqa: F401  (registers the spectral losses)
from anemoi_tpu_torch.training.losses import wrappers  # noqa: F401  (registers the wrappers)

__all__ = ["BaseLoss", "ScaleTensor", "get_loss_function"]
