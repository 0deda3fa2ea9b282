"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` means the CUDA card.  Raises when CUDA is asked for and no
    card is visible: the port never falls back to the CPU on its own; pass
    ``device="cpu"`` to run the plain PyTorch versions on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "anemoi_tpu_torch runs on a CUDA card by default and none is visible; "
            "pass device='cpu' to run on the CPU"
        )
    return device
