"""The port's hand-written CUDA kernels and their launch counts.

``gt_attention`` holds the sparse graph-attention kernels K1-K5,
``window_attention`` the banded window-attention kernels K6 and K7
(``K7_dq``, ``K7_dkv``).  Nothing is built when the package is imported.
"""

from __future__ import annotations

from anemoi_tpu_torch.kernels import gt_attention, window_attention


def launch_counts() -> dict:
    """{"K1": n, ..., "K7_dkv": n}: every kernel's launches since the last reset."""
    return {**gt_attention.launch_counts(), **window_attention.launch_counts()}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    gt_attention.reset_launches()
    window_attention.reset_launches()
