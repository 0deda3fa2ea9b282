"""Deterministic seeding.

Port of ``anemoi_tpu.utils.seeding``: a base seed from ``ANEMOI_BASE_SEED``
(42 when unset; seeds below 1000 are multiplied by 1000, as anemoi-core
does) and, per named context, a 31-bit seed derived with SHA-256, so that
model initialisation and data shuffling are independent streams and both
packages draw the same seeds.  :func:`context_generator` takes the place of
the JAX ``context_key``: a ``torch.Generator`` seeded from the context, and
:func:`fold_seed` the place of ``jax.random.fold_in``.
"""

from __future__ import annotations

import hashlib
import os

import torch

BASE_SEED_ENV = "ANEMOI_BASE_SEED"
DEFAULT_BASE_SEED = 42


def get_base_seed() -> int:
    """Base seed from ``ANEMOI_BASE_SEED`` (defaults to 42)."""
    raw = os.environ.get(BASE_SEED_ENV, "")
    if raw:
        seed = int(raw)
        if seed < 1000:
            seed = seed * 1000
        return seed
    return DEFAULT_BASE_SEED


def context_seed(context: str, base_seed: int | None = None) -> int:
    """A deterministic 31-bit seed for a named context."""
    if base_seed is None:
        base_seed = get_base_seed()
    digest = hashlib.sha256(f"{base_seed}:{context}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def context_generator(context: str, base_seed: int | None = None,
                      device: torch.device | str = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with :func:`context_seed`."""
    return torch.Generator(device=device).manual_seed(context_seed(context, base_seed))


def fold_seed(seed: int, *values: int) -> int:
    """A 31-bit seed derived from ``seed`` and ``values`` (e.g. the training
    step and the rollout step), as ``jax.random.fold_in`` derives a key."""
    digest = hashlib.sha256(":".join(str(int(v)) for v in (seed, *values)).encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF
