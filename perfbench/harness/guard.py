"""The import guard: no module of JAX, its libraries or the JAX package may
be loaded in a run's process.  Names are compared by their whole top-level
part, so ``anemoi_tpu_torch`` is not ``anemoi_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "anemoi_tpu")


def loaded() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def check(where: str) -> None:
    """Exit with code 3, printing no result, if a forbidden module is loaded."""
    found = loaded()
    if found:
        print(f"import guard: {', '.join(found)} loaded at {where}", file=sys.stderr)
        raise SystemExit(3)
