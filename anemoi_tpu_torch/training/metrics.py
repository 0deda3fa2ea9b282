"""Validation metric groups.

Port of ``anemoi_tpu.training.metrics.variable_groups``: model-output
variables grouped per parameter for levelled variables (``t`` for ``t_850``,
``t_500``, ...) and ``sfc`` for the rest; ``eval_step`` reports the RMSE of
each group as ``rmse/<dataset>/<group>/<step>``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def crack_variable_name(name: str) -> Tuple[str, Optional[int]]:
    """``q_850`` -> ``("q", 850)``; names without a numeric suffix give
    ``(name, None)`` (the port's copy of ``utils/variables_metadata.py``)."""
    head, _, tail = name.rpartition("_")
    if head and tail.isdigit():
        return head, int(tail)
    return name, None


def variable_groups(names: List[str]) -> Dict[str, List[int]]:
    groups: Dict[str, List[int]] = {}
    for i, name in enumerate(names):
        param, level = crack_variable_name(name)
        groups.setdefault(param if level is not None else "sfc", []).append(i)
    return groups
