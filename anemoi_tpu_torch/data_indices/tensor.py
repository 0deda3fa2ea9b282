"""Variable-index algebra over tensors.

Copy of ``anemoi_tpu.data_indices.tensor``: numpy int arrays (host-side
static metadata; the model turns the few it gathers with into device tensors
once, at build time).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class TensorIndex:
    """Index sets (prognostic/diagnostic/forcing/target/full) for one tensor space."""

    def __init__(
        self,
        *,
        prognostic: List[str],
        diagnostic: List[str],
        forcing: List[str],
        includes: List[str],
        name_to_index: Dict[str, int],
        target: List[str] = (),
    ) -> None:
        self.name_to_index = dict(name_to_index)
        self.includes = sorted(includes)
        missing = [v for v in includes if v not in self.name_to_index]
        assert not missing, f"Indexing has invalid entries {missing}, not in dataset."

        self.prognostic = self._idx(prognostic)
        self.diagnostic = self._idx(diagnostic)
        self.forcing = self._idx(forcing)
        self.target = self._idx(target)
        self.full = self._idx(includes)
        self.excludes = sorted(set(self.name_to_index) - set(self.includes))
        self.full_index_to_name = {int(i): n for n, i in self.name_to_index.items()}
        self.ordered_names = [self.full_index_to_name[int(i)] for i in self.full.tolist()]
        self.name_to_position = {n: p for p, n in enumerate(self.ordered_names)}

    def _idx(self, names: List[str]) -> np.ndarray:
        sel = sorted(i for n, i in self.name_to_index.items() if n in set(names))
        return np.asarray(sel, dtype=np.int32)

    def positions_for_names(self, names: List[str]) -> List[int]:
        missing = [n for n in names if n not in self.name_to_position]
        if missing:
            raise ValueError(
                f"Variables {missing} not in this index-space. Available: {self.ordered_names}"
            )
        return [self.name_to_position[n] for n in names]

    def __len__(self) -> int:
        return len(self.full)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, TensorIndex):
            return NotImplemented
        return (
            np.array_equal(self.prognostic, other.prognostic)
            and np.array_equal(self.diagnostic, other.diagnostic)
            and np.array_equal(self.forcing, other.forcing)
            and np.array_equal(self.target, other.target)
            and np.array_equal(self.full, other.full)
            and self.includes == other.includes
        )

    def __repr__(self) -> str:
        return f"TensorIndex(includes={self.includes}, excludes={self.excludes})"

    def todict(self) -> dict:
        return {
            "prognostic": self.prognostic.tolist(),
            "diagnostic": self.diagnostic.tolist(),
            "forcing": self.forcing.tolist(),
            "target": self.target.tolist(),
            "full": self.full.tolist(),
            "name_to_index": self.name_to_index,
        }


class InputTensorIndex(TensorIndex):
    def __len__(self) -> int:
        return len(self.prognostic) + len(self.forcing)


class OutputTensorIndex(TensorIndex):
    pass
