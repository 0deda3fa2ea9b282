"""IndexCollection: the data-space / model-space variable index bookkeeping.

Copy of ``anemoi_tpu.data_indices.collection``.

Variable roles (per dataset):
  - forcing:     model inputs that are never predicted (e.g. solar insolation)
  - diagnostic:  model outputs that are never inputs (e.g. precipitation)
  - target:      outputs only present in the data-space output (downscaling targets)
  - prognostic:  everything else -- both input and output, advanced autoregressively

Two index spaces:
  - "data" space:  variables laid out in dataset order (name_to_index)
  - "model" space: the packed input tensor (forcing+prognostic) and packed
                   output tensor (prognostic+diagnostic), each re-enumerated
"""

from __future__ import annotations

from typing import Dict, List, Optional

from anemoi_tpu_torch.data_indices.tensor import InputTensorIndex, OutputTensorIndex


def _by_index(name_to_index: Dict[str, int]) -> List[str]:
    """Variable names ordered by their dataset index."""
    return sorted(name_to_index, key=name_to_index.__getitem__)


class SpaceIndex:
    """One index space holding an input and an output TensorIndex."""

    def __init__(self, input_index: InputTensorIndex, output_index: OutputTensorIndex) -> None:
        self.input = input_index
        self.output = output_index

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SpaceIndex):
            return NotImplemented
        return self.input == other.input and self.output == other.output

    def todict(self) -> dict:
        return {"input": self.input.todict(), "output": self.output.todict()}


def _contiguous_span(indices: List[int]):
    """(is_contiguous, start, length) of an ascending run; (False, 0, 0) when
    the positions are not one unbroken range)."""
    if not indices:
        return True, 0, 0
    lo = indices[0]
    if indices == list(range(lo, lo + len(indices))):
        return True, lo, len(indices)
    return False, 0, 0


class IndexCollection:
    """Collection of data- and model-space indices for one dataset."""

    def __init__(
        self,
        name_to_index: Dict[str, int],
        forcing: Optional[List[str]] = None,
        diagnostic: Optional[List[str]] = None,
        target: Optional[List[str]] = None,
    ) -> None:
        ordered = _by_index(name_to_index)
        self.name_to_index = {n: name_to_index[n] for n in ordered}
        self.forcing = list(forcing or [])
        self.diagnostic = list(diagnostic or [])
        self.target = list(target or [])

        defined = set(self.forcing) | set(self.diagnostic) | set(self.target)
        self.prognostic = [v for v in ordered if v not in defined]

        for role, names in (("forcing", self.forcing), ("target", self.target)):
            clash = set(self.diagnostic) & set(names)
            assert not clash, (
                f"a variable cannot be both diagnostic and {role}: {sorted(clash)}"
            )

        def packed(*roles: List[str]) -> Dict[str, int]:
            # model-space enumeration: dataset order, restricted to the roles
            keep = set().union(*roles)
            return {n: i for i, n in enumerate(k for k in ordered if k in keep)}

        name_to_index_model_input = packed(self.forcing, self.prognostic)
        name_to_index_model_output = packed(self.prognostic, self.diagnostic)

        self.data = SpaceIndex(
            InputTensorIndex(
                includes=self.forcing + self.prognostic,
                forcing=self.forcing,
                diagnostic=self.diagnostic,
                target=self.target,
                prognostic=self.prognostic,
                name_to_index=self.name_to_index,
            ),
            OutputTensorIndex(
                includes=self.diagnostic + self.prognostic + self.target,
                forcing=self.forcing,
                diagnostic=self.diagnostic,
                target=self.target,
                prognostic=self.prognostic,
                name_to_index=self.name_to_index,
            ),
        )
        self.model = SpaceIndex(
            InputTensorIndex(
                includes=self.forcing + self.prognostic,
                forcing=self.forcing,
                diagnostic=self.diagnostic,
                target=self.target,
                prognostic=self.prognostic,
                name_to_index=name_to_index_model_input,
            ),
            OutputTensorIndex(
                includes=self.diagnostic + self.prognostic,
                forcing=self.forcing,
                diagnostic=self.diagnostic,
                target=self.target,
                prognostic=self.prognostic,
                name_to_index=name_to_index_model_output,
            ),
        )

        self.data_full_ordered_names = ordered
        self.data_full_name_to_position = {
            n: p for p, n in enumerate(self.data_full_ordered_names)
        }
        self.model_output_positions_in_data_output = self.data.output.positions_for_names(
            self.model.output.ordered_names
        )
        data_output_size = len(self.data.output.ordered_names)
        self.model_output_in_data_output_is_identity = (
            len(self.model_output_positions_in_data_output) == data_output_size
            and self.model_output_positions_in_data_output == list(range(data_output_size))
        )
        (
            self.model_output_in_data_output_is_contiguous,
            self.model_output_in_data_output_contiguous_start,
            self.model_output_in_data_output_contiguous_length,
        ) = _contiguous_span(self.model_output_positions_in_data_output)

    # Convenience sizes -------------------------------------------------
    @property
    def num_data_vars(self) -> int:
        return len(self.name_to_index)

    @property
    def num_model_input_vars(self) -> int:
        return len(self.model.input.full)

    @property
    def num_model_output_vars(self) -> int:
        return len(self.model.output.full)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, IndexCollection):
            return NotImplemented
        return self.model == other.model and self.data == other.data

    def __repr__(self) -> str:
        return f"IndexCollection(name_to_index={self.name_to_index})"

    def todict(self) -> dict:
        return {"data": self.data.todict(), "model": self.model.todict()}

    @classmethod
    def from_config(cls, data_config: dict, name_to_index: Dict[str, int]) -> "IndexCollection":
        return cls(
            name_to_index,
            forcing=data_config.get("forcing"),
            diagnostic=data_config.get("diagnostic"),
            target=data_config.get("target"),
        )


def compare_variables(
    ckpt_name_to_index: Optional[Dict[str, int]],
    data_name_to_index: Dict[str, int],
) -> None:
    """Verify the data's variable order against a checkpoint's recorded order.

    Raises ``ValueError`` when the orders are verifiably different: same names
    at different indices, or renamed variables at different index locations.
    Pure renames in the same positions only warn (the tensors line up)."""
    import logging

    log = logging.getLogger(__name__)
    if ckpt_name_to_index is None:
        log.info("No variable order to compare; skipping check.")
        return
    if ckpt_name_to_index == data_name_to_index:
        return

    keys_m = set(ckpt_name_to_index)
    keys_d = set(data_name_to_index)
    only_in_model = {k: ckpt_name_to_index[k] for k in keys_m - keys_d}
    only_in_data = {k: data_name_to_index[k] for k in keys_d - keys_m}
    different = {
        k: (ckpt_name_to_index[k], data_name_to_index[k])
        for k in keys_m & keys_d
        if ckpt_name_to_index[k] != data_name_to_index[k]
    }

    error = ""
    if only_in_model:
        log.warning("Variables only in model: %s", only_in_model)
    if only_in_data:
        log.warning("Variables only in data: %s", only_in_data)
    if set(only_in_model.values()) == set(only_in_data.values()):
        if only_in_model:
            log.warning(
                "Variable naming differs but the order appears unchanged; continuing."
            )
    else:
        error += (
            "The variable order in the model and data is different; adjust the "
            "variable order/renames in the dataloader config.\n"
        )
    if different:
        error += (
            f"Same variables at different positions: {different}. "
            f"Reorder the data to match: {ckpt_name_to_index}\n"
        )
    if error:
        raise ValueError(error)


def compare_variables(
    ckpt_name_to_index: Optional[Dict[str, int]],
    data_name_to_index: Dict[str, int],
) -> None:
    """Check the data's variable order against a recorded order (a
    checkpoint's).  Raises ``ValueError`` when the orders verifiably differ:
    the same names at other indices, or renamed variables at other index
    locations.  Renames in the same positions only warn."""
    import logging

    log = logging.getLogger(__name__)
    if ckpt_name_to_index is None:
        log.info("No variable order to compare; skipping check.")
        return
    if ckpt_name_to_index == data_name_to_index:
        return
    keys_m, keys_d = set(ckpt_name_to_index), set(data_name_to_index)
    only_in_model = {k: ckpt_name_to_index[k] for k in keys_m - keys_d}
    only_in_data = {k: data_name_to_index[k] for k in keys_d - keys_m}
    different = {
        k: (ckpt_name_to_index[k], data_name_to_index[k])
        for k in keys_m & keys_d
        if ckpt_name_to_index[k] != data_name_to_index[k]
    }
    error = ""
    if only_in_model:
        log.warning("Variables only in model: %s", only_in_model)
    if only_in_data:
        log.warning("Variables only in data: %s", only_in_data)
    if set(only_in_model.values()) == set(only_in_data.values()):
        if only_in_model:
            log.warning("Variable naming differs but the order appears unchanged; continuing.")
    else:
        error += ("The variable order in the model and data is different; adjust the "
                  "variable order/renames in the dataloader config.\n")
    if different:
        error += (f"Same variables at different positions: {different}. "
                  f"Reorder the data to match: {ckpt_name_to_index}\n")
    if error:
        raise ValueError(error)
