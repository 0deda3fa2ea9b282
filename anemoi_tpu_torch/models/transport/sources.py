"""Source fields of interpolant training and sampling.

Port of ``anemoi_tpu.models.transport.sources``: the stochastic-interpolant
bridge carries a SOURCE distribution to the target; the kinds are ``zero``,
``gaussian`` (``random_fields``) and ``reference_state`` (the latest input
state restricted to the model's output variables).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from anemoi_tpu_torch.models.transport import random_fields

TRANSPORT_SOURCE_KINDS = frozenset({"zero", "gaussian", "reference_state"})


@dataclass(frozen=True)
class SourceSpec:
    """Shape, type and device of one dataset's source field."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    device: torch.device | str = "cpu"

    @classmethod
    def from_tensor(cls, x: torch.Tensor) -> "SourceSpec":
        return cls(shape=tuple(x.shape), dtype=x.dtype, device=x.device)


def sampling_source_specs(x: Dict[str, torch.Tensor], *, n_step_output: int,
                          num_output_channels: Dict[str, int]) -> Dict[str, SourceSpec]:
    """Target-shaped specs ``[B, n_step_output, E, G, V_out]`` from the
    sampling input window."""
    return {
        ds: SourceSpec(shape=(xd.shape[0], n_step_output, xd.shape[2], xd.shape[-2],
                              num_output_channels[ds]), dtype=xd.dtype, device=xd.device)
        for ds, xd in x.items()
    }


def reference_state_source(x: Dict[str, torch.Tensor], *, data_indices: Dict[str, object],
                           n_step_output: int) -> Dict[str, torch.Tensor]:
    """The latest input state, restricted to the model's output variables.
    Every output variable must be a model input (no diagnostic-only
    outputs)."""
    sources = {}
    for ds, xd in x.items():
        idx = data_indices[ds]
        out_names = [n for n, _ in sorted(idx.model.output.name_to_index.items(),
                                          key=lambda kv: kv[1])]
        in_n2i = idx.model.input.name_to_index
        missing = [n for n in out_names if n not in in_n2i]
        if missing:
            raise ValueError(
                "reference_state transport sources need every model-output variable in the "
                f"model input; missing {missing} for '{ds}'. Choose a non-reference source "
                "instead.")
        pos = torch.as_tensor([in_n2i[n] for n in out_names], dtype=torch.long, device=xd.device)
        source = xd[:, -1:][..., pos]
        if n_step_output > 1:
            source = source.expand(source.shape[:1] + (n_step_output,) + source.shape[2:])
        sources[ds] = source
    return sources


def build_sources(kind: str, generator: Optional[torch.Generator],
                  specs: Dict[str, SourceSpec], *,
                  x: Optional[Dict[str, torch.Tensor]] = None,
                  data_indices: Optional[Dict[str, object]] = None,
                  n_step_output: int = 1,
                  shard: Optional[random_fields.DrawShard] = None) -> Dict[str, torch.Tensor]:
    """One source field per dataset; ``gaussian`` draws the datasets in
    sorted order from ``generator`` (under ``shard``, the one-process field
    cut to the rank's block: JAX ``shard_kwargs``)."""
    if kind not in TRANSPORT_SOURCE_KINDS:
        raise ValueError(f"Unknown transport source '{kind}'; expected one of "
                         f"{sorted(TRANSPORT_SOURCE_KINDS)}")
    if kind == "zero":
        return {ds: torch.zeros(sp.shape, dtype=sp.dtype, device=sp.device)
                for ds, sp in specs.items()}
    if kind == "gaussian":
        return {ds: random_fields.sharded_normal(generator, sp.shape, sp.dtype, shard)
                for ds, sp in sorted(specs.items())}
    if x is None or data_indices is None:
        raise ValueError("reference_state sources need the input batch and indices")
    return reference_state_source(x, data_indices=data_indices, n_step_output=n_step_output)
