"""Variable remapping: direction angles to cos/sin pairs.

Port of ``anemoi_tpu.preprocessing.remapper``, in two forms:

- ``CosSinRemapper`` remaps in place, between variables that all exist in
  the dataset's layout (``{"angle": ["cos_angle", "sin_angle"]}``);
- ``Remapper`` expands the layout: each remapped variable is dropped and
  its derived variables are appended at the end.  Its ``data_indices`` and
  :meth:`Remapper.remap_statistics` give the remapped space that the model
  and every other processor are built in (``models/interface.py``), and it
  goes first in each chain, so its inverse runs last.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from anemoi_tpu_torch.data_indices.collection import IndexCollection


class CosSinRemapper:
    """An angle variable (degrees) into existing cos/sin variables.  The
    pairs are positions in the full data space: a tensor of another width
    (model inputs, model outputs) passes through unchanged, where the JAX
    package's gathers would clamp the positions and its scatters drop them."""

    def __init__(self, data_indices, config: Dict[str, list]) -> None:
        name_to_index = data_indices.name_to_index
        self.width = len(name_to_index)
        self.pairs = [(name_to_index[angle], name_to_index[c], name_to_index[s])
                      for angle, (c, s) in (config or {}).items()]

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.width:
            return x
        x = x.clone()
        for angle_i, cos_i, sin_i in self.pairs:
            rad = torch.deg2rad(x[..., angle_i])
            x[..., cos_i] = torch.cos(rad)
            x[..., sin_i] = torch.sin(rad)
        return x

    def inverse_transform(self, x: torch.Tensor, aux=None) -> torch.Tensor:
        if x.shape[-1] != self.width:
            return x
        x = x.clone()
        for angle_i, cos_i, sin_i in self.pairs:
            ang = torch.rad2deg(torch.atan2(x[..., sin_i], x[..., cos_i]))
            x[..., angle_i] = torch.remainder(ang, 360.0)
        return x


class Remapper:
    """The variable-expanding remapper.  ``config``: mapping kind ->
    ``{source: [derived names]}``, e.g. ``{"cos_sin": {"wdir10m":
    ["cos_wdir10m", "sin_wdir10m"]}}``.  The kept variables stay in their
    order, the derived ones are appended, and each inherits its source's
    role (forcing, diagnostic, target or prognostic)."""

    MAPPINGS = ("cos_sin",)

    def __init__(self, data_indices: IndexCollection, config: Dict[str, Dict[str, List[str]]],
                 device: torch.device | str = "cpu") -> None:
        config = dict(config or {})
        for kind in config:
            if kind not in self.MAPPINGS:
                raise ValueError(f"Unknown remapper mapping '{kind}' (have {self.MAPPINGS})")
        cos_sin = dict(config.get("cos_sin", {}))
        self.src_indices = data_indices
        name_to_index = data_indices.name_to_index
        for src, derived in cos_sin.items():
            if src not in name_to_index:
                raise ValueError(f"remapped variable '{src}' not in the dataset")
            if len(derived) != 2:
                raise ValueError(f"cos_sin mapping for '{src}' needs [cos, sin] names")
            for d in derived:
                if d in name_to_index:
                    raise ValueError(f"derived name '{d}' already exists")

        kept_names = [n for n in name_to_index if n not in cos_sin]
        derived_names: List[str] = []
        self._derived_spec: List[tuple] = []  # (source data index, 0 cos / 1 sin)
        for src, (cos_name, sin_name) in cos_sin.items():
            derived_names += [cos_name, sin_name]
            self._derived_spec += [(name_to_index[src], 0), (name_to_index[src], 1)]

        def remap_role(role: List[str]) -> List[str]:
            return [d for n in role for d in (cos_sin[n] if n in cos_sin else [n])]

        self.data_indices = IndexCollection(
            {n: i for i, n in enumerate(kept_names + derived_names)},
            forcing=remap_role(data_indices.forcing),
            diagnostic=remap_role(data_indices.diagnostic),
            target=remap_role(data_indices.target),
        )
        self._keep_idx_np = np.asarray([name_to_index[n] for n in kept_names], dtype=np.int64)
        self._keep_idx = torch.as_tensor(self._keep_idx_np, device=device)
        src_idx = [i for i, _ in self._derived_spec]
        self._derived_src = torch.as_tensor(np.asarray(src_idx, dtype=np.int64), device=device)
        self._derived_sin = torch.as_tensor([k == 1 for _, k in self._derived_spec], device=device)

        def inverse_tables(src_space, dst_space):
            """One gather over the remapped tensor with the rebuilt angles
            appended: positions < width point into the remapped tensor, the
            others into the angle block; and each angle's (cos, sin)
            positions."""
            dst_pos = {n: i for i, n in enumerate(dst_space.ordered_names)}
            width = len(dst_space.ordered_names)
            gather, cos_pos, sin_pos = [], [], []
            for n in src_space.ordered_names:
                if n in cos_sin:
                    gather.append(width + len(cos_pos))
                    cos_pos.append(dst_pos[cos_sin[n][0]])
                    sin_pos.append(dst_pos[cos_sin[n][1]])
                else:
                    gather.append(dst_pos[n])
            return tuple(torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
                         for a in (gather, cos_pos, sin_pos))

        # by width; the model-output table wins where the widths are equal
        self._inverse = {
            len(self.data_indices.data.output.ordered_names):
                inverse_tables(data_indices.data.output, self.data_indices.data.output),
            len(self.data_indices.model.output.ordered_names):
                inverse_tables(data_indices.model.output, self.data_indices.model.output),
        }
        self._n_model_out = len(self.data_indices.model.output.ordered_names)
        self._n_data_out = len(self.data_indices.data.output.ordered_names)

    def remap_statistics(self, statistics: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Per-variable statistic vectors in the remapped layout; the derived
        columns get (minimum, maximum, mean, stdev) = (-1, 1, 0, 1), which a
        mean-std or min-max normaliser leaves as they are."""
        derived_stats = {"minimum": -1.0, "maximum": 1.0, "mean": 0.0, "stdev": 1.0}
        n_derived = len(self._derived_spec)
        out = {}
        for key, vec in statistics.items():
            vec = np.asarray(vec)
            if vec.ndim != 1 or vec.shape[0] != len(self.src_indices.name_to_index):
                out[key] = vec  # not per variable: passes through
                continue
            out[key] = np.concatenate([vec[self._keep_idx_np],
                                       np.full(n_derived, derived_stats.get(key, 0.0),
                                               dtype=vec.dtype)])
        return out

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Original data space ``[..., V]`` -> remapped data space ``[..., V']``."""
        if x.shape[-1] != len(self.src_indices.name_to_index):
            raise ValueError(f"Remapper.transform expects the full data space "
                             f"({len(self.src_indices.name_to_index)} variables), got "
                             f"{x.shape[-1]}")
        rad = torch.deg2rad(x[..., self._derived_src])
        derived = torch.where(self._derived_sin, torch.sin(rad), torch.cos(rad))
        return torch.cat([x[..., self._keep_idx], derived], dim=-1)

    def inverse_transform(self, y: torch.Tensor, aux=None) -> torch.Tensor:
        """Remapped model-output or data-output space -> the original one,
        with each angle rebuilt from its cos/sin pair (degrees in [0, 360))."""
        if y.shape[-1] not in self._inverse:
            raise ValueError(f"Remapper.inverse_transform: unexpected width {y.shape[-1]} "
                             f"(model out {self._n_model_out}, data out {self._n_data_out})")
        gather, cos_pos, sin_pos = self._inverse[y.shape[-1]]
        if len(cos_pos):
            ang = torch.rad2deg(torch.atan2(y[..., sin_pos], y[..., cos_pos]))
            y = torch.cat([y, torch.remainder(ang, 360.0)], dim=-1)
        return y[..., gather]
