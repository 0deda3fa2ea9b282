"""Input normalisation.

Port of ``anemoi_tpu.preprocessing.normalizer.InputNormalizer``:
per-variable affine normalisation built from dataset statistics, with methods
mean-std / std / min-max / max / none and optional statistic remapping.  The
``mul``/``add`` vectors are computed once on the host (float64 statistics,
float32 vectors) and kept on the device; transforms run in float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from anemoi_tpu_torch.data_indices.collection import IndexCollection

VALID_METHODS = ("mean-std", "std", "min-max", "max", "none")


class InputNormalizer:
    def __init__(
        self,
        data_indices: IndexCollection,
        statistics: Dict[str, np.ndarray],
        default: str = "mean-std",
        methods: Optional[Dict[str, str]] = None,
        remap: Optional[Dict[str, str]] = None,
        device: torch.device | str = "cpu",
    ) -> None:
        self.data_indices = data_indices
        name_to_index = data_indices.name_to_index
        methods = dict(methods or {})
        remap = dict(remap or {})

        minimum = np.array(statistics["minimum"], dtype=np.float64).copy()
        maximum = np.array(statistics["maximum"], dtype=np.float64).copy()
        mean = np.array(statistics["mean"], dtype=np.float64).copy()
        stdev = np.array(statistics["stdev"], dtype=np.float64).copy()

        # reuse statistics of one variable for another
        for tgt, src in remap.items():
            i, j = name_to_index[tgt], name_to_index[src]
            minimum[i], maximum[i], mean[i], stdev[i] = minimum[j], maximum[j], mean[j], stdev[j]

        for name, method in methods.items():
            if name not in name_to_index:
                raise ValueError(f"{name} is not a valid variable name")
            if method not in VALID_METHODS:
                raise ValueError(f"{method} is not a valid normalisation method")

        n = len(name_to_index)
        norm_add = np.zeros(n, dtype=np.float32)
        norm_mul = np.ones(n, dtype=np.float32)
        for name, i in name_to_index.items():
            method = methods.get(name, default)
            if method == "mean-std":
                norm_mul[i] = 1.0 / stdev[i]
                norm_add[i] = -mean[i] / stdev[i]
            elif method == "std":
                norm_mul[i] = 1.0 / stdev[i]
            elif method == "min-max":
                span = maximum[i] - minimum[i]
                norm_mul[i] = 1.0 / span
                norm_add[i] = -minimum[i] / span
            elif method == "max":
                norm_mul[i] = 1.0 / maximum[i]
            elif method != "none":
                raise ValueError(f"Unknown normalisation method {method}")

        model_out_names = set(data_indices.model.output.name_to_index)
        mask = np.array([n in model_out_names for n in data_indices.data.output.ordered_names])
        output_idx = np.asarray(data_indices.data.output.full, dtype=np.int64)

        def t(a):
            return torch.as_tensor(a, device=device)

        self._norm_mul = t(norm_mul)
        self._norm_add = t(norm_add)
        self._input_idx = t(np.asarray(data_indices.data.input.full, dtype=np.int64))
        self._output_idx = t(output_idx)
        self._model_output_idx = t(output_idx[mask])

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Normalise [..., V]; V may be the full data space or data.input space."""
        if x.shape[-1] == self._input_idx.shape[0]:
            idx = self._input_idx
            return x * self._norm_mul[idx] + self._norm_add[idx]
        return x * self._norm_mul + self._norm_add

    def inverse_transform(self, x: torch.Tensor, aux=None) -> torch.Tensor:
        if x.shape[-1] == self._model_output_idx.shape[0]:
            idx = self._model_output_idx
        elif x.shape[-1] == self._output_idx.shape[0]:
            idx = self._output_idx
        else:
            return (x - self._norm_add) / self._norm_mul
        return (x - self._norm_add[idx]) / self._norm_mul[idx]
