"""Windowed sampling and batching over datasets.

The port's copy of ``anemoi_tpu.data.datamodule``: valid anchors shared by
all datasets (missing-data aware), seeded per-epoch shuffling from the same
``context_seed`` contexts (``data-shuffle-<epoch>``), so both packages see
the same batches in the same order, and window extraction.  Batches are
numpy arrays on the host; ``data/prefetch.py`` moves them to the device.
The JAX package's sampler sharding (``shard_index``/``num_shards``: each
process strides the anchor order) and ``local_plan`` (``{dataset:
(batch_rows, grid_rows)}``, set by the trainer: every rank samples the same
seeded global order and reads only its batch rows and grid rows) are
copied.  Unlike the
JAX package, ``set_rollout`` keeps the configured ``validation_fraction``
(the JAX package re-splits at 0.15 whatever was configured).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from anemoi_tpu_torch.data.dataset import BaseDataset
from anemoi_tpu_torch.utils.seeding import context_seed


def usable_window_starts(
    num_times: int, window: int, missing: set, drop_tail: int = 0
) -> np.ndarray:
    """Start indices t such that [t, t+window) contains no missing step
    (ref data/usable_indices.py:91-124)."""
    ok = np.ones(num_times, dtype=bool)
    for m in missing:
        if 0 <= m < num_times:
            ok[m] = False
    starts = []
    limit = num_times - window + 1 - drop_tail
    run = 0
    for t in range(num_times):
        run = run + 1 if ok[t] else 0
        start = t - window + 1
        if start >= 0 and start < limit and run >= window:
            starts.append(start)
    return np.asarray(starts, dtype=np.int64)


def intersect_anchor_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(sequence, position) rows present in both anchor arrays, sorted
    (ref data/usable_indices.py:21-41)."""
    if a.size == 0 or b.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    dtype = np.dtype((np.void, a.dtype.itemsize * a.shape[1]))
    common = np.intersect1d(a.view(dtype), b.view(dtype))
    return common.view(np.int64).reshape(-1, 2)


def compute_valid_anchors(
    datasets: Dict[str, BaseDataset], window: int
) -> np.ndarray:
    """Valid (sequence, position) anchors shared by ALL datasets: an anchor
    is valid if each dataset can sample the full window [p, p+window) inside
    sequence s (missing-aware).  The intersection across datasets is the
    MultiDataset anchor set (ref data/usable_indices.py:44-88)."""
    rel = np.arange(window, dtype=np.int64)
    inter: np.ndarray = None
    for name, ds in datasets.items():
        anchors = ds.compute_anchors(rel)
        if len(anchors) == 0:
            raise ValueError(f"No valid anchors for dataset '{name}'")
        inter = anchors if inter is None else intersect_anchor_rows(inter, anchors)
    if inter is None or len(inter) == 0:
        raise ValueError("No valid anchors after intersection across datasets")
    return inter


class WindowSampler:
    """Seeded sampler of window start indices, in full batches; with
    ``num_shards`` each shard takes every ``num_shards``-th anchor of the
    order from ``shard_index``."""

    def __init__(self, starts: np.ndarray, batch_size: int, shuffle: bool = True,
                 shard_index: int = 0, num_shards: int = 1) -> None:
        self.starts = starts
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.shard_index = shard_index
        self.num_shards = num_shards

    def epoch_batches(self, epoch: int) -> Iterator[np.ndarray]:
        order = self.starts.copy()
        if self.shuffle:
            rng = np.random.default_rng(context_seed(f"data-shuffle-{epoch}"))
            rng.shuffle(order)
        local = order[self.shard_index :: self.num_shards]
        for i in range(len(self)):
            yield local[i * self.batch_size : (i + 1) * self.batch_size]

    def __len__(self) -> int:
        return len(self.starts[self.shard_index :: self.num_shards]) // self.batch_size


class DataModule:
    """Builds train/val batches over a dict of datasets.

    Batch layout per dataset: [B, window, E, G, V] float32 in data space
    (un-normalised); window = n_step_input + rollout * n_step_output.
    """

    def __init__(
        self,
        datasets: Dict[str, BaseDataset],
        n_step_input: int = 2,
        n_step_output: int = 1,
        rollout: int = 1,
        batch_size: int = 1,
        validation_fraction: float = 0.15,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> None:
        self.datasets = datasets
        self.n_step_input = n_step_input
        self.n_step_output = n_step_output
        self.rollout = rollout
        self.batch_size = batch_size
        self.validation_fraction = validation_fraction
        self.window = n_step_input + rollout * n_step_output
        train, val = self._split()
        self.train_sampler = WindowSampler(train, batch_size, shuffle=True,
                                           shard_index=shard_index, num_shards=num_shards)
        self.val_sampler = WindowSampler(val, batch_size, shuffle=False,
                                         shard_index=shard_index, num_shards=num_shards)
        # {dataset: (batch_rows, grid_rows)} this rank reads (set by the trainer)
        self.local_plan: Optional[Dict[str, Tuple[slice, slice]]] = None

    @property
    def train_starts(self) -> np.ndarray:
        """Training anchors of the current window."""
        return self.train_sampler.starts

    @property
    def val_starts(self) -> np.ndarray:
        """Validation anchors of the current window."""
        return self.val_sampler.starts

    def _split(self):
        """(train, validation) anchors of the current window: the last
        ``validation_fraction`` of the valid anchors validate."""
        anchors = compute_valid_anchors(self.datasets, self.window)
        n_val = max(1, int(len(anchors) * self.validation_fraction))
        return anchors[:-n_val], anchors[-n_val:]

    def set_rollout(self, rollout: int) -> None:
        """Grow the sampling window when the rollout curriculum advances
        (ref datamodule.py:143 set_epoch)."""
        if rollout == self.rollout:
            return
        self.rollout = rollout
        self.window = self.n_step_input + rollout * self.n_step_output
        self.train_sampler.starts, self.val_sampler.starts = self._split()

    def make_batch(self, anchors: np.ndarray) -> Dict[str, np.ndarray]:
        """``anchors``: [B, 2] (sequence, position) rows; with a
        ``local_plan``, only this rank's batch rows and grid rows are read."""
        batch = {}
        for name, ds in self.datasets.items():
            rows, grid = anchors, slice(None)
            if self.local_plan is not None and name in self.local_plan:
                batch_rows, grid = self.local_plan[name]
                rows = anchors[batch_rows]
            batch[name] = np.stack([ds.get_seq_window(int(s), int(p), self.window, grid)
                                    for s, p in rows])  # [B(_local), T, E, G(_local), V]
        return batch

    def train_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for idx in self.train_sampler.epoch_batches(epoch):
            yield self.make_batch(idx)

    def val_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        for idx in self.val_sampler.epoch_batches(0):
            yield self.make_batch(idx)

    @property
    def statistics(self) -> Dict[str, Dict[str, np.ndarray]]:
        return {name: ds.statistics for name, ds in self.datasets.items()}

    @property
    def name_to_index(self) -> Dict[str, Dict[str, int]]:
        return {name: ds.name_to_index for name, ds in self.datasets.items()}
