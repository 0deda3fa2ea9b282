"""Host->device batch prefetching.

Port of ``anemoi_tpu.data.prefetch``.  A worker thread assembles the next
batches (window reads, chunk decodes) and stages them on the device while
the current step runs, ``size`` batches ahead; closing the iterator stops
the worker and joins it.

On the card (:class:`HostToDevice`), the worker copies each array into a
pinned host buffer and sends it to the device with ``non_blocking=True`` on
a side stream, then records an event there.  The consumer makes the main
stream wait on that event before the step reads the batch, and marks the
tensors as used on the main stream so the caching allocator does not hand
their memory back while the step still reads it.  On the CPU the arrays
become tensors as they are.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


class StagedBatch:
    """Device tensors whose copies were issued on a side stream, and the
    event that marks their end."""

    def __init__(self, tensors: Dict[str, torch.Tensor], event: "torch.cuda.Event",
                 device: torch.device) -> None:
        self.tensors = tensors
        self.event = event
        self.device = device

    def ready(self) -> Dict[str, torch.Tensor]:
        """Order the current stream after the copies; returns the tensors."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(stream)
        return self.tensors


class HostToDevice:
    """``put_fn`` of :func:`prefetch_to_device`: numpy batch -> tensors on
    ``device`` (a :class:`StagedBatch` on the card)."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __call__(self, batch: Dict[str, np.ndarray]):
        if self.stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                    for k, v in batch.items()}
        with torch.cuda.stream(self.stream):
            tensors = {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                    self.device, non_blocking=True)
                for k, v in batch.items()
            }
            event = torch.cuda.Event()
            event.record(self.stream)
        return StagedBatch(tensors, event, self.device)


def ready_batch(item):
    """The tensors of a ``put_fn`` result, ordered after their copies on the card."""
    return item.ready() if isinstance(item, StagedBatch) else item


def prefetch_to_device(
    batches: Iterator,
    put_fn: Callable,
    size: int = 2,
) -> Iterator:
    """Yield ``put_fn(batch)`` for each batch, prepared ``size`` ahead on a
    daemon thread.  Closing the generator (early ``break``) stops the worker
    and joins it."""
    q: "queue.Queue" = queue.Queue(maxsize=max(int(size), 1))
    stop = threading.Event()
    errors = []

    def worker():
        try:
            for b in batches:
                item = put_fn(b)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # surfaced on the consumer side
            errors.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, name="batch-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if errors:
                    raise errors[0]
                return
            yield ready_batch(item)
    finally:
        stop.set()
        # join the worker: stop is set, so it exits after at most one item
        while not q.empty():  # unblock a worker mid-put
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=30.0)


def maybe_prefetch(
    batches: Iterator,
    put_fn: Callable,
    size: Optional[int],
) -> Iterator:
    """Prefetching iterator, or a plain map when size is falsy/0."""
    if size:
        return prefetch_to_device(batches, put_fn, size)
    return (ready_batch(put_fn(b)) for b in batches)
