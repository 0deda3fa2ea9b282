"""The profiled stretch of a ``--trace 1`` run and what is read from it.

``profile`` runs ``fn(i)`` for ``n`` units under ``torch.profiler`` (CPU and
CUDA activities), exports the trace to a file under the run's temporary
directory, reads it back and deletes it.  ``Trace`` keeps the device's
kernels, copies and sets, the host's runtime launches, annotations and
operators, the stretch's length on the host clock, and the union of the
device's intervals (overlapping work counts once).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


@dataclass
class Event:
    name: str
    ts: float  # microseconds
    dur: float
    corr: Optional[int] = None


class Trace:
    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        self.device: List[Event] = []
        self.kernels: List[Event] = []
        self.runtime: List[Event] = []
        self.host: List[Event] = []
        self.annotations: Dict[str, List[Event]] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ev = Event(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                       (e.get("args") or {}).get("correlation"))
            if cat in DEVICE_CATS:
                self.device.append(ev)
                if cat == "kernel":
                    self.kernels.append(ev)
            elif cat == "cuda_runtime" or cat == "cuda_driver":
                self.runtime.append(ev)
            elif cat in HOST_CATS:
                self.host.append(ev)
                if cat == "user_annotation":
                    self.annotations.setdefault(ev.name, []).append(ev)
        self.merged = _union(self.device)
        self.busy_s = sum(b - a for a, b in self.merged) / 1e6

    def kernel_seconds(self, part: str) -> Tuple[float, int]:
        """Total seconds and count of the kernels whose name contains ``part``."""
        hits = [k for k in self.kernels if part in k.name]
        return sum(k.dur for k in hits) / 1e6, len(hits)

    def seconds_under(self, annotation: str) -> Optional[float]:
        """Device seconds of the kernels launched while the host was inside
        ``annotation`` (by the launch's correlation id), or None if the
        annotation never ran."""
        spans = self.annotations.get(annotation)
        if not spans:
            return None
        spans = sorted((s.ts, s.ts + s.dur) for s in spans)
        starts = [a for a, _ in spans]
        corr = set()
        for r in self.runtime:
            i = bisect.bisect_right(starts, r.ts) - 1
            if i >= 0 and r.ts <= spans[i][1] and r.corr is not None:
                corr.add(r.corr)
        return sum(k.dur for k in self.kernels if k.corr in corr) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for d in self.device:
            total[d.name] = total.get(d.name, 0.0) + d.dur / 1e6
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between device intervals, each named by the
        innermost host event under way at its middle."""
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(self.merged, self.merged[1:])]
        gaps.sort(reverse=True)
        out = []
        for length, start, end in gaps[:n]:
            mid = 0.5 * (start + end)
            under = [h for h in self.host if h.ts <= mid <= h.ts + h.dur]
            name = min(under, key=lambda h: h.dur).name if under else "no host event"
            out.append([name[:160], length / 1e6])
        return out


def _union(events: List[Event]) -> List[Tuple[float, float]]:
    spans = sorted((e.ts, e.ts + e.dur) for e in events)
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def profile(fn: Callable[[int], None], n: int, device: torch.device) -> Trace:
    acts = [torch.profiler.ProfilerActivity.CPU]
    sync = (lambda: None) if device.type != "cuda" else torch.cuda.synchronize
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events, window_s)
