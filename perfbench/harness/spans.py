"""Device time and launches under the program's own spans.

The program (``anemoi_tpu_torch/utils/tracing.py``) opens a
``torch.profiler`` user annotation at each of its layer boundaries while a
profiler records; every name starts with ``anemoi.``: the training step
(``anemoi.step``) and its phases (``anemoi.step.cast``, ``.inputs``,
``.forward``, ``.loss``, ``.backward``, ``.grad_reduce``, ``.grad_norm``),
the optimizer's (``anemoi.optim.clip``, ``.update``), a forecast
(``anemoi.forecast``) and its phases (``anemoi.forecast.inputs``,
``.cast``, ``.model``, ``.output``, ``.advance``, ``.gather``) and the
model's components
(``anemoi.model.encoder``, ``.processor``, ``.decoder``, and in training
``anemoi.model.<part>.backward``, opened on the thread that runs the
backward).

Each kernel belongs to the innermost ``anemoi.`` span open, on any thread,
when the host launched it (by the launch's correlation id, as
``Trace.seconds_under`` matches them): the span that started last among
those whose host interval holds the launch.  So a kernel counts once
however its spans nest or are entered again (a checkpoint's recompute
enters the forward spans inside a backward one), and the metrics of
different spans never share a kernel.  A reader returns None where none of
its spans ran (a program without them) or where the trace holds no device
kernel (a run on the CPU).
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional

from perfbench.harness.readers import ReadContext
from perfbench.harness.trace import Event, Trace

PREFIX = "anemoi."


def owners(t: Trace, prefix: str = PREFIX) -> Dict[int, str]:
    """The correlation id of each launch made inside a span named
    ``prefix...`` -> the name of the innermost such span."""
    spans = sorted((s.ts, s.ts + s.dur, name) for name, events in t.annotations.items()
                   if name.startswith(prefix) for s in events)
    starts = [a for a, _, _ in spans]
    out: Dict[int, str] = {}
    for r in t.runtime:
        if r.corr is None:
            continue
        i = bisect.bisect_right(starts, r.ts) - 1
        while i >= 0 and spans[i][1] < r.ts:  # siblings that ended before the launch
            i -= 1
        if i >= 0:
            out[r.corr] = spans[i][2]
    return out


def kernels_under(t: Trace, names: Iterable[str]) -> Optional[List[Event]]:
    """The kernels that belong to any of ``names``, or None where none of
    them ran."""
    names = set(names)
    if not any(t.annotations.get(n) for n in names):
        return None
    owner = owners(t)
    return [k for k in t.kernels if owner.get(k.corr) in names]


def covered_share(t: Trace, prefix: str = PREFIX) -> Optional[float]:
    """The share of the stretch's kernel time launched inside some span
    named ``prefix...``, in %; None without kernels."""
    total = sum(k.dur for k in t.kernels)
    if total <= 0:
        return None
    corr = set(owners(t, prefix))
    return 100.0 * sum(k.dur for k in t.kernels if k.corr in corr) / total


def span_ms(t: Trace, ctx: ReadContext, kind: str, names, per: str) -> Optional[float]:
    """Device ms under ``names`` a unit (``per`` "unit": a sample or a
    forecast state) or a step (``per`` "step": a training step)."""
    if ctx.kind != kind or not t.kernels:
        return None
    n = ctx.units if per == "unit" else ctx.steps
    kernels = kernels_under(t, names)
    return None if kernels is None or n == 0 else sum(k.dur for k in kernels) / 1e3 / n


def span_launches(t: Trace, ctx: ReadContext, kind: str, names) -> Optional[float]:
    """Kernels launched under ``names`` a training step (or a forecast)."""
    if ctx.kind != kind or not t.kernels or ctx.steps == 0:
        return None
    kernels = kernels_under(t, names)
    return None if kernels is None else len(kernels) / ctx.steps
