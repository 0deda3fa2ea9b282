"""What the per-layer metric readers share.  Each file
``perfbench/metrics/<metric>.py`` defines ``read(trace, ctx)``, which
returns the metric's value, or None where the run has nothing for it to
read; the harness leaves a None out of the result line.

``ctx`` (a :class:`ReadContext`) says what the profiled stretch did: the
cell's kind (``train`` or ``forecast``), how many units it completed
(samples, or forecast states) and model evaluations it ran, the batch,
the configuration's shape for the yardstick, and the untraced window's
rate in units a second.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from perfbench import yardstick
from perfbench.harness.trace import Trace

OPTIMIZER_ANNOTATION = "Optimizer.step#AdamW.step"


@dataclass
class ReadContext:
    kind: str  # "train" or "forecast"
    units: int  # samples (train) or forecast states in the stretch
    steps: int  # training steps (train) or forecasts (forecast) in the stretch
    evaluations: int  # model evaluations of the whole batch in the stretch
    batch: int
    elt: int  # bytes of the compute type
    shape: yardstick.ModelShape
    window_rate: float  # units a second in the untraced window
    unit_flops: float  # model operations a unit


def launches_per_unit(t: Trace, ctx: ReadContext, kind: str) -> Optional[float]:
    if ctx.kind != kind or ctx.units == 0:
        return None
    return len(t.kernels) / ctx.units


def mfu(t: Trace, ctx: ReadContext, kind: str) -> Optional[float]:
    """The model's operations a second in the untraced window over the bf16
    peak, in %."""
    if ctx.kind != kind:
        return None
    return 100.0 * ctx.unit_flops * ctx.window_rate / yardstick.BF16_FLOP_PER_S


def device_idle(t: Trace, ctx: ReadContext, kind: str) -> Optional[float]:
    """The share of the untraced window in which the device runs nothing, in
    %: one less the device seconds a unit in the trace (the union of its
    intervals) times the window's units a second.  The profiled stretch's
    own host wall, which the profiler lengthens, is not used."""
    if ctx.kind != kind or ctx.units == 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / ctx.units * ctx.window_rate)


def optimizer_ms(t: Trace, ctx: ReadContext) -> Optional[float]:
    if ctx.kind != "train" or ctx.steps == 0:
        return None
    sec = t.seconds_under(OPTIMIZER_ANNOTATION)
    return None if sec is None else 1e3 * sec / ctx.steps


def gt_attention_roofline(t: Trace, ctx: ReadContext, kind: str) -> Optional[float]:
    """The least time of the graph attention's work in the stretch (every
    set's forward, and in training its backward) over the measured time of
    the kernels named ``gt_attention_``, in %."""
    if ctx.kind != kind:
        return None
    measured, count = t.kernel_seconds("gt_attention_")
    if count == 0 or measured <= 0:
        return None
    s = ctx.shape
    hd, heads, b = s.channels, s.heads, ctx.batch
    least = sum(yardstick.gt_forward_s(e, hd, heads, b, ctx.elt) for e in s.gt_sets())
    if kind == "train":
        least += sum(yardstick.gt_backward_s(e, hd, heads, b, ctx.elt) for e in s.gt_sets())
    return 100.0 * least * ctx.evaluations / measured


def window_attention_roofline(t: Trace, ctx: ReadContext, kind: str) -> Optional[float]:
    """The least time of the band attention's work in the stretch over the
    measured time of the kernels named ``window_attention_``, in %."""
    s = ctx.shape
    if ctx.kind != kind or s.processor != "TransformerProcessor":
        return None
    measured, count = t.kernel_seconds("window_attention_")
    if count == 0 or measured <= 0:
        return None
    args = (ctx.batch, s.n_hidden, s.heads, s.channels // s.heads, s.window, ctx.elt)
    least = yardstick.band_forward_s(*args)
    if kind == "train":
        least += yardstick.band_backward_s(*args)
    return 100.0 * least * s.layers * ctx.evaluations / measured
