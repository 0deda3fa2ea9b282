"""Named spans of the program in a ``torch.profiler`` trace.

:func:`span` opens ``torch.profiler.record_function(name, args)`` while a
profiler records, and otherwise returns a shared null context: with the
profiler off a span costs one flag test.  The spans are the profiler's user
annotations, on the same clock as the kernels they launch, so a reader of
the trace attributes each kernel to the spans whose host interval holds its
launch.  Every name starts with ``anemoi.``:

- the training step (``training/step.py``, ``training/optimizers.py``),
  ``anemoi.step``, and inside it
  ``anemoi.step.{cast,inputs,forward,loss,backward,grad_reduce,grad_norm}``
  and ``anemoi.optim.{clip,update}``;
- a forecast (``inference.make_forecast_fn``), ``anemoi.forecast``, and
  inside it ``anemoi.forecast.{inputs,cast,model,output,advance,gather}``;
- the model's components (``AnemoiModelEncProcDec.forward``, through
  :func:`components`): ``anemoi.model.{encoder,processor,decoder}`` and, in
  a backward the profiler records, ``anemoi.model.<part>.backward``;
- the trainer's wait for a batch, ``anemoi.trainer.data_wait``, and the
  sections of ``BenchmarkProfiler``, ``anemoi.profile.<section>``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str, args: Optional[object] = None):
    """A context that records ``name`` (with ``args`` turned into a string)
    while a profiler records, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name, None if args is None else str(args))


class _BackwardSpan:
    """The backward span of one component call: opened when the backward
    reaches the first of the call's outputs, closed once it has passed
    every input in the autograd graph, when another component of the same
    forward opens its own, or at the end of the backward."""

    __slots__ = ("name", "group", "pending", "record", "done")

    def __init__(self, name: str, group: "_Components") -> None:
        self.name = name
        self.group = group
        self.pending = 0  # inputs the backward has yet to pass
        self.record = None
        self.done = False

    def open(self, grad=None) -> None:
        if self.record is None and not self.done:
            if self.group.current is not None:
                self.group.current.close()
            self.group.current = self
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
            # whatever is still open at the end of the backward closes there
            torch.autograd.Variable._execution_engine.queue_callback(self.close)

    def passed(self, grad=None) -> None:
        self.pending -= 1
        if self.pending == 0:
            self.close()

    def close(self) -> None:
        if self.record is not None:
            self.record.__exit__(None, None, None)
            self.record = None
            self.done = True
            if self.group.current is self:
                self.group.current = None


def _in_graph(x) -> bool:
    """A tensor made in this backward's graph (not a leaf, whose hooks
    would outlive the step)."""
    return isinstance(x, torch.Tensor) and x.grad_fn is not None


class _Components:
    """The components of one model forward, while a profiler records."""

    __slots__ = ("current",)

    def __init__(self) -> None:
        self.current: Optional[_BackwardSpan] = None  # the open backward span

    def __call__(self, part: str, fn: Callable, *inputs):
        with torch.profiler.record_function(f"anemoi.model.{part}"):
            out = fn(*inputs)
            if torch.is_grad_enabled():
                mark = _BackwardSpan(f"anemoi.model.{part}.backward", self)
                for x in inputs:
                    if _in_graph(x):
                        mark.pending += 1
                        x.register_hook(mark.passed)
                for y in out if isinstance(out, tuple) else (out,):
                    if _in_graph(y):
                        y.register_hook(mark.open)
            return out


def plain(part: str, fn: Callable, *inputs):
    """``fn(*inputs)``: the components' caller with the profiler off."""
    return fn(*inputs)


def components() -> Callable:
    """The caller of one model forward's components: ``call(part, fn,
    *inputs)`` runs ``fn(*inputs)`` (a tensor or a tuple of tensors).  While
    a profiler records, under the span ``anemoi.model.<part>``; with
    gradients on, hooks on the inputs and outputs in the autograd graph
    also open ``anemoi.model.<part>.backward`` on the thread that
    runs the backward, when it reaches the first output, and close it once
    it has passed every such input, when the next component's opens, or at
    the end of the backward.  A checkpoint's recompute in the backward
    enters the forward span again.  Hooks add no autograd node and change
    no gradient.  With the profiler off the caller is ``fn(*inputs)``."""
    return _Components() if _profiler._is_profiler_enabled else plain
