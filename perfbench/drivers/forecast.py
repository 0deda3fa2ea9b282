"""The ``forecast`` loop: whole forecasts of the program's
``make_forecast_fn``, one client back to back, each on a fresh seeded
window copied to the card, its output copied back to the host.  A mix
gives ``steps`` (lead times a forecast), ``ring`` (windows held on the
host) and ``checked`` (forecasts of the window compared).

``correct``: a sample of the window's forecasts, drawn from the seed, is
compared with the reference's forecasts from the same windows and the
served weights.
"""

from __future__ import annotations

import random
import time
from typing import Dict

import torch

from perfbench import yardstick
from perfbench.harness import guard
from perfbench.harness.inputs import (
    build_inputs,
    draw_data,
    draw_weights,
    load_weights,
    model_shape,
    program_interface,
)
from perfbench.harness.loop import (
    WARMUP_STEPS,
    Outcome,
    Run,
    card_state,
    free,
    import_program,
    memory_peak,
    quartiles,
    reference,
    serving_dtype,
    sync,
)
from perfbench.harness.readers import ReadContext
from perfbench.harness.trace import profile
from perfbench.reference.procedures import forecast, forecast_gap

END_TO_END = ("forecast_states_per_s", "setup_s")


def reference_forecasts(inputs, windows, steps: int, device, precision=None):
    """The reference's (or the control's) forecasts of the raw windows [1,
    T, G, V] from the seed's weights, rounded to the serving type."""
    ref, norm = reference(inputs, device, precision)
    dtype = serving_dtype(inputs.config)
    w = {k: v.to(dtype).float() for k, v in draw_weights(inputs.shapes, inputs.seed,
                                                         device).items()}
    return [forecast(ref, w, win.to(device), norm, steps).cpu() for win in windows]


def checks(inputs, program, reference_outputs) -> Dict[str, tuple]:
    limit = float(inputs.config["limits"]["forecast"]["forecast_gap"])
    out = inputs.variables.output_idx
    mean, std = inputs.statistics["mean"][out], inputs.statistics["stdev"][out]
    gaps = [forecast_gap(p, r, mean, std) for p, r in zip(program, reference_outputs)]
    return {"forecast_gap": (max(gaps), limit)}


def calibrate(inputs, traffic: dict, seed: int, device, kind: str) -> Dict[str, float]:
    """The compared numbers of the control (the reference a precision
    lower) in the program's place, on the ring's first windows."""
    if kind != "control":
        raise ValueError(f"no {kind} for a forecast cell")
    steps = int(traffic["steps"])
    m = int(inputs.config["model"]["n_step_input"])
    g, v = inputs.num_nodes["data"], len(inputs.variables.names)
    ring = draw_data((int(traffic["ring"]), m + steps, 1, g, v), inputs.statistics, seed,
                     device, pin=False)
    windows = [ring[i : i + 1, :, 0] for i in range(int(traffic["checked"]))]
    control = reference_forecasts(inputs, windows, steps, device, inputs.ref.Precision("fp8"))
    compared = checks(inputs, control, reference_forecasts(inputs, windows, steps, device))
    return {k: v for k, (v, _) in compared.items()}


def run(run: Run) -> Outcome:
    t_started = time.perf_counter()
    program_s = import_program()
    from anemoi_tpu_torch.inference import make_forecast_fn

    cfg, traffic, dev = run.config, run.traffic, run.device
    inputs = build_inputs(cfg, run.seed)
    inputs.timings.update(start_s=t_started - run.t_start, program_import_s=program_s)
    t0 = time.perf_counter()
    iface = program_interface(inputs, dev, training=False)
    load_weights(iface.model, draw_weights(inputs.shapes, run.seed, dev))
    sync(dev)
    inputs.timings["model_s"] = time.perf_counter() - t0
    steps, n_ring = int(traffic["steps"]), int(traffic["ring"])
    m = int(cfg["model"]["n_step_input"])
    g, v = inputs.num_nodes["data"], len(inputs.variables.names)
    t0 = time.perf_counter()
    ring = draw_data((n_ring, m + steps, 1, g, v), inputs.statistics, run.seed, dev,
                     pin=dev.type == "cuda")
    inputs.timings["data_s"] = time.perf_counter() - t0
    fn = make_forecast_fn(iface, steps=steps)
    # the output's host buffer, pinned, as a service copies its answers back
    host = torch.empty((steps, g, len(inputs.variables.output_idx)), dtype=torch.float32,
                       pin_memory=dev.type == "cuda")

    def one(k: int):
        """A forecast: its output [steps, G, V_out] in ``host`` (overwritten by
        the next), and whether every value of it is finite."""
        i = k % n_ring
        with torch.profiler.record_function("perfbench.window_copy"):
            batch = {"data": ring[i : i + 1].to(dev, non_blocking=True)}
        with torch.profiler.record_function("perfbench.forecast"):
            out = fn(batch)["data"]
        with torch.profiler.record_function("perfbench.output_copy"):
            finite = torch.isfinite(out).all()
            host.copy_(out[0, :, 0], non_blocking=True)
            sync(dev)
            return host, bool(finite)

    t0 = time.perf_counter()
    for k in range(WARMUP_STEPS):
        one(k)
    guard.check("the end of set-up")
    sync(dev)
    inputs.timings["first_forecasts_s"] = time.perf_counter() - t0
    pick = random.Random(run.seed)
    keep: list = []  # (ring index, output): a sample drawn from the seed
    n_keep = int(traffic["checked"])
    t_window = time.perf_counter()
    setup_s = t_window - run.t_start
    done, failed, k, times, last = 0, 0, WARMUP_STEPS, [], t_window
    while True:
        out, finite = one(k)
        failed += not finite
        done += 1
        # reservoir sampling: every completed forecast equally likely kept
        if len(keep) < n_keep:
            keep.append((k % n_ring, out.clone()))
        else:
            j = pick.randrange(done)
            if j < n_keep:
                keep[j] = (k % n_ring, out.clone())
        k += 1
        now = time.perf_counter()
        times.append(now - last)
        last = now
        if last - t_window >= run.seconds:
            break
    window = last - t_window
    inputs.timings.update(card_after_window=card_state(dev), forecast_ms_quartiles=quartiles(times))
    rate = done * steps / window
    e2e = {"forecast_states_per_s": rate, "setup_s": setup_s}
    peak = memory_peak(dev)
    trace = ctx = None
    if run.trace:
        trace = profile(lambda i: one(k + i), 1, dev)
        shape = model_shape(inputs)
        ctx = ReadContext("forecast", steps, 1, steps, 1, serving_dtype(cfg).itemsize, shape,
                          rate, yardstick.forward_flops(shape))
    guard.check("the end of the window")
    del fn, iface
    free(dev)
    t_ref = time.perf_counter()
    windows = [ring[i : i + 1, :, 0] for i, _ in keep]
    compared = checks(inputs, [o for _, o in keep],
                      reference_forecasts(inputs, windows, steps, dev))
    return Outcome(e2e, done, failed, compared, peak, trace, ctx,
                   {**inputs.timings, "reference_s": time.perf_counter() - t_ref})
