"""The ``train`` loop: training steps of the program's ``make_step_fns``
train step, back to back, each on a fresh batch from a ring of seeded
samples held pinned on the host and copied to the card, each ended by
reading its loss back to the host.  A mix gives ``batch``, ``rollout`` and
``ring``.

``correct``: set-up drives the window's own step through its first
steps; the reference follows them from the same weights and batches, and
the losses, the first gradient and the change are compared.
"""

from __future__ import annotations

import math
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
    p90,
    quartiles,
    reference,
    serving_dtype,
    sync,
)
from perfbench.harness.readers import ReadContext
from perfbench.harness.trace import profile
from perfbench.reference.procedures import train_steps, training_numbers

END_TO_END = ("train_samples_per_s", "train_step_p90_ms", "setup_s")
TRACED_STEPS = 3  # training steps in the profiled stretch
SETUP_STEPS = 3  # the steps the reference follows


def optimizer_settings(config: dict) -> dict:
    t = config["training"]
    o, lr = t["optimizer"], t["lr"]
    return {"clip": float(t["gradient_clip"]["val"]), "rate": float(lr["rate"]),
            "min": float(lr["min"]), "warmup": int(lr["warmup"]),
            "iterations": int(lr["iterations"]), "b1": float(o["b1"]), "b2": float(o["b2"]),
            "weight_decay": float(o["weight_decay"])}


def reference_training(inputs, batches, device, precision=None) -> dict:
    """The reference's (or, at a lower precision, the control's) first
    steps on ``batches`` (raw [B, T, G, V] each) from the seed's weights."""
    ref, norm = reference(inputs, device, precision, checkpoint_blocks=True)
    w = draw_weights(inputs.shapes, inputs.seed, device)
    return train_steps(ref, w, batches, norm, ref.graph["area"], optimizer_settings(inputs.config))


def checks(inputs, program: dict, reference_steps: dict) -> Dict[str, tuple]:
    limits = inputs.config["limits"]["train"]
    numbers = training_numbers(program, reference_steps)
    return {k: (v, float(limits[k])) for k, v in numbers.items()}


def first_batches(inputs, traffic: dict, seed: int, device) -> list:
    """The batches of the first steps, as the run draws them."""
    b, r = int(traffic["batch"]), int(traffic["rollout"])
    m = int(inputs.config["model"]["n_step_input"])
    g, v = inputs.num_nodes["data"], len(inputs.variables.names)
    ring = draw_data((int(traffic["ring"]), m + r, 1, g, v), inputs.statistics, seed, device,
                     pin=False)
    return [ring[i * b : (i + 1) * b, :, 0].to(device) for i in range(SETUP_STEPS)]


def calibrate(inputs, traffic: dict, seed: int, device, kind: str) -> Dict[str, float]:
    """The compared numbers of the control (``control``: the reference a
    precision lower) or of the float32 reference trained on half of each
    batch, the mean taken over the rest (``half_batch``), in the program's
    place."""
    batches = first_batches(inputs, traffic, seed, device)
    if kind == "control":
        program = reference_training(inputs, batches, device, inputs.ref.Precision("fp8"))
    elif kind == "half_batch":
        half = max(1, int(traffic["batch"]) // 2)
        program = reference_training(inputs, [x[:half] for x in batches], device)
    else:
        raise ValueError(f"no {kind} for a training cell")
    return {k: v for k, (v, _) in checks(inputs, program,
                                         reference_training(inputs, batches, device)).items()}


def _loss_function(inputs):
    from anemoi_tpu_torch.training.losses import get_loss_function
    from anemoi_tpu_torch.training.losses.scalers import create_scalers

    attr = inputs.config["training"]["area_attribute"]
    scalers = create_scalers({"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                                       "attribute_name": attr}}, graph=inputs.graph)
    return get_loss_function({"name": "WeightedMSELoss", "scalers": ["area"]}, scalers)


def run(run: Run) -> Outcome:
    t_started = time.perf_counter()
    program_s = import_program()
    from anemoi_tpu_torch.training.optimizers import build_optimizer
    from anemoi_tpu_torch.training.step import TrainState, make_step_fns

    cfg, traffic, dev = run.config, run.traffic, run.device
    inputs = build_inputs(cfg, run.seed)
    inputs.timings.update(start_s=t_started - run.t_start, program_import_s=program_s)
    t0 = time.perf_counter()
    iface = program_interface(inputs, dev, training=True)
    load_weights(iface.model, draw_weights(inputs.shapes, run.seed, dev))
    sync(dev)
    inputs.timings["model_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    t = cfg["training"]
    state = TrainState.create(iface, build_optimizer(
        {"optimizer": {"name": "adamw", **{k: t["optimizer"][k] for k in
                                           ("b1", "b2", "weight_decay")}},
         "lr": t["lr"], "gradient_clip": t["gradient_clip"]}))
    rollout, b = int(traffic["rollout"]), int(traffic["batch"])
    train_step, _ = make_step_fns(iface, {"data": _loss_function(inputs)}, rollout=rollout,
                                  precision=cfg["precision"])
    inputs.timings["step_build_s"] = time.perf_counter() - t0
    m = int(cfg["model"]["n_step_input"])
    n_ring = int(traffic["ring"])
    if n_ring % b or n_ring < SETUP_STEPS * b:
        raise ValueError(f"ring {n_ring} must be a multiple of the batch {b} and hold "
                         f"{SETUP_STEPS} batches")
    g, v = inputs.num_nodes["data"], len(inputs.variables.names)
    t0 = time.perf_counter()
    ring = draw_data((n_ring, m + rollout, 1, g, v), inputs.statistics, run.seed, dev,
                     pin=dev.type == "cuda")
    inputs.timings["data_s"] = time.perf_counter() - t0

    def step(k: int) -> float:
        i = (k * b) % n_ring
        with torch.profiler.record_function("perfbench.batch_copy"):
            batch = {"data": ring[i : i + b].to(dev, non_blocking=True)}
        with torch.profiler.record_function("perfbench.train_step"):
            _, met = train_step(state, batch)
        with torch.profiler.record_function("perfbench.loss_readback"):
            return float(met["loss"])

    # the first steps, which the reference follows
    t0 = time.perf_counter()
    params = dict(iface.model.named_parameters())
    b1 = float(t["optimizer"]["b1"])
    program = {"losses": []}
    for k in range(SETUP_STEPS):
        program["losses"].append(step(k))
        if k == 0:  # the first gradient as the optimizer got it: exp_avg = (1 - b1) g
            opt_state = state.optimizer.opt.state
            # (a parameter the update never reached has no moment: 0)
            program["grad"] = {n: float(opt_state[p]["exp_avg"].norm()) / (1 - b1)
                               if "exp_avg" in opt_state.get(p, {}) else 0.0
                               for n, p in params.items()}
    w0 = draw_weights(inputs.shapes, run.seed, dev)
    program["change"] = {n: float((p.detach() - w0[n]).norm()) for n, p in params.items()}
    del w0
    for k in range(SETUP_STEPS, SETUP_STEPS + WARMUP_STEPS):
        step(k)
    guard.check("the end of set-up")
    sync(dev)
    t_window = time.perf_counter()
    inputs.timings["first_steps_s"] = t_window - t0
    setup_s = t_window - run.t_start
    times, failed, k, last = [], 0, SETUP_STEPS + WARMUP_STEPS, t_window
    while True:
        loss = step(k)
        now = time.perf_counter()
        times.append(now - last)
        last, k = now, k + 1
        failed += not math.isfinite(loss)
        if now - t_window >= run.seconds:
            break
    window = last - t_window
    inputs.timings.update(card_after_window=card_state(dev), step_ms_quartiles=quartiles(times))
    rate = len(times) * b / window
    e2e = {"train_samples_per_s": rate, "train_step_p90_ms": 1e3 * p90(times), "setup_s": setup_s}
    peak = memory_peak(dev)
    trace = ctx = None
    if run.trace:
        trace = profile(lambda i: step(k + i), TRACED_STEPS, dev)
        shape = model_shape(inputs)
        ctx = ReadContext("train", TRACED_STEPS * b, TRACED_STEPS, TRACED_STEPS * rollout, b,
                          serving_dtype(cfg).itemsize, shape, rate,
                          yardstick.training_flops(shape) * rollout)
    guard.check("the end of the window")
    del state, train_step, iface, params
    free(dev)
    t_ref = time.perf_counter()
    batches = [ring[i * b : (i + 1) * b, :, 0].to(dev) for i in range(SETUP_STEPS)]
    compared = checks(inputs, program, reference_training(inputs, batches, dev))
    return Outcome(e2e, len(times), failed, compared, peak, trace, ctx,
                   {**inputs.timings, "reference_s": time.perf_counter() - t_ref})
