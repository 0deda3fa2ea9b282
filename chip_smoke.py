"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--json PATH]

Phases (any failure exits non-zero, with no result line):
  1. card      -- require CUDA; print the card's name and power limit;
  2. build     -- build every kernel from the sources in this checkout, one
                  nvcc per source, all started together;
  3. kernels   -- hold K1 and K2 against their plain PyTorch versions at the
                  three full-size edge sets of the o96 -> ico-5 graph, in
                  float32 and bfloat16, and time both with CUDA events;
  4. backward  -- at the same edge sets and types, for both edge inputs (K1's
                  raw attributes and K2's projected edges): K3 + K4 and K3
                  (no dkv) + K5 against the plain backward, per output, and
                  K4 against a float32 index_add_ of K3's dkv; each kernel
                  timed beside its byte bound and its plain version (K3, K5:
                  the whole plain backward), K4 also beside one index_add_;
  5. serving   -- a 2-step forecast of the flagship GraphTransformer (o96 ->
                  ico-5, 512 channels, 16 layers, 16 heads, bf16) through the
                  port's entry points: finite, right shape, exactly 18 K1
                  launches per step, close to the same model run on the plain
                  attention; ms per step and peak memory;
  6. training  -- flagship training steps through ``make_step_fns`` (bf16
                  compute over float32 masters, area-weighted MSE, AdamW,
                  value clipping at 32, rollout 1): finite loss and grad norm,
                  exactly 18 K1, K3 and K4 launches per step (18 K5 and no K4
                  under ``paged_fused_bwd``), non-zero gradients on every
                  attention projection, gradients of both backwards close to
                  the same step on the plain attention; ms per step and peak
                  memory;
  7. report    -- one JSON line {"kernels": [...]}, the card line, and last
                  {"ok": true, "device": {...}}; with --json, the same and
                  the serving and training details also go to PATH.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from anemoi_tpu_torch.flagship import (
    EDGE_ATTRIBUTES,
    flagship_config,
    flagship_indices,
    flagship_recipe,
    flagship_statistics,
)

SEED = 0
HD, HEADS = 512, 16
FWD_SOURCE = "anemoi_tpu_torch/kernels/csrc/gt_attention_fwd.cu"
BWD_SOURCE = "anemoi_tpu_torch/kernels/csrc/gt_attention_bwd.cu"
KERNELS = {  # name -> (source, TPU kernel it replaces, public op or role)
    "K1": (FWD_SOURCE, "anemoi_tpu/ops/pallas/paged_gt.py:354 (_fwd_kernel, fuse_edge=True)",
           "paged_gt_attention_flat_fe (lin_edge fused)"),
    "K2": (FWD_SOURCE, "anemoi_tpu/ops/pallas/paged_gt.py:354 (_fwd_kernel, fuse_edge=False)",
           "paged_gt_attention_flat (pre-projected edges)"),
    "K3": (BWD_SOURCE, "anemoi_tpu/ops/pallas/paged_gt.py:457 (_bwd_kernel)",
           "backward, destination pass"),
    "K4": (BWD_SOURCE, "anemoi_tpu/ops/pallas/paged_gt.py:562 (_reduce_kernel)",
           "backward, source pass over dkv"),
    "K5": (BWD_SOURCE, "anemoi_tpu/ops/pallas/paged_gt.py:597 (_fused_reduce_kernel)",
           "backward, fused source pass (paged_fused_bwd)"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # non-tensor-core float32 (the kernel's arithmetic)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # max|out - ref| / max|ref|
SERVING_TOL = 2e-2  # relative L2, bf16 forecast on K1 against the plain attention
# relative L2 of the flattened gradient of one bf16 training step on the
# kernels against the same step on the plain attention: both run the same
# bf16 model and differ by where the attention's outputs, its dkv buffer and
# its input gradients are rounded to bf16 (~4e-3 each), carried through the
# backward of 18 blocks; measured 8.5e-4 on the H100
GRAD_TOL = 1e-2
STEPS = 2
LAUNCHES_PER_STEP = 18  # encoder + 16 processor layers + decoder
TRAIN_STEPS = 8  # timed training steps, after 2 of warmup


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(n_dst, n_src, n_edges, n_feat, elt, fused):
    """(bound_ms, bound_by) of one attention launch: each input read once and
    each output written once at the HBM rate, against the float32 operations
    the kernel does per edge and channel (q.k, k+e, v+e, the online-softmax
    update, and in K1 the F-term edge projection)."""
    edge_bytes = n_edges * n_feat * elt + n_feat * HD * elt + HD * elt if fused else n_edges * HD * elt
    nbytes = (
        2 * n_dst * HD * elt  # q in, out
        + 2 * n_src * HD * elt  # k, v
        + edge_bytes
        + 4 * (n_edges + n_dst + 1)  # src, dst_ptr (int32)
        + 4 * n_dst * HEADS  # lse
    )
    return bound(nbytes, n_edges * HD * (7 + (2 * n_feat if fused else 0)))


def bound(nbytes, flops):
    """(bound_ms, bound_by): the bytes at the HBM rate against the float32
    operations at the card's non-tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def backward_bounds(n_dst, n_src, n_edges, n_feat, elt, fused):
    """{kernel: (bound_ms, bound_by)} of K3, K4 and K5 as the training path
    launches them: each input read once, each output written once.  K3 writes
    dq, the per-edge dkv [E, 2HD] and, for projected edges, their float32
    gradient [E, HD], or, with the projection fused, dW and dbias (the
    flagship's raw attributes are constants: no d_attr); K4 reads dkv back
    and writes dk, dv; K5 reads K3's inputs plus the source-ordered view and
    writes dk, dv.  Operations per edge and channel: K3 12 (+ 4F for the
    projection and dW), K4 2, K5 12 (+ 2F)."""
    node_in = 2 * n_dst * HD * elt + 2 * n_src * HD * elt  # q, g; k, v
    stats = 2 * 4 * n_dst * HEADS  # lse, delta (float32)
    edge_in = (n_edges * n_feat * elt + n_feat * HD * elt + HD * elt) if fused \
        else n_edges * HD * elt
    dkv = n_edges * 2 * HD * elt
    k3 = (node_in + stats + edge_in + 4 * (n_edges + n_dst + 1) + n_dst * HD * elt + dkv
          + ((n_feat + 1) * HD * 4 if fused else n_edges * HD * 4))
    k4 = dkv + 4 * (n_edges + n_src + 1) + 2 * n_src * HD * elt
    k5 = node_in + stats + edge_in + 4 * (2 * n_edges + n_src + 1) + 2 * n_src * HD * elt
    per_edge = n_edges * HD
    return {
        "K3": bound(k3, per_edge * (12 + (4 * n_feat if fused else 0))),
        "K4": bound(k4, per_edge * 2),
        "K5": bound(k5, per_edge * (12 + (2 * n_feat if fused else 0))),
    }


def kernel_phase(graph, device) -> dict:
    """K1/K2 against their plain versions at the three full-size edge sets."""
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.ops.gt_attention import SourceOrder, gt_attention, gt_attention_fe

    gen = torch.Generator(device=device).manual_seed(SEED)
    results = {"K1": [], "K2": []}
    for key in (("data", "hidden"), ("hidden", "hidden"), ("hidden", "data")):
        es = graph[key]
        n_src, n_dst = graph[key[0]].num_nodes, graph[key[1]].num_nodes
        ei = torch.as_tensor(es.edge_index, dtype=torch.int32, device=device).contiguous()
        ptr = torch.as_tensor(es.dst_ptr, dtype=torch.int32, device=device)
        order = SourceOrder.of(ei, n_src)
        attr32 = torch.as_tensor(es.attribute_matrix(EDGE_ATTRIBUTES), device=device)
        n_e, n_f = attr32.shape
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape, scale=1.0):
                x = torch.randn(*shape, generator=gen, device=device) * scale
                return x.to(dtype)

            q, k, v = rnd(1, n_dst, HD), rnd(1, n_src, HD), rnd(1, n_src, HD)
            attr = attr32.to(dtype)
            w, b = rnd(HD, n_f, scale=0.3).t(), rnd(HD, scale=0.1)  # w: [F, HD] view
            e = rnd(n_e, HD, scale=0.5)
            cases = {
                "K1": (lambda p: gt_attention_fe(q, k, v, attr, w, b, ei, ptr, HEADS, plain=p,
                                                 source=order), True),
                "K2": (lambda p: gt_attention(q, k, v, e, ei, ptr, HEADS, plain=p,
                                              source=order), False),
            }
            for name, (fn, fused) in cases.items():
                wrapper = kern.gt_attention_fused_edge if fused else kern.gt_attention_edge
                before = wrapper.launches
                out, lse = fn(False)
                torch.cuda.synchronize()
                if wrapper.launches != before + 1:
                    raise RuntimeError(f"{name}: launch counter did not move")
                ref, ref_lse = fn(True)
                scale_ref = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                lse_err = (lse - ref_lse).nan_to_num(0.0).abs().max().item()  # -inf - -inf
                rel = err / scale_ref
                lse_rel = lse_err / ref_lse[ref_lse.isfinite()].abs().max().item()
                if not (rel <= TOL[dtype] and lse_rel <= 1e-3 and torch.isfinite(out).all()):
                    raise RuntimeError(
                        f"{name} {key} {dtype}: max|out-ref|/max|ref| = {rel:.3e} "
                        f"(tol {TOL[dtype]}), lse rel err {lse_rel:.3e}"
                    )
                ms = cuda_ms(lambda: fn(False))
                plain_ms = cuda_ms(lambda: fn(True), reps=20)
                bound_ms, bound_by = attention_bound(
                    n_dst, n_src, n_e, n_f, q.element_size(), fused
                )
                row = {
                    "edge_set": "->".join(key), "dtype": str(dtype).split(".")[-1],
                    "n_dst": n_dst, "n_src": n_src, "n_edges": n_e,
                    "max_abs_err": err, "rel_err": rel, "lse_max_abs_err": lse_err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None,
                }
                results[name].append(row)
                print(f"[kernels] {name} {row}", flush=True)
    return results


def backward_phase(graph, device) -> dict:
    """K3 + K4 and K3 (no dkv) + K5 against the plain backward at the three
    full-size edge sets, for both edge inputs, in float32 and bfloat16."""
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.ops.gt_attention import (
        SourceOrder, gt_attention_bwd_kernels, gt_attention_bwd_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rows = {"K3": [], "K4": [], "K5": []}
    for key in (("data", "hidden"), ("hidden", "hidden"), ("hidden", "data")):
        es = graph[key]
        n_src, n_dst = graph[key[0]].num_nodes, graph[key[1]].num_nodes
        ei = torch.as_tensor(es.edge_index, dtype=torch.int32, device=device).contiguous()
        ptr = torch.as_tensor(es.dst_ptr, dtype=torch.int32, device=device)
        order = SourceOrder.of(ei, n_src)
        src = ei[0].long()
        attr32 = torch.as_tensor(es.attribute_matrix(EDGE_ATTRIBUTES), device=device)
        n_e, n_f = attr32.shape
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

            q, k, v, g = rnd(1, n_dst, HD), rnd(1, n_src, HD), rnd(1, n_src, HD), rnd(1, n_dst, HD)
            for fused in (True, False):
                if fused:
                    edge_kw = dict(edge_attr=attr32.to(dtype), weight=rnd(HD, n_f, scale=0.3).t(),
                                   bias=rnd(HD, scale=0.1))
                    out, lse = kern.gt_attention_fused_edge(q, k, v, *edge_kw.values(), ei, ptr,
                                                            HEADS)
                else:
                    edge_kw = dict(edges=rnd(n_e, HD, scale=0.5))
                    out, lse = kern.gt_attention_edge(q, k, v, edge_kw["edges"], ei, ptr, HEADS)
                # what the training path asks of K3: the flagship's raw edge
                # attributes are constants (no d_attr); projected edges need d_e
                path_kw = dict(edge_grad=not fused, weight_grad=True)
                ref = gt_attention_bwd_plain(q, k, v, ei, HEADS, out, lse, g, **edge_kw)
                names = ("dq", "dk", "dv") + (("d_attr", "d_weight", "d_bias") if fused
                                              else ("d_edges",))
                errs = {}
                for fused_bwd in (False, True):
                    before = kern.launch_counts()
                    got = gt_attention_bwd_kernels(q, k, v, ei, ptr, order.src_ptr,
                                                   order.src_perm, HEADS, out, lse, g,
                                                   fused_bwd=fused_bwd, **edge_kw)
                    torch.cuda.synchronize()
                    after = kern.launch_counts()
                    second = "K5" if fused_bwd else "K4"
                    if after["K3"] != before["K3"] + 1 or after[second] != before[second] + 1:
                        raise RuntimeError(f"backward launch counters did not move: {after}")
                    for name in names:
                        x, y = getattr(got, name).float(), getattr(ref, name).float()
                        err = (x - y).abs().max().item()
                        scale_ref = y.abs().max().item()
                        if not (err <= TOL[dtype] * scale_ref and torch.isfinite(x).all()):
                            raise RuntimeError(
                                f"backward {key} {dtype} fused_edge={fused} fused_bwd={fused_bwd}"
                                f" {name}: max abs err {err:.3e}, max|ref| {scale_ref:.3e} "
                                f"(tol {TOL[dtype]} of max|ref|)"
                            )
                        errs[(fused_bwd, name)] = err

                delta = (out.float() * g.float()).reshape(1, n_dst, HEADS, -1).sum(-1)
                dkv = kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, HEADS,
                                                **edge_kw, **path_kw).dkv

                # K4 alone: the sum of K3's dkv rows into their sources.  Its
                # plain version accumulates in float32 as K4 does; the library
                # call is one index_add_ in the input type
                def k4_plain():
                    acc = torch.zeros(1, n_src, 2 * HD, device=device).index_add_(
                        1, src, dkv.float())
                    return acc[..., :HD].to(dtype), acc[..., HD:].to(dtype)

                def k4_library():
                    return torch.zeros(1, n_src, 2 * HD, device=device, dtype=dtype).index_add_(
                        1, src, dkv)

                k4_ref = k4_plain()
                for x, y in zip(kern.gt_attention_bwd_src(dkv, order.src_ptr, order.src_perm),
                                k4_ref):
                    err = (x.float() - y.float()).abs().max().item()
                    if not err <= TOL[dtype] * y.float().abs().max().item():
                        raise RuntimeError(f"K4 {key} {dtype} against its plain version: "
                                           f"max abs err {err:.3e}")
                del k4_ref
                ms = {
                    "K3": cuda_ms(lambda: kern.gt_attention_bwd_dst(
                        q, k, v, g, lse, delta, ei, ptr, HEADS, **edge_kw, **path_kw)),
                    "K3_no_dkv": cuda_ms(lambda: kern.gt_attention_bwd_dst(
                        q, k, v, g, lse, delta, ei, ptr, HEADS, emit_dkv=False, **edge_kw,
                        **path_kw)),
                    "K4": cuda_ms(lambda: kern.gt_attention_bwd_src(
                        dkv, order.src_ptr, order.src_perm)),
                    "K5": cuda_ms(lambda: kern.gt_attention_bwd_src_fused(
                        q, k, v, g, lse, delta, ei, ptr, order.src_ptr, order.src_perm, HEADS,
                        **edge_kw)),
                }
                k4_plain_ms, k4_library_ms = cuda_ms(k4_plain), cuda_ms(k4_library)
                del dkv
                plain_ms = cuda_ms(lambda: gt_attention_bwd_plain(
                    q, k, v, ei, HEADS, out, lse, g, **edge_kw), reps=10, warmup=2)
                bounds = backward_bounds(n_dst, n_src, n_e, n_f, q.element_size(), fused)
                # K3 and K5 each compute part of the backward and no PyTorch
                # call computes either part: their plain time is the whole
                # plain backward, and they have no library call
                base = {"edge_set": "->".join(key), "dtype": str(dtype).split(".")[-1],
                        "fused_edge": fused, "n_dst": n_dst, "n_src": n_src, "n_edges": n_e,
                        "plain_ms": plain_ms, "plain_is": "gt_attention_bwd_plain",
                        "library_ms": None}
                k3_errs = {n: errs[(False, n)] for n in names if n not in ("dk", "dv")}
                per_kernel = {
                    "K3": dict(max_abs_err=max(k3_errs.values()), errors=k3_errs,
                               ms_no_dkv=ms["K3_no_dkv"]),
                    "K4": dict(max_abs_err=max(errs[(False, "dk")], errs[(False, "dv")]),
                               plain_ms=k4_plain_ms, plain_is="float32 index_add_ of dkv",
                               library_ms=k4_library_ms, library_is="index_add_ of dkv"),
                    "K5": dict(max_abs_err=max(errs[(True, "dk")], errs[(True, "dv")])),
                }
                for name, extra in per_kernel.items():
                    row = {**base, "ms": ms[name], "bound_ms": bounds[name][0],
                           "bound_by": bounds[name][1], **extra}
                    rows[name].append(row)
                    print(f"[backward] {name} {row}", flush=True)
    return rows


def serving_phase(graph, device) -> dict:
    """The port's main path at full width: the flagship interface, a 2-step
    bf16 forecast through ``make_forecast_fn``."""
    from anemoi_tpu_torch.inference import make_forecast_fn
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface

    torch.manual_seed(SEED)  # the modules' random initial weights
    iface = AnemoiModelInterface(
        config=flagship_config(), graph=graph, data_indices=flagship_indices(),
        statistics=flagship_statistics(SEED), device=device,
    )
    idx = flagship_indices()["data"]
    n_grid = graph["data"].num_nodes
    gen = torch.Generator(device=device).manual_seed(SEED)
    m = iface.model.n_step_input
    batch = {"data": torch.randn(1, m + STEPS, 1, n_grid, idx.num_data_vars,
                                 generator=gen, device=device)}
    forecast = make_forecast_fn(iface, steps=STEPS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kern.reset_launches()
    out = forecast(batch)["data"]
    torch.cuda.synchronize()
    launches = kern.launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated(device)
    print(f"[serving] launches on the main path {launches}", flush=True)

    expect = (1, STEPS, 1, n_grid, idx.num_model_output_vars)
    if tuple(out.shape) != expect or not torch.isfinite(out).all():
        raise RuntimeError(f"forecast shape {tuple(out.shape)} (want {expect}) or not finite")
    want = {"K1": LAUNCHES_PER_STEP * STEPS, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    if launches != want:
        raise RuntimeError(f"expected launches {want}, got {launches}")

    iface.use_plain_attention(True)
    ref = forecast(batch)["data"]
    iface.use_plain_attention(False)
    rel_l2 = ((out - ref).norm() / ref.norm()).item()
    print(f"[serving] forecast vs plain attention: relative L2 {rel_l2:.3e} "
          f"(tol {SERVING_TOL})", flush=True)
    if not rel_l2 <= SERVING_TOL:
        raise RuntimeError(f"forecast disagrees with the plain attention: {rel_l2:.3e}")

    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forecast(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / STEPS)
    result = {
        "ms_per_step": statistics.median(times), "ms_per_step_runs": times,
        "peak_memory_bytes": peak_bytes, "rel_l2_vs_plain": rel_l2, "launches": launches,
        "output_shape": list(out.shape),
    }
    print(f"[serving] {json.dumps(result)}", flush=True)
    return result


def training_phase(graph, device) -> dict:
    """The flagship training step at full width through ``make_step_fns``."""
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface
    from anemoi_tpu_torch.training.losses import get_loss_function
    from anemoi_tpu_torch.training.losses.scalers import create_scalers
    from anemoi_tpu_torch.training.optimizers import build_optimizer
    from anemoi_tpu_torch.training.step import TrainState, make_step_fns

    idx = flagship_indices()["data"]
    scalers = create_scalers({"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                                       "attribute_name": "area_weight"}}, graph=graph)
    stats = flagship_statistics(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    noise = torch.randn(1, 3, 1, graph["data"].num_nodes, idx.num_data_vars, generator=gen,
                        device=device)
    mean, std = (torch.as_tensor(stats["data"][k], device=device) for k in ("mean", "stdev"))
    batch = {"data": mean + std * noise}  # data space; rollout 1 needs m + 1 = 3 steps

    def build(**model_keys):
        cfg = flagship_config()
        cfg["model"].update(model_keys)
        torch.manual_seed(SEED)  # the modules' random initial weights
        iface = AnemoiModelInterface(config=cfg, graph=graph, data_indices=flagship_indices(),
                                     statistics=stats, device=device, training=True)
        losses = {"data": get_loss_function({"name": "WeightedMSELoss", "scalers": ["area"]},
                                            scalers)}
        tx = build_optimizer({"lr": {"rate": 1e-4, "warmup": 10, "iterations": 1000},
                              "gradient_clip": {"val": 32.0, "algorithm": "value"}})
        train_step, _ = make_step_fns(iface, losses, rollout=1, precision="bf16")
        return iface, TrainState.create(iface, tx), train_step

    def one_step(state, train_step):
        kern.reset_launches()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        launches = kern.launch_counts()
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise RuntimeError(f"training step not finite: loss {loss}, grad_norm {gnorm}")
        return launches, loss, gnorm

    def timed_steps(state, train_step):
        for _ in range(2):
            train_step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            train_step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), times, torch.cuda.max_memory_allocated(device)

    def flat_grads(iface):
        return torch.cat([p.grad.float().flatten() for p in iface.parameters()])

    def grad_gap(iface, state, train_step, label):
        """Relative L2 of one step's gradient on the kernels against the
        same step on the plain attention."""
        train_step.compute_gradients(state, batch)
        g_kernel = flat_grads(iface)
        iface.use_plain_attention(True)
        train_step.compute_gradients(state, batch)
        g_plain = flat_grads(iface)
        iface.use_plain_attention(False)
        gap = ((g_kernel - g_plain).norm() / g_plain.norm()).item()
        print(f"[training] {label} gradient vs plain attention: relative L2 {gap:.3e} "
              f"(tol {GRAD_TOL})", flush=True)
        if not gap <= GRAD_TOL:
            raise RuntimeError(f"{label} training gradients disagree with the plain "
                               f"attention: {gap:.3e}")
        return gap

    iface, state, train_step = build()
    n_params = sum(p.numel() for p in iface.parameters())
    launches, loss, gnorm = one_step(state, train_step)
    print(f"[training] first step: loss {loss:.6f} grad_norm {gnorm:.6f} launches {launches}",
          flush=True)
    want = {"K1": LAUNCHES_PER_STEP, "K2": 0, "K3": LAUNCHES_PER_STEP,
            "K4": LAUNCHES_PER_STEP, "K5": 0}
    if launches != want:
        raise RuntimeError(f"training step: expected launches {want}, got {launches}")

    # every attention projection must get a gradient on the kernels
    train_step.compute_gradients(state, batch)
    missing = [n for n, p in iface.named_parameters()
               if any(f"{lin}." in n for lin in ("lin_query", "lin_key", "lin_value", "lin_edge"))
               and (p.grad is None or (not n.endswith("lin_key.bias") and not p.grad.any()))]
    if missing:
        raise RuntimeError(f"attention projections without a gradient on the kernels: {missing}")
    grad_rel_l2 = grad_gap(iface, state, train_step, "K3 + K4")
    ms, times, peak = timed_steps(state, train_step)
    result = {"ms_per_step": ms, "ms_per_step_runs": times, "peak_memory_bytes": peak,
              "n_params": n_params, "first_loss": loss, "first_grad_norm": gnorm,
              "grad_rel_l2_vs_plain": grad_rel_l2, "launches": launches}
    print(f"[training] {json.dumps(result)}", flush=True)
    del iface, state, train_step
    torch.cuda.empty_cache()

    # the fused backward (K3 without dkv + K5) through the config key
    iface, state, train_step = build(paged_fused_bwd=True)
    fused_launches, fused_loss, _ = one_step(state, train_step)
    want = {"K1": LAUNCHES_PER_STEP, "K2": 0, "K3": LAUNCHES_PER_STEP, "K4": 0,
            "K5": LAUNCHES_PER_STEP}
    if fused_launches != want:
        raise RuntimeError(f"paged_fused_bwd step: expected launches {want}, "
                           f"got {fused_launches}")
    fused_gap = grad_gap(iface, state, train_step, "K3 + K5")
    fused_ms, fused_times, fused_peak = timed_steps(state, train_step)
    result["fused_bwd"] = {"ms_per_step": fused_ms, "ms_per_step_runs": fused_times,
                           "peak_memory_bytes": fused_peak, "first_loss": fused_loss,
                           "grad_rel_l2_vs_plain": fused_gap, "launches": fused_launches}
    print(f"[training] paged_fused_bwd {json.dumps(result['fused_bwd'])}", flush=True)
    del iface, state, train_step
    torch.cuda.empty_cache()
    return result


def report(kernel_rows: dict, serving: dict, training: dict) -> dict:
    """One entry per kernel.  Headline numbers: the processor edge set in
    bf16 (16 of the 18 launches per step), with the flagship's fused edge
    projection for the backward kernels.  ``launches`` is each kernel's count
    on the path it serves: the 2-step forecast for K1 and K2, one training
    step for K3 and K4, one ``paged_fused_bwd`` training step for K5;
    ``launches_by_path`` has all three."""
    by_path = {"serving_2_steps": serving["launches"], "training_step": training["launches"],
               "training_step_fused_bwd": training["fused_bwd"]["launches"]}
    path_of = {"K1": "serving_2_steps", "K2": "serving_2_steps", "K3": "training_step",
               "K4": "training_step", "K5": "training_step_fused_bwd"}
    entries = []
    for name, rows in kernel_rows.items():
        head = next(r for r in rows if r["edge_set"] == "hidden->hidden"
                    and r["dtype"] == "bfloat16" and r.get("fused_edge", True))
        source, replaces, role = KERNELS[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "public_op": role,
            "launches": by_path[path_of[name]][name],
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": head["max_abs_err"], "max_err": head["max_abs_err"],
            "ms": head["ms"],
            # K3, K5: the plain version is the whole plain backward
            # (gt_attention_bwd_plain); K4: a float32 index_add_ of dkv
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_us": head["bound_ms"] * 1e3,
            "bound_by": head["bound_by"],
            # K4: one index_add_ of dkv by source.  No single PyTorch call
            # computes sparse graph attention with a per-edge bias on k and v
            # (K1, K2), nor K3's or K5's part of its backward (SDPA is dense;
            # its masks cannot add e_ij to v)
            "library_ms": head["library_ms"],
            "edge_set": head["edge_set"], "dtype": head["dtype"],
            "per_edge_set": rows,
        })
    return {"kernels": entries}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the report, serving and training details here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain references in full float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}", flush=True)

    from anemoi_tpu_torch.graphs.create import GraphCreator
    from anemoi_tpu_torch.kernels.build import KERNEL_SOURCES, build_all, build_log

    seconds = build_all()
    print(f"[build] seconds {seconds}", flush=True)
    for name in KERNEL_SOURCES:
        print(f"[build] {name} ptxas:\n{build_log(name)}", flush=True)

    t0 = time.perf_counter()
    graph = GraphCreator(flagship_recipe("o96", 5)).create()
    print(f"[graph] o96 -> ico-5 built in {time.perf_counter() - t0:.2f} s: "
          f"{ {k: es.num_edges for k, es in graph.edges.items()} }", flush=True)
    rows = kernel_phase(graph, device)
    rows.update(backward_phase(graph, device))
    serving = serving_phase(graph, device)
    training = training_phase(graph, device)
    rep = report(rows, serving, training)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "build_seconds": seconds, "serving": serving,
                       "training": training, **rep}, f, indent=1)
    print(json.dumps(rep))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
