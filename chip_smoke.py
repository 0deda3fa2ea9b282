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
                  K3 also back to back, with its route and its
                  instantiation's ptxas registers and spills; bf16 K3 run
                  twice at the processor edge set with the fused projection
                  must agree bit for bit (dq, dkv, dW, dbias);
  5. wide GT   -- K1 and K3 + K4 against their plain versions at HD = 1024
                  (16 heads of 64, the Transformer preset's mappers: K1, K4
                  in blocks of 1024 threads) on the data->hidden and
                  hidden->data edge sets, float32 and bfloat16; K1, K3 and K4
                  each timed beside its byte bound, its plain version and
                  (K4) one index_add_, K3 as in phase 4;
  6. window    -- K6 (out, lse) and K7 (K7_dq: dq; K7_dkv: dk, dv) against
                  the plain band and its autograd backward at the Transformer
                  preset's processor shape (B 1, N 10 242, H 16, D 64, w 512),
                  float32 and bfloat16, each timed (single calls, and calls
                  back to back) beside its operation bound, the plain version
                  and scaled_dot_product_attention with the [N, N] band mask
                  (forward; its backward for K7); one smaller case with ALiBi
                  and softcap, checked only; each window row names its route
                  (bf16 K6: warpgroup tensor cores, bf16 K7: mma.sync tensor
                  cores, float32: CUDA cores) and its instantiation's ptxas
                  registers and spills; bf16 K6 and K7 run twice at the main
                  shape must agree bit for bit;
  7. serving   -- a 2-step forecast of the flagship GraphTransformer (o96 ->
                  ico-5, 512 channels, 16 layers, 16 heads, bf16) through the
                  port's entry points: finite, right shape, exactly 18 K1
                  launches per step and no other kernel, close to the same
                  model run on the plain attention; ms per step and peak
                  memory;
  8. training  -- flagship training steps through ``make_step_fns`` (bf16
                  compute over float32 masters, area-weighted MSE, AdamW,
                  value clipping at 32, rollout 1): finite loss and grad norm,
                  exactly 18 K1, K3 and K4 launches per step (18 K5 and no K4
                  under ``paged_fused_bwd``) and no other kernel, non-zero
                  gradients on every attention projection, gradients of both
                  backwards close to the same step on the plain attention; ms
                  per step and peak memory;
  9. transformer serving -- a 2-step bf16 forecast of the ``transformer``
                  preset (GT mappers, 16 dense sliding-window layers, 1024
                  channels, window 512) on the same graph: finite, right
                  shape, exactly 16 K6 and 2 K1 launches per step and no other
                  kernel, relative L2 <= 2e-2 against the plain attention; ms
                  per step and peak memory;
 10. transformer training -- its ``make_step_fns`` step as in phase 8:
                  exactly 16 K6, 16 K7_dq, 16 K7_dkv, 2 K1, 2 K3, 2 K4 and no
                  K5 per step, non-zero gradients on every lin_q, lin_k, lin_v
                  and projection, the flattened gradient within relative L2
                  1e-2 of the plain attention's at all 16 layers; ms per step
                  and peak memory;
 11. report    -- one JSON line {"kernels": [...]} (K1-K7, K7 as K7_dq and
                  K7_dkv; each kernel's ``launches`` counted on its path:
                  ``path_of`` in ``report``), the card line, and last
                  {"ok": true, "device": {...}}; with --json, the same and
                  the serving and training details also go to PATH.

Launch counts come from ``anemoi_tpu_torch.kernels.launch_counts()`` (all
seven kernels), set to 0 just before each path runs; each path's ``want``
dict lists every kernel, the ones it must not launch at 0.
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
    transformer_config,
)

SEED = 0
HD, HEADS = 512, 16
FWD_SOURCE = "anemoi_tpu_torch/kernels/csrc/gt_attention_fwd.cu"
BWD_SOURCE = "anemoi_tpu_torch/kernels/csrc/gt_attention_bwd.cu"
WIN_FWD_SOURCE = "anemoi_tpu_torch/kernels/csrc/window_attention_fwd.cu"
WIN_BWD_SOURCE = "anemoi_tpu_torch/kernels/csrc/window_attention_bwd.cu"
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
    "K6": (WIN_FWD_SOURCE, "anemoi_tpu/ops/pallas/window_attention.py:42 (_flash_band_kernel)",
           "banded window attention, forward (out, lse)"),
    "K7_dq": (WIN_BWD_SOURCE,
              "anemoi_tpu/ops/pallas/window_attention.py:188 (_flash_bwd_dq_kernel)",
              "banded window attention, backward: dq"),
    "K7_dkv": (WIN_BWD_SOURCE,
               "anemoi_tpu/ops/pallas/window_attention.py:233 (_flash_bwd_dkv_kernel)",
               "banded window attention, backward: dk, dv"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # non-tensor-core float32 (the kernel's arithmetic)
BF16_FLOP_PER_S = 989.4e12  # dense bf16 tensor cores (a bf16 product's operations)
# the Transformer preset's processor attention: one batch row, the ico-5
# mesh as the sequence, 16 heads of 64, window 512
WIN_B, WIN_N, WIN_H, WIN_D, WIN_W = 1, 10242, 16, 64, 512
WIDE_HD = 1024  # the Transformer preset's mappers: 16 heads of 64
TRANSFORMER_LAYERS = 16
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # max|out - ref| / max|ref|
# window kernel -> (library, kernel-name stem); (kernel, dtype) -> (route, what
# follows the stem in the mangled name of the instantiation the type takes):
# bf16 K6 on the warpgroup tensor cores, bf16 K7 on mma.sync, float32 on
# CUDA cores
WINDOW_BUILDS = {"K6": ("window_attention_fwd", "window_attention_fwd"),
                 "K7_dq": ("window_attention_bwd", "window_attention_bwd_dq"),
                 "K7_dkv": ("window_attention_bwd", "window_attention_bwd_dkv")}
# K3: one route for both types; the instantiation a launch takes is named by
# its type, channels a lane (V), fused projection and room for edge features
K3_ROUTE = "CUDA cores, 16-byte vectors a lane, several destinations a block"
WINDOW_ROUTES = {
    ("K6", torch.bfloat16): ("bf16 warpgroup tensor cores (wgmma m64nNk16)", "_wgmma_kernelILi"),
    ("K7_dq", torch.bfloat16): ("bf16 tensor cores (mma.sync m16n8k16)", "_mma_kernelILi"),
    ("K7_dkv", torch.bfloat16): ("bf16 tensor cores (mma.sync m16n8k16)", "_mma_kernelILi"),
    **{(name, torch.float32): ("float32 CUDA cores", "_kernelIfLi") for name in WINDOW_BUILDS},
}
SERVING_TOL = 2e-2  # relative L2, bf16 forecast on K1 against the plain attention
# relative L2 of the flattened gradient of one bf16 training step on the
# kernels against the same step on the plain attention: both run the same
# bf16 model and differ by where the attention's outputs, its dkv buffer and
# its input gradients are rounded to bf16 (~4e-3 each), carried through the
# backward of 18 blocks; measured 8.5e-4 on the H100
GRAD_TOL = 1e-2
STEPS = 2
LAUNCHES_PER_STEP = 18  # encoder + 16 processor layers + decoder
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)
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


def cuda_ms_back_to_back(fn, launches: int = 50, warmup: int = 5) -> float:
    """Milliseconds a call of ``fn()`` over ``launches`` calls enqueued back
    to back between two CUDA events: the card's time per call once the host
    keeps ahead of it (``cuda_ms`` times single calls, host latency
    included)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def attention_bound(n_dst, n_src, n_edges, n_feat, elt, fused, hd=HD):
    """(bound_ms, bound_by) of one attention launch of width ``hd``: each
    input read once and each output written once at the HBM rate, against
    the float32 operations the kernel does per edge and channel (q.k, k+e,
    v+e, the online-softmax update, and in K1 the F-term edge projection)."""
    edge_bytes = (n_edges * n_feat * elt + n_feat * hd * elt + hd * elt if fused
                  else n_edges * hd * elt)
    nbytes = (
        2 * n_dst * hd * elt  # q in, out
        + 2 * n_src * hd * elt  # k, v
        + edge_bytes
        + 4 * (n_edges + n_dst + 1)  # src, dst_ptr (int32)
        + 4 * n_dst * HEADS  # lse
    )
    return bound(nbytes, n_edges * hd * (7 + (2 * n_feat if fused else 0)))


def bound(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    """(bound_ms, bound_by): the bytes at the HBM rate against the operations
    at ``flop_per_s`` (default: float32 outside the tensor cores)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def window_bounds(b, n, h, d, w, elt):
    """{kernel: (bound_ms, bound_by)} of K6, K7_dq and K7_dkv on ``[b, n, h,
    d]`` inputs of ``elt`` bytes: each input read once, each output written
    once, against the operations of the band's pairs at the peak rate of the
    type (bf16 tensor cores, or float32): K6 4d per pair (q.k, p.v), K7_dq 6d
    (q.k, g.v, ds.k), K7_dkv 8d (q.k, g.v, p.g, ds.q).  K6 reads q, k, v and
    writes out and lse; K7_dq reads q, k, v, g, lse, delta and writes dq;
    K7_dkv reads the same and writes dk and dv."""
    from anemoi_tpu_torch.ops.window_attention import band_pairs

    pairs = b * h * band_pairs(n, w)
    x, stats = b * n * h * d * elt, 4 * b * h * n
    rate = BF16_FLOP_PER_S if elt == 2 else FP32_FLOP_PER_S
    return {"K6": bound(4 * x + stats, 4 * d * pairs, rate),
            "K7_dq": bound(5 * x + 2 * stats, 6 * d * pairs, rate),
            "K7_dkv": bound(6 * x + 2 * stats, 8 * d * pairs, rate)}


def backward_bounds(n_dst, n_src, n_edges, n_feat, elt, fused, hd=HD):
    """{kernel: (bound_ms, bound_by)} of K3, K4 and K5 of width ``hd`` as the
    training path launches them: each input read once, each output written
    once.  K3 writes dq, the per-edge dkv [E, 2HD] and, for projected edges,
    their float32 gradient [E, HD], or, with the projection fused, dW and
    dbias (the flagship's raw attributes are constants: no d_attr); K4 reads
    dkv back and writes dk, dv; K5 reads K3's inputs plus the source-ordered
    view and writes dk, dv.  Operations per edge and channel: K3 12 (+ 4F for
    the projection and dW), K4 2, K5 12 (+ 2F)."""
    node_in = 2 * n_dst * hd * elt + 2 * n_src * hd * elt  # q, g; k, v
    stats = 2 * 4 * n_dst * HEADS  # lse, delta (float32)
    edge_in = (n_edges * n_feat * elt + n_feat * hd * elt + hd * elt) if fused \
        else n_edges * hd * elt
    dkv = n_edges * 2 * hd * elt
    k3 = (node_in + stats + edge_in + 4 * (n_edges + n_dst + 1) + n_dst * hd * elt + dkv
          + ((n_feat + 1) * hd * 4 if fused else n_edges * hd * 4))
    k4 = dkv + 4 * (n_edges + n_src + 1) + 2 * n_src * hd * elt
    k5 = node_in + stats + edge_in + 4 * (2 * n_edges + n_src + 1) + 2 * n_src * hd * elt
    per_edge = n_edges * hd
    return {
        "K3": bound(k3, per_edge * (12 + (4 * n_feat if fused else 0))),
        "K4": bound(k4, per_edge * 2),
        "K5": bound(k5, per_edge * (12 + (2 * n_feat if fused else 0))),
    }


def k3_build(dtype, d, n_feat, fused) -> dict:
    """Route, ptxas registers and spill bytes of the K3 instantiation that
    a launch of ``dtype`` at head size ``d`` with ``n_feat`` edge features
    takes."""
    from anemoi_tpu_torch.kernels.build import build_log, ptxas_usage
    from anemoi_tpu_torch.kernels.gt_attention import dst_instantiation

    vec, fmax = dst_instantiation(dtype, d, n_feat, fused)
    name = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
    key = f"gt_attention_bwd_dst_kernelI{name}Li{vec}ELb{int(fused)}ELi{fmax}EE"
    found = [u for entry, u in ptxas_usage(build_log("gt_attention_bwd")).items() if key in entry]
    return {"route": K3_ROUTE, "instantiation": key, **(found[0] if found else {})}


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
                first = kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, HEADS,
                                                  **edge_kw, **path_kw)
                dkv = first.dkv
                if dtype == torch.bfloat16 and fused and key == ("hidden", "hidden"):
                    # a destination's edges belong to one group and dW, dbias
                    # sum the partials in a fixed order: bitwise repeatable
                    again = kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, HEADS,
                                                      **edge_kw, **path_kw)
                    for name in ("dq", "dkv", "d_weight", "d_bias"):
                        if not torch.equal(getattr(first, name), getattr(again, name)):
                            raise RuntimeError(f"bf16 K3 is not deterministic: {name} differs")
                    print("[backward] bf16 K3 deterministic: dq, dkv, dW, dbias of two runs "
                          "bitwise equal", flush=True)
                    del again
                del first

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
                    "K3_b2b": cuda_ms_back_to_back(lambda: kern.gt_attention_bwd_dst(
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
                               ms_no_dkv=ms["K3_no_dkv"], ms_back_to_back=ms["K3_b2b"],
                               **k3_build(dtype, HD // HEADS, n_f, fused)),
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


def gt_wide_phase(graph, device):
    """K1 and K3 + K4 at HD = 1024 (16 heads of 64) against their plain
    versions, at the Transformer preset's mapper edge sets and edge
    attributes; each of K1, K3 and K4 timed beside its byte bound, its plain
    version and (K4) one index_add_.
    Returns ({kernel: rows}, {check: max abs error})."""
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.ops.gt_attention import (
        SourceOrder, gt_attention_bwd_kernels, gt_attention_bwd_plain, gt_attention_fe,
    )

    attrs = transformer_config()["model"]["encoder"]["sub_graph_edge_attributes"]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    errors, rows = {}, {"K1": [], "K3": [], "K4": []}
    for key in (("data", "hidden"), ("hidden", "data")):
        es = graph[key]
        n_src, n_dst = graph[key[0]].num_nodes, graph[key[1]].num_nodes
        ei = torch.as_tensor(es.edge_index, dtype=torch.int32, device=device).contiguous()
        ptr = torch.as_tensor(es.dst_ptr, dtype=torch.int32, device=device)
        order = SourceOrder.of(ei, n_src)
        src = ei[0].long()
        attr32 = torch.as_tensor(es.attribute_matrix(attrs), device=device)
        n_e, n_f = attr32.shape
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

            q, k, v, g = (rnd(1, n, WIDE_HD) for n in (n_dst, n_src, n_src, n_dst))
            edge_kw = dict(edge_attr=attr32.to(dtype), weight=rnd(WIDE_HD, n_f, scale=0.3).t(),
                           bias=rnd(WIDE_HD, scale=0.1))
            out, lse = gt_attention_fe(q, k, v, *edge_kw.values(), ei, ptr, HEADS, source=order)
            ref, _ = gt_attention_fe(q, k, v, *edge_kw.values(), ei, ptr, HEADS, plain=True)
            got = {"out": out}
            want = {"out": ref}
            grads = gt_attention_bwd_kernels(q, k, v, ei, ptr, order.src_ptr, order.src_perm,
                                             HEADS, out, lse, g, **edge_kw)
            refs = gt_attention_bwd_plain(q, k, v, ei, HEADS, out, lse, g, **edge_kw)
            for name in ("dq", "dk", "dv", "d_attr", "d_weight", "d_bias"):
                got[name], want[name] = getattr(grads, name), getattr(refs, name)
            torch.cuda.synchronize()
            errs = {}
            for name, x in got.items():
                y = want[name].float()
                err = (x.float() - y).abs().max().item()
                if not (err <= TOL[dtype] * y.abs().max().item() and torch.isfinite(x).all()):
                    raise RuntimeError(f"HD={WIDE_HD} {key} {dtype} {name}: max abs err "
                                       f"{err:.3e}, max|ref| {y.abs().max().item():.3e}")
                errs[name] = err
                errors[f"{'->'.join(key)} {str(dtype).split('.')[-1]} {name}"] = err
            del got, want, grads, refs, ref

            # the times, as the Transformer's training path launches K3
            # (fused projection: dW and dbias, no d_attr) and K4
            path_kw = dict(edge_grad=False, weight_grad=True)
            delta = (out.float() * g.float()).reshape(1, n_dst, HEADS, -1).sum(-1)
            dkv = kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, HEADS, **edge_kw,
                                            **path_kw).dkv
            ms = {
                "K1": cuda_ms(lambda: gt_attention_fe(q, k, v, *edge_kw.values(), ei, ptr, HEADS,
                                                      source=order)),
                "K3": cuda_ms(lambda: kern.gt_attention_bwd_dst(
                    q, k, v, g, lse, delta, ei, ptr, HEADS, **edge_kw, **path_kw)),
                "K3_b2b": cuda_ms_back_to_back(lambda: kern.gt_attention_bwd_dst(
                    q, k, v, g, lse, delta, ei, ptr, HEADS, **edge_kw, **path_kw)),
                "K4": cuda_ms(lambda: kern.gt_attention_bwd_src(dkv, order.src_ptr,
                                                                order.src_perm)),
            }
            plain = {
                "K1": cuda_ms(lambda: gt_attention_fe(q, k, v, *edge_kw.values(), ei, ptr, HEADS,
                                                      plain=True), reps=10, warmup=2),
                "K3": cuda_ms(lambda: gt_attention_bwd_plain(q, k, v, ei, HEADS, out, lse, g,
                                                             **edge_kw), reps=5, warmup=1),
                "K4": cuda_ms(lambda: torch.zeros(1, n_src, 2 * WIDE_HD, device=device)
                              .index_add_(1, src, dkv.float()), reps=10, warmup=2),
            }
            k4_library_ms = cuda_ms(lambda: torch.zeros(
                1, n_src, 2 * WIDE_HD, device=device, dtype=dtype).index_add_(1, src, dkv),
                reps=10, warmup=2)
            del dkv
            bounds = {"K1": attention_bound(n_dst, n_src, n_e, n_f, q.element_size(), True,
                                            WIDE_HD),
                      **backward_bounds(n_dst, n_src, n_e, n_f, q.element_size(), True, WIDE_HD)}
            base = {"edge_set": "->".join(key), "dtype": str(dtype).split(".")[-1],
                    "hd": WIDE_HD, "fused_edge": True, "n_dst": n_dst, "n_src": n_src,
                    "n_edges": n_e}
            per_kernel = {
                "K1": dict(max_abs_err=errs["out"], plain_is="gt_attention_fe(plain=True)",
                           library_ms=None),
                "K3": dict(max_abs_err=max(errs[n] for n in ("dq", "d_weight", "d_bias")),
                           plain_is="gt_attention_bwd_plain", library_ms=None,
                           ms_back_to_back=ms["K3_b2b"],
                           **k3_build(dtype, WIDE_HD // HEADS, n_f, True)),
                "K4": dict(max_abs_err=max(errs["dk"], errs["dv"]),
                           plain_is="float32 index_add_ of dkv", library_ms=k4_library_ms,
                           library_is="index_add_ of dkv"),
            }
            for name, extra in per_kernel.items():
                row = {**base, "ms": ms[name], "plain_ms": plain[name],
                       "bound_ms": bounds[name][0], "bound_by": bounds[name][1], **extra}
                rows[name].append(row)
                print(f"[wide GT] {name} {row}", flush=True)
    print(f"[wide GT] K1, K3 + K4 at HD={WIDE_HD} hold: {json.dumps(errors)}", flush=True)
    return rows, errors


def window_phase(device) -> dict:
    """K6 and K7 against the plain band at the Transformer preset's shape,
    float32 and bfloat16, timed; one ALiBi + softcap case, checked."""
    import torch.nn.functional as F

    from anemoi_tpu_torch.kernels import window_attention as wkern
    from anemoi_tpu_torch.kernels.build import build_log, ptxas_usage
    from anemoi_tpu_torch.models.layers.attention import get_alibi_slopes
    from anemoi_tpu_torch.ops.window_attention import (
        band_attention_bwd_plain, band_attention_plain,
    )

    usage = {lib: ptxas_usage(build_log(lib)) for lib, _ in WINDOW_BUILDS.values()}

    def window_build(name, dtype, d):
        """Route, ptxas registers and spill bytes of the instantiation of
        window kernel ``name`` that ``dtype`` takes at head size ``d``."""
        lib, stem = WINDOW_BUILDS[name]
        route, part = WINDOW_ROUTES[(name, dtype)]
        key = f"{stem}{part}{d}E"
        found = [u for entry, u in usage[lib].items() if key in entry]
        return {"route": route, **(found[0] if found else {})}

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    rows = {"K6": [], "K7_dq": [], "K7_dkv": []}
    cases = {"main": (WIN_B, WIN_N, WIN_H, WIN_D, WIN_W, None, False),
             "alibi_softcap": (1, 2000, 4, WIN_D, 100, 5.0, True)}
    for case, (b, n, h, d, w, softcap, alibi) in cases.items():
        slopes = get_alibi_slopes(h).to(device) if alibi else None
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.randn(b, n, h, d, generator=gen, device=device).to(dtype)
                          for _ in range(4))
            before = wkern.launch_counts()
            out, lse = wkern.window_attention_fwd(q, k, v, w, softcap, slopes)
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            dq = wkern.window_attention_bwd_dq(q, k, v, g, lse, delta, w, softcap, slopes)
            dk, dv = wkern.window_attention_bwd_dkv(q, k, v, g, lse, delta, w, softcap, slopes)
            torch.cuda.synchronize()
            if wkern.launch_counts() != {key: c + 1 for key, c in before.items()}:
                raise RuntimeError(f"window launch counters did not move: {wkern.launch_counts()}")
            ref, ref_lse = band_attention_plain(q, k, v, w, softcap, slopes)
            ref_grads = band_attention_bwd_plain(q, k, v, g, w, softcap, slopes)
            errs, rel = {}, {}
            for name, x, y in (("out", out, ref), ("dq", dq, ref_grads[0]),
                               ("dk", dk, ref_grads[1]), ("dv", dv, ref_grads[2])):
                err = (x.float() - y.float()).abs().max().item()
                scale_ref = y.float().abs().max().item()
                if not (err <= TOL[dtype] * scale_ref and torch.isfinite(x).all()):
                    raise RuntimeError(f"window {case} {dtype} {name}: max abs err {err:.3e}, "
                                       f"max|ref| {scale_ref:.3e} (tol {TOL[dtype]} of max|ref|)")
                errs[name], rel[name] = err, err / scale_ref
            lse_err = (lse - ref_lse).abs().max().item()
            if not lse_err <= 1e-3 * ref_lse.abs().max().item():
                raise RuntimeError(f"window {case} {dtype} lse: max abs err {lse_err:.3e}")
            del ref, ref_lse, ref_grads
            base = {"case": case, "dtype": str(dtype).split(".")[-1], "shape": [b, n, h, d],
                    "window": w, "softcap": softcap, "alibi": alibi}
            print(f"[window] {base} max abs errors {errs}, over max|ref| {rel}, "
                  f"lse {lse_err:.3e}", flush=True)
            if case != "main":
                continue
            if dtype == torch.bfloat16:  # each block alone writes its rows: bitwise repeatable
                again = (*wkern.window_attention_fwd(q, k, v, w),
                         wkern.window_attention_bwd_dq(q, k, v, g, lse, delta, w),
                         *wkern.window_attention_bwd_dkv(q, k, v, g, lse, delta, w))
                first = (out, lse, dq, dk, dv)
                if not all(torch.equal(x, y) for x, y in zip(first, again)):
                    raise RuntimeError("bf16 K6 or K7 is not deterministic: two runs differ")
                print("[window] bf16 K6 and K7 deterministic: two runs bitwise equal", flush=True)
                del again, first
            calls = {
                "K6": lambda: wkern.window_attention_fwd(q, k, v, w),
                "K7_dq": lambda: wkern.window_attention_bwd_dq(q, k, v, g, lse, delta, w),
                "K7_dkv": lambda: wkern.window_attention_bwd_dkv(q, k, v, g, lse, delta, w),
            }
            ms = {name: cuda_ms(fn) for name, fn in calls.items()}
            ms_run = {name: cuda_ms_back_to_back(fn) for name, fn in calls.items()}
            plain_fwd_ms = cuda_ms(lambda: band_attention_plain(q, k, v, w), reps=10, warmup=2)
            plain_bwd_ms = cuda_ms(lambda: band_attention_bwd_plain(q, k, v, g, w), reps=5,
                                   warmup=1)
            # the library yardstick: SDPA with the [N, N] boolean band mask,
            # forward, and the backward of that call (dq, dk, dv together)
            pos = torch.arange(n, device=device)
            mask = (pos[:, None] - pos[None, :]).abs() <= w
            leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
            lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask),
                                 reps=10, warmup=2)
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            g_t = g.transpose(1, 2)
            lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, g_t,
                                                              retain_graph=True),
                                 reps=10, warmup=2)
            del lib_out, leaves, mask
            bounds = window_bounds(b, n, h, d, w, q.element_size())
            plain = {"K6": plain_fwd_ms, "K7_dq": plain_bwd_ms, "K7_dkv": plain_bwd_ms}
            library = {"K6": lib_fwd_ms, "K7_dq": lib_bwd_ms, "K7_dkv": lib_bwd_ms}
            errors = {"K6": errs["out"], "K7_dq": errs["dq"],
                      "K7_dkv": max(errs["dk"], errs["dv"])}
            # K7_dq and K7_dkv each compute part of the backward, and both
            # yardsticks compute all of it: compare them with the pair's time
            pair = {"K7_pair_ms": ms["K7_dq"] + ms["K7_dkv"]}
            for name in rows:
                row = {**base, **(pair if name != "K6" else {}), **window_build(name, dtype, d),
                       "max_abs_err": errors[name], "lse_max_abs_err": lse_err,
                       "ms": ms[name], "ms_back_to_back": ms_run[name], "plain_ms": plain[name],
                       "plain_is": ("band_attention_plain" if name == "K6"
                                    else "band_attention_bwd_plain (dq, dk, dv)"),
                       "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                       "library_ms": library[name],
                       "library_is": ("scaled_dot_product_attention, [N, N] band mask"
                                      + ("" if name == "K6" else ": its backward"))}
                rows[name].append(row)
                print(f"[window] {name} {row}", flush=True)
            del q, k, v, g, out, lse, delta, dq, dk, dv
            torch.cuda.empty_cache()
    return rows


def serving_phase(graph, device, config=None, per_step=None, label="serving") -> dict:
    """A model's main serving path at full width: its interface and a 2-step
    bf16 forecast through ``make_forecast_fn``; ``per_step``: the launches of
    each kernel per forecast step (others must stay 0).  Default: the
    flagship GraphTransformer, 18 K1 launches a step."""
    from anemoi_tpu_torch import kernels
    from anemoi_tpu_torch.inference import make_forecast_fn
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface

    config = config or flagship_config()
    per_step = per_step or {"K1": LAUNCHES_PER_STEP}
    torch.manual_seed(SEED)  # the modules' random initial weights
    iface = AnemoiModelInterface(
        config=config, graph=graph, data_indices=flagship_indices(),
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
    kernels.reset_launches()
    out = forecast(batch)["data"]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated(device)
    print(f"[{label}] launches on the main path {launches}", flush=True)

    expect = (1, STEPS, 1, n_grid, idx.num_model_output_vars)
    if tuple(out.shape) != expect or not torch.isfinite(out).all():
        raise RuntimeError(f"forecast shape {tuple(out.shape)} (want {expect}) or not finite")
    want = {**NO_LAUNCHES, **{name: n * STEPS for name, n in per_step.items()}}
    if launches != want:
        raise RuntimeError(f"{label}: expected launches {want}, got {launches}")

    iface.use_plain_attention(True)
    ref = forecast(batch)["data"]
    iface.use_plain_attention(False)
    rel_l2 = ((out - ref).norm() / ref.norm()).item()
    print(f"[{label}] forecast vs plain attention: relative L2 {rel_l2:.3e} "
          f"(tol {SERVING_TOL})", flush=True)
    if not rel_l2 <= SERVING_TOL:
        raise RuntimeError(f"{label}: forecast disagrees with the plain attention: {rel_l2:.3e}")
    del ref

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
        "n_params": sum(p.numel() for p in iface.parameters()),
    }
    print(f"[{label}] {json.dumps(result)}", flush=True)
    del iface, forecast
    torch.cuda.empty_cache()
    return result


def training_batch(graph, device):
    """A data-space batch of m + 1 = 3 steps (rollout 1) from the seeded
    statistics."""
    idx = flagship_indices()["data"]
    stats = flagship_statistics(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    noise = torch.randn(1, 3, 1, graph["data"].num_nodes, idx.num_data_vars, generator=gen,
                        device=device)
    mean, std = (torch.as_tensor(stats["data"][k], device=device) for k in ("mean", "stdev"))
    return {"data": mean + std * noise}


def build_training(graph, device, config):
    """(interface, TrainState, train_step) of the bench's training setup:
    bf16 over float32 masters, area-weighted MSE, AdamW, value clipping at
    32, rollout 1."""
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface
    from anemoi_tpu_torch.training.losses import get_loss_function
    from anemoi_tpu_torch.training.losses.scalers import create_scalers
    from anemoi_tpu_torch.training.optimizers import build_optimizer
    from anemoi_tpu_torch.training.step import TrainState, make_step_fns

    scalers = create_scalers({"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                                       "attribute_name": "area_weight"}}, graph=graph)
    torch.manual_seed(SEED)  # the modules' random initial weights
    iface = AnemoiModelInterface(config=config, graph=graph, data_indices=flagship_indices(),
                                 statistics=flagship_statistics(SEED), device=device,
                                 training=True)
    losses = {"data": get_loss_function({"name": "WeightedMSELoss", "scalers": ["area"]},
                                        scalers)}
    tx = build_optimizer({"lr": {"rate": 1e-4, "warmup": 10, "iterations": 1000},
                          "gradient_clip": {"val": 32.0, "algorithm": "value"}})
    train_step, _ = make_step_fns(iface, losses, rollout=1, precision="bf16")
    return iface, TrainState.create(iface, tx), train_step


def one_step(state, train_step, batch):
    """One training step with the launch counts set to 0 just before it."""
    from anemoi_tpu_torch import kernels

    kernels.reset_launches()
    state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise RuntimeError(f"training step not finite: loss {loss}, grad_norm {gnorm}")
    return launches, loss, gnorm


def timed_steps(device, state, train_step, batch):
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


def grad_gap(iface, state, train_step, batch, label):
    """Relative L2 of one step's gradient on the kernels against the same
    step on the plain attention."""
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


def check_grads(iface, projections, label):
    """Every parameter of the named attention projections has a non-zero
    gradient (``lin_key.bias``'s is zero by softmax shift invariance)."""
    missing = [n for n, p in iface.named_parameters()
               if any(f"{lin}." in n for lin in projections)
               and (p.grad is None or (not n.endswith("lin_key.bias") and not p.grad.any()))]
    if missing:
        raise RuntimeError(f"{label}: attention projections without a gradient on the "
                           f"kernels: {missing}")


def training_phase(graph, device) -> dict:
    """The flagship training step at full width through ``make_step_fns``."""
    batch = training_batch(graph, device)
    iface, state, train_step = build_training(graph, device, flagship_config())
    n_params = sum(p.numel() for p in iface.parameters())
    launches, loss, gnorm = one_step(state, train_step, batch)
    print(f"[training] first step: loss {loss:.6f} grad_norm {gnorm:.6f} launches {launches}",
          flush=True)
    want = {**NO_LAUNCHES, "K1": LAUNCHES_PER_STEP, "K3": LAUNCHES_PER_STEP,
            "K4": LAUNCHES_PER_STEP}
    if launches != want:
        raise RuntimeError(f"training step: expected launches {want}, got {launches}")

    train_step.compute_gradients(state, batch)
    check_grads(iface, ("lin_query", "lin_key", "lin_value", "lin_edge"), "flagship")
    grad_rel_l2 = grad_gap(iface, state, train_step, batch, "K3 + K4")
    ms, times, peak = timed_steps(device, state, train_step, batch)
    result = {"ms_per_step": ms, "ms_per_step_runs": times, "peak_memory_bytes": peak,
              "n_params": n_params, "first_loss": loss, "first_grad_norm": gnorm,
              "grad_rel_l2_vs_plain": grad_rel_l2, "launches": launches}
    print(f"[training] {json.dumps(result)}", flush=True)
    del iface, state, train_step
    torch.cuda.empty_cache()

    # the fused backward (K3 without dkv + K5) through the config key
    cfg = flagship_config()
    cfg["model"]["paged_fused_bwd"] = True
    iface, state, train_step = build_training(graph, device, cfg)
    fused_launches, fused_loss, _ = one_step(state, train_step, batch)
    want = {**NO_LAUNCHES, "K1": LAUNCHES_PER_STEP, "K3": LAUNCHES_PER_STEP,
            "K5": LAUNCHES_PER_STEP}
    if fused_launches != want:
        raise RuntimeError(f"paged_fused_bwd step: expected launches {want}, "
                           f"got {fused_launches}")
    fused_gap = grad_gap(iface, state, train_step, batch, "K3 + K5")
    fused_ms, fused_times, fused_peak = timed_steps(device, state, train_step, batch)
    result["fused_bwd"] = {"ms_per_step": fused_ms, "ms_per_step_runs": fused_times,
                           "peak_memory_bytes": fused_peak, "first_loss": fused_loss,
                           "grad_rel_l2_vs_plain": fused_gap, "launches": fused_launches}
    print(f"[training] paged_fused_bwd {json.dumps(result['fused_bwd'])}", flush=True)
    del iface, state, train_step
    torch.cuda.empty_cache()
    return result


def transformer_training_phase(graph, device) -> dict:
    """The ``transformer`` preset's training step at full width and depth:
    launches, gradients on every projection, ms per step and peak memory;
    then its gradient against the plain attention's."""
    batch = training_batch(graph, device)
    iface, state, train_step = build_training(graph, device, transformer_config())
    n_params = sum(p.numel() for p in iface.parameters())
    launches, loss, gnorm = one_step(state, train_step, batch)
    print(f"[transformer training] first step: loss {loss:.6f} grad_norm {gnorm:.6f} "
          f"launches {launches}", flush=True)
    layers = TRANSFORMER_LAYERS
    want = {**NO_LAUNCHES, "K1": 2, "K3": 2, "K4": 2, "K6": layers, "K7_dq": layers,
            "K7_dkv": layers}
    if launches != want:
        raise RuntimeError(f"transformer training step: expected launches {want}, "
                           f"got {launches}")
    train_step.compute_gradients(state, batch)
    check_grads(iface, ("lin_q", "lin_k", "lin_v", "projection"), "transformer")
    ms, times, peak = timed_steps(device, state, train_step, batch)
    result = {"ms_per_step": ms, "ms_per_step_runs": times, "peak_memory_bytes": peak,
              "n_params": n_params, "first_loss": loss, "first_grad_norm": gnorm,
              "launches": launches}
    print(f"[transformer training] {json.dumps(result)}", flush=True)

    result["grad_rel_l2_vs_plain"] = grad_gap(iface, state, train_step, batch,
                                              f"transformer ({layers} layers)")
    del iface, state, train_step
    torch.cuda.empty_cache()
    return result


def report(kernel_rows: dict, serving: dict, training: dict, t_serving: dict,
           t_training: dict) -> dict:
    """One entry per kernel.  Headline numbers, bf16: for K1-K5 the
    processor edge set (16 of the 18 launches per flagship step), with the
    flagship's fused edge projection for the backward kernels; for K6 and
    K7 the Transformer preset's processor shape.  ``launches`` is each
    kernel's count on the path it serves (``path_of``): the flagship's
    2-step forecast for K1 and K2, its training step for K3 and K4, its
    ``paged_fused_bwd`` training step for K5, the Transformer's 2-step
    forecast for K6 and its training step for K7; ``launches_by_path`` has
    all five."""
    by_path = {"serving_2_steps": serving["launches"], "training_step": training["launches"],
               "training_step_fused_bwd": training["fused_bwd"]["launches"],
               "transformer_serving_2_steps": t_serving["launches"],
               "transformer_training_step": t_training["launches"]}
    path_of = {"K1": "serving_2_steps", "K2": "serving_2_steps", "K3": "training_step",
               "K4": "training_step", "K5": "training_step_fused_bwd",
               "K6": "transformer_serving_2_steps", "K7_dq": "transformer_training_step",
               "K7_dkv": "transformer_training_step"}

    def headline(r):
        return (r["dtype"] == "bfloat16" and r.get("edge_set", "hidden->hidden") == "hidden->hidden"
                and r.get("fused_edge", True) and r.get("case", "main") == "main"
                and r.get("hd", HD) == HD)

    entries = []
    for name, rows in kernel_rows.items():
        head = next(r for r in rows if headline(r))
        source, replaces, role = KERNELS[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "public_op": role,
            "launches": by_path[path_of[name]][name],
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": head["max_abs_err"], "max_err": head["max_abs_err"],
            "ms": head["ms"],
            **({"ms_back_to_back": head["ms_back_to_back"]} if "ms_back_to_back" in head else {}),
            # K3, K5: the plain version is the whole plain backward
            # (gt_attention_bwd_plain); K4: a float32 index_add_ of dkv; K6:
            # the plain band; K7: the plain band's autograd backward, to be
            # compared with K7_pair_ms (K7_dq + K7_dkv), as is library_ms
            "plain_ms": head["plain_ms"],
            **({"K7_pair_ms": head["K7_pair_ms"]} if "K7_pair_ms" in head else {}),
            "bound_ms": head["bound_ms"], "bound_us": head["bound_ms"] * 1e3,
            "bound_by": head["bound_by"],
            # K4: one index_add_ of dkv by source; K6: SDPA with the band
            # mask, K7 its whole backward.  No single PyTorch call computes sparse
            # graph attention with a per-edge bias on k and v (K1, K2), nor
            # K3's or K5's part of its backward (SDPA is dense; its masks
            # cannot add e_ij to v)
            "library_ms": head["library_ms"],
            "edge_set": head.get("edge_set"), "shape": head.get("shape"),
            "dtype": head["dtype"],
            "rows": rows,
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
    wide_rows, wide = gt_wide_phase(graph, device)
    for name, extra in wide_rows.items():
        rows[name] += extra
    rows.update(window_phase(device))
    serving = serving_phase(graph, device)
    training = training_phase(graph, device)
    layers = TRANSFORMER_LAYERS
    t_serving = serving_phase(graph, device, transformer_config(num_layers=layers),
                              {"K1": 2, "K6": layers}, "transformer serving")
    t_training = transformer_training_phase(graph, device)
    rep = report(rows, serving, training, t_serving, t_training)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "build_seconds": seconds, "serving": serving,
                       "training": training, "transformer_serving": t_serving,
                       "transformer_training": t_training, "wide_gt_errors": wide, **rep},
                      f, indent=1)
    print(json.dumps(rep))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
