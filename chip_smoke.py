"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--json PATH]

Phases (any failure exits non-zero, with no result line):
  1. card      -- require CUDA; print the card's name and power limit;
  2. build     -- build every kernel from the sources in this checkout, one
                  nvcc per source, all started together;
  3. kernels   -- hold K1 and K2 against their plain PyTorch versions at the
                  three full-size edge sets of the o96 -> ico-5 graph, in
                  float32 and bfloat16, and time both with CUDA events
                  (single calls, and calls back to back), each row with
                  its route and its instantiation's ptxas registers and
                  spills; then K1 and K3 + K4 at B = 4 (the ensemble's four
                  members as batch rows) at the processor edge set, bf16,
                  against their plain versions, timed as in phases 3-4;
  4. backward  -- at the same edge sets and types, for both edge inputs (K1's
                  raw attributes and K2's projected edges): K3 + K4 and K3
                  (no dkv) + K5 against the plain backward, per output, and
                  K4 against a float32 index_add_ of K3's dkv; each kernel
                  timed beside its byte bound and its plain version (K3, K5:
                  the whole plain backward), K4 also beside one index_add_;
                  K3, K4 and K5 also back to back, K3 and K5 with their
                  route and their instantiation's ptxas registers and
                  spills; bf16 K3 and K5 run twice at the processor edge set
                  with the fused projection must agree bit for bit (K3: dq,
                  dkv, dW, dbias; K5: dk, dv);
  5. wide GT   -- K1, K3 + K4 and K3 + K5 against their plain versions at HD
                  = 1024 (16 heads of 64, the Transformer preset's mappers:
                  K4 in blocks of 1024 threads) on the data->hidden and
                  hidden->data edge sets, and on the ``multi_scale`` graph's
                  hidden->hidden set (ico-5 ``MultiScaleEdges`` sorted by
                  incoming degree: the processor of ``temporal_downscaler``,
                  the ``graphtransformer`` model at 1024 channels), float32
                  and bfloat16; K1, K3, K4
                  and K5 each timed beside its byte bound, its plain version
                  and (K4) one index_add_, K1 as in phase 3, K3, K4 and K5
                  as in phase 4;
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
                  value clipping at 32, rollout 1; the processor's default
                  per-layer remat, ``save_attention``, as in phases 9 and
                  12): finite loss and grad norm,
                  exactly 18 K1, K3 and K4 launches per step (18 K5 and no K4
                  under ``paged_fused_bwd``) and no other kernel, non-zero
                  gradients on every attention projection, gradients of both
                  backwards close to the same step on the plain attention; ms
                  per step and peak memory;
  9. trainer   -- the packaged example (``example_o96_gt_config``: the
                  ``multi_scale`` graph with spherical area weights, 512
                  channels, 16 layers, bf16) through the port's CLI,
                  ``cli.main(["train", cfg.json])``, reading a zlib zarr
                  store of the synthetic o96 dataset (12 variables, 64
                  times) written first: 8 steps with the prefetch thread,
                  a validation pass with the ``RolloutEvalCallback``
                  (rollout 4), a checkpoint and an inference bundle; exit
                  code 0, 8 finite loss and grad_norm records, a validation
                  record with ``val_loss`` and ``rmse/...``, exactly 18 K1,
                  K3 and K4 launches and no other kernel in every training
                  step; then the trained model's gradient on a batch of the
                  store against the same step on the plain attention
                  (relative L2 within phase 8's tolerance: K1, K3 and K4 at
                  the packaged graph's edge sets); the packaged graph's edge
                  counts, the LZ4 blocks each decoder decoded in the run
                  (none for a zlib store), the trainer's wall ms a step over
                  steps 3-8 (median and spread) beside phase 8's and its
                  host wait for batches;
 10. predict   -- ``cli.main(["predict", bundle, "--steps", "2", ...])`` on
                  that bundle: exactly 18 K1 launches a step and no other
                  kernel, a finite forecast [1, 2, 1, 40320, 11], equal bit
                  for bit to ``make_forecast_fn`` on an interface loaded
                  in-process from the same bundle on the same window, and
                  within relative L2 2e-2 of that interface on the plain
                  attention; ms a step of the in-process forecast;
 11. transformer serving -- a 2-step bf16 forecast of the ``transformer``
                  preset (GT mappers, 16 dense sliding-window layers, 1024
                  channels, window 512) on the same graph: finite, right
                  shape, exactly 16 K6 and 2 K1 launches per step and no other
                  kernel, relative L2 <= 2e-2 against the plain attention; ms
                  per step and peak memory;
 12. transformer training -- its ``make_step_fns`` step as in phase 8:
                  exactly 16 K6, 16 K7_dq, 16 K7_dkv, 2 K1, 2 K3, 2 K4 and no
                  K5 per step, non-zero gradients on every lin_q, lin_k, lin_v
                  and projection, the flattened gradient within relative L2
                  1e-2 of the plain attention's at all 16 layers; ms per step
                  and peak memory;
 13. remat     -- the flagship through ``make_step_fns`` on one interface
                  (the same weights) in each remat variant: per-layer remat
                  off, ``save_attention`` and ``full`` at rollout 1; no
                  remat, ``remat_rollout`` off, and on with no policy
                  (``full``) and with ``save_attention`` at rollout 2; no
                  remat and ``remat_rollout`` (``full``) at rollout 3.  Each:
                  exactly the K1, K3 and K4 launches a step that the remat
                  structure gives (``remat_launches``: the counts
                  tests/test_torch_remat.py asserts on the CPU), the
                  gradient within relative L2 1e-5 of no remat at the same
                  rollout, wall ms a step (median of 3 after 1 of warmup),
                  device ms and launches a step (``torch.profiler``, the
                  card's activity over 1 step) and peak memory;
 14. presets   -- the packaged YAML presets without PyYAML: ``cli config
                  list`` lists the files of ``anemoi_tpu/config`` (49, 16
                  presets); ``example_o96_gt.yaml`` composed with the
                  flagship's width equals ``example_o96_gt_config()``;
                  ``cli train`` on that YAML over phase 9's store at
                  rollout 2 with the packaged remat defaults (3 steps:
                  finite records, exactly 72 K1, 36 K3 and 36 K4 a step);
                  ``cli evaluate --rollout 2`` on it;
 15. ensemble  -- the ensemble CRPS preset (AIFS-ENS) at its own width:
                  ``ensemble_crps.yaml`` (``AnemoiEnsModelEncProcDec``,
                  ``NoiseConditioning``, conditional processor norms,
                  ``KernelCRPS``, 512 channels, 16 layers, 16 heads, the
                  ``multi_scale`` graph, 4 members) through ``cli train``
                  over phase 9's store, bf16, 3 steps: finite records,
                  exactly 18 K1, K3 and K4 and no other kernel in every step;
                  the trained step's gradient against the plain attention
                  (same weights and noise seed, relative L2 <= 1e-2); wall,
                  device ms and peak memory of the step; ``predict_step`` on
                  a window tiled to the 4 members: [1, 1, 4, 40320, 11],
                  finite, exactly 18 K1, relative L2 <= 2e-2 against the
                  plain attention (the same noise), members that differ
                  once the conditional scales are nonzero; its wall, device
                  ms and peak memory;
 16. point_wise -- ``point_wise.yaml`` at its width (GT mappers of 16
                  heads, 4 point-wise layers, 512 channels) on the
                  ``encoder_decoder_only`` graph (no processor edges) through
                  ``cli train`` over phase 9's store, bf16, 3 steps: finite
                  records, exactly 2 K1, 2 K3 and 2 K4 or K5 (the
                  ``fused_backward`` rule at the mapper edge counts) in every
                  step and no other kernel; the trained step's gradient
                  against the plain attention (relative L2 <= 1e-2); ``cli
                  predict`` on its bundle, 2 steps: exactly 2 K1 a step, a
                  finite forecast within relative L2 2e-2 of the plain
                  attention's; wall and device ms and peak memory of the
                  step and of the forecast;
 17. autoencoder -- ``autoencoder.yaml`` (``AnemoiModelAutoEncoder``, 2
                  point-wise layers, one input step, the ``autoencoder``
                  task) as phase 16;
 18. downscaler -- ``temporal_downscaler.yaml`` at its width (1024
                  channels, 16 layers, 16 heads, the ``multi_scale`` graph,
                  2 output steps) through ``cli train``, 3 steps: exactly 18
                  K1, 18 K3 and the K4/K5 of the ``fused_backward`` rule a
                  step; the gradient gate; a validation record with
                  ``PerTimestepMetrics``' ``t_1`` and ``t_2`` keys; then
                  ``temporal_downscaler_ensemble.yaml`` (512 channels, 4
                  members: B·M = 4 rows), 2 steps, the same counts and gate;
 19. gnn       -- the GNN model (``model: gnn`` on ``graph: multi_scale``
                  from a config file's ``defaults:`` list) at ``gnn.yaml``'s
                  width (512 channels, 16 layers): ``cli train`` 3 steps and
                  ``cli predict`` 2 steps, finite, none of the seven kernels
                  launched; then at 2 layers of 64 channels on the same
                  graph, its float32 forward and gradient on the card
                  against the CPU's (same weights and batch, relative L2
                  <= 1e-4);
 20. report    -- one JSON line {"kernels": [...]} (K1-K7, K7 as K7_dq and
                  K7_dkv; each kernel's ``launches`` counted on its path:
                  ``path_of`` in ``report``; ``launches_by_path`` also each
                  remat variant's, the YAML preset's, the ensemble's
                  training step and ``predict_step``, and phases 16-19's
                  training steps and forecasts), the card line, and
                  last {"ok": true, "device": {...}}; with --json, the same
                  and the serving and training details also go to PATH.

Launch counts come from ``anemoi_tpu_torch.kernels.launch_counts()`` (all
seven kernels), set to 0 just before each path runs (in the trainer phase,
before each of its training steps); each path's ``want`` dict lists every
kernel, the ones it must not launch at 0.  Every phase prints its seconds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
# K1, K2, K3 (destination groups) and K5 (source groups): kernel ->
# (library, kernel-name stem, route), one route for both types; the
# instantiation a launch takes is named by its type, channels a lane (V),
# fused projection and room for edge features
DST_ROUTE = "CUDA cores, 16-byte vectors a lane, several destinations a block"
FWD_ROUTE = DST_ROUTE + ", edge rows through a cp.async ring, grid-stride over destinations"
SRC_ROUTE = ("CUDA cores, 16-byte vectors a lane, several sources a block, gathered rows "
             "through a cp.async ring, grid-stride over sources")
DST_BUILDS = {"K1": ("gt_attention_fwd", "gt_attention_fwd_kernel", FWD_ROUTE),
              "K2": ("gt_attention_fwd", "gt_attention_fwd_kernel", FWD_ROUTE),
              "K3": ("gt_attention_bwd", "gt_attention_bwd_dst_kernel", DST_ROUTE),
              "K5": ("gt_attention_bwd", "gt_attention_bwd_src_fused_kernel", SRC_ROUTE)}
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
MEMBERS = 4  # the ensemble_crps preset's ensemble_size


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


def attention_bound(n_dst, n_src, n_edges, n_feat, elt, fused, hd=HD, batch=1):
    """(bound_ms, bound_by) of one attention launch of width ``hd`` over
    ``batch`` rows: each input read once and each output written once at
    the HBM rate (the edges and their projection are shared by the rows),
    against the float32 operations the kernel does per edge, channel and row
    (q.k, k+e, v+e, the online-softmax update, and in K1 the F-term edge
    projection)."""
    edge_bytes = (n_edges * n_feat * elt + n_feat * hd * elt + hd * elt if fused
                  else n_edges * hd * elt)
    nbytes = (
        batch * 2 * n_dst * hd * elt  # q in, out
        + batch * 2 * n_src * hd * elt  # k, v
        + edge_bytes
        + 4 * (n_edges + n_dst + 1)  # src, dst_ptr (int32)
        + batch * 4 * n_dst * HEADS  # lse
    )
    return bound(nbytes, batch * n_edges * hd * (7 + (2 * n_feat if fused else 0)))


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


def backward_bounds(n_dst, n_src, n_edges, n_feat, elt, fused, hd=HD, batch=1):
    """{kernel: (bound_ms, bound_by)} of K3, K4 and K5 of width ``hd`` over
    ``batch`` rows as the training path launches them: each input read once,
    each output written once.  K3 writes dq, the per-edge dkv [B, E, 2HD]
    and, for projected edges, their float32 gradient [E, HD] (summed over
    the rows), or, with the projection fused, dW and dbias (the flagship's
    raw attributes are constants: no d_attr); K4 reads dkv back and writes
    dk, dv; K5 reads K3's inputs plus the source-ordered view and writes dk,
    dv.  Operations per edge, channel and row: K3 12 (+ 4F for the
    projection and dW), K4 2, K5 12 (+ 2F)."""
    node_in = batch * (2 * n_dst * hd * elt + 2 * n_src * hd * elt)  # q, g; k, v
    stats = batch * 2 * 4 * n_dst * HEADS  # lse, delta (float32)
    edge_in = (n_edges * n_feat * elt + n_feat * hd * elt + hd * elt) if fused \
        else n_edges * hd * elt
    dkv = batch * n_edges * 2 * hd * elt
    k3 = (node_in + stats + edge_in + 4 * (n_edges + n_dst + 1) + batch * n_dst * hd * elt
          + dkv + ((n_feat + 1) * hd * 4 if fused else n_edges * hd * 4))
    k4 = dkv + 4 * (n_edges + n_src + 1) + batch * 2 * n_src * hd * elt
    k5 = (node_in + stats + edge_in + 4 * (2 * n_edges + n_src + 1)
          + batch * 2 * n_src * hd * elt)
    per_edge = batch * n_edges * hd
    return {
        "K3": bound(k3, per_edge * (12 + (4 * n_feat if fused else 0))),
        "K4": bound(k4, per_edge * 2),
        "K5": bound(k5, per_edge * (12 + (2 * n_feat if fused else 0))),
    }


def dst_build(kernel, dtype, d, n_feat, fused) -> dict:
    """Route, ptxas registers and spill bytes of the instantiation of
    ``kernel`` (K1, K2, K3 or K5) that a launch of ``dtype`` at head size
    ``d`` with ``n_feat`` edge features takes."""
    from anemoi_tpu_torch.kernels.build import build_log, ptxas_usage
    from anemoi_tpu_torch.kernels.gt_attention import dst_instantiation

    lib, stem, route = DST_BUILDS[kernel]
    vec, fmax = dst_instantiation(dtype, d, n_feat, fused)
    name = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
    key = f"{stem}I{name}Li{vec}ELb{int(fused)}ELi{fmax}EE"
    found = [u for entry, u in ptxas_usage(build_log(lib)).items() if key in entry]
    if not found:  # another build of the kernel (an older checkout's)
        route = "unknown: no such instantiation in the build log"
    return {"route": route, "instantiation": key, **(found[0] if found else {})}


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
                                                 source=order), True,
                       lambda: kern.gt_attention_fused_edge(q, k, v, attr, w, b, ei, ptr, HEADS)),
                "K2": (lambda p: gt_attention(q, k, v, e, ei, ptr, HEADS, plain=p,
                                              source=order), False,
                       lambda: kern.gt_attention_edge(q, k, v, e, ei, ptr, HEADS)),
            }
            for name, (fn, fused, raw) in cases.items():
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
                ms_b2b = cuda_ms_back_to_back(raw)
                plain_ms = cuda_ms(lambda: fn(True), reps=20)
                bound_ms, bound_by = attention_bound(
                    n_dst, n_src, n_e, n_f, q.element_size(), fused
                )
                row = {
                    "edge_set": "->".join(key), "dtype": str(dtype).split(".")[-1],
                    "n_dst": n_dst, "n_src": n_src, "n_edges": n_e,
                    "max_abs_err": err, "rel_err": rel, "lse_max_abs_err": lse_err,
                    "ms": ms, "ms_back_to_back": ms_b2b,
                    "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None, **dst_build(name, dtype, HD // HEADS, n_f, fused),
                }
                results[name].append(row)
                print(f"[kernels] {name} {row}", flush=True)
    for name, rows in member_batch_rows(graph, device).items():
        results.setdefault(name, []).extend(rows)
    return results


def member_batch_rows(graph, device) -> dict:
    """K1 and K3 + K4 at B = 4 (the ensemble's four members folded into the
    batch rows, as the ensemble phase runs them) at the processor edge set,
    bf16 with the fused edge projection, against their plain versions (K4:
    the float32 index_add_ of K3's dkv), each timed single and back to back
    beside its bound, its plain version and (K4) one index_add_."""
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.ops.gt_attention import (
        SourceOrder, gt_attention_bwd_kernels, gt_attention_bwd_plain, gt_attention_fe,
    )

    b, dtype, key = MEMBERS, torch.bfloat16, ("hidden", "hidden")
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    es = graph[key]
    n = graph["hidden"].num_nodes
    ei = torch.as_tensor(es.edge_index, dtype=torch.int32, device=device).contiguous()
    ptr = torch.as_tensor(es.dst_ptr, dtype=torch.int32, device=device)
    order = SourceOrder.of(ei, n)
    src = ei[0].long()
    attr = torch.as_tensor(es.attribute_matrix(EDGE_ATTRIBUTES), device=device).to(dtype)
    n_e, n_f = attr.shape

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    q, k, v, g = rnd(b, n, HD), rnd(b, n, HD), rnd(b, n, HD), rnd(b, n, HD)
    edge_kw = dict(edge_attr=attr, weight=rnd(HD, n_f, scale=0.3).t(), bias=rnd(HD, scale=0.1))
    tol = TOL[dtype]
    base = {"edge_set": "->".join(key), "dtype": "bfloat16", "batch": b, "fused_edge": True,
            "n_dst": n, "n_src": n, "n_edges": n_e}

    def k1(plain=False):
        return gt_attention_fe(q, k, v, *edge_kw.values(), ei, ptr, HEADS, plain=plain,
                               source=order)

    before = kern.gt_attention_fused_edge.launches
    out, lse = k1()
    torch.cuda.synchronize()
    if kern.gt_attention_fused_edge.launches != before + 1:
        raise RuntimeError("K1 at B = 4: launch counter did not move")
    ref, _ = k1(plain=True)
    k1_err = (out.float() - ref.float()).abs().max().item()
    if not k1_err <= tol * ref.float().abs().max().item():
        raise RuntimeError(f"K1 at B = {b}: max abs err {k1_err:.3e}")
    del ref
    rows = {"K1": [{**base, "max_abs_err": k1_err, "ms": cuda_ms(k1),
                    "ms_back_to_back": cuda_ms_back_to_back(
                        lambda: kern.gt_attention_fused_edge(q, k, v, *edge_kw.values(), ei, ptr,
                                                             HEADS)),
                    "plain_ms": cuda_ms(lambda: k1(plain=True), reps=10, warmup=2),
                    **dict(zip(("bound_ms", "bound_by"), attention_bound(
                        n, n, n_e, n_f, 2, True, batch=b))),
                    "library_ms": None}]}

    got = gt_attention_bwd_kernels(q, k, v, ei, ptr, order.src_ptr, order.src_perm, HEADS,
                                   out, lse, g, fused_bwd=False, **edge_kw)
    ref = gt_attention_bwd_plain(q, k, v, ei, HEADS, out, lse, g, **edge_kw)
    errs = {}
    for name in ("dq", "dk", "dv", "d_attr", "d_weight", "d_bias"):
        x, y = getattr(got, name).float(), getattr(ref, name).float()
        errs[name] = (x - y).abs().max().item()
        if not errs[name] <= tol * y.abs().max().item():
            raise RuntimeError(f"K3 + K4 at B = {b} {name}: max abs err {errs[name]:.3e}")
    del got, ref
    delta = (out.float() * g.float()).reshape(b, n, HEADS, -1).sum(-1)

    def k3():
        return kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, HEADS, **edge_kw,
                                         edge_grad=False, weight_grad=True)

    dkv = k3().dkv

    def k4():
        return kern.gt_attention_bwd_src(dkv, order.src_ptr, order.src_perm)

    def k4_plain():
        acc = torch.zeros(b, n, 2 * HD, device=device).index_add_(1, src, dkv.float())
        return acc[..., :HD].to(dtype), acc[..., HD:].to(dtype)

    k4_err = max((x.float() - y.float()).abs().max().item() for x, y in zip(k4(), k4_plain()))
    bounds = backward_bounds(n, n, n_e, n_f, 2, True, batch=b)
    plain_ms = cuda_ms(lambda: gt_attention_bwd_plain(q, k, v, ei, HEADS, out, lse, g,
                                                      **edge_kw), reps=5, warmup=1)
    rows["K3"] = [{**base, "max_abs_err": max(v_ for n_, v_ in errs.items()
                                              if n_ not in ("dk", "dv")), "errors": errs,
                   "ms": cuda_ms(k3), "ms_back_to_back": cuda_ms_back_to_back(k3),
                   "plain_ms": plain_ms, "plain_is": "gt_attention_bwd_plain",
                   "bound_ms": bounds["K3"][0], "bound_by": bounds["K3"][1],
                   "library_ms": None}]
    rows["K4"] = [{**base, "max_abs_err": k4_err, "max_abs_err_dk_dv_vs_plain_backward":
                   max(errs["dk"], errs["dv"]),
                   "ms": cuda_ms(k4), "ms_back_to_back": cuda_ms_back_to_back(k4),
                   "plain_ms": cuda_ms(k4_plain), "plain_is": "float32 index_add_ of dkv",
                   "bound_ms": bounds["K4"][0], "bound_by": bounds["K4"][1],
                   "library_ms": cuda_ms(lambda: torch.zeros(
                       b, n, 2 * HD, device=device, dtype=dtype).index_add_(1, src, dkv)),
                   "library_is": "index_add_ of dkv"}]
    for name, r in rows.items():
        print(f"[kernels] {name} at B = {b} (the ensemble's members) {r[0]}", flush=True)
    del dkv, q, k, v, g, out, lse
    torch.cuda.empty_cache()
    return rows


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
                    # a source's edges are summed by one group in source
                    # order, with no atomics on the sums
                    runs = [kern.gt_attention_bwd_src_fused(
                        q, k, v, g, lse, delta, ei, ptr, order.src_ptr, order.src_perm, HEADS,
                        **edge_kw) for _ in range(2)]
                    if not all(torch.equal(x, y) for x, y in zip(*runs)):
                        raise RuntimeError("bf16 K5 is not deterministic: dk or dv differs")
                    print("[backward] bf16 K5 deterministic: dk, dv of two runs bitwise equal",
                          flush=True)
                    del again, runs
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

                def k3():
                    return kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, HEADS,
                                                     **edge_kw, **path_kw)

                def k4():
                    return kern.gt_attention_bwd_src(dkv, order.src_ptr, order.src_perm)

                def k5():
                    return kern.gt_attention_bwd_src_fused(
                        q, k, v, g, lse, delta, ei, ptr, order.src_ptr, order.src_perm, HEADS,
                        **edge_kw)

                ms = {
                    "K3": cuda_ms(k3), "K3_b2b": cuda_ms_back_to_back(k3),
                    "K3_no_dkv": cuda_ms(lambda: kern.gt_attention_bwd_dst(
                        q, k, v, g, lse, delta, ei, ptr, HEADS, emit_dkv=False, **edge_kw,
                        **path_kw)),
                    "K4": cuda_ms(k4), "K4_b2b": cuda_ms_back_to_back(k4),
                    "K5": cuda_ms(k5), "K5_b2b": cuda_ms_back_to_back(k5),
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
                               **dst_build("K3", dtype, HD // HEADS, n_f, fused)),
                    "K4": dict(max_abs_err=max(errs[(False, "dk")], errs[(False, "dv")]),
                               plain_ms=k4_plain_ms, plain_is="float32 index_add_ of dkv",
                               library_ms=k4_library_ms, library_is="index_add_ of dkv",
                               ms_back_to_back=ms["K4_b2b"]),
                    "K5": dict(max_abs_err=max(errs[(True, "dk")], errs[(True, "dv")]),
                               ms_back_to_back=ms["K5_b2b"],
                               **dst_build("K5", dtype, HD // HEADS, n_f, fused)),
                }
                for name, extra in per_kernel.items():
                    row = {**base, "ms": ms[name], "bound_ms": bounds[name][0],
                           "bound_by": bounds[name][1], **extra}
                    rows[name].append(row)
                    print(f"[backward] {name} {row}", flush=True)
    return rows


def multi_scale_processor_graph():
    """The ``multi_scale`` graph's processor edge set alone: ico-5 hidden
    nodes, ``MultiScaleEdges`` with ``[edge_length, edge_dirs]``, the nodes
    sorted by incoming degree of that set (as in the whole graph, whose sort
    reads the self-edges only)."""
    from anemoi_tpu_torch.graphs.create import GraphCreator

    ea = {"edge_length": {"name": "EdgeLength"}, "edge_dirs": {"name": "EdgeDirection"}}
    return GraphCreator({
        "nodes": {"hidden": {"node_builder": {"name": "TriNodes", "resolution": 5}}},
        "edges": [{"source_name": "hidden", "target_name": "hidden",
                   "edge_builder": {"name": "MultiScaleEdges", "x_hops": 1}, "attributes": ea}],
        "post_processors": [{"name": "SortNodesByIncomingDegree", "nodes_name": "hidden"}],
    }).create()


def gt_wide_phase(graph, device):
    """K1, K3 + K4 and K3 + K5 at HD = 1024 (16 heads of 64) against their
    plain versions, at the Transformer preset's mapper edge sets and edge
    attributes and at the ``multi_scale`` processor set of the
    ``temporal_downscaler`` preset; each of K1, K3, K4 and K5 timed beside
    its byte bound, its plain version and (K4) one index_add_.
    Returns ({kernel: rows}, {check: max abs error})."""
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.ops.gt_attention import (
        SourceOrder, gt_attention_bwd_kernels, gt_attention_bwd_plain, gt_attention_fe,
    )

    attrs = transformer_config()["model"]["encoder"]["sub_graph_edge_attributes"]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    errors, rows = {}, {"K1": [], "K3": [], "K4": [], "K5": []}
    multi_scale = multi_scale_processor_graph()
    for edge_graph, key in ((graph, ("data", "hidden")), (graph, ("hidden", "data")),
                            (multi_scale, ("hidden", "hidden"))):
        es = edge_graph[key]
        n_src, n_dst = edge_graph[key[0]].num_nodes, edge_graph[key[1]].num_nodes
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
            fused = gt_attention_bwd_kernels(q, k, v, ei, ptr, order.src_ptr, order.src_perm,
                                             HEADS, out, lse, g, fused_bwd=True, **edge_kw)
            refs = gt_attention_bwd_plain(q, k, v, ei, HEADS, out, lse, g, **edge_kw)
            for name in ("dq", "dk", "dv", "d_attr", "d_weight", "d_bias"):
                got[name], want[name] = getattr(grads, name), getattr(refs, name)
            for name in ("dk", "dv"):  # K5's outputs
                got[f"{name} (K5)"] = getattr(fused, name)
                want[f"{name} (K5)"] = getattr(refs, name)
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
            del got, want, grads, fused, refs, ref

            # the times, as the Transformer's training path launches K3
            # (fused projection: dW and dbias, no d_attr) and K4
            path_kw = dict(edge_grad=False, weight_grad=True)
            delta = (out.float() * g.float()).reshape(1, n_dst, HEADS, -1).sum(-1)
            dkv = kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, HEADS, **edge_kw,
                                            **path_kw).dkv
            def k1_raw():
                return kern.gt_attention_fused_edge(q, k, v, *edge_kw.values(), ei, ptr, HEADS)

            def k3():
                return kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, HEADS,
                                                 **edge_kw, **path_kw)

            def k4():
                return kern.gt_attention_bwd_src(dkv, order.src_ptr, order.src_perm)

            def k5():
                return kern.gt_attention_bwd_src_fused(q, k, v, g, lse, delta, ei, ptr,
                                                       order.src_ptr, order.src_perm, HEADS,
                                                       **edge_kw)

            ms = {
                "K1": cuda_ms(lambda: gt_attention_fe(q, k, v, *edge_kw.values(), ei, ptr, HEADS,
                                                      source=order)),
                "K1_b2b": cuda_ms_back_to_back(k1_raw),
                "K3": cuda_ms(k3), "K3_b2b": cuda_ms_back_to_back(k3),
                "K4": cuda_ms(k4), "K4_b2b": cuda_ms_back_to_back(k4),
                "K5": cuda_ms(k5), "K5_b2b": cuda_ms_back_to_back(k5),
            }
            plain = {
                "K1": cuda_ms(lambda: gt_attention_fe(q, k, v, *edge_kw.values(), ei, ptr, HEADS,
                                                      plain=True), reps=10, warmup=2),
                "K3": cuda_ms(lambda: gt_attention_bwd_plain(q, k, v, ei, HEADS, out, lse, g,
                                                             **edge_kw), reps=5, warmup=1),
                "K4": cuda_ms(lambda: torch.zeros(1, n_src, 2 * WIDE_HD, device=device)
                              .index_add_(1, src, dkv.float()), reps=10, warmup=2),
            }
            plain["K5"] = plain["K3"]  # both parts of the whole plain backward
            k4_library_ms = cuda_ms(lambda: torch.zeros(
                1, n_src, 2 * WIDE_HD, device=device, dtype=dtype).index_add_(1, src, dkv),
                reps=10, warmup=2)
            del dkv
            bounds = {"K1": attention_bound(n_dst, n_src, n_e, n_f, q.element_size(), True,
                                            WIDE_HD),
                      **backward_bounds(n_dst, n_src, n_e, n_f, q.element_size(), True, WIDE_HD)}
            base = {"edge_set": "->".join(key), "dtype": str(dtype).split(".")[-1],
                    "hd": WIDE_HD, "fused_edge": True, "n_dst": n_dst, "n_src": n_src,
                    "n_edges": n_e,
                    "graph": "multi_scale" if edge_graph is multi_scale else "flagship"}
            per_kernel = {
                "K1": dict(max_abs_err=errs["out"], plain_is="gt_attention_fe(plain=True)",
                           library_ms=None, ms_back_to_back=ms["K1_b2b"],
                           **dst_build("K1", dtype, WIDE_HD // HEADS, n_f, True)),
                "K3": dict(max_abs_err=max(errs[n] for n in ("dq", "d_weight", "d_bias")),
                           plain_is="gt_attention_bwd_plain", library_ms=None,
                           ms_back_to_back=ms["K3_b2b"],
                           **dst_build("K3", dtype, WIDE_HD // HEADS, n_f, True)),
                "K4": dict(max_abs_err=max(errs["dk"], errs["dv"]),
                           plain_is="float32 index_add_ of dkv", library_ms=k4_library_ms,
                           library_is="index_add_ of dkv", ms_back_to_back=ms["K4_b2b"]),
                "K5": dict(max_abs_err=max(errs["dk (K5)"], errs["dv (K5)"]),
                           plain_is="gt_attention_bwd_plain", library_ms=None,
                           ms_back_to_back=ms["K5_b2b"],
                           **dst_build("K5", dtype, WIDE_HD // HEADS, n_f, True)),
            }
            for name, extra in per_kernel.items():
                row = {**base, "ms": ms[name], "plain_ms": plain[name],
                       "bound_ms": bounds[name][0], "bound_by": bounds[name][1], **extra}
                rows[name].append(row)
                print(f"[wide GT] {name} {row}", flush=True)
    print(f"[wide GT] K1, K3 + K4, K3 + K5 at HD={WIDE_HD} hold: {json.dumps(errors)}",
          flush=True)
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
    # the weights: the interface's own draws from context_seed("model-init")
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


def training_batch(graph, device, times: int = 3):
    """A data-space batch of ``times`` steps (3 = m + 1: rollout 1) from the
    seeded statistics."""
    idx = flagship_indices()["data"]
    stats = flagship_statistics(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    noise = torch.randn(1, times, 1, graph["data"].num_nodes, idx.num_data_vars, generator=gen,
                        device=device)
    mean, std = (torch.as_tensor(stats["data"][k], device=device) for k in ("mean", "stdev"))
    return {"data": mean + std * noise}


def training_losses(graph):
    """The bench's loss: area-weighted MSE."""
    from anemoi_tpu_torch.training.losses import get_loss_function
    from anemoi_tpu_torch.training.losses.scalers import create_scalers

    scalers = create_scalers({"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                                       "attribute_name": "area_weight"}}, graph=graph)
    return {"data": get_loss_function({"name": "WeightedMSELoss", "scalers": ["area"]},
                                      scalers)}


def build_training(graph, device, config):
    """(interface, TrainState, train_step) of the bench's training setup:
    bf16 over float32 masters, area-weighted MSE, AdamW, value clipping at
    32, rollout 1; the processor's per-layer remat as configured (default:
    ``save_attention``)."""
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface
    from anemoi_tpu_torch.training.optimizers import build_optimizer
    from anemoi_tpu_torch.training.step import TrainState, make_step_fns

    # the weights: the interface's own draws from context_seed("model-init")
    iface = AnemoiModelInterface(config=config, graph=graph, data_indices=flagship_indices(),
                                 statistics=flagship_statistics(SEED), device=device,
                                 training=True)
    tx = build_optimizer({"lr": {"rate": 1e-4, "warmup": 10, "iterations": 1000},
                          "gradient_clip": {"val": 32.0, "algorithm": "value"}})
    train_step, _ = make_step_fns(iface, training_losses(graph), rollout=1, precision="bf16")
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


TRAINER_STEPS = 8  # the trainer phase's training steps (max_steps)
TRAINER_TIMED = slice(2, None)  # steps 3-8: after the first steps' warmup


def write_example_store(path: str, config: dict) -> float:
    """The example's synthetic dataset written as a zlib zarr store with the
    port's writer; returns the seconds it took."""
    from anemoi_tpu_torch.data.dataset import open_dataset, save_zarr_copy

    t0 = time.perf_counter()
    save_zarr_copy(open_dataset(dict(config["data"]["datasets"]["data"])), path)
    return time.perf_counter() - t0


class StepLaunches:
    """Counts each training step's launches inside the trainer: wraps the
    ``train_step`` that ``make_step_fns`` builds so that the counts are set
    to 0 just before each step and read just after it (validation and the
    rollout evaluation run outside it), and keeps the trainer it ran in and
    the unwrapped ``train_step``."""

    def __init__(self):
        self.per_step, self.trainer, self.train_step = [], None, None

    def __enter__(self):
        from anemoi_tpu_torch import kernels
        from anemoi_tpu_torch.training import trainer as trainer_mod

        self._mod, self._make, self._train = (trainer_mod, trainer_mod.make_step_fns,
                                              trainer_mod.AnemoiTrainer.train)
        counter = self

        def make_step_fns(*args, **kwargs):
            train_step, eval_step = counter._make(*args, **kwargs)
            counter.train_step = train_step

            def counted(state, batch):
                kernels.reset_launches()
                out = train_step(state, batch)
                counter.per_step.append(kernels.launch_counts())
                return out

            return counted, eval_step

        def train(trainer):
            counter.trainer = trainer
            return counter._train(trainer)

        trainer_mod.make_step_fns = make_step_fns
        trainer_mod.AnemoiTrainer.train = train
        return self

    def __exit__(self, *exc):
        self._mod.make_step_fns = self._make
        self._mod.AnemoiTrainer.train = self._train


def trainer_phase(workdir: str, training: dict) -> dict:
    """The packaged example trained through the port's CLI (phase 9)."""
    from anemoi_tpu_torch.data import _lz4
    from anemoi_tpu_torch.flagship import example_o96_gt_config
    from anemoi_tpu_torch.graphs.graph import Graph
    from anemoi_tpu_torch.training import cli

    config = example_o96_gt_config()
    store = os.path.join(workdir, "example_o96.zarr")
    write_s = write_example_store(store, config)
    print(f"[trainer] synthetic o96 dataset (12 variables, 64 times) written to a zlib zarr "
          f"store in {write_s:.2f} s", flush=True)
    config["data"]["datasets"]["data"] = {"kind": "zarr", "path": store}
    config["graph"]["save_path"] = os.path.join(workdir, "graph.npz")
    config["output_dir"] = os.path.join(workdir, "run")
    config["training"].update(max_steps=TRAINER_STEPS, max_epochs=1)
    config["diagnostics"]["log_interval"] = 1
    config["dataloader"]["prefetch"] = 2
    cfg_path = os.path.join(workdir, "example_o96_gt.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)

    lz4_before = _lz4.decoded_blocks()
    t0 = time.perf_counter()
    with StepLaunches() as counted:
        rc = cli.main(["train", cfg_path])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"trainer: cli train returned {rc}")
    lz4 = {k: n - lz4_before[k] for k, n in _lz4.decoded_blocks().items()}
    print(f"[trainer] LZ4 blocks decoded in the run, by decoder: {lz4}"
          + ("" if any(lz4.values()) else " (the store is zlib: no LZ4 decoder ran)"),
          flush=True)
    graph = Graph.load(config["graph"]["save_path"])
    edges = {f"{s}->{d}": es.num_edges for (s, d), es in graph.edges.items()}
    print(f"[trainer] packaged graph (multi_scale, SortNodesByIncomingDegree): edges {edges}",
          flush=True)

    with open(os.path.join(config["output_dir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r]
    if [r["step"] for r in steps] != list(range(1, TRAINER_STEPS + 1)) or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps):
        raise RuntimeError(f"trainer: want {TRAINER_STEPS} finite loss/grad_norm records, "
                           f"got {steps}")
    val = [r for r in records if "val_loss" in r]
    if not val or not math.isfinite(val[-1]["val_loss"]) or not any(
            k.startswith("rmse/data/") and k.endswith("/4") for k in val[-1]):
        raise RuntimeError(f"trainer: no validation record with val_loss and the rollout-4 "
                           f"rmse keys: {val}")
    for path in ("checkpoints", os.path.join("inference", "checkpoint.json")):
        if not os.path.exists(os.path.join(config["output_dir"], path)):
            raise RuntimeError(f"trainer: {path} missing from the run directory")
    want = {**NO_LAUNCHES, "K1": LAUNCHES_PER_STEP, "K3": LAUNCHES_PER_STEP,
            "K4": LAUNCHES_PER_STEP}
    if len(counted.per_step) != TRAINER_STEPS or any(c != want for c in counted.per_step):
        raise RuntimeError(f"trainer: expected {want} in each of {TRAINER_STEPS} steps, "
                           f"got {counted.per_step}")
    # the trained example's step on a batch of the store, on the kernels
    # against the plain attention: K1, K3 and K4 at the packaged graph's edge sets
    trainer = counted.trainer
    trainer.datamodule.set_rollout(1)
    batch = trainer.put_batch(trainer.datamodule.make_batch(trainer.datamodule.train_starts[:1]))
    grad_rel_l2 = grad_gap(trainer.interface, trainer.state, counted.train_step, batch,
                           "example (packaged graph) K3 + K4")

    walls = [(b["elapsed_s"] - a["elapsed_s"]) * 1e3 for a, b in zip(steps, steps[1:])]
    timed = walls[TRAINER_TIMED.start - 1:]  # the walls of steps 3-8
    waits = [w * 1e3 for w in trainer.data_wait_s[TRAINER_TIMED]]
    counted.trainer = counted.train_step = None
    del trainer, batch
    torch.cuda.empty_cache()
    result = {
        "seconds": seconds, "store_write_s": write_s, "edges": edges,
        "ms_per_step": statistics.median(timed), "ms_per_step_runs": timed,
        "ms_per_step_min": min(timed), "ms_per_step_max": max(timed),
        "data_wait_ms_runs": waits, "data_wait_ms": statistics.median(waits),
        "fixed_batch_ms_per_step": training["ms_per_step"],
        "losses": [r["loss"] for r in steps], "grad_norms": [r["grad_norm"] for r in steps],
        "val_loss": val[-1]["val_loss"], "launches_per_step": counted.per_step[-1],
        "n_val_keys": len(val[-1]), "lz4_blocks_decoded": lz4,
        "grad_rel_l2_vs_plain": grad_rel_l2,
    }
    print(f"[trainer] wall ms a step over steps 3-{TRAINER_STEPS} (data pipeline included): "
          f"median {result['ms_per_step']:.3f}, min {min(timed):.3f}, max {max(timed):.3f}; "
          f"host wait for batches median {result['data_wait_ms']:.3f} ms; phase 8's fixed "
          f"batch {training['ms_per_step']:.3f} ms", flush=True)
    print(f"[trainer] {json.dumps(result)}", flush=True)
    return result


def predict_phase(workdir: str) -> dict:
    """The bundle of phase 9 served through the port's CLI (phase 10)."""
    import numpy as np

    from anemoi_tpu_torch import kernels
    from anemoi_tpu_torch.data.dataset import open_dataset
    from anemoi_tpu_torch.inference import make_forecast_fn
    from anemoi_tpu_torch.training import cli
    from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint

    bundle = os.path.join(workdir, "run", "inference")
    output = os.path.join(workdir, "forecast.npz")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["predict", bundle, "--steps", str(STEPS), "--output", output])
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if rc != 0:
        raise RuntimeError(f"predict: cli predict returned {rc}")
    want = {**NO_LAUNCHES, "K1": LAUNCHES_PER_STEP * STEPS}
    if launches != want:
        raise RuntimeError(f"predict: expected launches {want}, got {launches}")
    with open(os.path.join(bundle, "checkpoint.json")) as f:
        dataset = open_dataset(dict(json.load(f)["config"]["data"]["datasets"]["data"]))
    out = np.load(output)["data|forecast"]
    expect = (1, STEPS, 1, dataset.num_grid_points, 11)  # 40 320 points at o96
    if out.shape != expect or not np.isfinite(out).all():
        raise RuntimeError(f"predict: forecast shape {out.shape} (want {expect}) or not finite")

    iface = load_inference_checkpoint(bundle)
    window = dataset.get_window(0, iface.model.n_step_input + STEPS)
    batch = {"data": torch.from_numpy(window[None]).to(iface.device)}
    forecast = make_forecast_fn(iface, steps=STEPS)
    ref = forecast(batch)["data"].cpu().numpy()
    max_abs = float(np.abs(out - ref).max())
    print(f"[predict] cli forecast vs make_forecast_fn in-process: max |diff| {max_abs:.3e} "
          f"(want 0: same bundle, window and kernels)", flush=True)
    if not np.array_equal(out, ref):
        raise RuntimeError(f"predict: the CLI's forecast differs from the in-process one "
                           f"(max |diff| {max_abs:.3e})")
    iface.use_plain_attention(True)
    plain = forecast(batch)["data"].cpu().numpy()
    iface.use_plain_attention(False)
    rel_l2 = float(np.linalg.norm(out - plain) / np.linalg.norm(plain))
    print(f"[predict] cli forecast vs the bundle on the plain attention (K1 at the packaged "
          f"graph's edge sets): relative L2 {rel_l2:.3e} (tol {SERVING_TOL})", flush=True)
    if not rel_l2 <= SERVING_TOL:
        raise RuntimeError(f"predict: forecast disagrees with the plain attention: {rel_l2:.3e}")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        forecast(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3 / STEPS)
    # the serving time: the in-process make_forecast_fn on the bundle the CLI
    # served, timed after the CLI call (the CLI's own call includes loading)
    result = {"seconds": seconds, "launches": launches, "output_shape": list(out.shape),
              "in_process_ms_per_step": statistics.median(times),
              "in_process_ms_per_step_runs": times,
              "max_abs_diff_vs_in_process": max_abs, "rel_l2_vs_plain": rel_l2}
    print(f"[predict] in-process make_forecast_fn on the loaded bundle, after the CLI call: "
          f"median {result['in_process_ms_per_step']:.3f} ms a step", flush=True)
    print(f"[predict] {json.dumps(result)}", flush=True)
    del iface, forecast
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


# the remat phase's variants on the flagship: (label, rollout, the
# processor's per-layer policy or "off", remat_rollout, rollout policy)
REMAT_VARIANTS = [
    ("r1 layers off", 1, "off", False, None),
    ("r1 layers save_attention", 1, "save_attention", False, None),
    ("r1 layers full", 1, "full", False, None),
    ("r2 no remat", 2, "off", False, None),
    ("r2 rollout off", 2, "save_attention", False, None),
    ("r2 rollout full", 2, "save_attention", True, None),
    ("r2 rollout save_attention", 2, "save_attention", True, "save_attention"),
    ("r3 no remat", 3, "off", False, None),
    ("r3 rollout full", 3, "save_attention", True, None),
]
REMAT_STEPS = 3  # wall-timed steps a variant, after 1 of warmup; 1 more profiled
REMAT_TOL = 1e-5  # relative L2, a variant's gradient against no remat at its rollout
FLAGSHIP_LAYERS = 16
KEEPS_ATTENTION = ("save_attention", "save_attention_mlp")


def remat_launches(rollout, layer_policy, remat_rollout, rollout_policy) -> dict:
    """A flagship training step's launches from the remat structure (the
    counts tests/test_torch_remat.py asserts for the same structure): each
    rollout step's forward launches K1 in its 18 blocks; a rollout
    checkpoint that does not keep the attention's outputs runs the forward
    again in the backward (rollout > 1 only); a per-layer checkpoint that
    does not keep them runs each layer's K1 once more; K3 and K4 run once
    a block's backward."""
    f = LAUNCHES_PER_STEP
    outer = remat_rollout and rollout > 1 and rollout_policy not in KEEPS_ATTENTION
    again = FLAGSHIP_LAYERS if layer_policy not in ("off", *KEEPS_ATTENTION) else 0
    return {**NO_LAUNCHES, "K1": (f * (1 + outer) + again) * rollout, "K3": f * rollout,
            "K4": f * rollout}


def profiled_device_ms(fn, steps: int, split: int = 0):
    """(device ms a step, device launches a step) of ``steps`` calls of
    ``fn`` under ``torch.profiler`` (kernels and copies on the card; the
    card's activity only: host ops would multiply the trace's parse
    time).  With ``split`` > 0 also the ``split`` device kernels that took
    the most time, ``{name: ms a step}``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    ms, n, by_name = 0.0, 0, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            ms += evt.device_time / 1e3
            n += 1
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.device_time / 1e3 / steps
    if n == 0:
        raise RuntimeError("torch.profiler recorded no device activity")
    if not split:
        return ms / steps, n / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:split]
    return ms / steps, n / steps, {short_kernel_name(k): v for k, v in top}


def short_kernel_name(name: str, width: int = 120) -> str:
    """A device kernel's name without its namespaces, cut to ``width``."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "c10::"):
        name = name.replace(noise, "")
    return name[:width]


def remat_phase(graph, device) -> dict:
    """The flagship through ``make_step_fns`` under each remat variant: exact
    launches a step, the gradient against no remat at the same rollout, wall
    and device ms a step and peak memory.  One interface (the same weights)
    for every variant: the per-layer policy is set on its processor."""
    from anemoi_tpu_torch.models.layers.remat import resolve_remat_policy
    from anemoi_tpu_torch.training.step import make_step_fns

    batch = training_batch(graph, device, times=2 + max(v[1] for v in REMAT_VARIANTS))
    iface, state, _ = build_training(graph, device, flagship_config())
    losses = training_losses(graph)
    proc = iface.model.processor

    def configure(rollout, layer_policy, remat_rollout, rollout_policy):
        proc.gradient_checkpointing = layer_policy != "off"
        proc.remat_policy = resolve_remat_policy(None if layer_policy == "off" else layer_policy)
        train_step, _ = make_step_fns(iface, losses, rollout=rollout, remat_rollout=remat_rollout,
                                      remat_policy=rollout_policy, precision="bf16")
        return train_step, {"data": batch["data"][:, :2 + rollout]}

    from anemoi_tpu_torch import kernels

    # gradients first, all at the same weights
    results, reference = {}, {}
    for label, rollout, layer_policy, remat_rollout, rollout_policy in REMAT_VARIANTS:
        train_step, b = configure(rollout, layer_policy, remat_rollout, rollout_policy)
        kernels.reset_launches()
        train_step.compute_gradients(state, b)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = remat_launches(rollout, layer_policy, remat_rollout, rollout_policy)
        if launches != want:
            raise RuntimeError(f"remat {label}: expected launches {want}, got {launches}")
        g = flat_grads(iface)
        if layer_policy == "off" and not remat_rollout:
            reference[rollout] = g
        gap = ((g - reference[rollout]).norm() / reference[rollout].norm()).item()
        if not gap <= REMAT_TOL:
            raise RuntimeError(f"remat {label}: gradient against no remat {gap:.3e} "
                               f"(tol {REMAT_TOL})")
        results[label] = {"rollout": rollout, "layer_policy": layer_policy,
                          "remat_rollout": remat_rollout,
                          "rollout_policy": rollout_policy if remat_rollout else None,
                          "launches": launches, "grad_rel_l2_vs_no_remat": gap}
        del g
    del reference
    iface.zero_grad(set_to_none=True)

    for label, rollout, layer_policy, remat_rollout, rollout_policy in REMAT_VARIANTS:
        train_step, b = configure(rollout, layer_policy, remat_rollout, rollout_policy)
        train_step(state, b)  # warmup
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        walls = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            launches, loss, _ = one_step(state, train_step, b)
            walls.append((time.perf_counter() - t0) * 1e3)
            if launches != results[label]["launches"]:
                raise RuntimeError(f"remat {label}: launches {launches} in a timed step")
        peak = torch.cuda.max_memory_allocated(device)
        device_ms, device_launches = profiled_device_ms(lambda: train_step(state, b), 1)
        r = results[label]
        r.update(ms_per_step=statistics.median(walls), ms_per_step_runs=walls,
                 device_ms_per_step=device_ms, device_launches_per_step=device_launches,
                 peak_memory_bytes=peak, loss=loss)
        print(f"[remat] {label}: K1 {r['launches']['K1']} K3 {r['launches']['K3']} "
              f"K4 {r['launches']['K4']} a step; gradient vs no remat "
              f"{r['grad_rel_l2_vs_no_remat']:.3e}; "
              f"wall {r['ms_per_step']:.3f} ms, device {device_ms:.3f} ms "
              f"({device_launches:.1f} device launches) a step; peak {peak} B", flush=True)
    proc.gradient_checkpointing = True
    proc.remat_policy = resolve_remat_policy("save_attention")
    del iface, state
    torch.cuda.empty_cache()
    print(f"[remat] {json.dumps(results)}", flush=True)
    return results


PRESET_STEPS = 3  # training steps of the presets phase, at rollout 2
PRESET_ROLLOUT = 2


def presets_phase(workdir: str) -> dict:
    """The packaged presets read without PyYAML: ``cli config list``, the
    example composed from its YAML, ``cli train`` on it over phase 9's store
    at rollout 2 with the packaged remat defaults, ``cli evaluate --rollout
    2``."""
    import contextlib
    import glob
    import io

    from anemoi_tpu_torch.flagship import example_o96_gt_config
    from anemoi_tpu_torch.training import cli
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["config", "list"])
    listed = out.getvalue().split()
    jax_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "anemoi_tpu", "config")
    files = sorted(os.path.relpath(p, jax_dir)
                   for p in glob.glob(os.path.join(jax_dir, "**", "*.yaml"), recursive=True))
    presets = [f for f in listed if os.sep not in f]
    if rc != 0 or sorted(listed) != files or len(presets) != 16:
        raise RuntimeError(f"presets: config list returned {rc} and {listed}, want {files}")
    print(f"[presets] config list: {len(listed)} files, {len(presets)} presets, as "
          f"anemoi_tpu/config lists them", flush=True)

    preset = os.path.join(PACKAGED_CONFIG_DIR, "example_o96_gt.yaml")
    width = ["model.num_channels=512", "model.processor.num_layers=16", "training.precision=bf16"]
    t0 = time.perf_counter()
    composed = load_config(preset, width, search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    compose_s = time.perf_counter() - t0
    if composed != example_o96_gt_config():
        raise RuntimeError("presets: example_o96_gt.yaml composed differs from "
                           "example_o96_gt_config()")
    training = composed["training"]
    print(f"[presets] example_o96_gt.yaml composed in {compose_s * 1e3:.2f} ms equals "
          f"example_o96_gt_config(); remat_rollout {training.get('remat_rollout')}, "
          f"remat_policy {training.get('remat_policy')}", flush=True)

    store = os.path.join(workdir, "example_o96.zarr")
    run_dir = os.path.join(workdir, "presets_run")
    run = width + ["data.datasets.data.kind=zarr", f"data.datasets.data.path={store}",
                   f"graph.save_path={os.path.join(workdir, 'graph.npz')}",  # phase 9's
                   f"output_dir={run_dir}", f"training.max_steps={PRESET_STEPS}",
                   "training.max_epochs=1", f"training.rollout.start={PRESET_ROLLOUT}",
                   f"training.rollout.max={PRESET_ROLLOUT}", "diagnostics.log_interval=1"]
    t0 = time.perf_counter()
    with StepLaunches() as counted:
        rc = cli.main(["train", preset, *run])
    train_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"presets: cli train returned {rc}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r]
    if [(r["step"], r["rollout"]) for r in steps] != [
            (i, PRESET_ROLLOUT) for i in range(1, PRESET_STEPS + 1)] or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps):
        raise RuntimeError(f"presets: want {PRESET_STEPS} finite records at rollout "
                           f"{PRESET_ROLLOUT}, got {steps}")
    # the packaged defaults: remat_rollout true with no policy (full
    # recompute of each rollout step), per-layer save_attention
    want = remat_launches(PRESET_ROLLOUT, "save_attention", True, None)
    if len(counted.per_step) != PRESET_STEPS or any(c != want for c in counted.per_step):
        raise RuntimeError(f"presets: expected {want} in each of {PRESET_STEPS} steps, "
                           f"got {counted.per_step}")
    counted.trainer = counted.train_step = None
    walls = [(b["elapsed_s"] - a["elapsed_s"]) * 1e3 for a, b in zip(steps, steps[1:])]

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["evaluate", preset, *run, "--rollout", str(PRESET_ROLLOUT)])
    evaluate_s = time.perf_counter() - t0
    text = out.getvalue()
    if rc != 0 or "val_loss" not in text or f"/{PRESET_ROLLOUT}'" not in text:
        raise RuntimeError(f"presets: cli evaluate returned {rc}: {text[-2000:]}")
    torch.cuda.empty_cache()
    result = {"files_listed": len(listed), "presets": len(presets), "compose_ms": compose_s * 1e3,
              "train_s": train_s, "evaluate_s": evaluate_s,
              "launches_per_step": counted.per_step[-1],
              "losses": [r["loss"] for r in steps], "grad_norms": [r["grad_norm"] for r in steps],
              "wall_ms_steps_2_on": walls}
    print(f"[presets] cli train example_o96_gt.yaml at rollout {PRESET_ROLLOUT}: "
          f"{PRESET_STEPS} steps, launches a step {counted.per_step[-1]}, wall ms a step "
          f"(steps 2-{PRESET_STEPS}) {walls}; cli evaluate --rollout {PRESET_ROLLOUT} "
          f"{evaluate_s:.2f} s", flush=True)
    print(f"[presets] {json.dumps(result)}", flush=True)
    return result


ENSEMBLE_STEPS = 3  # training steps of the ensemble phase, at rollout 1


def ensemble_phase(workdir: str, device) -> dict:
    """The ensemble CRPS preset (AIFS-ENS) at its own width: ``cli train
    ensemble_crps.yaml`` over phase 9's store, then its step against the
    plain attention and ``predict_step`` on the trained interface."""
    import contextlib
    import io

    from anemoi_tpu_torch import kernels
    from anemoi_tpu_torch.models.layers.normalization import ConditionalLayerNorm
    from anemoi_tpu_torch.training import cli
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config

    preset = os.path.join(PACKAGED_CONFIG_DIR, "ensemble_crps.yaml")
    store = os.path.join(workdir, "example_o96.zarr")
    run_dir = os.path.join(workdir, "ensemble_run")
    # the preset's model, graph and training at its own width (512 channels,
    # 16 layers, 16 heads, multi_scale o96 -> ico-5, 4 members), in bf16;
    # phase 9's store and graph (the same recipe); the rollout evaluation
    # callback, which cannot run a noise-drawing model (the JAX package's
    # fails on it too), left out
    run = ["data.datasets.data.kind=zarr", f"data.datasets.data.path={store}",
           f"graph.save_path={os.path.join(workdir, 'graph.npz')}", f"output_dir={run_dir}",
           f"training.max_steps={ENSEMBLE_STEPS}", "training.max_epochs=1",
           "training.precision=bf16", "diagnostics.log_interval=1",
           "diagnostics.callbacks=[{name: LearningRateMonitor}]"]
    composed = load_config(preset, run, search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    model = composed["model"]
    shape = (model["name"], model["num_channels"], model["processor"]["num_layers"],
             model["processor"]["num_heads"], composed["training"]["ensemble_size"])
    if shape != ("AnemoiEnsModelEncProcDec", 512, 16, 16, MEMBERS):
        raise RuntimeError(f"ensemble: the preset composed to {shape}")
    t0 = time.perf_counter()
    with StepLaunches() as counted:
        rc = cli.main(["train", preset, *run])
    train_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"ensemble: cli train returned {rc}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r]
    if [r["step"] for r in steps] != list(range(1, ENSEMBLE_STEPS + 1)) or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps):
        raise RuntimeError(f"ensemble: want {ENSEMBLE_STEPS} finite records, got {steps}")
    val = [r for r in records if "val_loss" in r]
    if not val or not math.isfinite(val[-1]["val_loss"]):
        raise RuntimeError(f"ensemble: no finite validation record: {val}")
    want = {**NO_LAUNCHES, "K1": LAUNCHES_PER_STEP, "K3": LAUNCHES_PER_STEP,
            "K4": LAUNCHES_PER_STEP}
    if len(counted.per_step) != ENSEMBLE_STEPS or any(c != want for c in counted.per_step):
        raise RuntimeError(f"ensemble: expected {want} in each of {ENSEMBLE_STEPS} steps, "
                           f"got {counted.per_step}")
    print(f"[ensemble] cli train ensemble_crps.yaml: {ENSEMBLE_STEPS} steps at {MEMBERS} "
          f"members, losses {[r['loss'] for r in steps]}, launches a step "
          f"{counted.per_step[-1]}, val_loss {val[-1]['val_loss']}", flush=True)

    trainer, train_step = counted.trainer, counted.train_step
    counted.trainer = counted.train_step = None
    iface, state = trainer.interface, trainer.state
    trainer.datamodule.set_rollout(1)
    batch = trainer.put_batch(trainer.datamodule.make_batch(trainer.datamodule.train_starts[:1]))
    # the same weights and noise seed (the state's step) on both attentions
    grad_rel_l2 = grad_gap(iface, state, train_step, batch,
                           f"ensemble ({MEMBERS} members) K3 + K4")
    iface.zero_grad(set_to_none=True)
    ms, walls, peak = timed_steps(device, state, train_step, batch)
    device_ms, device_launches = profiled_device_ms(lambda: train_step(state, batch), 1)

    # predict_step on the trained interface, the window tiled to the members
    window = {"data": batch["data"][:, :iface.model.n_step_input].expand(
        -1, -1, MEMBERS, -1, -1).contiguous()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    out = iface.predict_step(window)["data"]
    torch.cuda.synchronize()
    p_launches = kernels.launch_counts()
    p_peak = torch.cuda.max_memory_allocated(device)
    n_grid = trainer.datamodule.datasets["data"].num_grid_points
    expect = (1, 1, MEMBERS, n_grid, iface.data_indices["data"].num_model_output_vars)
    if tuple(out.shape) != expect or not torch.isfinite(out).all():
        raise RuntimeError(f"ensemble: predict_step shape {tuple(out.shape)} (want {expect}) "
                           "or not finite")
    if p_launches != {**NO_LAUNCHES, "K1": LAUNCHES_PER_STEP}:
        raise RuntimeError(f"ensemble: predict_step launches {p_launches}")
    iface.use_plain_attention(True)
    plain = iface.predict_step(window)["data"]  # the same noise: context_generator("noise")
    iface.use_plain_attention(False)
    p_rel_l2 = ((out - plain).norm() / plain.norm()).item()
    print(f"[ensemble] predict_step vs plain attention: relative L2 {p_rel_l2:.3e} "
          f"(tol {SERVING_TOL})", flush=True)
    if not p_rel_l2 <= SERVING_TOL:
        raise RuntimeError(f"ensemble: predict_step disagrees with the plain attention: "
                           f"{p_rel_l2:.3e}")
    del plain
    p_walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        iface.predict_step(window)
        torch.cuda.synchronize()
        p_walls.append((time.perf_counter() - t1) * 1e3)
    p_device_ms, p_device_launches = profiled_device_ms(lambda: iface.predict_step(window), 1)
    spread_trained = (out[0, 0, 0] - out[0, 0, 1]).abs().max().item()
    # members differ once the conditional scales are nonzero (zero at init;
    # three steps at the preset's warmup rate move them by ~1e-7): seeded
    # random kernels (a constant kernel would sum the zero-mean conditioning
    # of noise_mlp's LayerNorm to 0)
    norms = [m_ for m_ in iface.modules() if isinstance(m_, ConditionalLayerNorm)]
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    nudges = [0.1 * torch.randn(m_.scale.weight.shape, generator=gen, device=device)
              for m_ in norms]
    with torch.no_grad():
        for m_, d in zip(norms, nudges):
            m_.scale.weight.add_(d)
        nudged = iface.predict_step(window)["data"]
        for m_, d in zip(norms, nudges):
            m_.scale.weight.sub_(d)
    spread = (nudged[0, 0, 0] - nudged[0, 0, 1]).abs().max().item()
    if not (torch.isfinite(nudged).all() and spread > 0):
        raise RuntimeError(f"ensemble: members equal with nonzero conditional scales ({spread})")
    del trainer, state, train_step, iface, batch, window, out, nudged
    torch.cuda.empty_cache()
    result = {
        "train_s": train_s, "members": MEMBERS, "losses": [r["loss"] for r in steps],
        "grad_norms": [r["grad_norm"] for r in steps], "val_loss": val[-1]["val_loss"],
        "launches_per_step": counted.per_step[-1], "grad_rel_l2_vs_plain": grad_rel_l2,
        "ms_per_step": ms, "ms_per_step_runs": walls, "peak_memory_bytes": peak,
        "device_ms_per_step": device_ms, "device_launches_per_step": device_launches,
        "trainer_wall_ms_steps_2_on": [(b_["elapsed_s"] - a_["elapsed_s"]) * 1e3
                                       for a_, b_ in zip(steps, steps[1:])],
        "predict": {"launches": p_launches, "output_shape": list(expect),
                    "rel_l2_vs_plain": p_rel_l2, "ms": statistics.median(p_walls),
                    "ms_runs": p_walls, "device_ms": p_device_ms,
                    "device_launches": p_device_launches, "peak_memory_bytes": p_peak,
                    "member_spread_trained": spread_trained,
                    "member_spread_scales_nudged": spread},
        "conditional_norms": len(norms),
    }
    print(f"[ensemble] fixed-batch step at {MEMBERS} members: wall {ms:.3f} ms, device "
          f"{device_ms:.3f} ms ({device_launches:.1f} device launches), peak {peak} B; "
          f"predict_step wall {result['predict']['ms']:.3f} ms, device {p_device_ms:.3f} ms, "
          f"peak {p_peak} B; member spread trained {spread_trained:.3e}, scales nudged "
          f"{spread:.3e}", flush=True)
    print(f"[ensemble] {json.dumps(result)}", flush=True)
    return result


FAMILY_STEPS = 3  # cli train steps of phases 16-19 (2 for the ensemble downscaler)
FAMILY_TIMED = 3  # fixed-batch steps timed after the run, after 1 of warmup
LR_ONLY = "diagnostics.callbacks=[{name: LearningRateMonitor}]"
CARD_CPU_TOL = 1e-4  # relative L2, the GNN's float32 forward and gradient, card against CPU
GNN_DEFAULTS = """defaults:
  - data: synthetic
  - dataloader: default
  - diagnostics: default
  - graph: multi_scale
  - model: gnn
  - task: forecaster
  - training: default
  - _self_
"""


def expected_launches(config: dict, graph, processor_layers: int) -> dict:
    """A training step's launches from the edge counts: K1 and K3 once a GT
    block (the two mappers and ``processor_layers`` processor layers), and
    on each of those edge sets K5 where the JAX package's rule
    (``fused_backward``: 2 GB of estimated two-pass transient) picks the
    fused backward, else K4."""
    from anemoi_tpu_torch.models.encoder_processor_decoder import fused_backward

    model = config["model"]
    c = int(model["num_channels"])
    sets = [("encoder", graph[("data", "hidden")].num_edges),
            ("decoder", graph[("hidden", "data")].num_edges)]
    if processor_layers:
        sets += [("processor", graph[("hidden", "hidden")].num_edges)] * processor_layers
    fused = [fused_backward(model, part, n, c) for part, n in sets]
    return {**NO_LAUNCHES, "K1": len(sets), "K3": len(sets), "K4": fused.count(False),
            "K5": fused.count(True)}


def family_train(workdir: str, device, label: str, path: str, overrides: list, steps: int,
                 want, attention: bool = True, split: int = 0) -> tuple:
    """``cli train`` on ``path`` over phase 9's store, bf16: exit 0, ``steps``
    finite records, a finite validation record, exactly ``want(trainer)``
    launches in every step; then, on a batch of the store, the trained
    step's gradient against the plain attention (``attention``), wall ms a
    step (median of ``FAMILY_TIMED`` after 1 of warmup), device ms and
    launches a step (``torch.profiler``; with ``split``, its kernels that
    took the most device time) and peak memory.  Returns (result, run
    directory, last validation record)."""
    from anemoi_tpu_torch.training import cli

    store = os.path.join(workdir, "example_o96.zarr")
    run_dir = os.path.join(workdir, f"{label}_run")
    run = ["data.datasets.data.kind=zarr", f"data.datasets.data.path={store}",
           f"output_dir={run_dir}", f"training.max_steps={steps}", "training.max_epochs=1",
           "training.precision=bf16", "diagnostics.log_interval=1", *overrides]
    t0 = time.perf_counter()
    with StepLaunches() as counted:
        rc = cli.main(["train", path, *run])
    train_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{label}: cli train returned {rc}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    done = [r for r in records if "loss" in r]
    if [r["step"] for r in done] != list(range(1, steps + 1)) or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in done):
        raise RuntimeError(f"{label}: want {steps} finite records, got {done}")
    val = [r for r in records if "val_loss" in r]
    if not val or not all(math.isfinite(v) for k, v in val[-1].items()
                          if k == "val_loss" or k.startswith("rmse/")):
        raise RuntimeError(f"{label}: no finite validation record: {val}")
    trainer, train_step = counted.trainer, counted.train_step
    counted.trainer = counted.train_step = None
    want = want(trainer)
    if len(counted.per_step) != steps or any(c != want for c in counted.per_step):
        raise RuntimeError(f"{label}: expected {want} in each of {steps} steps, got "
                           f"{counted.per_step}")
    print(f"[{label}] cli train: {steps} steps in {train_s:.2f} s, losses "
          f"{[r['loss'] for r in done]}, launches a step {counted.per_step[-1]}, val_loss "
          f"{val[-1]['val_loss']}", flush=True)

    iface, state = trainer.interface, trainer.state
    trainer.datamodule.set_rollout(1)
    batch = trainer.put_batch(trainer.datamodule.make_batch(trainer.datamodule.train_starts[:1]))
    grad_rel_l2 = (grad_gap(iface, state, train_step, batch, f"{label} K3 + K4/K5")
                   if attention else None)
    iface.zero_grad(set_to_none=True)
    train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for _ in range(FAMILY_TIMED):
        t1 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated(device)
    device_ms, device_launches, *top = profiled_device_ms(lambda: train_step(state, batch), 1,
                                                          split)
    result = {
        "train_s": train_s, "losses": [r["loss"] for r in done],
        "grad_norms": [r["grad_norm"] for r in done], "val_loss": val[-1]["val_loss"],
        "launches_per_step": counted.per_step[-1], "grad_rel_l2_vs_plain": grad_rel_l2,
        "ms_per_step": statistics.median(walls), "ms_per_step_runs": walls,
        "device_ms_per_step": device_ms, "device_launches_per_step": device_launches,
        "peak_memory_bytes": peak,
        "trainer_wall_ms_steps_2_on": [(b["elapsed_s"] - a["elapsed_s"]) * 1e3
                                       for a, b in zip(done, done[1:])],
        "edges": {f"{s}->{d}": es.num_edges for (s, d), es in trainer.graph.edges.items()},
        **({"device_ms_by_kernel": top[0]} if top else {}),
    }
    print(f"[{label}] fixed-batch step: wall {result['ms_per_step']:.3f} ms, device "
          f"{device_ms:.3f} ms ({device_launches:.1f} device launches), peak {peak} B; "
          f"edges {result['edges']}", flush=True)
    del trainer, state, train_step, iface, batch
    torch.cuda.empty_cache()
    return result, run_dir, val[-1]


def family_predict(workdir: str, device, label: str, run_dir: str, k1_per_step: int,
                   split: int = 0) -> dict:
    """``cli predict`` on the bundle of ``run_dir``, ``STEPS`` steps: exit 0,
    exactly ``k1_per_step`` K1 a step and no other kernel, a finite forecast
    of the right shape, within relative L2 2e-2 of the same bundle served
    in-process on the plain attention (on the kernels, for a model with no
    attention: the sums' atomics vary the last bits); the in-process
    forecast's wall and device ms a step and peak memory."""
    import numpy as np

    from anemoi_tpu_torch import kernels
    from anemoi_tpu_torch.data.dataset import open_dataset
    from anemoi_tpu_torch.inference import make_forecast_fn
    from anemoi_tpu_torch.training import cli
    from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint

    bundle = os.path.join(run_dir, "inference")
    output = os.path.join(workdir, f"{label}_forecast.npz")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["predict", bundle, "--steps", str(STEPS), "--output", output])
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if rc != 0:
        raise RuntimeError(f"{label}: cli predict returned {rc}")
    want = {**NO_LAUNCHES, "K1": k1_per_step * STEPS}
    if launches != want:
        raise RuntimeError(f"{label}: predict launches {launches}, want {want}")
    with open(os.path.join(bundle, "checkpoint.json")) as f:
        dataset = open_dataset(dict(json.load(f)["config"]["data"]["datasets"]["data"]))
    out = np.load(output)["data|forecast"]
    expect = (1, STEPS, 1, dataset.num_grid_points, 11)
    if out.shape != expect or not np.isfinite(out).all():
        raise RuntimeError(f"{label}: forecast shape {out.shape} (want {expect}) or not finite")
    iface = load_inference_checkpoint(bundle)
    window = dataset.get_window(0, iface.model.n_step_input + STEPS)
    batch = {"data": torch.from_numpy(window[None]).to(iface.device)}
    forecast = make_forecast_fn(iface, steps=STEPS)
    iface.use_plain_attention(bool(k1_per_step))
    ref = forecast(batch)["data"].cpu().numpy()
    iface.use_plain_attention(False)
    rel_l2 = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    against = "the plain attention" if k1_per_step else "the in-process forecast"
    print(f"[{label}] cli predict vs {against}: relative L2 {rel_l2:.3e} (tol {SERVING_TOL})",
          flush=True)
    if not rel_l2 <= SERVING_TOL:
        raise RuntimeError(f"{label}: forecast disagrees with {against}: {rel_l2:.3e}")
    forecast(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        forecast(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3 / STEPS)
    peak = torch.cuda.max_memory_allocated(device)
    device_ms, device_launches, *top = profiled_device_ms(lambda: forecast(batch), 1, split)
    result = {"seconds": seconds, "launches": launches, "output_shape": list(out.shape),
              "rel_l2": rel_l2, "rel_l2_against": against,
              "ms_per_step": statistics.median(walls), "ms_per_step_runs": walls,
              "device_ms_per_step": device_ms / STEPS,
              "device_launches_per_step": device_launches / STEPS, "peak_memory_bytes": peak,
              **({"device_ms_by_kernel_2_steps": top[0]} if top else {})}
    print(f"[{label}] in-process forecast: wall {result['ms_per_step']:.3f} ms a step, device "
          f"{result['device_ms_per_step']:.3f} ms a step, peak {peak} B", flush=True)
    del iface, forecast, batch
    torch.cuda.empty_cache()
    return result


def composed_preset(path: str, overrides: list, expect: dict) -> dict:
    """The preset composed by the port; ``expect``: dotted keys it must hold."""
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config

    cfg = load_config(path, overrides, search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    for key, value in expect.items():
        node = cfg
        for part in key.split("."):
            node = node[part]
        if node != value:
            raise RuntimeError(f"{os.path.basename(path)} composed to {key}={node}, want {value}")
    return cfg


def point_wise_phase(workdir: str, device, preset: str) -> dict:
    """``point_wise.yaml`` or ``autoencoder.yaml`` at its width (512
    channels, GT mappers of 16 heads, a point-wise processor) on the
    ``encoder_decoder_only`` graph (no processor edges): ``cli train`` 3
    steps and ``cli predict`` 2 steps."""
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    path = os.path.join(PACKAGED_CONFIG_DIR, f"{preset}.yaml")
    graph_file = os.path.join(workdir, "graph_encoder_decoder_only.npz")
    overrides = [f"graph.save_path={graph_file}", LR_ONLY]
    layers = {"point_wise": 4, "autoencoder": 2}[preset]
    composed_preset(path, overrides, {
        "model.num_channels": 512, "model.processor.name": "PointWiseMLPProcessor",
        "model.processor.num_layers": layers, "model.encoder.num_heads": 16,
        "model.decoder.num_heads": 16, "task.name": {"point_wise": "forecaster",
                                                     "autoencoder": "autoencoder"}[preset]})
    train, run_dir, _ = family_train(
        workdir, device, preset, path, overrides, FAMILY_STEPS,
        lambda t: expected_launches(t.config, t.graph, 0))
    if "hidden->hidden" in train["edges"]:
        raise RuntimeError(f"{preset}: the graph has processor edges: {train['edges']}")
    predict = family_predict(workdir, device, preset, run_dir, 2)
    result = {"train": train, "predict": predict}
    print(f"[{preset}] {json.dumps(result)}", flush=True)
    return result


def downscaler_phase(workdir: str, device) -> dict:
    """``temporal_downscaler.yaml`` at its width (the ``graphtransformer``
    model: 1024 channels, 16 layers, 16 heads, ``n_step_output`` 2, the
    ``multi_scale`` graph) through ``cli train``, 3 steps, with
    ``PerTimestepMetrics`` (the ``t_1``, ``t_2`` records); then
    ``temporal_downscaler_ensemble.yaml`` (512 channels, 4 members), 2
    steps."""
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    graph_file = os.path.join(workdir, "graph.npz")  # phase 9's multi_scale graph
    path = os.path.join(PACKAGED_CONFIG_DIR, "temporal_downscaler.yaml")
    overrides = [f"graph.save_path={graph_file}",
                 "diagnostics.callbacks=[{name: LearningRateMonitor}, {name: PerTimestepMetrics}]"]
    composed_preset(path, overrides, {
        "model.num_channels": 1024, "model.processor.num_layers": 16,
        "model.processor.num_heads": 16, "model.n_step_input": 2, "model.n_step_output": 2,
        "training.task": "temporal_downscaler"})
    train, _, val = family_train(workdir, device, "downscaler", path, overrides, FAMILY_STEPS,
                                 lambda t: expected_launches(t.config, t.graph, FLAGSHIP_LAYERS))
    per_timestep = {k: v for k, v in val.items() if "/t_" in k}
    if not per_timestep or {k.rsplit("/", 1)[1] for k in per_timestep} != {"t_1", "t_2"}:
        raise RuntimeError(f"downscaler: the validation record has no t_1/t_2 keys: {val}")
    print(f"[downscaler] validation by output step: {json.dumps(per_timestep)}", flush=True)

    path = os.path.join(PACKAGED_CONFIG_DIR, "temporal_downscaler_ensemble.yaml")
    overrides = [f"graph.save_path={graph_file}", LR_ONLY]
    composed_preset(path, overrides, {
        "model.name": "AnemoiEnsModelEncProcDec", "model.num_channels": 512,
        "model.processor.num_layers": 16, "model.n_step_output": 2,
        "training.ensemble_size": MEMBERS, "training.task": "temporal_downscaler"})
    ens, _, _ = family_train(workdir, device, "downscaler ensemble", path, overrides,
                             FAMILY_STEPS - 1,
                             lambda t: expected_launches(t.config, t.graph, FLAGSHIP_LAYERS))
    result = {"train": train, "per_timestep_metrics": per_timestep, "ensemble": ens}
    print(f"[downscaler] {json.dumps(result)}", flush=True)
    return result


def gnn_phase(workdir: str, device) -> dict:
    """The GNN model (``model: gnn`` on ``graph: multi_scale``, from a config
    file's ``defaults:`` list) at ``gnn.yaml``'s width (512 channels, 16
    layers): ``cli train`` 3 steps and ``cli predict`` 2 steps, none of the
    seven kernels launched, the device time of both split by kernel; then, cut to 2 layers of 64 channels on the same
    graph, its float32 forward and gradient on the card against the same on
    the CPU (the same weights and batch)."""
    cfg_path = os.path.join(workdir, "gnn.yaml")
    with open(cfg_path, "w") as f:
        f.write(GNN_DEFAULTS)
    overrides = [f"graph.save_path={os.path.join(workdir, 'graph.npz')}", LR_ONLY]
    composed_preset(cfg_path, overrides, {
        "model.num_channels": 512, "model.processor.name": "GNNProcessor",
        "model.processor.num_layers": 16, "model.encoder.name": "GNNForwardMapper"})
    train, run_dir, _ = family_train(workdir, device, "gnn", cfg_path, overrides, FAMILY_STEPS,
                                     lambda t: dict(NO_LAUNCHES), attention=False, split=12)
    predict = family_predict(workdir, device, "gnn", run_dir, 0, split=12)
    card_cpu = gnn_card_against_cpu(cfg_path, overrides, device)
    result = {"train": train, "predict": predict, "card_vs_cpu": card_cpu}
    print(f"[gnn] {json.dumps(result)}", flush=True)
    return result


def gnn_card_against_cpu(cfg_path: str, overrides: list, device) -> dict:
    """The GNN at 2 layers of 64 channels on the ``multi_scale`` graph, float32:
    one forward and one step's gradient on the card against the CPU's, the
    same weights and batch (relative L2 <= ``CARD_CPU_TOL``): the card's
    gathers and float32 ``index_add_`` sums against their CPU path."""
    from anemoi_tpu_torch.graphs.graph import Graph
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface
    from anemoi_tpu_torch.training.step import TrainState, make_step_fns
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config

    cfg = load_config(cfg_path, overrides + ["model.num_channels=64",
                                             "model.processor.num_layers=2",
                                             "model.inference_precision=fp32"],
                      search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    graph = Graph.load(cfg["graph"]["save_path"])
    batch = training_batch(graph, device)
    out, grads, losses = {}, {}, {}
    state_dict = None
    for where in (torch.device("cpu"), device):
        iface = AnemoiModelInterface(config=cfg, graph=graph, data_indices=flagship_indices(),
                                     statistics=flagship_statistics(SEED), device=where,
                                     training=True)
        if state_dict is None:
            state_dict = {k: v.clone() for k, v in iface.state_dict().items()}
        iface.load_state_dict(state_dict, strict=True)
        data = {"data": batch["data"].to(where)}
        with torch.no_grad():
            _, x = iface.normalised_input(data)
            out[where.type] = iface.run_model(x)["data"].cpu()
        train_step, _ = make_step_fns(iface, training_losses(graph), rollout=1, precision="fp32")
        losses[where.type] = float(train_step.compute_gradients(TrainState(0, iface, None), data))
        grads[where.type] = flat_grads(iface).cpu()
        del iface, train_step
    gaps = {"forward": ((out["cuda"] - out["cpu"]).norm() / out["cpu"].norm()).item(),
            "gradient": ((grads["cuda"] - grads["cpu"]).norm() / grads["cpu"].norm()).item()}
    print(f"[gnn] 2 layers, 64 channels, float32, card vs CPU: relative L2 forward "
          f"{gaps['forward']:.3e}, gradient {gaps['gradient']:.3e} (tol {CARD_CPU_TOL}); loss "
          f"{losses['cuda']} / {losses['cpu']}", flush=True)
    if not all(g <= CARD_CPU_TOL for g in gaps.values()):
        raise RuntimeError(f"gnn: the card disagrees with the CPU: {gaps}")
    torch.cuda.empty_cache()
    return {**gaps, "losses": losses}


def report(kernel_rows: dict, serving: dict, training: dict, t_serving: dict,
           t_training: dict, trainer: dict, predict: dict, remat: dict, presets: dict,
           ens: dict, families: dict) -> dict:
    """One entry per kernel.  Headline numbers, bf16: for K1-K5 the
    processor edge set (16 of the 18 launches per flagship step), with the
    flagship's fused edge projection for the backward kernels; for K6 and
    K7 the Transformer preset's processor shape.  ``launches`` is each
    kernel's count on the path it serves (``path_of``): the flagship's
    2-step forecast for K1 and K2, its training step for K3 and K4, its
    ``paged_fused_bwd`` training step for K5, the Transformer's 2-step
    forecast for K6 and its training step for K7; ``launches_by_path`` has
    these five, the packaged example's trainer step and 2-step
    ``predict``, each remat variant's flagship step (``remat: <variant>``)
    the YAML preset's trainer step at rollout 2, the ensemble's step and
    ``predict_step``, and each family path's training step and 2-step
    ``cli predict`` (phases 16-19)."""
    by_path = {"serving_2_steps": serving["launches"], "training_step": training["launches"],
               "training_step_fused_bwd": training["fused_bwd"]["launches"],
               "example_trainer_step": trainer["launches_per_step"],
               "example_predict_2_steps": predict["launches"],
               "transformer_serving_2_steps": t_serving["launches"],
               "transformer_training_step": t_training["launches"],
               **{f"remat: {label}": r["launches"] for label, r in remat.items()},
               "example_yaml_trainer_step_rollout_2": presets["launches_per_step"],
               "ensemble_train": ens["launches_per_step"],
               "ensemble_predict": ens["predict"]["launches"],
               "point_wise_train": families["point_wise"]["train"]["launches_per_step"],
               "point_wise_predict_2_steps": families["point_wise"]["predict"]["launches"],
               "autoencoder_train": families["autoencoder"]["train"]["launches_per_step"],
               "autoencoder_predict_2_steps": families["autoencoder"]["predict"]["launches"],
               "downscaler_train": families["downscaler"]["train"]["launches_per_step"],
               "downscaler_ensemble_train":
                   families["downscaler"]["ensemble"]["launches_per_step"],
               "gnn_train": families["gnn"]["train"]["launches_per_step"],
               "gnn_predict_2_steps": families["gnn"]["predict"]["launches"]}
    path_of = {"K1": "serving_2_steps", "K2": "serving_2_steps", "K3": "training_step",
               "K4": "training_step", "K5": "training_step_fused_bwd",
               "K6": "transformer_serving_2_steps", "K7_dq": "transformer_training_step",
               "K7_dkv": "transformer_training_step"}

    def headline(r):
        return (r["dtype"] == "bfloat16" and r.get("edge_set", "hidden->hidden") == "hidden->hidden"
                and r.get("fused_edge", True) and r.get("case", "main") == "main"
                and r.get("hd", HD) == HD and r.get("batch", 1) == 1)

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
            # K1-K3 and K6/K7: the kernel's design, its instantiation's ptxas
            # registers and spills, and its time back to back
            **{key: head[key] for key in ("ms_back_to_back", "instantiation", "registers",
                                          "spill_stores", "spill_loads")
               if key in head},
            **({"route_detail": head["route"]} if "route" in head else {}),
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
    phase_seconds = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_seconds[name] = time.perf_counter() - t
        print(f"[phase] {name}: {phase_seconds[name]:.2f} s", flush=True)
        return out

    rows = phase("kernels", kernel_phase, graph, device)
    for name, extra in phase("backward", backward_phase, graph, device).items():
        rows.setdefault(name, []).extend(extra)
    wide_rows, wide = phase("wide GT", gt_wide_phase, graph, device)
    for name, extra in wide_rows.items():
        rows[name] += extra
    rows.update(phase("window", window_phase, device))
    serving = phase("serving", serving_phase, graph, device)
    training = phase("training", training_phase, graph, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        trainer = phase("trainer", trainer_phase, workdir, training)
        predict = phase("predict", predict_phase, workdir)
        layers = TRANSFORMER_LAYERS
        t_serving = phase("transformer serving", serving_phase, graph, device,
                          transformer_config(num_layers=layers), {"K1": 2, "K6": layers},
                          "transformer serving")
        t_training = phase("transformer training", transformer_training_phase, graph, device)
        remat = phase("remat", remat_phase, graph, device)
        presets = phase("presets", presets_phase, workdir)
        ens = phase("ensemble", ensemble_phase, workdir, device)
        families = {
            "point_wise": phase("point_wise", point_wise_phase, workdir, device, "point_wise"),
            "autoencoder": phase("autoencoder", point_wise_phase, workdir, device,
                                 "autoencoder"),
            "downscaler": phase("downscaler", downscaler_phase, workdir, device),
            "gnn": phase("gnn", gnn_phase, workdir, device),
        }
    rep = report(rows, serving, training, t_serving, t_training, trainer, predict, remat, presets,
                 ens, families)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "build_seconds": seconds, "phase_seconds": phase_seconds,
                       "serving": serving,
                       "training": training, "trainer": trainer, "predict": predict,
                       "transformer_serving": t_serving,
                       "transformer_training": t_training, "remat": remat, "presets": presets,
                       "ensemble": ens, "families": families,
                       "wide_gt_errors": wide, **rep},
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
