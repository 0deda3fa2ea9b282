"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--json PATH]

Phases (any failure exits non-zero, with no result line; widths are the
models' own; phases 13-15, 18-22 and 24-33 and phase 34's profiled and
MLflow runs cut their processors to ``CUT_LAYERS`` = 2 of their 16 layers,
so that the whole run stays well inside its time limit on a slow host;
phases 7-12, 16-17, 23, 34's other parts and 35 run at full depth):
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
                  K4 alone against ``gt_attention_bwd_src_plain`` of K3's dkv
                  (every K4 row, in every phase: its edgeless sources'
                  rows exactly 0); each kernel timed beside its byte bound
                  and its plain version (K3, K5: the whole plain backward),
                  K4 also beside one index_add_; K3, K4 and K5 also back to
                  back (K4's index_add_ too), each with its route and its
                  instantiation's ptxas registers and spills; bf16 K3, K4
                  and K5 run twice at the processor edge set with the fused
                  projection must agree bit for bit (K3: dq, dkv, dW,
                  dbias; K4 and K5: dk, dv);
  5. wide GT   -- K1, K3 + K4 and K3 + K5 against their plain versions at HD
                  = 1024 (16 heads of 64, the Transformer preset's mappers)
                  on the data->hidden and
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
 13. remat     -- the flagship (2 layers) through ``make_step_fns`` on one
                  interface (the same weights) in each remat variant:
                  per-layer remat off, ``save_attention`` and ``full`` at
                  rollout 1; no
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
                  ``cli train`` on that YAML (2 layers) over phase 9's
                  store at rollout 2 with the packaged remat defaults (3
                  steps: finite records, exactly 16 K1, 8 K3 and 8 K4 a
                  step);
                  ``cli evaluate --rollout 2`` on it;
 15. ensemble  -- the ensemble CRPS preset (AIFS-ENS) at its own width:
                  ``ensemble_crps.yaml`` (``AnemoiEnsModelEncProcDec``,
                  ``NoiseConditioning``, conditional processor norms,
                  ``KernelCRPS``, 512 channels, 16 heads, the
                  ``multi_scale`` graph, 4 members; 2 layers) through ``cli
                  train`` over phase 9's store, bf16, 3 steps: finite
                  records, exactly 4 K1, K3 and K4 and no other kernel in
                  every step;
                  the trained step's gradient against the plain attention
                  (same weights and noise seed, relative L2 <= 1e-2); wall,
                  device ms and peak memory of the step; ``predict_step`` on
                  a window tiled to the 4 members: [1, 1, 4, 40320, 11],
                  finite, exactly 4 K1, relative L2 <= 2e-2 against the
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
                  channels, 16 heads, the ``multi_scale`` graph, 2 output
                  steps; 2 layers) through ``cli train``, 3 steps: exactly 4
                  K1, 4 K3 and the K4/K5 of the ``fused_backward`` rule a
                  step; the gradient gate; a validation record with
                  ``PerTimestepMetrics``' ``t_1`` and ``t_2`` keys; then
                  ``temporal_downscaler_ensemble.yaml`` (512 channels, 4
                  members: B·M = 4 rows), 2 steps, the same counts and gate;
 19. gnn       -- the GNN model (``model: gnn`` on ``graph: multi_scale``
                  from a config file's ``defaults:`` list) at ``gnn.yaml``'s
                  width (512 channels; 2 layers): ``cli train`` 3 steps and
                  ``cli predict`` 2 steps, finite, none of the seven kernels
                  launched; then at 2 layers of 64 channels on the same
                  graph, its float32 forward and gradient on the card
                  against the CPU's (same weights and batch, relative L2
                  <= 1e-4);
 20. lam       -- ``lam.yaml`` at its width (the ``graphtransformer`` model:
                  1024 channels, 16 heads, 2 layers; the ``limited_area``
                  graph: ``LimitedAreaTriNodes`` ico-5 clipped to the o96
                  grid with a 300 km margin; the loss masked to the
                  ``cutout_mask`` area) through ``cli train`` over phase 9's
                  store, 3 steps: the hidden node count and each edge set's
                  count and degree ranges, exactly 4 K1, 4 K3 and the K4/K5
                  of the ``fused_backward`` rule a step, the gradient gate;
                  then one rollout-2 step under the packaged rollout remat
                  (exactly twice the launches, K1 twice more: the rollout
                  checkpoint recomputes the forward) and, through the port's
                  ``advance_input`` on the card, the second model step's
                  input: outside the area the normalised truth bit for bit,
                  inside the prediction; ``cli predict`` 2 steps (6 K1 a
                  step, relative L2 <= 2e-2 against the plain attention);
                  wall, device ms and peak memory of each;
 21. stretched -- ``stretched.yaml`` at its width (1024 channels; 2 layers;
                  the ``stretched_grid`` graph: ico-4 outside and ico-6
                  inside a 20 degree cap, KNN-8 processor edges) with
                  AdEMAMix and ``[InputImputer (mean), InputNormalizer]``
                  over phase 9's fields written in the npy layout with
                  ``t_850`` NaN on a lat/lon box partly inside the area
                  (statistics from ``np.nanmean``/``np.nanstd``): as phase
                  20, and the imputer's loss mask 0 at exactly the NaN
                  points and 1 elsewhere, AdEMAMix's three float32 moments
                  per parameter; the device time of the step by kernel;
 22. transport -- the transport family at the presets' width (512
                  channels, 16 heads; 2 layers; phase 9's ``multi_scale``
                  graph and store, bf16): ``transport_edm_diffusion.yaml``
                  and ``transport_stochastic_interpolant_tendency.yaml``
                  through ``cli train``, 3 steps each with no callbacks:
                  finite records, exactly 4 K1, 4 K3 and the K4/K5 of the
                  ``fused_backward`` rule a step, the gradient gate; on the
                  trained model in bf16, one evaluation at each end of the
                  noise range (sigma_max and sigma_min; t = 0 and 1) and a
                  4-step sample from one generator, each within relative L2
                  2e-2 of the plain attention; one evaluation's launches (6
                  K1) and times; then ``cli predict --seed 7`` at the
                  presets' 20 sampling steps: 2 forecast steps of
                  ``edm_heun`` (39 evaluations, 156 K1 a step) and 1 of
                  ``vf_heun`` (40, 160 K1), finite, equal bit for bit to an
                  in-process ``make_transport_forecast_fn`` with a generator
                  seeded 7, the gap to the plain attention's forecast
                  printed; wall and device ms and peak memory of each;
 23. hierarchical -- ``hierarchical.yaml`` and
                  ``hierarchical_autoencoder.yaml`` at their width (the
                  V-cycle: 512 channels, 16 heads, 2 layers a level, the
                  packaged o96 -> ico-5 -> ico-3 graph) through ``cli train``
                  over phase 9's store, bf16, 3 steps each (the forecaster
                  with the default diagnostics, the autoencoder with the
                  rate monitor alone, as phase 17): finite records, exactly
                  the 10 K1, 10 K3, 10 K4 and no K5 a step that
                  ``hierarchical_launches`` computes from the config and the
                  graph, the gradient gate; ``cli predict`` 2 steps (10 K1
                  a step), equal bit for bit to the in-process forecast and
                  within relative L2 2e-2 of the plain attention; the
                  graph's edge counts and degree ranges; K3 + K4 at the
                  down set (hidden_1 -> hidden_2, 1 926 edges: 8 316 of the
                  10 242 sources have none) against the plain backward,
                  float32 and bfloat16, the dk and dv rows of those sources
                  exactly 0, timed as in phase 4; a fixed-batch step at
                  ``level_channel_ratio`` 2 (hidden_2 and the down and up
                  mappers at 1024 channels): the same counts, the gradient
                  gate; wall, device ms and peak memory of each;
 24. spectral  -- ``ReducedSHT`` octahedral at n = 96 (``lmax`` 95) on the
                  card: a band-limited field (l <= 95, m <= 9) through
                  synthesis, analysis and synthesis within rtol 1e-4 / atol
                  1e-5, the coefficients of 12 random fields against the
                  port's CPU transform (<= 1e-4 of the largest), analysis
                  and synthesis timed; then the example (phase 9's graph,
                  2 layers) in a fixed-batch bf16 step with
                  ``CombinedLoss`` (MSE + ``SpectralAMSELoss`` on
                  ``octahedral_sht``, n 96) and
                  ``residual: SpectralOrnsteinConnection`` (octahedral, 96),
                  the store's points checked to be the O96 rings in order:
                  exactly 4 K1, K3 and K4, the gradient gate, device ms
                  beside the same step with the MSE and the plain skip;
 25. projections -- the example at its width (2 layers) with a
                  ``truncation`` node set (o32, 5 248 nodes, KNN-3 both
                  ways weighted by ``GaussianDistanceWeights`` l1) in its
                  graph, ``residual:
                  TruncatedConnection`` and ``MultiscaleLossWrapper`` (the
                  preset's area- and variable-weighted MSE, native weight 1,
                  one scale onto ``hidden`` through the data -> hidden set
                  at 0.5) through ``cli train`` over phase 9's store, bf16, 3
                  steps: 4/4/4/0 a step, the gradient gate; the trained
                  model's three projectors on the card against the CPU
                  (float32 and bf16 inputs, <= 1e-5 of the largest value,
                  projection and input gradient), twice bit for bit, timed;
                  ``cli predict`` 2 steps, bit for bit with the in-process
                  forecast; a fixed-batch step with the projections beside
                  the same step with the MSE and the plain skip (device ms);
 26. dynamic   -- the example (2 layers) with ``DynamicKNN`` (k 3) on the
                  encoder and the decoder (runtime sets of 30 726 and 120 960
                  edges, built on the card every forward): ``cli train`` 3
                  steps, 4/4/4/0 a step, the gradient gate; the runtime sets
                  against a host KNN of the same coordinates (destinations
                  that differ, each a near tie), the device ``SourceOrder``
                  equal to the host one, the tables' build ms; K3 + K4 at the
                  encoder's runtime set (9 978 of the 40 320 sources
                  edgeless) against the plain backward and ``index_add_``,
                  as phase 23's down set; ``cli predict`` 2 steps bit for
                  bit with the in-process forecast, and within the serving
                  gate of the same weights on a static graph holding the
                  runtime sets (the gap to the static KNN-3 graph, whose
                  sets differ at ties, printed);
 27. transformer mappers -- the example (2 layers) with
                  ``TransformerForwardMapper`` /
                  ``TransformerBackwardMapper`` (dense cross attention, 16
                  heads) around its GT processor: SDPA (flash /
                  memory-efficient) against the plain cross attention at
                  o32 -> ico-3 both ways (forward relative L2 <= 1e-4 in
                  float32, 2e-2 in bf16; dq, dk, dv <= 1e-2); ``cli train`` 3
                  steps, 2/2/2/0 a step, the gradient gate, each mapper's
                  bf16 forward and forward + backward at full shape with its
                  peak memory; ``cli predict`` 2 steps (2 K1 a step) bit for
                  bit with the in-process forecast;
 28. hex       -- the ``graphtransformer`` model at its width (1024
                  channels, 16 heads; 2 layers) on ``graph/hex_mesh.yaml``
                  (o96 -> ``HexNodes`` r5, ``MultiScaleEdges`` x_hops 2)
                  through ``cli train`` over phase 9's store, bf16, 3 steps:
                  the graph's node and edge counts (40 320 / 20 480; 41 704
                  / 245 700 / 120 960 edges), degree ranges and edgeless
                  sources, exactly 4 K1, K3 and K4 and no K5 a step, the
                  gradient gate; K3 + K4 at the encoder set (6 764 of the
                  40 320 sources edgeless) at HD 1024 against the plain
                  backward and ``index_add_``, timed as in phase 23; ``cli
                  predict`` 2 steps (4 K1 a step) bit for bit with the
                  in-process forecast; wall, device ms and peak memory;
 29. healpix   -- as phase 28 with ``HEALPixNodes`` r5 (nested) and
                  ``HEALPixMultiScaleEdges`` (12 288 hidden nodes; 48 880 /
                  130 568 / 120 960 edges), without the encoder rows;
 30. icon      -- ``graph/icon_mesh.yaml`` on a synthetic ICON grid the
                  phase writes (``write_synthetic_icon_grid`` r6,
                  ``max_level`` 5: 81 920 cells, 10 242 vertices; 245 760 /
                  81 900 / 245 760 edges) with a synthetic dataset on its
                  cells: as phase 28, but 4 K1, 4 K3, 2 K4 and 2 K5 a step
                  (the 2 GB rule picks the fused backward for both mappers at
                  1024 channels), and at the encoder set K3 + K4 and K3 + K5;
 31. parallel  -- data and halo model parallelism over ranks that share the
                  card (``parallel/distributed.spawn``; more ranks than
                  cards: gloo, whose collectives take the CUDA tensors; one
                  world of 2 ranks and one of 4, which also run phases 32
                  and 33's rank parts, one start-up each): the
                  flagship (512 channels, 16 heads, its processor cut to
                  ``CUT_LAYERS`` = 2 layers, ``shard_strategy:
                  edges``) on a model group of 2 against
                  one process on the same weights and batches: float32
                  step-1 gradients and 2-step forecast within relative L2
                  1e-4, bf16 within 1e-2 and 2e-2; every rank's K1, K3 and
                  K4 exactly ``halo_calls`` a training step (interior and
                  boundary rows of each GT layer) and K1 ``halo_calls`` a
                  forecast step, no K5; 3 timed bf16 steps a rank (wall ms
                  marked as gloo on one shared card), each rank's peak
                  memory beside one process's, each exchange's rows and
                  bytes; K1 and K3 + K4 on the processor set of shard 2 of
                  2 (14 padded edgeless destinations, edgeless halo rows)
                  against the plain op, edgeless rows exact; data 2 x model
                  2 (4 ranks) float32 losses of 2 steps against one process
                  at batch 2 (relative 1e-4; a constant rate, so that the
                  first update moves the weights); ``cli train`` with
                  ``num_devices_per_model: 2`` (the example on the
                  flagship's graph, 2 layers, 2 steps, its own ranks) and
                  ``cli predict`` of its bundle on one device (4 K1 a step); a
                  one-rank NCCL group in that world: an all-reduce of a
                  CUDA tensor and a training step reduced over it; the
                  seconds of each part;
 32. parallel families -- the rest of item 9 over ranks that share the
                  card (gloo), each part against one process on the same
                  weights and batches (step-1 gradients and the part's
                  forecast, float32 within relative L2 1e-4, bf16 within
                  1e-2 and 2e-2: phase 31's gates), every rank's
                  launches exactly ``family_launches`` a training step and
                  a forecast, 2 timed bf16 steps a rank (wall ms marked as
                  gloo on one shared card), peak memory beside one
                  process's, the bytes each rank sends: on a model group of
                  2 the flagship (512 channels, 16 heads) and the
                  Transformer preset (1 024 channels, w 512), their
                  processors and the transport and ensemble models' cut to
                  ``CUT_LAYERS`` = 2 layers,
                  under ``shard_strategy: heads`` (Ulysses: 2 + 2 K1/K3/K4
                  a flagship step; 2 K6/K7 a Transformer step on 8 heads
                  over the whole mesh), the ``transport_edm_diffusion`` model
                  under ``edges`` (its training step; one generative
                  forecast step of 4 EDM-Heun sampling steps, not the
                  preset's 20: 7 evaluations), the ``hierarchical`` V-cycle
                  under ``edges`` on phase 23's graph; the
                  ``ensemble_crps`` model's 4 members on ensemble 2 x model
                  2 (4 ranks, 2 members a rank: its CRPS step and
                  ``predict_step``); ``cli train ensemble_crps.yaml`` with
                  ``hardware.num_devices_per_ensemble: 2`` (2 layers, as
                  phase 15; 2 steps, its first loss within 2e-2 of phase
                  15's one process); K1 and
                  K3 + K4 on 8 of 16 heads (HD 256) at the processor set
                  and K6/K7 on 8 of 16 heads at N 10 242, each against its
                  plain op and timed beside its bound; K3 + K4 at model
                  shard 2 of 2 of the V-cycle's down set, dk and dv exactly
                  0 on its edgeless and padded rows; the seconds of each
                  part;
 33. parallel routes -- the rest of item 9 over ranks that share the card
                  (gloo), as phase 32 (phase 31's gates against one process,
                  every rank's launches exactly ``family_launches``, 2
                  timed bf16 steps a rank, peak memory, the bytes each rank
                  sends), on a model group of 2 at each model's width
                  (the processors at ``CUT_LAYERS`` = 2 layers): the
                  flagship with ``SpectralOrnsteinConnection`` and
                  ``CombinedLoss`` (MSE + ``SpectralAMSELoss``, O96), the
                  flagship with ``TruncatedConnection`` and the multiscale
                  loss (an o32 ``truncation`` set), the Transformer preset
                  under ``edges`` (the band halo: 2 K6/K7 a step on the
                  rank's extended block), the GNN model (no kernel), the
                  flagship with dense Transformer mappers, with
                  ``DynamicKNN`` mappers (the runtime sets of the rank's
                  destinations), the ``point_wise`` preset's model under
                  ``gspmd``, the ``hierarchical`` V-cycle under ``heads``
                  on phase 23's graph; ``transport_edm_diffusion``'s model
                  on an ensemble group of 2 (replicas: their parameters
                  equal after the steps, the first loss one process's);
                  K6 and K7 on rank 0's extended block (5 640 of 10 242
                  rows) against the plain op, timed beside the bound and
                  SDPA with the band mask; the seconds of each part;
 34. auxiliary -- the auxiliary modules through the CLI (``[auxiliary]``, each
                  part's seconds): (a) a copy of the committed round-2
                  bundle ``tests/fixtures/inference_ckpt_r2`` (one migration
                  pending) through ``cli checkpoint migrate``, then ``cli
                  predict`` 2 steps on the card and with ``--platform cpu``,
                  in float32 (relative L2 <= 1e-4) and in the bundle's bf16
                  (the serving gate): 6 K1 on the card, none on the CPU; an
                  unmigrated copy through ``load_inference_checkpoint`` on
                  the card, the same forecast bit for bit; (b) ``cli train``
                  of phase 9's config 3 steps through ``[local <phase 9's
                  bundle>, weights_only, freeze [encoder]]``: the weights
                  equal to its ``params.pt`` before step 1, the encoder's
                  bit for bit and every processor tensor moved after step
                  3, 18 K1, K3 and K4 a step; (c) ``cli profile`` 20 steps
                  with ``--trace --benchmark-store``: the four reports, the
                  peak bytes above 0 beside the card's name, K1, K3 and K4
                  named in the trace, the store's numbers those of the
                  report, 4 K1, K3 and K4 a step (2 layers); ms a step and
                  peak bytes with the card line; (d) ``cli train`` 2 steps
                  (2 layers) with the
                  ``mlflow_offline`` logger: its losses those of
                  ``metrics.jsonl``, system samples with the card's memory;
                  (e) ``cli validate`` of every packaged preset (exit 0) and
                  of one with a bad ``training.rollout`` (exit 1);
 35. presets left -- the packaged presets no earlier phase runs, at their
                  width, bf16: ``multi.yaml`` (o96 ``era`` and o48 ``obs``,
                  synthetic, into one ico-5 mesh; 1024 channels, 16 layers,
                  16 heads; an encoder and a decoder a dataset; edge sets of
                  62 980 / 17 548 / 81 900 / 120 960 / 32 832 edges) through
                  ``cli train`` 3 steps with no callbacks: 20 K1, 20 K3, 20
                  K4 and no K5 a step (K5 nowhere: no mapper set crosses the
                  2 GB rule at 1024 channels), the gradient gate; ``cli
                  predict`` 2 steps (20 K1 a step), each dataset's forecast
                  bit for bit with the in-process one and within relative L2
                  2e-2 of the plain attention; K3 + K4 at the two o48 sets
                  at HD 1024 against the plain backward, timed; ms a step
                  and peak bytes with the card line; then
                  ``transport_edm_diffusion_tendency.yaml`` and
                  ``transport_stochastic_interpolant.yaml`` at their 16
                  layers, trained and served as phase 22 trains and serves
                  its two (3 steps, 18 K1/K3/K4 a step, the gradient,
                  evaluation and 4-step sample gates; ``cli predict`` 1
                  forecast step at 20 sampling steps, 18 K1 a model
                  evaluation, bit for bit with the in-process forecast);
 36. report    -- one JSON line {"kernels": [...]} (K1-K7, K7 as K7_dq and
                  K7_dkv; each kernel's ``launches`` counted on its path:
                  ``path_of`` in ``report``; ``launches_by_path`` also each
                  remat variant's, the YAML preset's, the ensemble's
                  training step and ``predict_step``, phases 16-19's
                  training steps and forecasts, phases 20-21's training
                  steps, rollout-2 steps and forecasts, phase 22's
                  training steps and generative forecasts, phase 23's
                  training steps, forecasts and ratio-2 step and phase 24's
                  two steps, phases 25-30's training steps and forecasts,
                  phase 31's rank-0 training step and forecast, phases
                  32's and 33's rank-0 training step and forecast of each
                  part, phase 34's migrated fixture's forecast, pipeline
                  step and profiled step, phase 35's training steps and
                  forecasts;
                  the K1 row also model shard 2 of 2's processor set and
                  the head subset's, the K3 and K4 rows those sets', the
                  down set's and its shard's, the two o48 sets of
                  ``multi``, the dynamic encoder set's and
                  the hex and ICON encoder sets', the K5 row the ICON
                  encoder set's, the K6 and K7 rows the head subset's and
                  the extended block's), the
                  card line, and
                  last {"ok": true, "device": {...}}; with --json, the same
                  and the serving and training details also go to PATH.

Launch counts come from ``anemoi_tpu_torch.kernels.launch_counts()`` (all
seven kernels), set to 0 just before each path runs (in the trainer phase,
before each of its training steps); each path's ``want`` dict lists every
kernel, the ones it must not launch at 0.  Every phase prints its seconds.
Phases 9-35 share one temporary working directory; once a phase has passed,
the directories it made there (its trainers' checkpoints and bundles) are
removed, all but phase 9's run and store, which later phases read.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import shutil
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
SUM_ROUTE = ("CUDA cores, 16-byte vectors a lane, several sources a block, grid-stride over "
             "sources and batch rows, the dkv rows of 4 edges loaded before they are added")
DST_BUILDS = {"K1": ("gt_attention_fwd", "gt_attention_fwd_kernel", FWD_ROUTE),
              "K2": ("gt_attention_fwd", "gt_attention_fwd_kernel", FWD_ROUTE),
              "K3": ("gt_attention_bwd", "gt_attention_bwd_dst_kernel", DST_ROUTE),
              "K4": ("gt_attention_bwd", "gt_attention_bwd_src_sum_kernel", SUM_ROUTE),
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


def attention_bound(n_dst, n_src, n_edges, n_feat, elt, fused, hd=HD, batch=1, heads=HEADS):
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
        + batch * 4 * n_dst * heads  # lse
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


def backward_bounds(n_dst, n_src, n_edges, n_feat, elt, fused, hd=HD, batch=1, heads=HEADS):
    """{kernel: (bound_ms, bound_by)} of K3, K4 and K5 of width ``hd`` over
    ``batch`` rows as the training path launches them: each input read once,
    each output written once.  K3 writes dq, the per-edge dkv [B, E, 2HD]
    and, for projected edges, their float32 gradient [E, HD] (summed over
    the rows), or, with the projection fused, dW and dbias (the flagship's
    raw attributes are constants: no d_attr); K4 reads dkv back and writes
    dk, dv; K5 reads K3's inputs plus the source-ordered view and writes dk,
    dv; K3 beside K5 writes no dkv.  Operations per edge, channel and row:
    K3 12 (+ 4F for the projection and dW), K4 2, K5 12 (+ 2F)."""
    node_in = batch * (2 * n_dst * hd * elt + 2 * n_src * hd * elt)  # q, g; k, v
    stats = batch * 2 * 4 * n_dst * heads  # lse, delta (float32)
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
        "K3 (no dkv)": bound(k3 - dkv, per_edge * (12 + (4 * n_feat if fused else 0))),
        "K4": bound(k4, per_edge * 2),
        "K5": bound(k5, per_edge * (12 + (2 * n_feat if fused else 0))),
    }


def dst_build(kernel, dtype, d, n_feat, fused) -> dict:
    """Route, ptxas registers and spill bytes of the instantiation of
    ``kernel`` (K1, K2, K3 or K5) that a launch of ``dtype`` at head size
    ``d`` with ``n_feat`` edge features takes."""
    from anemoi_tpu_torch.kernels.gt_attention import dst_instantiation

    vec, fmax = dst_instantiation(dtype, d, n_feat, fused)
    return group_build(kernel, f"I{type_name(dtype)}Li{vec}ELb{int(fused)}ELi{fmax}EE")


def k4_build(dtype, hd) -> dict:
    """Route, ptxas registers and spill bytes of the K4 instantiation that a
    launch of ``dtype`` at width ``hd`` takes (V channels a lane)."""
    from anemoi_tpu_torch.kernels.gt_attention import src_sum_vector

    return group_build("K4", f"I{type_name(dtype)}Li{src_sum_vector(dtype, hd)}EE")


def type_name(dtype) -> str:
    """The element type as it appears in a mangled kernel name."""
    return "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"


def group_build(kernel, args: str) -> dict:
    """Route, ptxas registers and spill bytes of ``kernel``'s instantiation
    whose mangled template arguments are ``args``."""
    from anemoi_tpu_torch.kernels.build import build_log, ptxas_usage

    lib, stem, route = DST_BUILDS[kernel]
    key = stem + args
    found = [u for entry, u in ptxas_usage(build_log(lib)).items() if key in entry]
    if not found:  # another build of the kernel (an older checkout's)
        route = "unknown: no such instantiation in the build log"
    return {"route": route, "instantiation": key, **(found[0] if found else {})}


def k4_alone(label, dkv, order, src, n_src) -> dict:
    """K4 alone on K3's ``dkv``: against ``gt_attention_bwd_src_plain``
    within ``TOL`` of max|ref| per output and exactly 0 at the sources with
    no edge; timed single and back to back beside its plain version and one
    ``index_add_`` of dkv by source (timed the same two ways); its route,
    registers and spills."""
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.ops.gt_attention import gt_attention_bwd_src_plain

    dtype, (b, _, two_hd) = dkv.dtype, dkv.shape

    def k4():
        return kern.gt_attention_bwd_src(dkv, order.src_ptr, order.src_perm)

    def plain():
        return gt_attention_bwd_src_plain(dkv, order.src_ptr, order.src_perm)

    def library():
        return torch.zeros(b, n_src, two_hd, device=dkv.device, dtype=dtype).index_add_(1, src, dkv)

    edgeless = torch.bincount(src, minlength=n_src) == 0
    err = 0.0
    for name, x, y in zip(("dk", "dv"), k4(), plain()):
        e = (x.float() - y.float()).abs().max().item()
        if not (e <= TOL[dtype] * y.float().abs().max().item() and torch.isfinite(x).all()):
            raise RuntimeError(f"K4 {label} {dtype} {name} against its plain version: max abs "
                               f"err {e:.3e} (tol {TOL[dtype]} of max|ref|)")
        if x[:, edgeless].count_nonzero().item():
            raise RuntimeError(f"K4 {label} {dtype} {name}: not exactly 0 at the "
                               f"{int(edgeless.sum())} sources with no edge")
        err = max(err, e)
    return {"max_abs_err": err, "ms": cuda_ms(k4), "ms_back_to_back": cuda_ms_back_to_back(k4),
            "plain_ms": cuda_ms(plain), "plain_is": "gt_attention_bwd_src_plain",
            "library_ms": cuda_ms(library),
            "library_ms_back_to_back": cuda_ms_back_to_back(library),
            "library_is": "index_add_ of dkv", **k4_build(dtype, two_hd // 2)}


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
    ``gt_attention_bwd_src_plain`` of K3's dkv), each timed single and back
    to back beside its bound, its plain version and (K4) one index_add_,
    timed the same two ways."""
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
    bounds = backward_bounds(n, n, n_e, n_f, 2, True, batch=b)
    plain_ms = cuda_ms(lambda: gt_attention_bwd_plain(q, k, v, ei, HEADS, out, lse, g,
                                                      **edge_kw), reps=5, warmup=1)
    rows["K3"] = [{**base, "max_abs_err": max(v_ for n_, v_ in errs.items()
                                              if n_ not in ("dk", "dv")), "errors": errs,
                   "ms": cuda_ms(k3), "ms_back_to_back": cuda_ms_back_to_back(k3),
                   "plain_ms": plain_ms, "plain_is": "gt_attention_bwd_plain",
                   "bound_ms": bounds["K3"][0], "bound_by": bounds["K3"][1],
                   "library_ms": None}]
    rows["K4"] = [{**base, **k4_alone(f"at B = {b}", dkv, order, src, n),
                   "max_abs_err_dk_dv_vs_plain_backward": max(errs["dk"], errs["dv"]),
                   "bound_ms": bounds["K4"][0], "bound_by": bounds["K4"][1]}]
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
                    # each source's dkv rows are summed by one group in
                    # src_perm order, with no atomics
                    runs = [kern.gt_attention_bwd_src(dkv, order.src_ptr, order.src_perm)
                            for _ in range(2)]
                    if not all(torch.equal(x, y) for x, y in zip(*runs)):
                        raise RuntimeError("bf16 K4 is not deterministic: dk or dv differs")
                    print("[backward] bf16 K4 deterministic: dk, dv of two runs bitwise equal",
                          flush=True)
                    del again, runs
                del first

                # K4 alone: the sum of K3's dkv rows into their sources
                k4 = k4_alone("->".join(key), dkv, order, src, n_src)

                def k3():
                    return kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, HEADS,
                                                     **edge_kw, **path_kw)

                def k5():
                    return kern.gt_attention_bwd_src_fused(
                        q, k, v, g, lse, delta, ei, ptr, order.src_ptr, order.src_perm, HEADS,
                        **edge_kw)

                ms = {
                    "K3": cuda_ms(k3), "K3_b2b": cuda_ms_back_to_back(k3),
                    "K3_no_dkv": cuda_ms(lambda: kern.gt_attention_bwd_dst(
                        q, k, v, g, lse, delta, ei, ptr, HEADS, emit_dkv=False, **edge_kw,
                        **path_kw)),
                    "K4": k4["ms"],
                    "K5": cuda_ms(k5), "K5_b2b": cuda_ms_back_to_back(k5),
                }
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
                    "K4": dict(**k4, max_abs_err_dk_dv_vs_plain_backward=max(
                        errs[(False, "dk")], errs[(False, "dv")])),
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

            k4 = k4_alone(f"HD={WIDE_HD} {'->'.join(key)}", dkv, order, src, n_src)

            def k5():
                return kern.gt_attention_bwd_src_fused(q, k, v, g, lse, delta, ei, ptr,
                                                       order.src_ptr, order.src_perm, HEADS,
                                                       **edge_kw)

            ms = {
                "K1": cuda_ms(lambda: gt_attention_fe(q, k, v, *edge_kw.values(), ei, ptr, HEADS,
                                                      source=order)),
                "K1_b2b": cuda_ms_back_to_back(k1_raw),
                "K3": cuda_ms(k3), "K3_b2b": cuda_ms_back_to_back(k3),
                "K4": k4["ms"],
                "K5": cuda_ms(k5), "K5_b2b": cuda_ms_back_to_back(k5),
            }
            plain = {
                "K1": cuda_ms(lambda: gt_attention_fe(q, k, v, *edge_kw.values(), ei, ptr, HEADS,
                                                      plain=True), reps=10, warmup=2),
                "K3": cuda_ms(lambda: gt_attention_bwd_plain(q, k, v, ei, HEADS, out, lse, g,
                                                             **edge_kw), reps=5, warmup=1),
                "K4": k4["plain_ms"],
            }
            plain["K5"] = plain["K3"]  # both parts of the whole plain backward
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
                "K4": dict(**k4, max_abs_err_dk_dv_vs_plain_backward=max(errs["dk"],
                                                                         errs["dv"])),
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


def window_phase(device, cases=None, label="window", timed=("main",)) -> dict:
    """K6 and K7 against the plain band at the Transformer preset's shape,
    float32 and bfloat16, timed; one ALiBi + softcap case, checked.  Or
    ``cases`` (name -> (B, N, H, D, w, softcap, ALiBi)), those in ``timed``
    timed, printed under ``label``."""
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
    cases = cases or {"main": (WIN_B, WIN_N, WIN_H, WIN_D, WIN_W, None, False),
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
                    raise RuntimeError(f"{label} {case} {dtype} {name}: max abs err {err:.3e}, "
                                       f"max|ref| {scale_ref:.3e} (tol {TOL[dtype]} of max|ref|)")
                errs[name], rel[name] = err, err / scale_ref
            lse_err = (lse - ref_lse).abs().max().item()
            if not lse_err <= 1e-3 * ref_lse.abs().max().item():
                raise RuntimeError(f"{label} {case} {dtype} lse: max abs err {lse_err:.3e}")
            del ref, ref_lse, ref_grads
            base = {"case": case, "dtype": str(dtype).split(".")[-1], "shape": [b, n, h, d],
                    "window": w, "softcap": softcap, "alibi": alibi}
            print(f"[{label}] {base} max abs errors {errs}, over max|ref| {rel}, "
                  f"lse {lse_err:.3e}", flush=True)
            if case not in timed:
                continue
            if dtype == torch.bfloat16:  # each block alone writes its rows: bitwise repeatable
                again = (*wkern.window_attention_fwd(q, k, v, w),
                         wkern.window_attention_bwd_dq(q, k, v, g, lse, delta, w),
                         *wkern.window_attention_bwd_dkv(q, k, v, g, lse, delta, w))
                first = (out, lse, dq, dk, dv)
                if not all(torch.equal(x, y) for x, y in zip(first, again)):
                    raise RuntimeError("bf16 K6 or K7 is not deterministic: two runs differ")
                print(f"[{label}] bf16 K6 and K7 deterministic: two runs bitwise equal", flush=True)
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
                print(f"[{label}] {name} {row}", flush=True)
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


def training_batch(graph, device, times: int = 3, seed: int = SEED + 2):
    """A data-space batch of ``times`` steps (3 = m + 1: rollout 1) from the
    seeded statistics."""
    idx = flagship_indices()["data"]
    stats = flagship_statistics(SEED)
    gen = torch.Generator(device=device).manual_seed(seed)
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


def build_training(graph, device, config, losses=None):
    """(interface, TrainState, train_step) of the bench's training setup:
    bf16 over float32 masters, area-weighted MSE (or ``losses``), AdamW,
    value clipping at 32, rollout 1; the processor's per-layer remat as
    configured (default: ``save_attention``)."""
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface
    from anemoi_tpu_torch.training.optimizers import build_optimizer
    from anemoi_tpu_torch.training.step import TrainState, make_step_fns

    # the weights: the interface's own draws from context_seed("model-init")
    iface = AnemoiModelInterface(config=config, graph=graph, data_indices=flagship_indices(),
                                 statistics=flagship_statistics(SEED), device=device,
                                 training=True)
    tx = build_optimizer({"lr": {"rate": 1e-4, "warmup": 10, "iterations": 1000},
                          "gradient_clip": {"val": 32.0, "algorithm": "value"}})
    train_step, _ = make_step_fns(iface, losses or training_losses(graph), rollout=1,
                                  precision="bf16")
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
    ``train_step`` that ``make_step_fns`` (or, for the transport task,
    ``make_transport_step_fns``) builds so that the counts are set to 0 just
    before each step and read just after it (validation and the rollout
    evaluation run outside it), and keeps the trainer it ran in and the
    unwrapped ``train_step``; with ``snapshot``, also a CPU copy of the
    trainer's weights as its loop starts (``initial``)."""

    BUILDERS = ("make_step_fns", "make_transport_step_fns")

    def __init__(self, snapshot: bool = False):
        self.per_step, self.trainer, self.train_step = [], None, None
        self.snapshot, self.initial = snapshot, None

    def __enter__(self):
        from anemoi_tpu_torch import kernels
        from anemoi_tpu_torch.training import trainer as trainer_mod

        self._mod, self._train = trainer_mod, trainer_mod.AnemoiTrainer.train
        self._made = {name: getattr(trainer_mod, name) for name in self.BUILDERS}
        counter = self

        def wrapped(make):
            def make_fns(*args, **kwargs):
                train_step, eval_step = make(*args, **kwargs)
                counter.train_step = train_step

                def counted(state, batch):
                    kernels.reset_launches()
                    out = train_step(state, batch)
                    counter.per_step.append(kernels.launch_counts())
                    return out

                return counted, eval_step

            return make_fns

        def train(trainer):
            counter.trainer = trainer
            if counter.snapshot:
                counter.initial = {k: v.detach().cpu().clone()
                                   for k, v in trainer.interface.state_dict().items()}
            return counter._train(trainer)

        for name, make in self._made.items():
            setattr(trainer_mod, name, wrapped(make))
        trainer_mod.AnemoiTrainer.train = train
        return self

    def __exit__(self, *exc):
        for name, make in self._made.items():
            setattr(self._mod, name, make)
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
    counted.trainer = counted.train_step = None
    del trainer, batch
    torch.cuda.empty_cache()
    result = {
        "seconds": seconds, "store_write_s": write_s, "edges": edges,
        "ms_per_step": statistics.median(timed), "ms_per_step_runs": timed,
        "ms_per_step_min": min(timed), "ms_per_step_max": max(timed),
        "fixed_batch_ms_per_step": training["ms_per_step"],
        "losses": [r["loss"] for r in steps], "grad_norms": [r["grad_norm"] for r in steps],
        "val_loss": val[-1]["val_loss"], "launches_per_step": counted.per_step[-1],
        "n_val_keys": len(val[-1]), "lz4_blocks_decoded": lz4,
        "grad_rel_l2_vs_plain": grad_rel_l2,
    }
    print(f"[trainer] wall ms a step over steps 3-{TRAINER_STEPS} (data pipeline included): "
          f"median {result['ms_per_step']:.3f}, min {min(timed):.3f}, max {max(timed):.3f}; "
          f"phase 8's fixed batch {training['ms_per_step']:.3f} ms", flush=True)
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
# the processor depth of phases 13-15, 18-22 and 24-33 and of phase 34's
# profiled and MLflow runs (their widths are the models'): cut from 16 so
# that the whole run stays well inside its 1 200 s limit on a slow host (at
# 16 layers one host ran it in 1 009 s, another had not finished it at
# 1 200 s)
CUT_LAYERS = 2
DEPTH_CUT = f"model.processor.num_layers={CUT_LAYERS}"
KEEPS_ATTENTION = ("save_attention", "save_attention_mlp")


def remat_launches(rollout, layer_policy, remat_rollout, rollout_policy,
                   layers: int = FLAGSHIP_LAYERS) -> dict:
    """A flagship training step's launches from the remat structure (the
    counts tests/test_torch_remat.py asserts for the same structure) at
    ``layers`` processor layers: each rollout step's forward launches K1 in
    its ``layers`` + 2 blocks; a rollout checkpoint that does not keep the
    attention's outputs runs the forward again in the backward (rollout > 1
    only); a per-layer checkpoint that does not keep them runs each layer's
    K1 once more; K3 and K4 run once a block's backward."""
    f = layers + 2
    outer = remat_rollout and rollout > 1 and rollout_policy not in KEEPS_ATTENTION
    again = layers if layer_policy not in ("off", *KEEPS_ATTENTION) else 0
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
    iface, state, _ = build_training(graph, device, flagship_config(num_layers=CUT_LAYERS))
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
        want = remat_launches(rollout, layer_policy, remat_rollout, rollout_policy, CUT_LAYERS)
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
                   f"training.rollout.max={PRESET_ROLLOUT}", "diagnostics.log_interval=1",
                   DEPTH_CUT]
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
    want = remat_launches(PRESET_ROLLOUT, "save_attention", True, None, CUT_LAYERS)
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
    # 16 heads, multi_scale o96 -> ico-5, 4 members; the processor at
    # CUT_LAYERS of its 16 layers), in bf16;
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
        rc = cli.main(["train", preset, *run, DEPTH_CUT])
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
    want = {**NO_LAUNCHES, "K1": CUT_LAYERS + 2, "K3": CUT_LAYERS + 2, "K4": CUT_LAYERS + 2}
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
    if p_launches != {**NO_LAUNCHES, "K1": CUT_LAYERS + 2}:
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
FAMILY_DEFAULTS = """defaults:
  - data: synthetic
  - dataloader: default
  - diagnostics: default
  - graph: {graph}
  - model: {model}
  - task: forecaster
  - training: default
  - _self_
"""


def expected_launches(config: dict, graph, processor_layers: int) -> dict:
    """A training step's launches from the edge counts: K1 and K3 once a GT
    block (each dataset's two mappers and ``processor_layers`` processor
    layers), and on each of those edge sets K5 where the JAX package's rule
    (``fused_backward``: 2 GB of estimated two-pass transient) picks the
    fused backward, else K4."""
    from anemoi_tpu_torch.models.encoder_processor_decoder import fused_backward

    model = config["model"]
    c = int(model["num_channels"])
    sets = [(part, graph[key].num_edges) for ds in sorted(config["data"]["datasets"])
            for part, key in (("encoder", (ds, "hidden")), ("decoder", ("hidden", ds)))]
    if processor_layers:
        sets += [("processor", graph[("hidden", "hidden")].num_edges)] * processor_layers
    fused = [fused_backward(model, part, n, c) for part, n in sets]
    return {**NO_LAUNCHES, "K1": len(sets), "K3": len(sets), "K4": fused.count(False),
            "K5": fused.count(True)}


def family_train(workdir: str, device, label: str, path: str, overrides: list, steps: int,
                 want, attention: bool = True, split: int = 0, dataset=None,
                 after=None) -> tuple:
    """``cli train`` on ``path`` over phase 9's store (or ``dataset``, a
    ``(kind, path)``; ``"config"``: the config's own dataset), bf16: exit 0,
    ``steps`` finite records, a finite
    validation record, exactly ``want(trainer)`` launches in every step;
    then, on a batch of the store, the trained step's gradient against the
    plain attention (``attention``), ``after(trainer, state, want)`` (its
    result under ``"after"``), wall ms a step (median of ``FAMILY_TIMED``
    after 1 of warmup), device ms and launches a step (``torch.profiler``;
    with ``split``, its kernels that took the most device time) and peak
    memory.  Returns (result, run directory, last validation record)."""
    from anemoi_tpu_torch.training import cli

    data = []
    if dataset != "config":
        kind, store = dataset or ("zarr", os.path.join(workdir, "example_o96.zarr"))
        data = [f"data.datasets.data.kind={kind}", f"data.datasets.data.path={store}"]
    run_dir = os.path.join(workdir, f"{label}_run")
    run = [*data, f"output_dir={run_dir}", f"training.max_steps={steps}", "training.max_epochs=1",
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
    extra = after(trainer, state, want) if after is not None else None
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
        **({"after": extra} if extra is not None else {}),
    }
    print(f"[{label}] fixed-batch step: wall {result['ms_per_step']:.3f} ms, device "
          f"{device_ms:.3f} ms ({device_launches:.1f} device launches), peak {peak} B; "
          f"edges {result['edges']}", flush=True)
    del trainer, state, train_step, iface, batch
    torch.cuda.empty_cache()
    return result, run_dir, val[-1]


def family_predict(workdir: str, device, label: str, run_dir: str, k1_per_step: int,
                   split: int = 0, bitwise: bool = False) -> dict:
    """``cli predict`` on the bundle of ``run_dir``, ``STEPS`` steps: exit 0,
    exactly ``k1_per_step`` K1 a step and no other kernel, for each of the
    bundle's datasets a finite forecast of the right shape, within relative
    L2 2e-2 of the same bundle served in-process on the plain attention (on
    the kernels, for a model with no attention: the sums' atomics vary the
    last bits); with ``bitwise``, also equal bit for bit to the in-process
    forecast on the kernels; the in-process forecast's wall and device ms a
    step and peak memory."""
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
        datasets = {name: open_dataset(dict(cfg)) for name, cfg in
                    json.load(f)["config"]["data"]["datasets"].items()}
    iface = load_inference_checkpoint(bundle)
    written = np.load(output)
    outs = {name: written[f"{name}|forecast"] for name in datasets}
    for name, out in outs.items():
        expect = (1, STEPS, 1, datasets[name].num_grid_points,
                  iface.data_indices[name].num_model_output_vars)
        if out.shape != expect or not np.isfinite(out).all():
            raise RuntimeError(f"{label}: {name} forecast shape {out.shape} (want {expect}) or "
                               "not finite")
    batch = {name: torch.from_numpy(ds.get_window(0, iface.model.n_step_input + STEPS)[None])
             .to(iface.device) for name, ds in datasets.items()}
    forecast = make_forecast_fn(iface, steps=STEPS)
    if bitwise:
        same = forecast(batch)
        max_abs = max(float(np.abs(out - same[name].cpu().numpy()).max())
                      for name, out in outs.items())
        print(f"[{label}] cli predict vs make_forecast_fn in-process: max |diff| {max_abs:.3e} "
              "(want 0: same bundle, window and kernels)", flush=True)
        if max_abs != 0:
            raise RuntimeError(f"{label}: the CLI's forecast differs from the in-process one "
                               f"(max |diff| {max_abs:.3e})")
    iface.use_plain_attention(bool(k1_per_step))
    ref = forecast(batch)
    iface.use_plain_attention(False)
    by_dataset = {}
    for name, out in outs.items():
        r = ref[name].cpu().numpy()
        by_dataset[name] = float(np.linalg.norm(out - r) / np.linalg.norm(r))
    rel_l2 = max(by_dataset.values())
    against = "the plain attention" if k1_per_step else "the in-process forecast"
    print(f"[{label}] cli predict vs {against}: relative L2 {by_dataset} (tol {SERVING_TOL})",
          flush=True)
    if not rel_l2 <= SERVING_TOL:
        raise RuntimeError(f"{label}: forecast disagrees with {against}: {by_dataset}")
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
    result = {"seconds": seconds, "launches": launches,
              "output_shape": {name: list(out.shape) for name, out in outs.items()},
              "rel_l2": rel_l2, "rel_l2_by_dataset": by_dataset, "rel_l2_against": against,
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
    train, _, val = family_train(workdir, device, "downscaler", path, [*overrides, DEPTH_CUT],
                                 FAMILY_STEPS,
                                 lambda t: expected_launches(t.config, t.graph, CUT_LAYERS))
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
    ens, _, _ = family_train(workdir, device, "downscaler ensemble", path,
                             [*overrides, DEPTH_CUT], FAMILY_STEPS - 1,
                             lambda t: expected_launches(t.config, t.graph, CUT_LAYERS))
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
        f.write(FAMILY_DEFAULTS.format(graph="multi_scale", model="gnn"))
    overrides = [f"graph.save_path={os.path.join(workdir, 'graph.npz')}", LR_ONLY]
    composed_preset(cfg_path, overrides, {
        "model.num_channels": 512, "model.processor.name": "GNNProcessor",
        "model.processor.num_layers": 16, "model.encoder.name": "GNNForwardMapper"})
    train, run_dir, _ = family_train(workdir, device, "gnn", cfg_path, [*overrides, DEPTH_CUT],
                                     FAMILY_STEPS, lambda t: dict(NO_LAUNCHES), attention=False,
                                     split=12)
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


NAN_VARIABLE = "t_850"  # the stretched phase's prognostic variable with a NaN box
NAN_BOX = (45.0, 70.0, 30.0, 60.0)  # lat min/max, lon min/max (degrees): partly in the area


def graph_summary(label: str, graph, hidden: str = "hidden") -> dict:
    """The ``hidden`` node count (and the area's, on a limited-area graph),
    each edge set's count and its sources' and destinations' degree ranges,
    printed and returned."""
    import numpy as np

    out = {"data_nodes": graph["data"].num_nodes, "hidden_nodes": graph[hidden].num_nodes}
    if "cutout_mask" in graph["data"].attributes:
        out["area_nodes"] = int(graph["data"].attributes["cutout_mask"].sum())
    for (src, dst), es in graph.edges.items():
        out_deg = np.bincount(es.edge_index[0], minlength=graph[src].num_nodes)
        in_deg = np.diff(es.dst_ptr)
        out[f"{src}->{dst}"] = {
            "edges": es.num_edges, "source_degree": [int(out_deg.min()), int(out_deg.max())],
            "sources_without_edges": int((out_deg == 0).sum()),
            "destination_degree": [int(in_deg.min()), int(in_deg.max())],
            "mean_destination_degree": float(in_deg.mean())}
    print(f"[{label}] graph: {json.dumps(out)}", flush=True)
    return out


def rollout_2_and_boundary(label: str, trainer, state, want_1: dict) -> dict:
    """One rollout-2 step of the trained model under the packaged rollout
    remat: exactly the launches ``want_1`` gives a rollout-1 step, twice,
    K1 once more where the rollout checkpoint recomputes the forward; its
    wall, device ms and peak memory.  Then the second model step's input,
    built by the port's ``advance_input`` on the card from the trained
    interface's prediction: outside the area the normalised truth bit for
    bit, inside the prediction (prognostics) and the truth (forcings)."""
    from anemoi_tpu_torch import kernels
    from anemoi_tpu_torch.training.step import advance_input, device_index_arrays

    device = trainer.device
    cfg = trainer.config["training"]
    trainer.datamodule.set_rollout(2)
    batch = trainer.put_batch(trainer.datamodule.make_batch(trainer.datamodule.train_starts[:1]))
    trainer.datamodule.set_rollout(1)
    train_step, _ = trainer._get_step_fns(2)
    recompute = bool(cfg.get("remat_rollout", True)) and cfg.get("remat_policy") not in \
        KEEPS_ATTENTION
    want = {k: 2 * n for k, n in want_1.items()}
    want["K1"] *= 1 + recompute
    torch.cuda.synchronize()
    kernels.reset_launches()
    state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches != want or not math.isfinite(float(metrics["loss"])):
        raise RuntimeError(f"{label}: rollout-2 step launches {launches} (want {want}), loss "
                           f"{float(metrics['loss'])}")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    train_step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(device)
    device_ms, device_launches = profiled_device_ms(lambda: train_step(state, batch), 1)

    iface = trainer.interface
    ia = device_index_arrays(iface)["data"]
    area = trainer.output_masks["data"].as_tensor(device)
    m = iface.model.n_step_input
    with torch.no_grad():
        batch_norm = iface.pre_processors["data"].transform(batch["data"].float())
        x = batch_norm[:, :m][..., ia["data_input_full"]].to(torch.bfloat16)
        y = iface.run_model({"data": x}, iface.cast_parameters(torch.bfloat16))["data"]
        new = advance_input(x, y, batch_norm, m, ia, boundary_mask=area)[:, -1]
    truth = batch_norm[:, m][..., ia["from_data"]].to(x.dtype)
    pred = y[:, 0][..., ia["from_pred"]]
    prog = ia["is_prog"]
    inside = new[:, :, area]
    checks = {
        "outside_equals_truth": torch.equal(new[:, :, ~area], truth[:, :, ~area]),
        "inside_prognostics_equal_prediction": torch.equal(inside[..., prog],
                                                           pred[:, :, area][..., prog]),
        "inside_forcings_equal_truth": torch.equal(inside[..., ~prog],
                                                   truth[:, :, area][..., ~prog]),
        # not vacuous: outside the area the prediction differs from the truth
        "prediction_differs_outside": not torch.equal(pred[:, :, ~area][..., prog],
                                                      truth[:, :, ~area][..., prog]),
        "finite": bool(torch.isfinite(new).all()),
    }
    print(f"[{label}] rollout-2 step: launches {launches}, loss {float(metrics['loss']):.6f}, "
          f"wall {wall:.3f} ms, device {device_ms:.3f} ms ({device_launches:.1f} launches), "
          f"peak {peak} B; boundary of the second step's input ({int(area.sum())} of "
          f"{area.numel()} points inside): {checks}", flush=True)
    if not all(checks.values()):
        raise RuntimeError(f"{label}: the boundary forcing failed its checks: {checks}")
    del batch, batch_norm, x, y, new, train_step
    return {"launches": launches, "loss": float(metrics["loss"]), "wall_ms": wall,
            "device_ms": device_ms, "device_launches": device_launches,
            "peak_memory_bytes": peak, "boundary": checks}


def lam_phase(workdir: str, device) -> dict:
    """``lam.yaml`` at its width (the ``graphtransformer`` model: 1024
    channels, 16 layers, 16 heads; the ``limited_area`` graph; the loss
    masked to ``cutout_mask``) through ``cli train`` over phase 9's store, 3
    steps; a rollout-2 step with the boundary check; ``cli predict`` 2 steps."""
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    path = os.path.join(PACKAGED_CONFIG_DIR, "lam.yaml")
    overrides = [f"graph.save_path={os.path.join(workdir, 'graph_lam.npz')}", LR_ONLY]
    composed_preset(path, overrides, {
        "model.num_channels": 1024, "model.processor.num_layers": FLAGSHIP_LAYERS,
        "model.processor.num_heads": 16, "training.output_mask.data.attribute_name": "cutout_mask",
        "graph.recipe.nodes.hidden.node_builder.name": "LimitedAreaTriNodes"})
    summary = {}

    def after(trainer, state, want):
        summary.update(graph_summary("lam", trainer.graph))
        return rollout_2_and_boundary("lam", trainer, state, want)

    train, run_dir, _ = family_train(
        workdir, device, "lam", path, [*overrides, DEPTH_CUT], FAMILY_STEPS,
        lambda t: expected_launches(t.config, t.graph, CUT_LAYERS), after=after)
    predict = family_predict(workdir, device, "lam", run_dir, CUT_LAYERS + 2)
    result = {"graph": summary, "train": train, "predict": predict}
    print(f"[lam] {json.dumps(result)}", flush=True)
    return result


def write_nan_store(workdir: str) -> tuple:
    """Phase 9's fields written in the npy layout (``save_dataset``) with
    ``NAN_VARIABLE`` NaN on ``NAN_BOX`` at every time; the statistics
    rewritten from ``np.nanmean`` and ``np.nanstd`` (and ``nanmin``,
    ``nanmax``), as anemoi-datasets computes them (the writer's plain
    ``mean``/``std`` are NaN over a NaN field).  Returns (path, box mask)."""
    import numpy as np

    from anemoi_tpu_torch.data.dataset import open_dataset, save_dataset

    src = open_dataset({"kind": "zarr", "path": os.path.join(workdir, "example_o96.zarr")})
    data = src.get_window(0, len(src)).transpose(0, 3, 1, 2).copy()  # [T, V, E, G]
    lat, lon = np.rad2deg(src.latitudes), np.rad2deg(src.longitudes) % 360.0
    box = (lat >= NAN_BOX[0]) & (lat <= NAN_BOX[1]) & (lon >= NAN_BOX[2]) & (lon <= NAN_BOX[3])
    data[:, src.variables.index(NAN_VARIABLE), :, box] = np.nan
    path = os.path.join(workdir, "example_o96_nan")
    save_dataset(path, data, src.variables, np.rad2deg(src.latitudes),
                 np.rad2deg(src.longitudes), timestep_hours=src.timestep_hours,
                 missing=sorted(src.missing))
    for name, values in (("statistics", data), ("statistics_tendencies", np.diff(data, axis=0))):
        flat = values.reshape(values.shape[0], values.shape[1], -1)
        np.savez(os.path.join(path, f"{name}.npz"),
                 mean=np.nanmean(flat, axis=(0, 2)).astype(np.float32),
                 stdev=(np.nanstd(flat, axis=(0, 2)) + 1e-12).astype(np.float32),
                 minimum=np.nanmin(flat, axis=(0, 2)).astype(np.float32),
                 maximum=np.nanmax(flat, axis=(0, 2)).astype(np.float32))
    return path, box


def imputer_and_optimizer_checks(trainer, box) -> dict:
    """The imputer's loss mask on a batch of the NaN store: 0 at exactly the
    NaN points of ``NAN_VARIABLE``, 1 everywhere else; AdEMAMix's state:
    three float32 moments of each parameter's shape, and its update count."""
    from anemoi_tpu_torch.training.optimizers import AdEMAMix

    trainer.datamodule.set_rollout(1)
    batch = trainer.put_batch(trainer.datamodule.make_batch(trainer.datamodule.train_starts[:1]))
    pre = trainer.interface.pre_processors["data"]
    mask = pre.loss_mask(pre.compute_aux(batch["data"]))  # [B, G, V_out]
    j = trainer.interface.data_indices["data"].model.output.name_to_index[NAN_VARIABLE]
    want = torch.ones_like(mask)
    want[:, torch.as_tensor(box, device=mask.device), j] = 0.0
    opt = trainer.state.optimizer.opt
    params = [p for p in trainer.interface.parameters() if p.requires_grad]
    moments = all(
        opt.state[p][k].dtype == torch.float32 and opt.state[p][k].shape == p.shape
        for p in params for k in ("m1", "m2", "nu"))
    counts = sorted({opt.state[p]["count"] for p in params})
    checks = {"loss_mask_exact": torch.equal(mask, want), "nan_points": int(box.sum()),
              "mask_zeros": int((mask == 0).sum()), "ademamix": isinstance(opt, AdEMAMix),
              "float32_moments": moments, "update_counts": counts}
    print(f"[stretched] imputer loss mask and AdEMAMix state: {checks}", flush=True)
    if not (checks["loss_mask_exact"] and checks["ademamix"] and moments
            and counts == [FAMILY_STEPS]):
        raise RuntimeError(f"stretched: the imputer or optimizer check failed: {checks}")
    return checks


def stretched_phase(workdir: str, device) -> dict:
    """``stretched.yaml`` at its width (1024 channels, 16 layers, the
    ``stretched_grid`` graph: ico-4 outside, ico-6 inside a 20 degree cap,
    KNN-8 processor edges) with AdEMAMix and ``[InputImputer (mean),
    InputNormalizer]`` over phase 9's fields in the npy layout with a NaN
    box: ``cli train`` 3 steps, the imputer and optimizer checks, a
    rollout-2 step with the boundary check; ``cli predict`` 2 steps."""
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    store, box = write_nan_store(workdir)
    path = os.path.join(PACKAGED_CONFIG_DIR, "stretched.yaml")
    overrides = [f"graph.save_path={os.path.join(workdir, 'graph_stretched.npz')}", LR_ONLY,
                 "training.optimizer={name: ademamix}",
                 "data.processors=[{name: InputImputer, default: mean}, "
                 "{name: InputNormalizer, default: mean-std}]"]
    composed_preset(path, overrides, {
        "model.num_channels": 1024, "model.processor.num_layers": FLAGSHIP_LAYERS,
        "graph.recipe.nodes.hidden.node_builder.name": "StretchedTriNodes",
        "graph.recipe.nodes.hidden.node_builder.lam_resolution": 6,
        "training.optimizer.name": "ademamix"})
    summary = {}

    def after(trainer, state, want):
        summary.update(graph_summary("stretched", trainer.graph))
        checks = imputer_and_optimizer_checks(trainer, box)
        return {**rollout_2_and_boundary("stretched", trainer, state, want), "checks": checks}

    train, run_dir, _ = family_train(
        workdir, device, "stretched", path, [*overrides, DEPTH_CUT], FAMILY_STEPS,
        lambda t: expected_launches(t.config, t.graph, CUT_LAYERS), split=12,
        dataset=("npy", store), after=after)
    predict = family_predict(workdir, device, "stretched", run_dir, CUT_LAYERS + 2)
    result = {"graph": summary, "nan_points": int(box.sum()), "train": train,
              "predict": predict}
    print(f"[stretched] {json.dumps(result)}", flush=True)
    return result


TRANSPORT_STEPS = 3  # cli train steps of each transport preset in phase 22
TRANSPORT_SEED = 7  # predict --seed, and the generators of the in-process samples
TRANSPORT_GATE_STEPS = 4  # sampler steps of the sample held against the plain attention
TRANSPORT_PRESETS = {  # label -> (preset, objective, forecast steps of cli predict)
    "transport_edm": ("transport_edm_diffusion", "edm", 2),
    "transport_interpolant": ("transport_stochastic_interpolant_tendency", "interpolant", 1),
}


def rel_gap(ours: torch.Tensor, ref: torch.Tensor) -> float:
    return ((ours.float() - ref.float()).norm() / ref.float().norm()).item()


def transport_window(trainer, device):
    """The normalised model-space window (float32) of the store's first
    training sample."""
    dm = trainer.datamodule
    dm.set_rollout(1)
    batch = trainer.put_batch(dm.make_batch(dm.train_starts[:1]))
    iface = trainer.interface
    m = iface.model.n_step_input
    norm = iface.pre_processors["data"].transform(batch["data"].float())
    x = norm[:, :m][..., torch.as_tensor(iface.data_indices["data"].data.input.full,
                                         device=device)]
    return {"data": x}


def transport_gates(label: str, objective: str, device, k1_per_eval: int):
    """``after`` of ``family_train`` for a transport preset: on the trained
    interface, in its serving type (bf16), one model evaluation at each end
    of the noise range (EDM: sigma_max and sigma_min; interpolant: t = 0 and
    1) and a ``TRANSPORT_GATE_STEPS``-step sample from the same generator,
    each on the kernels against the plain attention (relative L2 <=
    ``SERVING_TOL``); the device ms, wall ms and K1 launches
    (``k1_per_eval``) of one model evaluation."""
    from anemoi_tpu_torch import kernels
    from anemoi_tpu_torch.models.transport.objectives import (
        EDMConfig, edm_denoise, edm_preconditioning)
    from anemoi_tpu_torch.training.transport_step import make_sampler

    def gates(trainer, state, want):
        iface = trainer.interface
        x = transport_window(trainer, device)
        params = iface.cast_parameters(iface.inference_dtype)
        xc = {"data": x["data"].to(iface.inference_dtype)}
        b, _, e, g = x["data"].shape[:4]
        v_out = iface.data_indices["data"].num_model_output_vars
        gen = torch.Generator(device=device).manual_seed(TRANSPORT_SEED)
        y = torch.randn((b, 1, e, g, v_out), generator=gen, device=device)
        edm = EDMConfig.from_config(trainer.config["training"]["transport"].get("edm"))
        levels = ({"sigma_max": edm.sigma_max, "sigma_min": edm.sigma_min} if objective == "edm"
                  else {"t_0": 0.0, "t_1": 1.0})
        out = {}

        @torch.no_grad()
        def evaluate(level: float):
            if objective == "edm":
                sig = torch.full((b, 1, e, 1, 1), level, device=device)
                _, _, c_in, c_noise = edm_preconditioning(sig, edm.sigma_data)
                noised, noise_level = (y * level) * c_in, c_noise[:, 0, :, 0, 0]
            else:
                noised, noise_level = y, torch.full((b, e), level, device=device)
            f = iface.run_model(xc, params, y_noised={"data": noised.to(iface.inference_dtype)},
                                noise_level=noise_level)["data"].float()
            if objective == "edm":
                return f, edm_denoise(f, y * level, sig, edm)
            return f, f

        for name, level in levels.items():
            f, d = evaluate(level)
            iface.use_plain_attention(True)
            f_ref, d_ref = evaluate(level)
            iface.use_plain_attention(False)
            out[name] = {"network_rel_l2": rel_gap(f, f_ref), "output_rel_l2": rel_gap(d, d_ref),
                         "finite": bool(torch.isfinite(f).all())}
            print(f"[{label}] one model evaluation at {name} ({level}) vs the plain attention: "
                  f"network output relative L2 {out[name]['network_rel_l2']:.3e}, "
                  f"{'denoised' if objective == 'edm' else 'velocity'} "
                  f"{out[name]['output_rel_l2']:.3e} (tol {SERVING_TOL})", flush=True)
            if not (out[name]["finite"] and out[name]["network_rel_l2"] <= SERVING_TOL):
                raise RuntimeError(f"{label}: the evaluation at {name} disagrees with the plain "
                                   f"attention: {out[name]}")

        sampler = "edm_heun" if objective == "edm" else "vf_heun"
        generate = make_sampler(iface, objective=objective, sampler=sampler,
                                num_steps=TRANSPORT_GATE_STEPS, edm=edm)
        samples = {}
        for plain in (False, True):
            iface.use_plain_attention(plain)
            samples[plain] = generate(x, torch.Generator(device=device).manual_seed(
                TRANSPORT_SEED))["data"]
        iface.use_plain_attention(False)
        out["sample_4_steps_rel_l2"] = rel_gap(samples[False], samples[True])
        print(f"[{label}] {TRANSPORT_GATE_STEPS}-step {sampler} sample vs the plain attention "
              f"(same generator): relative L2 {out['sample_4_steps_rel_l2']:.3e} "
              f"(tol {SERVING_TOL})", flush=True)
        if not (torch.isfinite(samples[False]).all()
                and out["sample_4_steps_rel_l2"] <= SERVING_TOL):
            raise RuntimeError(f"{label}: the 4-step sample disagrees with the plain attention")

        level = next(iter(levels.values()))
        evaluate(level)
        torch.cuda.synchronize()
        kernels.reset_launches()
        evaluate(level)
        torch.cuda.synchronize()
        out["evaluation_launches"] = kernels.launch_counts()
        if out["evaluation_launches"] != {**NO_LAUNCHES, "K1": k1_per_eval}:
            raise RuntimeError(f"{label}: one evaluation launched {out['evaluation_launches']}")
        out["evaluation_ms"] = cuda_ms(lambda: evaluate(level), reps=10, warmup=2)
        out["evaluation_device_ms"], _ = profiled_device_ms(lambda: evaluate(level), 1)
        print(f"[{label}] one bf16 model evaluation: {out['evaluation_ms']:.3f} ms a single call "
              f"(CUDA events), device "
              f"{out['evaluation_device_ms']:.3f} ms, launches {out['evaluation_launches']}",
              flush=True)
        del params, samples
        return out

    return gates


def transport_predict(workdir: str, device, label: str, run_dir: str, steps: int,
                      k1_per_eval: int) -> dict:
    """``cli predict <bundle> --steps <steps> --seed TRANSPORT_SEED`` on a
    transport bundle at its ``sampling_steps`` (20): exit 0, exactly
    ``k1_per_eval`` K1 a model evaluation and no other kernel, a finite
    forecast of the right shape, equal bit for bit to an in-process
    ``make_transport_forecast_fn``
    with a generator seeded alike; its gap to the plain attention's forecast
    from the same generator (printed: 20 chained steps, not gated); the
    in-process forecast's wall and device ms a forecast step and peak
    memory."""
    import numpy as np

    from anemoi_tpu_torch import kernels
    from anemoi_tpu_torch.data.dataset import open_dataset
    from anemoi_tpu_torch.inference import make_transport_forecast_fn, transport_settings
    from anemoi_tpu_torch.models.transport.samplers import evaluations
    from anemoi_tpu_torch.training import cli
    from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint

    bundle = os.path.join(run_dir, "inference")
    output = os.path.join(workdir, f"{label}_forecast.npz")
    with open(os.path.join(bundle, "checkpoint.json")) as f:
        config = json.load(f)["config"]
    settings = transport_settings(config)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["predict", bundle, "--steps", str(steps), "--seed", str(TRANSPORT_SEED),
                   "--output", output])
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if rc != 0:
        raise RuntimeError(f"{label}: cli predict returned {rc}")
    dataset = open_dataset(dict(config["data"]["datasets"]["data"]))
    out = np.load(output)["data|forecast"]
    expect = (1, steps, 1, dataset.num_grid_points, 11)
    if out.shape != expect or not np.isfinite(out).all():
        raise RuntimeError(f"{label}: forecast shape {out.shape} (want {expect}) or not finite")

    iface = load_inference_checkpoint(bundle)
    forecast = make_transport_forecast_fn(iface, steps, **settings)
    n_eval = evaluations(settings["sampler"], settings["num_steps"], forecast.schedule)
    want = {**NO_LAUNCHES, "K1": k1_per_eval * n_eval * steps}
    print(f"[{label}] cli predict: {settings}, {n_eval} model evaluations a forecast step, "
          f"launches {launches}", flush=True)
    if launches != want:
        raise RuntimeError(f"{label}: predict launches {launches}, want {want}")
    window = dataset.get_window(0, iface.model.n_step_input + steps)
    batch = {"data": torch.from_numpy(window[None]).to(iface.device)}

    def run():
        return forecast(batch, torch.Generator(device=iface.device).manual_seed(TRANSPORT_SEED))

    ref = run()["data"].cpu().numpy()
    max_abs = float(np.abs(out - ref).max())
    print(f"[{label}] cli predict vs make_transport_forecast_fn in-process (seed "
          f"{TRANSPORT_SEED}): max |diff| {max_abs:.3e} (want 0)", flush=True)
    if not np.array_equal(out, ref):
        raise RuntimeError(f"{label}: the CLI's forecast differs from the in-process one")
    iface.use_plain_attention(True)
    plain = run()["data"].cpu().numpy()
    iface.use_plain_attention(False)
    plain_gap = float(np.linalg.norm(out - plain) / np.linalg.norm(plain))
    print(f"[{label}] the {settings['num_steps']}-step forecast vs the plain attention's (same "
          f"generator): relative L2 {plain_gap:.3e} (printed, not gated)", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for _ in range(2):
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3 / steps)
    peak = torch.cuda.max_memory_allocated(device)
    device_ms, device_launches = profiled_device_ms(run, 1)
    result = {"seconds": seconds,
              "settings": {**settings, "edm": dataclasses.asdict(settings["edm"])},
              "evaluations_per_step": n_eval,
              "launches": launches, "output_shape": list(out.shape),
              "max_abs_diff_vs_in_process": max_abs, "rel_l2_vs_plain": plain_gap,
              "ms_per_step": statistics.median(walls), "ms_per_step_runs": walls,
              "device_ms_per_step": device_ms / steps,
              "device_launches_per_step": device_launches / steps, "peak_memory_bytes": peak}
    print(f"[{label}] in-process forecast: wall {result['ms_per_step']:.3f} ms a step, device "
          f"{result['device_ms_per_step']:.3f} ms a step ({n_eval} evaluations), peak {peak} B",
          flush=True)
    del iface, forecast, batch
    torch.cuda.empty_cache()
    return result


def transport_phase(workdir: str, device, presets: dict = TRANSPORT_PRESETS,
                    layers: int = CUT_LAYERS) -> dict:
    """Phase 22: the transport ``presets`` at their width (512 channels, 16
    heads, phase 9's ``multi_scale`` graph and store; the processor at
    ``layers`` of the presets' 16), bf16: ``cli train`` ``TRANSPORT_STEPS``
    steps with no callbacks, exactly ``layers`` + 2 K1 and K3 and the K4/K5
    of the ``fused_backward`` rule a step, the
    gradient gate, the evaluation and 4-step sample gates
    (``transport_gates``), then ``cli predict`` (``transport_predict``) of
    the steps ``presets`` gives: EDM diffusion 2 forecast steps of
    ``edm_heun``, the tendency interpolant 1 of ``vf_heun``, each at 20
    sampling steps."""
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    overrides = [f"graph.save_path={os.path.join(workdir, 'graph.npz')}",  # phase 9's
                 "diagnostics.callbacks=[]"]
    result = {}
    for label, (preset, objective, steps) in presets.items():
        path = os.path.join(PACKAGED_CONFIG_DIR, f"{preset}.yaml")
        composed_preset(path, overrides, {
            "model.num_channels": 512, "model.processor.num_layers": 16,
            "model.processor.num_heads": 16, "training.task": "transport",
            "training.transport.objective": objective,
            "graph.recipe.nodes.hidden.node_builder.resolution": 5})
        train, run_dir, _ = family_train(
            workdir, device, label, path,
            [*overrides, f"model.processor.num_layers={layers}"], TRANSPORT_STEPS,
            lambda t: expected_launches(t.config, t.graph, layers),
            after=transport_gates(label, objective, device, layers + 2))
        result[label] = {"train": train, "predict": transport_predict(
            workdir, device, label, run_dir, steps, layers + 2)}
        print(f"[{label}] {json.dumps(result[label])}", flush=True)
    return result


HIERARCHICAL_PRESETS = {  # label -> (preset, callbacks: the flat model's phase of the task)
    "hierarchical": ("hierarchical", None),  # the default diagnostics (the rollout evaluation)
    "hierarchical_autoencoder": ("hierarchical_autoencoder", LR_ONLY),  # as phase 17
}
DOWN_SET = ("hidden_1", "hidden_2")  # the V-cycle's down mapper: KNN-3 from each hidden_2 node


def hierarchical_launches(config: dict, graph) -> dict:
    """A hierarchical training step's launches from the config and the graph:
    K1 and K3 once a GraphTransformer block -- the encoder and the decoder,
    the down and up mappers between levels (the up mappers from
    ``up_mapper`` where the config has it) and the layers of each level's
    processor that has edges (below the deepest level twice, down and up, at
    ``level_process_num_layers``); on each block's edge set K5 where the JAX
    hierarchical model picks the fused backward (``paged_fused_bwd`` on the
    level sets, ``paged_mapper_fused_bwd``, default ``paged_fused_bwd``, on
    the mappers'), else K4.  A forecast step launches the same K1."""
    from anemoi_tpu_torch.models.graph import infer_hidden_names

    model = config["model"]
    levels = list(model.get("hidden_names") or infer_hidden_names(graph.node_names()))
    fused = bool(model.get("paged_fused_bwd", False))
    mapper_key = model.get("paged_mapper_fused_bwd")
    mapper_fused = fused if mapper_key is None else bool(mapper_key)

    def gt(cfg):
        return str((cfg or {}).get("name", "")).startswith("GraphTransformer")

    between = len(levels) - 1
    blocks = [mapper_fused] * (gt(model["encoder"]) * (1 + between) + gt(model["decoder"])
                               + gt(model.get("up_mapper", model["decoder"])) * between)
    process = model.get("enable_hierarchical_level_processing", model.get("level_process", True))
    proc = model["processor"]
    if process and gt(proc):
        for i, h in enumerate(levels):
            if (h, h) not in graph.edges:
                continue
            if i == len(levels) - 1:
                blocks += [fused] * int(proc["num_layers"])
            else:
                layers = model.get("level_process_num_layers") or proc["num_layers"]
                blocks += [fused] * 2 * int(layers)
    return {**NO_LAUNCHES, "K1": len(blocks), "K3": len(blocks), "K4": blocks.count(False),
            "K5": blocks.count(True)}


def graph_set_backward(label, graph, key, device, **kw) -> dict:
    """:func:`sparse_set_backward` on the host-built edge set ``key`` of
    ``graph`` with its ``edge_length`` and ``edge_dirs``."""
    from anemoi_tpu_torch.ops.gt_attention import SourceOrder

    es = graph[key]
    n_src, n_dst = graph[key[0]].num_nodes, graph[key[1]].num_nodes
    ei = torch.as_tensor(es.edge_index, dtype=torch.int32, device=device).contiguous()
    ptr = torch.as_tensor(es.dst_ptr, dtype=torch.int32, device=device)
    attr32 = torch.as_tensor(es.attribute_matrix(["edge_length", "edge_dirs"]), device=device)
    return sparse_set_backward(label, "->".join(key), ei, ptr, SourceOrder.of(ei, n_src),
                               attr32, n_src, n_dst, device, **kw)


def sparse_set_backward(label, edge_set, ei, ptr, order, attr32, n_src, n_dst, device,
                        hd=HD, k5=False, heads=HEADS) -> dict:
    """K3 + K4 (and, with ``k5``, K3 + K5) at an edge set, against the plain
    backward, the flagship's fused edge projection, width ``hd``, float32
    and bfloat16, within the phase-4 gates; the dk and dv rows of the
    sources with no edge exactly 0; K4 alone against its plain version
    (``k4_alone``).  Rows for K3, K4 (and K5), each timed single and back to
    back beside its byte bound, K4 also beside its plain version and
    ``index_add_`` timed the same two ways; with ``k5`` also K3 without its
    dkv output, as the fused backward launches it, and both backward
    passes' back-to-back sums (K3 + K4, K3 without dkv + K5).  ``heads``:
    the heads of ``hd`` (a head subset under ``heads`` sharding)."""
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.ops.gt_attention import gt_attention_bwd_kernels, gt_attention_bwd_plain

    no_edge = torch.bincount(ei[0].long(), minlength=n_src) == 0
    n_e, n_f = attr32.shape
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    rows = {"K3": [], "K4": [], **({"K5": []} if k5 else {})}
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

        q, k, v, g = rnd(1, n_dst, hd), rnd(1, n_src, hd), rnd(1, n_src, hd), rnd(1, n_dst, hd)
        edge_kw = dict(edge_attr=attr32.to(dtype), weight=rnd(hd, n_f, scale=0.3).t(),
                       bias=rnd(hd, scale=0.1))
        out, lse = kern.gt_attention_fused_edge(q, k, v, *edge_kw.values(), ei, ptr, heads)
        ref = gt_attention_bwd_plain(q, k, v, ei, heads, out, lse, g, **edge_kw)
        got = {}
        for fused_bwd in (False, True)[:1 + k5]:
            source_pass = "K5" if fused_bwd else "K4"
            kern.reset_launches()
            got[source_pass] = gt_attention_bwd_kernels(
                q, k, v, ei, ptr, order.src_ptr, order.src_perm, heads, out, lse, g,
                fused_bwd=fused_bwd, **edge_kw)
            torch.cuda.synchronize()
            launches = kern.launch_counts()  # the graph attention's K1-K5
            if launches != {name: int(name in ("K3", source_pass)) for name in launches}:
                raise RuntimeError(f"{label} {edge_set} backward: launches {launches}, want "
                                   f"one K3 and one {source_pass}")
        errs = {}  # source pass -> gradient field -> max abs error
        for source_pass, grads in got.items():
            errs[source_pass] = {}
            for field in ("dq", "dk", "dv", "d_attr", "d_weight", "d_bias"):
                x, y = getattr(grads, field).float(), getattr(ref, field).float()
                err = errs[source_pass][field] = (x - y).abs().max().item()
                if not (err <= TOL[dtype] * y.abs().max().item() and torch.isfinite(x).all()):
                    raise RuntimeError(f"{label} {edge_set} backward {dtype} K3 + {source_pass} "
                                       f"{field}: max abs err {err:.3e}, max|ref| "
                                       f"{y.abs().max().item():.3e}")
        zero_rows = [f"{name} ({source_pass})" for source_pass, grads in got.items()
                     for name in ("dk", "dv")
                     if getattr(grads, name)[:, no_edge].count_nonzero().item()]
        if zero_rows:
            raise RuntimeError(f"{label} {edge_set} backward {dtype}: {zero_rows} not exactly 0 at the "
                               f"{int(no_edge.sum())} sources with no edge")
        print(f"[{label}] K3 + {' / '.join(got)} at {edge_set} ({n_e} edges, "
              f"{int(no_edge.sum())} of {n_src} sources with no edge, HD {hd}), {dtype}: max "
              f"abs errors {errs}; dk and dv exactly 0 at the sources with no edge", flush=True)
        delta = (out.float() * g.float()).reshape(1, n_dst, heads, -1).sum(-1)
        path_kw = dict(edge_grad=False, weight_grad=True)
        dkv = kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, heads, **edge_kw,
                                        **path_kw).dkv
        calls = {"K3": lambda: kern.gt_attention_bwd_dst(
                     q, k, v, g, lse, delta, ei, ptr, heads, **edge_kw, **path_kw),
                 "K4": lambda: kern.gt_attention_bwd_src(dkv, order.src_ptr, order.src_perm),
                 "K5": lambda: kern.gt_attention_bwd_src_fused(
                     q, k, v, g, lse, delta, ei, ptr, order.src_ptr, order.src_perm, heads,
                     **edge_kw)}
        k4 = k4_alone(f"{label} {edge_set}", dkv, order, ei[0].long(), n_src)
        ms = {name: k4["ms"] if name == "K4" else cuda_ms(calls[name]) for name in rows}
        b2b = {name: k4["ms_back_to_back"] if name == "K4" else cuda_ms_back_to_back(calls[name])
               for name in rows}
        plain_ms = cuda_ms(lambda: gt_attention_bwd_plain(q, k, v, ei, heads, out, lse, g,
                                                          **edge_kw), reps=10, warmup=2)
        bounds = backward_bounds(n_dst, n_src, n_e, n_f, q.element_size(), True, hd,
                                 heads=heads)
        base = {"edge_set": edge_set, "dtype": str(dtype).split(".")[-1], "hd": hd,
                **({"heads": heads} if heads != HEADS else {}),
                "fused_edge": True, "n_dst": n_dst, "n_src": n_src, "n_edges": n_e,
                "sources_without_edges": int(no_edge.sum()), "no_edge_rows_exactly_0": True}
        k3_fields = ("dq", "d_attr", "d_weight", "d_bias")
        per_kernel = {
            "K3": dict(plain_ms=plain_ms, plain_is="gt_attention_bwd_plain", library_ms=None,
                       max_abs_err=max(e[f] for e in errs.values() for f in k3_fields),
                       errors=errs),
            "K4": dict(**k4, max_abs_err_dk_dv_vs_plain_backward=max(errs["K4"]["dk"],
                                                                     errs["K4"]["dv"])),
            "K5": dict(plain_ms=plain_ms, plain_is="gt_attention_bwd_plain", library_ms=None,
                       max_abs_err=max(errs["K5"]["dk"], errs["K5"]["dv"]) if k5 else None),
        }
        if k5:  # the fused backward's K3 writes no dkv: time it as the path runs it
            def k3_no_dkv():
                return kern.gt_attention_bwd_dst(q, k, v, g, lse, delta, ei, ptr, heads,
                                                 **edge_kw, **path_kw, emit_dkv=False)

            no_dkv = {"ms_no_dkv": cuda_ms(k3_no_dkv),
                      "ms_back_to_back_no_dkv": cuda_ms_back_to_back(k3_no_dkv),
                      "bound_ms_no_dkv": bounds["K3 (no dkv)"][0]}
            per_kernel["K3"].update(no_dkv)
            passes = {"K3 + K4": b2b["K3"] + b2b["K4"],
                      "K3 (no dkv) + K5": no_dkv["ms_back_to_back_no_dkv"] + b2b["K5"]}
            per_kernel["K5"]["backward_ms_back_to_back"] = passes
            print(f"[{label}] backward at {edge_set}, {dtype}, back to back: {passes}", flush=True)
        for name in rows:
            rows[name].append({**base, "ms": ms[name], "ms_back_to_back": b2b[name],
                               "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                               **per_kernel[name]})
            print(f"[{label}] {name} {rows[name][-1]}", flush=True)
        del q, k, v, g, out, lse, ref, got, dkv
    torch.cuda.empty_cache()
    return rows


def hierarchical_ratio_2_step(cfg: dict, graph, device) -> dict:
    """One fixed-batch training step of the preset at ``level_channel_ratio``
    2 (hidden_2, the down and the up mappers at 1024 channels, HD 1024):
    exactly ``hierarchical_launches``, the gradient gate, wall and device ms
    a step and peak memory."""
    cfg = json.loads(json.dumps(cfg))
    cfg["model"]["level_channel_ratio"] = 2
    batch = training_batch(graph, device)
    iface, state, train_step = build_training(graph, device, cfg)
    c = int(cfg["model"]["num_channels"])
    if iface.model.dims != [c, 2 * c]:
        raise RuntimeError(f"hierarchical ratio 2: level widths {iface.model.dims}")
    launches, loss, _ = one_step(state, train_step, batch)
    want = hierarchical_launches(cfg, graph)
    if launches != want:
        raise RuntimeError(f"hierarchical ratio 2: launches {launches}, want {want}")
    gap = grad_gap(iface, state, train_step, batch, "hierarchical ratio 2 K3 + K4")
    ms, runs, peak = timed_steps(device, state, train_step, batch)
    device_ms, device_launches = profiled_device_ms(lambda: train_step(state, batch), 1)
    result = {"level_dims": iface.model.dims, "launches": launches, "first_loss": loss,
              "grad_rel_l2_vs_plain": gap, "ms_per_step": ms, "ms_per_step_runs": runs,
              "device_ms_per_step": device_ms, "device_launches_per_step": device_launches,
              "peak_memory_bytes": peak}
    print(f"[hierarchical] ratio 2 fixed-batch step: {json.dumps(result)}", flush=True)
    del iface, state, train_step
    torch.cuda.empty_cache()
    return result


def hierarchical_phase(workdir: str, device) -> dict:
    """Phase 23: ``hierarchical.yaml`` and ``hierarchical_autoencoder.yaml``
    at their width (512 channels, 16 heads, 2 layers a level, the packaged
    o96 -> ico-5 -> ico-3 graph) over phase 9's store, bf16: ``cli train``
    ``FAMILY_STEPS`` steps, exactly ``hierarchical_launches`` a step, the
    gradient gate; ``cli predict`` 2 steps, equal bit for bit to the
    in-process forecast and within the serving gate of the plain
    attention; then K3 + K4 at the down set (``graph_set_backward``) and a
    fixed-batch step at ``level_channel_ratio`` 2."""
    from anemoi_tpu_torch.graphs.graph import Graph
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    graph_file = os.path.join(workdir, "graph_hierarchical.npz")
    result = {}
    for label, (preset, callbacks) in HIERARCHICAL_PRESETS.items():
        path = os.path.join(PACKAGED_CONFIG_DIR, f"{preset}.yaml")
        overrides = [f"graph.save_path={graph_file}"] + ([callbacks] if callbacks else [])
        cfg = composed_preset(path, overrides, {
            "model.num_channels": 512, "model.hidden_names": ["hidden_1", "hidden_2"],
            "model.processor.num_layers": 2, "model.processor.num_heads": 16,
            "graph.recipe.nodes.hidden_1.node_builder.resolution": 5,
            "graph.recipe.nodes.hidden_2.node_builder.resolution": 3})
        train, run_dir, _ = family_train(
            workdir, device, label, path, overrides, FAMILY_STEPS,
            lambda t: hierarchical_launches(t.config, t.graph), split=8)
        want = hierarchical_launches(cfg, Graph.load(graph_file))
        predict = family_predict(workdir, device, label, run_dir, want["K1"], split=8,
                                 bitwise=True)
        result[label] = {"train": train, "predict": predict}
        print(f"[{label}] {json.dumps(result[label])}", flush=True)
    graph = Graph.load(graph_file)
    result["graph"] = graph_summary("hierarchical", graph, "hidden_1")
    result["down_set_rows"] = graph_set_backward("hierarchical", graph, DOWN_SET, device)
    result["ratio_2"] = hierarchical_ratio_2_step(
        composed_preset(os.path.join(PACKAGED_CONFIG_DIR, "hierarchical.yaml"),
                        [f"graph.save_path={graph_file}"], {}), graph, device)
    return result


SHT_N = 96  # the o96 grid of every packaged preset
SHT_FIELDS = 12  # B * V of the timed transform
SHT_BAND_M = 9  # the shortest O96 ring (20 points) resolves m <= 9
SHT_CPU_TOL = 1e-4  # max |card - CPU| / max |CPU| of the coefficients


def sht_checks(device) -> dict:
    """``ReducedSHT`` octahedral at n = 96 (``lmax`` 95) on the card: a
    band-limited field (l <= 95, m <= 9) survives synthesis, analysis and
    synthesis again within the tolerance of the JAX package's own round
    trip (rtol 1e-4, atol 1e-5); the card's coefficients of a random field
    against the port's CPU transform; analysis + synthesis of 12 fields
    timed (CUDA events) beside the bytes and operations they need."""
    import numpy as np

    from anemoi_tpu_torch.ops.spectral import ReducedSHT

    sht = ReducedSHT.create(SHT_N, kind="octahedral")
    rng = np.random.default_rng(SEED + 6)
    L = sht.lmax + 1
    l_idx, m_idx = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    coeffs = (rng.normal(size=(L, L)) + 1j * rng.normal(size=(L, L))).astype(np.complex64)
    coeffs = np.where((m_idx <= l_idx) & (m_idx <= SHT_BAND_M), coeffs, 0).astype(np.complex64)
    coeffs[:, 0] = coeffs[:, 0].real
    c = torch.from_numpy(coeffs).to(device)
    field = sht.synthesis(c)
    back = sht.analysis(field)
    field2 = sht.synthesis(back)
    torch.cuda.synchronize()
    gaps = {"coeffs": (back - c).abs().max().item(), "field": (field2 - field).abs().max().item()}
    ok = (torch.allclose(back, c, rtol=1e-4, atol=1e-5)
          and torch.allclose(field2, field, rtol=1e-4, atol=1e-5))
    print(f"[spectral] O96 band-limited (l <= {L - 1}, m <= {SHT_BAND_M}) round trip on the card: "
          f"max |diff| {gaps} (rtol 1e-4, atol 1e-5)", flush=True)
    if not ok:
        raise RuntimeError(f"spectral: the O96 round trip fails its tolerance: {gaps}")

    x = torch.from_numpy(rng.normal(size=(SHT_FIELDS, sht.n_points)).astype(np.float32))
    cpu = sht.analysis(x)
    card = sht.analysis(x.to(device)).cpu()
    cpu_gap = ((card - cpu).abs().max() / cpu.abs().max()).item()
    print(f"[spectral] O96 analysis of {SHT_FIELDS} fields, card vs CPU: max |diff| / max|CPU| "
          f"{cpu_gap:.3e} (tol {SHT_CPU_TOL})", flush=True)
    if not cpu_gap <= SHT_CPU_TOL:
        raise RuntimeError(f"spectral: the card's coefficients disagree with the CPU's: {cpu_gap}")

    xd = x.to(device)
    ms = {"analysis": cuda_ms(lambda: sht.analysis(xd)),
          "synthesis": cuda_ms(lambda: sht.synthesis(back.expand(SHT_FIELDS, L, L))),
          "analysis_and_synthesis": cuda_ms(lambda: sht.synthesis(sht.analysis(xd)))}
    # the ring products and the Legendre products each way, as the tables lay them out
    nlat, nmax = sht.nlat, int(sht.ring_lengths.max())
    flops = 2 * SHT_FIELDS * (2 * 2 * nlat * nmax * L + 2 * 2 * nlat * L * L)
    table_bytes = 4 * (4 * nlat * nmax * L + 2 * L * L * nlat)
    io_bytes = 4 * 2 * SHT_FIELDS * sht.n_points
    bound_ms, bound_by = bound(table_bytes + io_bytes, flops)
    result = {"n_points": sht.n_points, "lmax": sht.lmax, "fields": SHT_FIELDS,
              "round_trip_max_abs": gaps, "card_vs_cpu": cpu_gap, "ms": ms,
              "bound_ms_analysis_and_synthesis": bound_ms, "bound_by": bound_by,
              "flops_analysis_and_synthesis": flops,
              "table_bytes_on_device": sum(t.numel() * t.element_size()
                                           for t in sht.tables(device).values())}
    print(f"[spectral] O96 SHT: {json.dumps(result)}", flush=True)
    return result


def spectral_step(graph, device, store) -> dict:
    """The example (phase 9's ``multi_scale`` graph, 512 channels;
    ``CUT_LAYERS`` layers) in one fixed-batch bf16 training step with
    ``CombinedLoss`` (area-weighted MSE + ``SpectralAMSELoss``,
    ``octahedral_sht``, ``gaussian_n`` 96: the spectral leaf takes no grid
    scaler) and ``residual: SpectralOrnsteinConnection`` (octahedral, 96):
    the store's points first checked to be the O96 rings, north to south,
    from longitude 0; exactly ``CUT_LAYERS`` + 2 K1, K3 and K4; the gradient
    gate; wall and device ms a step, and the same step with the
    area-weighted MSE and the plain skip: the difference is what the
    transforms take."""
    import numpy as np

    from anemoi_tpu_torch.data.dataset import open_dataset
    from anemoi_tpu_torch.flagship import example_o96_gt_config
    from anemoi_tpu_torch.graphs.generate.gaussian import octahedral_gaussian_grid
    from anemoi_tpu_torch.training.losses import get_loss_function
    from anemoi_tpu_torch.training.losses.scalers import create_scalers

    dataset = open_dataset({"kind": "zarr", "path": store})
    rings = octahedral_gaussian_grid(SHT_N)
    lon = np.where(rings[:, 1] < 0, rings[:, 1] + 2 * np.pi, rings[:, 1])
    ds_lon = np.mod(dataset.longitudes, 2 * np.pi)
    if not (np.allclose(dataset.latitudes, rings[:, 0], atol=1e-6)
            and np.allclose(ds_lon, lon, atol=1e-6)
            and np.allclose(graph["data"].coords, rings, atol=1e-6)):
        raise RuntimeError("spectral: the store's or the graph's points are not the O96 rings "
                           "in order")
    print("[spectral] the store's and the graph's 40 320 points are the O96 rings, north to "
          "south, each from longitude 0", flush=True)

    scalers = create_scalers({"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                                       "attribute_name": "area_weight"}}, graph=graph)
    spectral_loss = {"data": get_loss_function({
        "name": "CombinedLoss", "loss_weights": [1.0, 0.5], "losses": [
            {"name": "WeightedMSELoss", "scalers": ["area"]},
            {"name": "SpectralAMSELoss", "transform": "octahedral_sht", "gaussian_n": SHT_N,
             "scalers": []}]}, scalers)}
    batch = training_batch(graph, device)
    result = {}
    for label, residual, losses in (
            ("spectral", {"name": "SpectralOrnsteinConnection", "gaussian_n": SHT_N,
                          "grid_kind": "octahedral", "theta_init": 0.3}, spectral_loss),
            ("plain", None, None)):
        cfg = example_o96_gt_config()
        cfg["model"]["processor"]["num_layers"] = CUT_LAYERS
        if residual is not None:
            cfg["model"]["residual"] = residual
        iface, state, train_step = build_training(graph, device, cfg, losses)
        launches, loss, _ = one_step(state, train_step, batch)
        want = {**NO_LAUNCHES, "K1": CUT_LAYERS + 2, "K3": CUT_LAYERS + 2, "K4": CUT_LAYERS + 2}
        if launches != want:
            raise RuntimeError(f"spectral {label} step: launches {launches}, want {want}")
        gap = (grad_gap(iface, state, train_step, batch, f"spectral {label} K3 + K4")
               if label == "spectral" else None)
        ms, runs, peak = timed_steps(device, state, train_step, batch)
        device_ms, device_launches, top = profiled_device_ms(
            lambda: train_step(state, batch), 1, 8)
        result[label] = {"launches": launches, "first_loss": loss, "grad_rel_l2_vs_plain": gap,
                         "ms_per_step": ms, "ms_per_step_runs": runs,
                         "device_ms_per_step": device_ms,
                         "device_launches_per_step": device_launches,
                         "device_ms_by_kernel": top, "peak_memory_bytes": peak}
        print(f"[spectral] {label} fixed-batch step: {json.dumps(result[label])}", flush=True)
        del iface, state, train_step
        torch.cuda.empty_cache()
    result["transforms_device_ms"] = (result["spectral"]["device_ms_per_step"]
                                      - result["plain"]["device_ms_per_step"])
    result["transforms_share"] = (result["transforms_device_ms"]
                                  / result["spectral"]["device_ms_per_step"])
    print(f"[spectral] the loss's and the residual's transforms: "
          f"{result['transforms_device_ms']:.3f} device ms a step, "
          f"{100 * result['transforms_share']:.1f} % of the step", flush=True)
    return result


def spectral_phase(workdir: str, device) -> dict:
    """Phase 24: the spherical-harmonic transform at O96 on the card
    (``sht_checks``) and the example's training step with the spectral loss
    and the spectral Ornstein residual (``spectral_step``)."""
    from anemoi_tpu_torch.graphs.graph import Graph

    result = {"sht": sht_checks(device)}
    graph = Graph.load(os.path.join(workdir, "graph.npz"))  # phase 9's
    result["step"] = spectral_step(graph, device, os.path.join(workdir, "example_o96.zarr"))
    return result


PROJECTION_GRID = "o32"  # the truncation set of phase 25: 5 248 nodes
PROJECTOR_CARD_TOL = 1e-5  # max |card - CPU| / max |CPU| of a projection and its gradient
DYNAMIC_K = 3  # phase 26's runtime kNN, encoder and decoder
NEAR_TIE_RAD = 1e-5  # float32 similarities resolve arcs to ~4e-6 rad at the o96 spacing
CROSS_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # relative L2, SDPA against plain
CROSS_GRAD_TOL = 1e-2  # relative L2 of dq, dk, dv, SDPA against plain
CROSS_CHECK = (("o32", 5248), ("ico-3", 642))  # where the plain cross attention fits


def example_json(workdir: str, label: str, edit) -> str:
    """The packaged example at its width (512 channels, 16 heads, the
    ``multi_scale`` o96 -> ico-5 graph saved in the work directory; the
    processor at ``CUT_LAYERS`` of its 16), changed by ``edit(config)``, as
    a JSON file for ``cli train``."""
    from anemoi_tpu_torch.flagship import example_o96_gt_config

    cfg = example_o96_gt_config()
    cfg["model"]["processor"]["num_layers"] = CUT_LAYERS
    cfg["graph"]["save_path"] = os.path.join(workdir, f"graph_{label}.npz")
    edit(cfg)
    path = os.path.join(workdir, f"{label}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def with_projections(cfg: dict) -> None:
    """A ``truncation`` node set (o32) with KNN-3 both ways weighted by
    ``GaussianDistanceWeights`` l1, ``residual: TruncatedConnection``, and
    ``MultiscaleLossWrapper`` around the preset's loss (native weight 1,
    one scale onto ``hidden`` through the data -> hidden set at 0.5)."""
    recipe = cfg["graph"]["recipe"]
    recipe["nodes"]["truncation"] = {"node_builder": {"name": "ReducedGaussianGridNodes",
                                                      "grid": PROJECTION_GRID}}
    recipe["edges"] += [
        {"source_name": src, "target_name": dst,
         "edge_builder": {"name": "KNNEdges", "num_nearest_neighbours": 3},
         "attributes": {"gauss_weight": {"name": "GaussianDistanceWeights", "norm": "l1"}}}
        for src, dst in (("data", "truncation"), ("truncation", "data"))]
    cfg["model"]["residual"] = {"name": "TruncatedConnection"}
    cfg["training"]["loss"] = {"name": "MultiscaleLossWrapper", "native_weight": 1.0,
                               "loss": dict(cfg["training"]["loss"]),
                               "scales": [{"nodes": "hidden", "weight": 0.5}]}
    # the config schemas (both packages') have no MultiscaleLossWrapper: train
    # it unvalidated, as the JAX CLI trains it
    cfg["config_validation"] = False


def projector_checks(trainer, device) -> dict:
    """The trained model's truncated residual (down, up) and the loss's
    projection on the card: against the CPU (float32 and bf16 inputs, the
    projection and its input gradient, within ``PROJECTOR_CARD_TOL``), two
    runs equal bit for bit, forward and forward + backward timed."""
    residual, loss = trainer.interface.model.residual["data"], trainer.losses["data"]
    if type(residual).__name__ != "TruncatedConnection" or type(
            loss).__name__ != "MultiscaleLossWrapper":
        raise RuntimeError(f"projections: residual {type(residual).__name__}, loss "
                           f"{type(loss).__name__}")
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    result = {}
    for name, proj, n_src in (("residual_down", residual.down, residual.num_data),
                              ("residual_up", residual.up, residual.num_coarse),
                              ("loss_data_to_hidden", loss.projections[0], residual.num_data)):
        x32 = torch.randn(1, 1, n_src, 12, generator=gen, device=device)
        g = torch.randn(1, 1, proj.num_dst, 12, generator=gen, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            runs = []
            for dev in (device, device, torch.device("cpu")):
                x = x32.to(dev, dtype).clone().requires_grad_()
                out = proj(x)
                out.backward(g.to(dev))
                runs.append((out.detach(), x.grad))
            (o1, g1), (o2, g2), (oc, gc) = runs
            if o1.dtype != torch.float32 or not (torch.equal(o1, o2) and torch.equal(g1, g2)):
                raise RuntimeError(f"projections {name} {dtype}: output {o1.dtype}, not "
                                   "bit for bit repeatable")
            errs = [float((a.cpu().float() - b.float()).abs().max() / b.float().abs().max())
                    for a, b in ((o1, oc), (g1, gc))]
            if not max(errs) <= PROJECTOR_CARD_TOL:
                raise RuntimeError(f"projections {name} {dtype}: card against CPU {errs}")
            x = x32.to(dtype).clone().requires_grad_()
            row = {"n_src": n_src, "n_dst": proj.num_dst, "n_edges": int(proj.src.shape[0]),
                   "card_vs_cpu_out": errs[0], "card_vs_cpu_grad": errs[1], "bitwise": True,
                   "forward_ms": cuda_ms(lambda: proj(x.detach())),
                   "forward_backward_ms": cuda_ms(lambda: proj(x).backward(g))}
            result[f"{name}_{str(dtype).split('.')[-1]}"] = row
            print(f"[projections] {name} {dtype}: {json.dumps(row)}", flush=True)
    return result


def projection_step(graph, device) -> dict:
    """One fixed-batch bf16 step of the example (``CUT_LAYERS`` layers) on
    phase 25's graph with ``residual: TruncatedConnection`` and the
    multiscale loss (area-weighted MSE inside), beside the same step with
    the area-weighted MSE and the plain skip: exactly ``CUT_LAYERS`` + 2 K1,
    K3 and K4 each, the gradient gate on the first, device ms of both; the
    difference is what the projections take."""
    from anemoi_tpu_torch.flagship import example_o96_gt_config
    from anemoi_tpu_torch.training.losses import get_loss_function
    from anemoi_tpu_torch.training.losses.scalers import create_scalers

    scalers = create_scalers({"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                                       "attribute_name": "area_weight"}}, graph=graph)
    multiscale = {"data": get_loss_function({
        "name": "MultiscaleLossWrapper", "native_weight": 1.0,
        "loss": {"name": "WeightedMSELoss", "scalers": ["area"]},
        "scales": [{"nodes": "hidden", "weight": 0.5}]}, scalers, graph=graph)}
    batch = training_batch(graph, device)
    result = {}
    for label, residual, losses in (("projections", {"name": "TruncatedConnection"}, multiscale),
                                    ("plain", None, None)):
        cfg = example_o96_gt_config()
        cfg["model"]["processor"]["num_layers"] = CUT_LAYERS
        if residual is not None:
            cfg["model"]["residual"] = residual
        iface, state, train_step = build_training(graph, device, cfg, losses)
        launches, loss, _ = one_step(state, train_step, batch)
        want = {**NO_LAUNCHES, "K1": CUT_LAYERS + 2, "K3": CUT_LAYERS + 2, "K4": CUT_LAYERS + 2}
        if launches != want:
            raise RuntimeError(f"projections {label} step: launches {launches}, want {want}")
        gap = (grad_gap(iface, state, train_step, batch, f"projections {label} K3 + K4")
               if residual is not None else None)
        ms, runs, peak = timed_steps(device, state, train_step, batch)
        device_ms, device_launches = profiled_device_ms(lambda: train_step(state, batch), 1)
        result[label] = {"launches": launches, "first_loss": loss, "grad_rel_l2_vs_plain": gap,
                         "ms_per_step": ms, "ms_per_step_runs": runs,
                         "device_ms_per_step": device_ms,
                         "device_launches_per_step": device_launches, "peak_memory_bytes": peak}
        print(f"[projections] {label} fixed-batch step: {json.dumps(result[label])}", flush=True)
        del iface, state, train_step
        torch.cuda.empty_cache()
    result["projections_device_ms"] = (result["projections"]["device_ms_per_step"]
                                       - result["plain"]["device_ms_per_step"])
    result["projections_share"] = (result["projections_device_ms"]
                                   / result["projections"]["device_ms_per_step"])
    print(f"[projections] the residual's and the loss's projections: "
          f"{result['projections_device_ms']:.3f} device ms a step, "
          f"{100 * result['projections_share']:.1f} % of the step ({card_line()})", flush=True)
    return result


def projections_phase(workdir: str, device) -> dict:
    """Phase 25: the example with a ``truncation`` set in its graph,
    ``TruncatedConnection`` and ``MultiscaleLossWrapper`` through ``cli
    train`` (3 steps: 18/18/18/0 a step, the gradient gate, the projectors
    on the card against the CPU and bit for bit repeatable) and ``cli
    predict`` (2 steps, bit for bit with the in-process forecast); then the
    step beside the same step with the MSE and the plain skip."""
    from anemoi_tpu_torch.graphs.graph import Graph

    path = example_json(workdir, "projections", with_projections)
    checks = {}

    def after(trainer, state, want):
        checks.update(projector_checks(trainer, device))
        return {"truncation_nodes": trainer.graph["truncation"].num_nodes}

    train, run_dir, _ = family_train(
        workdir, device, "projections", path, [LR_ONLY], FAMILY_STEPS,
        lambda t: expected_launches(t.config, t.graph, CUT_LAYERS), split=8, after=after)
    predict = family_predict(workdir, device, "projections", run_dir, CUT_LAYERS + 2,
                             split=8, bitwise=True)
    graph = Graph.load(os.path.join(workdir, "graph_projections.npz"))
    result = {"train": train, "predict": predict, "projectors": checks,
              "step": projection_step(graph, device)}
    print(f"[projections] {json.dumps(result)}", flush=True)
    return result


def with_dynamic_knn(cfg: dict) -> None:
    """``DynamicKNN`` (k 3) on the encoder and the decoder, with the static
    sets' attribute order."""
    for part in ("encoder", "decoder"):
        cfg["model"][part]["edge_provider"] = {
            "name": "DynamicKNN", "num_nearest_neighbours": DYNAMIC_K,
            "attributes": list(cfg["model"][part]["sub_graph_edge_attributes"])}


def runtime_set_checks(trainer, device) -> dict:
    """The trained model's runtime sets on the card: against a host KNN set
    of the same coordinates (destinations whose neighbour sets differ, each
    a near tie), the device ``SourceOrder`` equal to the host one, the
    tables' build time, and K3 + K4 at the encoder's runtime set (a quarter
    of its sources edgeless) against the plain backward and
    ``index_add_``."""
    import numpy as np

    from anemoi_tpu_torch.graphs.edges import knn_edges
    from anemoi_tpu_torch.graphs.transforms import great_circle_distance
    from anemoi_tpu_torch.ops.gt_attention import SourceOrder

    model, graph = trainer.interface.model, trainer.graph
    mg = model.graph
    result, subs = {}, {}
    for part, src, dst in (("encoder", "data", "hidden"), ("decoder", "hidden", "data")):
        sub = model._mapper_edges(part, src, dst, getattr(mg, part)["data"])
        subs[part] = sub
        ei = sub.edge_index.cpu().numpy().astype(np.int64)
        host = knn_edges(graph, src, dst, DYNAMIC_K)
        mine_k = np.sort(ei[0].reshape(-1, DYNAMIC_K), 1)
        host_k = np.sort(host[0].reshape(-1, DYNAMIC_K), 1)
        differ = np.flatnonzero((mine_k != host_k).any(1))
        dist = [np.sort(great_circle_distance(graph[src].coords[e[0]],
                                              graph[dst].coords[e[1]]).reshape(-1, DYNAMIC_K), 1)
                for e in (ei, host)]
        gap = float(np.abs(dist[0] - dist[1]).max())
        if gap > NEAR_TIE_RAD:
            raise RuntimeError(f"dynamic {part}: runtime neighbours farther than the host's by "
                               f"{gap:.3e} rad")
        device_order = SourceOrder.on_device(sub.edge_index, sub.num_src)
        host_order = SourceOrder.of(sub.edge_index, sub.num_src)
        if not all(torch.equal(a, b) for a, b in zip(device_order, host_order)):
            raise RuntimeError(f"dynamic {part}: the device source order differs from the host's")
        build_ms = cuda_ms(lambda: model._mapper_edges(part, src, dst, getattr(mg, part)["data"]),
                           reps=10, warmup=2)
        result[part] = {"edges": sub.num_edges, "destinations_differing_from_host_knn":
                        int(differ.size), "max_arc_gap_rad": gap,
                        "source_order_equal_to_host": True, "table_build_ms": build_ms,
                        "max_out_degree": int((sub.src_ptr[1:] - sub.src_ptr[:-1]).max())}
        print(f"[dynamic] {part} runtime set: {json.dumps(result[part])} ({card_line()})",
              flush=True)
    result["table_build_ms_per_step"] = sum(result[p]["table_build_ms"] for p in subs)
    enc = subs["encoder"]
    result["encoder_rows"] = sparse_set_backward(
        "dynamic", f"data->hidden (runtime kNN-{DYNAMIC_K})", enc.edge_index, enc.dst_ptr,
        enc.source, enc.edge_attr.float(), enc.num_src, enc.num_dst, device)
    return result


def tie_regions(runtime: dict, knn_graph) -> dict:
    """Grid points by how a tie broken the other way reaches them: the data
    nodes whose decoder set differs between the runtime and the static KNN
    sets (``decoder_tied``), those whose decoder reads a hidden node whose
    encoder set differs (``reads_encoder_tied``), and the ``rest``."""
    import numpy as np

    def differing(a, b):
        """[Nd] True where the k sources of a destination differ."""
        rows = [e[0][np.lexsort((e[0], e[1]))].reshape(-1, DYNAMIC_K) for e in (a, b)]
        return (rows[0] != rows[1]).any(1)

    enc_tied = differing(runtime[("data", "hidden")], knn_graph[("data", "hidden")].edge_index)
    dec = runtime[("hidden", "data")]
    dec_tied = differing(dec, knn_graph[("hidden", "data")].edge_index)
    reads = np.zeros_like(dec_tied)
    reads[dec[1][enc_tied[dec[0]]]] = True
    return {"decoder_tied": dec_tied, "reads_encoder_tied": reads & ~dec_tied,
            "rest": ~(dec_tied | reads)}


def split_gap(out, ref, regions: dict) -> dict:
    """Per forecast step and region of ``tie_regions``: the relative L2 of
    ``out`` against ``ref`` ``[B, T, E, G, V]`` over the region's grid
    points, and the region's share of the squared difference."""
    import numpy as np

    split = {}
    for t in range(ref.shape[1]):
        d, r = out[:, t] - ref[:, t], ref[:, t]
        total = float((d ** 2).sum())
        split[f"step_{t + 1}"] = {
            name: {"rel_l2": float(np.linalg.norm(d[..., m, :]) / np.linalg.norm(r[..., m, :])),
                   "share": float((d[..., m, :] ** 2).sum()) / max(total, 1e-30)}
            for name, m in regions.items() if m.any()}
    return split


def dynamic_against_static(workdir: str, run_dir: str, device) -> dict:
    """The dynamic bundle's forecast against the same weights on static
    graphs of the same nodes (copies of the bundle without the edge
    providers): the static KNN-3 graph (``KNNEdges`` on both mappers), whose
    sets differ from the runtime ones at near ties, and the graph holding
    the runtime sets themselves with their attributes from the host
    builders.  The second is gated by the serving tolerance; the first
    differs wherever a tie was broken the other way (tens of destinations
    at o96 -> ico-5), and is printed, also split by grid point
    (``tie_regions``)."""

    import numpy as np

    from anemoi_tpu_torch.data.dataset import open_dataset
    from anemoi_tpu_torch.graphs.create import GraphCreator
    from anemoi_tpu_torch.graphs.edges import edge_direction, edge_length
    from anemoi_tpu_torch.graphs.graph import EdgeSet
    from anemoi_tpu_torch.inference import make_forecast_fn
    from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint

    bundle = os.path.join(run_dir, "inference")
    iface = load_inference_checkpoint(bundle, device)
    with open(os.path.join(bundle, "checkpoint.json")) as f:
        meta = json.load(f)
    cfg = meta["config"]
    dataset = open_dataset(dict(cfg["data"]["datasets"]["data"]))
    window = dataset.get_window(0, iface.model.n_step_input + STEPS)
    batch = {"data": torch.from_numpy(window[None]).to(device)}
    out = {"dynamic": make_forecast_fn(iface, steps=STEPS)(batch)["data"].float().cpu().numpy()}
    runtime = {(src, dst): iface.model._mapper_edges(
        part, src, dst, getattr(iface.model.graph, part)["data"]).edge_index.cpu().numpy()
        for part, src, dst in (("encoder", "data", "hidden"), ("decoder", "hidden", "data"))}
    del iface
    for part in ("encoder", "decoder"):
        cfg["model"][part].pop("edge_provider")
    cfg["graph"]["recipe"]["edges"][0]["edge_builder"] = {
        "name": "KNNEdges", "num_nearest_neighbours": DYNAMIC_K}
    knn_graph = GraphCreator(cfg["graph"]["recipe"]).create()
    regions = tie_regions(runtime, knn_graph)
    result = {"tie_regions": {name: int(m.sum()) for name, m in regions.items()}}
    for label in ("static_knn", "static_runtime_sets"):
        graph_path = os.path.join(workdir, f"graph_dynamic_{label}.npz")
        if label == "static_runtime_sets":
            for (src, dst), ei in runtime.items():
                ei = ei.astype(np.int64)
                attrs = {"edge_length": edge_length(knn_graph, src, dst, ei),
                         "edge_dirs": edge_direction(knn_graph, src, dst, ei)}
                knn_graph[(src, dst)] = EdgeSet(ei, attrs).sort_by_dst(knn_graph[dst].num_nodes)
        knn_graph.save(graph_path)
        cfg["graph"]["save_path"] = graph_path
        static = os.path.join(workdir, f"dynamic_{label}_bundle")
        shutil.copytree(bundle, static)
        with open(os.path.join(static, "checkpoint.json"), "w") as f:
            json.dump(meta, f)
        iface = load_inference_checkpoint(static, device)
        ref = make_forecast_fn(iface, steps=STEPS)(batch)["data"].float().cpu().numpy()
        del iface
        result[label] = float(np.linalg.norm(out["dynamic"] - ref) / np.linalg.norm(ref))
        result[f"{label}_by_region"] = split_gap(out["dynamic"], ref, regions)
        print(f"[dynamic] forecast against the same weights on the {label} graph: relative L2 "
              f"{result[label]:.3e} (tol {SERVING_TOL}); by region and step: "
              f"{json.dumps(result[f'{label}_by_region'])}", flush=True)
    if not result["static_runtime_sets"] <= SERVING_TOL:
        raise RuntimeError(f"dynamic: forecast differs from the static graphs': {result}")
    torch.cuda.empty_cache()
    return result


def dynamic_phase(workdir: str, device) -> dict:
    """Phase 26: the example with ``DynamicKNN`` on the encoder and the
    decoder through ``cli train`` (3 steps: 18/18/18/0 a step on the
    runtime sets, the gradient gate, ``runtime_set_checks``) and ``cli
    predict`` (2 steps, bit for bit with the in-process forecast), then the
    forecast against the static graphs."""
    path = example_json(workdir, "dynamic", with_dynamic_knn)
    checks = {}

    def after(trainer, state, want):
        checks.update(runtime_set_checks(trainer, device))
        return {}

    train, run_dir, _ = family_train(
        workdir, device, "dynamic", path, [LR_ONLY], FAMILY_STEPS,
        lambda t: expected_launches(t.config, t.graph, CUT_LAYERS), split=8, after=after)
    predict = family_predict(workdir, device, "dynamic", run_dir, CUT_LAYERS + 2, split=8,
                             bitwise=True)
    result = {"train": train, "predict": predict, "runtime_sets": checks,
              "static": dynamic_against_static(workdir, run_dir, device)}
    print(f"[dynamic] {json.dumps({k: v for k, v in result.items() if k != 'runtime_sets'})}",
          flush=True)
    return result


def with_transformer_mappers(cfg: dict) -> None:
    cfg["model"]["encoder"] = {"name": "TransformerForwardMapper", "num_heads": HEADS,
                               "mlp_hidden_ratio": 4.0}
    cfg["model"]["decoder"] = {"name": "TransformerBackwardMapper", "num_heads": HEADS,
                               "mlp_hidden_ratio": 4.0, "initialise_data_extractor_zero": False}


def cross_attention_checks(device) -> dict:
    """SDPA (flash / memory-efficient) against the plain cross attention at
    o32 -> ico-3 (where the plain one fits), both directions, 16 heads of
    32, float32 and bf16: the output within ``CROSS_TOL`` and dq, dk, dv
    within ``CROSS_GRAD_TOL`` (relative L2); both timed, forward and
    forward + backward."""
    from anemoi_tpu_torch.models.layers.attention import cross_attention, cross_attention_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    (grid, n_grid), (mesh, n_mesh) = CROSS_CHECK
    d = HD // HEADS
    rows = []
    for label, nq, nk in ((f"{grid}->{mesh}", n_mesh, n_grid), (f"{mesh}->{grid}", n_grid, n_mesh)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(1, n, HEADS, d, generator=gen, device=device).to(dtype)
                       for n in (nq, nk, nk))
            g = torch.randn(1, nq, HEADS, d, generator=gen, device=device).to(dtype)
            outs = {}
            for route, fn in (("sdpa", cross_attention), ("plain", cross_attention_plain)):
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                out = fn(*leaves)
                out.backward(g)
                outs[route] = [out.detach().float()] + [t.grad.float() for t in leaves]

            def rel(a, b):
                return float((a - b).norm() / b.norm())

            errs = [rel(a, b) for a, b in zip(outs["sdpa"], outs["plain"])]
            if not (errs[0] <= CROSS_TOL[dtype] and max(errs[1:]) <= CROSS_GRAD_TOL):
                raise RuntimeError(f"cross attention {label} {dtype}: SDPA against plain "
                                   f"(out, dq, dk, dv) {errs}")
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            row = {"shape": label, "dtype": str(dtype).split(".")[-1], "nq": nq, "nk": nk,
                   "rel_l2_out": errs[0], "rel_l2_dq_dk_dv": errs[1:],
                   "sdpa_ms": cuda_ms(lambda: cross_attention(q, k, v)),
                   "plain_ms": cuda_ms(lambda: cross_attention_plain(q, k, v), reps=10),
                   "sdpa_fwd_bwd_ms": cuda_ms(lambda: cross_attention(*leaves).backward(g),
                                              reps=10)}
            rows.append(row)
            print(f"[transformer mappers] SDPA vs plain: {json.dumps(row)}", flush=True)
    return {"rows": rows}


def mapper_times(trainer, device) -> dict:
    """Each Transformer mapper of the trained model, cast to bf16, forward
    and forward + backward at the full shapes (o96 -> ico-5, B 1), CUDA
    events; peak memory of the encoder's forward + backward."""
    import copy

    model = trainer.interface.model
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    n_grid, n_mesh = model.graph.num_nodes["data"], model.graph.num_nodes["hidden"]
    result = {}
    for part, mapper in (("encoder", model.encoder["data"]), ("decoder", model.decoder["data"])):
        m = copy.deepcopy(mapper).to(torch.bfloat16)
        if part == "encoder":
            shapes = ((1, n_grid, m.emb_nodes_src.in_features),
                      (1, n_mesh, m.emb_nodes_dst.in_features))
        else:
            shapes = ((1, n_mesh, HD), (1, n_grid, m.emb_nodes_dst.in_features))
        xs = [torch.randn(*sh, generator=gen, device=device, dtype=torch.bfloat16) for sh in shapes]

        def fwd(m=m, xs=xs, part=part):
            out = m(tuple(xs))
            return out[1] if part == "encoder" else out

        def fwd_bwd():
            fwd().float().square().mean().backward()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        fwd_bwd()
        torch.cuda.synchronize()
        result[part] = {"forward_ms": cuda_ms(fwd, reps=10), "forward_backward_ms":
                        cuda_ms(fwd_bwd, reps=10), "peak_memory_bytes":
                        torch.cuda.max_memory_allocated(device)}
        print(f"[transformer mappers] {part} bf16 at full shape: {json.dumps(result[part])} "
              f"({card_line()})", flush=True)
        del m
        torch.cuda.empty_cache()
    return result


def transformer_mappers_phase(workdir: str, device) -> dict:
    """Phase 27: the example with the dense cross-attention Transformer
    mappers (16 heads) and its GT processor: SDPA against the plain cross
    attention where the plain one fits (``cross_attention_checks``); ``cli
    train`` 3 steps (16 K1, K3 and K4 a step, the processor's; the gradient
    gate), the mappers' times at full shape, ``cli predict`` 2 steps (16 K1
    a step, bit for bit with the in-process forecast)."""
    checks = cross_attention_checks(device)
    path = example_json(workdir, "transformer_mappers", with_transformer_mappers)
    times = {}

    def after(trainer, state, want):
        times.update(mapper_times(trainer, device))
        return {}

    want = {**NO_LAUNCHES, "K1": CUT_LAYERS, "K3": CUT_LAYERS, "K4": CUT_LAYERS}
    train, run_dir, _ = family_train(workdir, device, "transformer_mappers", path, [LR_ONLY],
                                     FAMILY_STEPS, lambda t: want, split=8, after=after)
    predict = family_predict(workdir, device, "transformer_mappers", run_dir, CUT_LAYERS,
                             split=8, bitwise=True)
    result = {"sdpa_vs_plain": checks, "train": train, "mapper_times": times,
              "predict": predict}
    print(f"[transformer mappers] {json.dumps(result)}", flush=True)
    return result


MESH_GRAPHS = {  # label -> data nodes, hidden nodes, data->hidden, hidden->hidden, hidden->data
    "hex": (40320, 20480, 41704, 245700, 120960),
    "healpix": (40320, 12288, 48880, 130568, 120960),
    "icon": (81920, 10242, 245760, 81900, 245760),
}
MESH_LAUNCHES = {  # label -> K1, K3, K4, K5 a training step (K5: the 2 GB mapper rule)
    "hex": (CUT_LAYERS + 2,) * 3 + (0,), "healpix": (CUT_LAYERS + 2,) * 3 + (0,),
    "icon": (CUT_LAYERS + 2, CUT_LAYERS + 2, CUT_LAYERS, 2)}
ICON_RESOLUTION, ICON_MAX_LEVEL = 6, 5  # the synthetic ICON grid: 81 920 cells, 10 242 vertices
ENCODER_SET = ("data", "hidden")


def mesh_config(workdir: str, label: str, edit) -> str:
    """The ``graphtransformer`` model at its width (1024 channels, 16 heads;
    the processor at ``CUT_LAYERS`` of its 16) on ``graph/hex_mesh.yaml`` or
    ``graph/icon_mesh.yaml`` (``edit(config)`` picks and changes it),
    composed from a defaults list by the port's ``load_config`` and written
    as JSON for ``cli train``."""
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config

    graph = "icon_mesh" if label == "icon" else "hex_mesh"
    defaults = os.path.join(workdir, f"{label}.yaml")
    with open(defaults, "w") as f:
        f.write(FAMILY_DEFAULTS.format(graph=graph, model="graphtransformer"))
    cfg = load_config(defaults, search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    model = cfg["model"]
    width = (model["num_channels"], model["processor"]["num_layers"],
             model["processor"]["num_heads"], model["encoder"]["num_heads"])
    if width != (1024, FLAGSHIP_LAYERS, 16, 16):
        raise RuntimeError(f"{label}: the graphtransformer preset composed to {width}")
    model["processor"]["num_layers"] = CUT_LAYERS
    cfg["graph"]["save_path"] = os.path.join(workdir, f"graph_{label}.npz")
    edit(cfg)
    path = os.path.join(workdir, f"{label}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def with_healpix(cfg: dict) -> None:
    """The hex recipe with a nested HEALPix r5 processor mesh."""
    recipe = cfg["graph"]["recipe"]
    recipe["nodes"]["hidden"]["node_builder"] = {"name": "HEALPixNodes", "resolution": 5}
    [processor] = [e for e in recipe["edges"] if e["source_name"] == e["target_name"]]
    processor["edge_builder"] = {"name": "HEALPixMultiScaleEdges"}


def with_icon_grid(grid: str):
    """``graph/icon_mesh.yaml`` on ``grid`` at ``ICON_MAX_LEVEL``, and a
    synthetic dataset (the example's 12 variables, 64 times) on the grid's
    cells."""
    def set_grid(node):
        if isinstance(node, dict):
            for key, value in node.items():
                if key == "grid_filename":
                    node[key] = grid
                elif key == "max_level":
                    node[key] = ICON_MAX_LEVEL
                else:
                    set_grid(value)
        elif isinstance(node, list):
            for value in node:
                set_grid(value)

    def edit(cfg: dict) -> None:
        set_grid(cfg["graph"])
        data = cfg["data"]["datasets"]["data"]
        data["nodes"] = {"name": "ICONCellGridNodes", "grid_filename": grid}
        data["num_times"] = 64
    return edit


def mesh_phase(workdir: str, device, label: str) -> dict:
    """Phases 28-30: the ``graphtransformer`` model at its width on the hex,
    HEALPix or ICON processor mesh through ``cli train`` (3 steps: exactly
    ``MESH_LAUNCHES`` a step, the 2 GB rule's K5 on the ICON mappers; the
    gradient gate) and ``cli predict`` (2 steps, 18 K1 a step, bit for bit
    with the in-process forecast); the graph's node and edge counts against
    ``MESH_GRAPHS``, its degree ranges and edgeless sources; K3 + K4 at the
    encoder set beside ``index_add_`` (hex), K3 + K4 and K3 + K5 there
    (ICON)."""
    from anemoi_tpu_torch.graphs.generate.icon import write_synthetic_icon_grid

    if label == "icon":
        grid = os.path.join(workdir, "icon_grid.nc")
        write_synthetic_icon_grid(grid, ICON_RESOLUTION)
        edit, dataset = with_icon_grid(grid), "config"
    else:
        edit, dataset = (with_healpix if label == "healpix" else lambda cfg: None), None
    path = mesh_config(workdir, label, edit)
    summary, encoder_rows = {}, {}

    def want(trainer):
        counts = expected_launches(trainer.config, trainer.graph, CUT_LAYERS)
        if tuple(counts[k] for k in ("K1", "K3", "K4", "K5")) != MESH_LAUNCHES[label]:
            raise RuntimeError(f"{label}: the launch rule gives {counts}, want K1/K3/K4/K5 "
                               f"{MESH_LAUNCHES[label]}")
        return counts

    def after(trainer, state, want_1):
        graph = trainer.graph
        summary.update(graph_summary(label, graph))
        counts = (summary["data_nodes"], summary["hidden_nodes"],
                  *(summary[key]["edges"] for key in ("data->hidden", "hidden->hidden",
                                                      "hidden->data")))
        if counts != MESH_GRAPHS[label]:
            raise RuntimeError(f"{label}: graph counts {counts}, want {MESH_GRAPHS[label]}")
        if label != "healpix":
            encoder_rows.update(graph_set_backward(label, graph, ENCODER_SET, device,
                                                   hd=WIDE_HD, k5=label == "icon"))
        return {}

    train, run_dir, _ = family_train(workdir, device, label, path, [LR_ONLY], FAMILY_STEPS,
                                     want, split=8, dataset=dataset, after=after)
    predict = family_predict(workdir, device, label, run_dir, CUT_LAYERS + 2, split=8,
                             bitwise=True)
    result = {"graph": summary, "train": train, "predict": predict}
    print(f"[{label}] {json.dumps(result)}", flush=True)
    result["encoder_rows"] = encoder_rows
    return result


# --- phase 31: data and halo model parallelism -------------------------------
PARALLEL_STEPS = 3  # timed bf16 training steps of each rank of the model group of 2
PARALLEL_DP_STEPS = 2  # fp32 steps of data 2 x model 2 against one process at batch 2
# relative L2 gates (forecast, step-1 gradients) against one process: PERF.md section 2
PARALLEL_TOL = {"fp32": (1e-4, 1e-4), "bf16": (2e-2, 1e-2)}
PARALLEL_DP_TOL = 1e-4  # relative, each step's loss of the 4 ranks against one process
PARALLEL_RATE = 1e-4  # constant, so that the first update already moves the weights


def halo_calls(model) -> int:
    """The attention op's calls in one forward of a halo-sharded model on
    this rank: per edge set, its interior and its boundary rows (all its
    rows without ``halo_overlap``), each where it has edges."""
    def calls(shard):
        sets = (shard.interior, shard.boundary) if shard.overlap else (shard.full,)
        return sum(csr.num_edges > 0 for csr in sets)

    halo = model.halo
    return (sum(calls(s) for s in halo["encoder"].values())
            + len(model.processor.proc) * calls(halo["processor"])
            + sum(calls(s) for s in halo["decoder"].values()))


def halo_exchanges(model, channels: int, elt: int) -> dict:
    """Per edge set of this rank: the rows each exchange sends and receives
    (``S * h_pair``, the buffer, self slot included), the real rows it
    receives, and the buffer's bytes each way (keys and values: 2C
    channels of ``elt`` bytes, batch 1)."""
    def sizes(shard):
        buf = shard.num_shards * shard.h_pair
        return {"h_pair": shard.h_pair, "buffer_rows": buf,
                "real_rows_sent": int(shard.send_mask.sum()),
                "bytes_each_way": buf * 2 * channels * elt,
                "n_local": shard.n_local, "n_local_src": shard.n_local_src}

    halo = model.halo
    return {"encoder": sizes(halo["encoder"]["data"]), "processor": sizes(halo["processor"]),
            "decoder": sizes(halo["decoder"]["data"])}


def parallel_interface(graph, device, mesh=None, num_layers: int = None):
    """The flagship's training interface (float32 masters) for phase 31,
    ``shard_strategy: edges`` over ``mesh``'s model group when it has more
    than one rank.  The weights are the interface's own draws from
    ``context_seed("model-init")``, the same on every rank and in one
    process."""
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface

    config = flagship_config(num_layers=CUT_LAYERS if num_layers is None else num_layers)
    if mesh is not None and mesh.size("model") > 1:
        config["model"].update(shard_strategy="edges", num_model_shards=mesh.size("model"))
    return AnemoiModelInterface(config=config, graph=graph, data_indices=flagship_indices(),
                                statistics=flagship_statistics(SEED), device=device,
                                training=True, mesh=mesh)


def parallel_step(iface, graph, precision: str):
    """(TrainState, train_step) with a fresh optimizer state: ``precision``
    compute over the masters (AdamW at a constant rate, value clipping at
    32); the interface's forecasts serve in that type too."""
    from anemoi_tpu_torch.training.optimizers import build_optimizer
    from anemoi_tpu_torch.training.step import COMPUTE_TYPES, TrainState, make_step_fns

    iface.inference_dtype = COMPUTE_TYPES[precision] or torch.float32
    tx = build_optimizer({"gradient_clip": {"val": 32.0, "algorithm": "value"}},
                         schedule=lambda count: PARALLEL_RATE)
    train_step, _ = make_step_fns(iface, training_losses(graph), rollout=1, precision=precision)
    return TrainState.create(iface, tx), train_step


def forecast_batch(graph, device):
    """The serving phase's seeded raw window (m + 2 steps)."""
    idx = flagship_indices()["data"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    return {"data": torch.randn(1, 2 + STEPS, 1, graph["data"].num_nodes, idx.num_data_vars,
                                generator=gen, device=device)}


def parallel_rank(graph, workdir: str) -> dict:
    """One rank of a model group of 2 on the card (phase 31): per precision
    the step-1 gradient and a 2-step forecast (rank 0 saves both for the
    parent), each with its launches; in bf16 also ``PARALLEL_STEPS``
    training steps, each with its launches and wall ms, and the rank's peak
    memory; then, on rank 0, a one-rank NCCL group."""
    import torch.distributed as dist

    from anemoi_tpu_torch import kernels
    from anemoi_tpu_torch.inference import make_forecast_fn
    from anemoi_tpu_torch.parallel import distributed
    from anemoi_tpu_torch.parallel.mesh import Mesh, MeshSpec, create_mesh

    launch = distributed.launch()
    device = launch.device
    mesh = create_mesh(MeshSpec(model=launch.world), device)
    batch, fbatch = training_batch(graph, device), forecast_batch(graph, device)
    out = {"rank": launch.rank, "backend": launch.backend, "device": str(device)}
    iface = parallel_interface(graph, device, mesh)
    calls = halo_calls(iface.model)
    for precision in ("fp32", "bf16"):
        state, train_step = parallel_step(iface, graph, precision)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launches()
        train_step.compute_gradients(state, batch)
        torch.cuda.synchronize()
        res = {"halo_calls": calls, "grad_launches": kernels.launch_counts()}
        if launch.rank == 0:
            torch.save(flat_grads(iface).cpu(), os.path.join(workdir, f"grads_{precision}.pt"))
        forecast = make_forecast_fn(iface, STEPS)
        kernels.reset_launches()
        y = forecast(fbatch)["data"]
        torch.cuda.synchronize()
        res["forecast_launches"] = kernels.launch_counts()
        if launch.rank == 0:
            torch.save(y.cpu(), os.path.join(workdir, f"forecast_{precision}.pt"))
        if precision == "bf16":
            res["exchanges"] = halo_exchanges(iface.model, HD, 2)
            res["step_launches"], res["losses"], res["wall_ms"] = [], [], []
            for _ in range(PARALLEL_STEPS):
                t0 = time.perf_counter()
                kernels.reset_launches()
                state, metrics = train_step(state, batch)
                torch.cuda.synchronize()
                res["wall_ms"].append((time.perf_counter() - t0) * 1e3)
                res["step_launches"].append(kernels.launch_counts())
                res["losses"].append(float(metrics["loss"]))
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
        out[precision] = res
        del state, train_step, forecast, y
        torch.cuda.empty_cache()
    del iface
    torch.cuda.empty_cache()
    # a one-rank NCCL group on the card (every rank takes part in creating
    # it): an all-reduce of a CUDA tensor, and a training step whose
    # gradient reduction runs over it (the group as the data group)
    nccl = dist.new_group([0], backend="nccl")
    if launch.rank == 0:
        t = torch.arange(4, dtype=torch.float32, device=device)
        distributed.all_reduce(t, nccl)
        one_rank = Mesh(MeshSpec(), 0, device, groups={"data": nccl})
        iface = parallel_interface(graph, device, one_rank, num_layers=1)
        state, train_step = parallel_step(iface, graph, "bf16")
        state, metrics = train_step(state, batch)
        out["nccl"] = {"backend": dist.get_backend(nccl), "all_reduce": t.cpu().tolist(),
                       "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
        del iface, state, train_step
    dist.barrier()
    return out


def parallel_dp_rank(graph) -> dict:
    """One rank of data 2 x model 2 (phase 31): the fp32 losses of
    ``PARALLEL_DP_STEPS`` steps on its batch row of the batch-2 window."""
    from anemoi_tpu_torch.parallel import distributed
    from anemoi_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    launch = distributed.launch()
    device = launch.device
    mesh = create_mesh(MeshSpec(data=2, model=2), device)
    row = mesh.index("data")
    batch = {"data": torch.cat([training_batch(graph, device)["data"],
                                training_batch(graph, device, seed=SEED + 3)["data"]])[row:row + 1]}
    iface = parallel_interface(graph, device, mesh)
    state, train_step = parallel_step(iface, graph, "fp32")
    losses = []
    for _ in range(PARALLEL_DP_STEPS):
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return {"rank": launch.rank, "coords": mesh.coords, "losses": losses,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device)}


def k1_set_rows(label, edge_set, ei, ptr, attr32, n_src, n_dst, device, hd=HD,
                heads=HEADS) -> list:
    """K1 at an edge set (the flagship's fused projection, width ``hd`` in
    ``heads`` heads), float32 and bfloat16: out and lse against the plain
    op on every row (out 0 and lse -inf on the destinations without edges,
    both sides), dq of K3 exactly 0 there; each row timed single and back
    to back beside its bound and the plain op."""
    from anemoi_tpu_torch.kernels import gt_attention as kern
    from anemoi_tpu_torch.ops.gt_attention import SourceOrder, gt_attention_bwd_kernels
    from anemoi_tpu_torch.ops.gt_attention import gt_attention_plain

    no_dst = (ptr[1:] - ptr[:-1]) == 0
    order = SourceOrder.of(ei, n_src)
    rows = []
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

        q, k, v, g = rnd(1, n_dst, hd), rnd(1, n_src, hd), rnd(1, n_src, hd), rnd(1, n_dst, hd)
        w, b = rnd(hd, attr32.shape[1], scale=0.3).t(), rnd(hd, scale=0.1)
        attr = attr32.to(dtype)

        def k1():
            return kern.gt_attention_fused_edge(q, k, v, attr, w, b, ei, ptr, heads)

        kern.reset_launches()
        out, lse = k1()
        torch.cuda.synchronize()
        if kern.launch_counts()["K1"] != 1:
            raise RuntimeError(f"{label}: K1 did not launch once: {kern.launch_counts()}")

        def plain():
            return gt_attention_plain(q, k, v, attr.float() @ w.float() + b.float(), ei, ptr,
                                      heads)

        ref, ref_lse = plain()
        err = (out.float() - ref.float()).abs().max().item()
        edgeless_out = out[:, no_dst].count_nonzero().item()
        lse_pattern = bool(torch.equal(torch.isinf(lse), torch.isinf(ref_lse)))
        finite = torch.isfinite(ref_lse)
        lse_err = (lse[finite] - ref_lse[finite]).abs().max().item()
        if not (err <= TOL[dtype] * ref.float().abs().max().item() and edgeless_out == 0
                and lse_pattern and bool(torch.isinf(lse[:, no_dst]).all())
                and lse_err <= 1e-2):
            raise RuntimeError(f"{label} K1 at {edge_set} {dtype}: out err {err:.3e}, nonzero "
                               f"edgeless outputs {edgeless_out}, lse -inf pattern "
                               f"{lse_pattern}, lse err {lse_err:.3e}")
        grads = gt_attention_bwd_kernels(q, k, v, ei, ptr, order.src_ptr, order.src_perm,
                                         heads, out, lse, g, edge_attr=attr, weight=w, bias=b)
        if grads.dq[:, no_dst].count_nonzero().item():
            raise RuntimeError(f"{label} K3 at {edge_set} {dtype}: dq not exactly 0 on the "
                               f"{int(no_dst.sum())} edgeless destinations")
        bound_ms, bound_by = attention_bound(n_dst, n_src, int(ei.shape[1]), attr.shape[1],
                                             q.element_size(), True, hd, heads=heads)
        rows.append({
            "edge_set": edge_set, "dtype": str(dtype).split(".")[-1], "fused_edge": True,
            **({"hd": hd, "heads": heads} if hd != HD else {}),
            "n_dst": n_dst, "n_src": n_src, "n_edges": int(ei.shape[1]),
            "destinations_without_edges": int(no_dst.sum()), "max_abs_err": err,
            "lse_max_abs_err": lse_err, "edgeless_rows_exact": True,
            "ms": cuda_ms(k1), "ms_back_to_back": cuda_ms_back_to_back(k1),
            "plain_ms": cuda_ms(plain, reps=10, warmup=2),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        print(f"[{label}] K1 {rows[-1]}; dq exactly 0 on the {int(no_dst.sum())} edgeless "
              "destinations", flush=True)
        del q, k, v, g, out, lse, ref, ref_lse, grads
    return rows


def halo_shard_kernels(graph, device) -> dict:
    """K1 and K3 + K4 on the processor set of model shard 2 of 2 (no
    ``halo_overlap``: its 5 128 destination rows, 14 of them padded and
    edgeless, over 5 128 local and 2 x 400 halo source rows, the padded and
    self-slot halo rows edgeless), with the set's own attributes in the
    shard's edge order: K1's out and lse against the plain op on every row
    (``k1_set_rows``), K3 + K4 through ``sparse_set_backward`` (its gates,
    dk and dv exactly 0 on the edgeless sources)."""
    from anemoi_tpu_torch.models.graph import extract_subgraph

    sub = extract_subgraph(graph, "hidden", "hidden", list(EDGE_ATTRIBUTES), device,
                           torch.float32)
    shard = sub.sharded_edge_data(2, 1, None, overlap=False)
    csr = shard.full
    attr32 = sub.edge_attr[shard.edge_perm[: csr.num_edges]]
    edge_set = "hidden->hidden, model shard 2 of 2"
    rows = {"K1": k1_set_rows("parallel", edge_set, csr.edge_index, csr.dst_ptr, attr32,
                              csr.num_src, csr.num_dst, device)}
    rows.update(sparse_set_backward("parallel", edge_set, csr.edge_index, csr.dst_ptr,
                                    csr.source, attr32, csr.num_src, csr.num_dst, device))
    torch.cuda.empty_cache()
    return rows


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def ranks_of_2(graph, hierarchical_file: str, projections_file: str, workdir: str) -> dict:
    """Every run of phases 31-33 on a world of 2 ranks, in one world (one
    start-up for the three): ``parallel_rank``, ``families_rank`` and
    ``routes_rank`` in turn."""
    return {"parallel": parallel_rank(graph, workdir),
            "families": families_rank(graph, hierarchical_file, workdir),
            "routes": routes_rank(graph, projections_file, hierarchical_file, workdir)}


def ranks_of_4(graph, workdir: str) -> dict:
    """Every run of phases 31-32 on a world of 4 ranks, in one world:
    ``parallel_dp_rank`` (data 2 x model 2), then ``ensemble_axis_rank``
    (ensemble 2 x model 2)."""
    return {"data2_model2": parallel_dp_rank(graph),
            "ensemble": ensemble_axis_rank(graph, workdir)}


def parallel_phase(workdir: str, graph, device) -> dict:
    """Phase 31: the flagship over ranks that share the card (gloo).  Its
    two worlds (``ranks_of_2``, ``ranks_of_4``) also run the rank parts of
    phases 32 and 33, whose results go back under ``"worlds"``."""
    from anemoi_tpu_torch import kernels
    from anemoi_tpu_torch.inference import make_forecast_fn
    from anemoi_tpu_torch.parallel.distributed import spawn
    from anemoi_tpu_torch.training import cli

    seconds, t_part = {}, time.perf_counter()

    def lap(name):
        nonlocal t_part
        seconds[name] = round(time.perf_counter() - t_part, 2)
        t_part = time.perf_counter()

    # one process: the same weights and batches
    batch, fbatch = training_batch(graph, device), forecast_batch(graph, device)
    one = {}
    iface = parallel_interface(graph, device)
    for precision in ("fp32", "bf16"):
        state, train_step = parallel_step(iface, graph, precision)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        train_step.compute_gradients(state, batch)
        grads = flat_grads(iface).cpu()
        y = make_forecast_fn(iface, STEPS)(fbatch)["data"].cpu()
        walls = []
        if precision == "bf16":
            for _ in range(PARALLEL_STEPS):
                t0 = time.perf_counter()
                train_step(state, batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        one[precision] = {"grads": grads, "forecast": y, "wall_ms": walls,
                          "peak_memory_bytes": torch.cuda.max_memory_allocated(device)}
        del state, train_step
        torch.cuda.empty_cache()
    del iface

    lap("one process")
    hier_file = os.path.join(workdir, "graph_hierarchical.npz")  # phase 23's
    proj_file = os.path.join(workdir, "graph_routes_projections.npz")
    projections_graph(proj_file)  # phase 33's
    world_2 = spawn(ranks_of_2, 2, args=(graph, hier_file, proj_file, workdir))
    ranks = [r["parallel"] for r in world_2]
    lap("ranks of 2 (phases 31-33)")
    result = {"ranks": [], "model_group": 2}
    for r in ranks:
        for precision in ("fp32", "bf16"):
            res = r[precision]
            calls = res["halo_calls"]
            want_step = {**NO_LAUNCHES, "K1": calls, "K3": calls, "K4": calls}
            want_fc = {**NO_LAUNCHES, "K1": calls * STEPS}
            steps = res.get("step_launches", []) + [res["grad_launches"]]
            if any(c != want_step for c in steps) or res["forecast_launches"] != want_fc:
                raise RuntimeError(f"parallel rank {r['rank']} {precision}: want {want_step} a "
                                   f"step and {want_fc} a forecast, got {steps} and "
                                   f"{res['forecast_launches']}")
    for precision in ("fp32", "bf16"):
        fc_tol, grad_tol = PARALLEL_TOL[precision]
        g = torch.load(os.path.join(workdir, f"grads_{precision}.pt"))
        y = torch.load(os.path.join(workdir, f"forecast_{precision}.pt"))
        gap = {"grads": rel_l2(g, one[precision]["grads"]),
               "forecast": rel_l2(y, one[precision]["forecast"])}
        finite = bool(torch.isfinite(y).all()) and tuple(y.shape) == tuple(
            one[precision]["forecast"].shape)
        print(f"[parallel] {precision}: model group of 2 against one process, relative L2 "
              f"{gap} (tol forecast {fc_tol}, gradients {grad_tol})", flush=True)
        if not (finite and gap["forecast"] <= fc_tol and gap["grads"] <= grad_tol):
            raise RuntimeError(f"parallel {precision}: {gap}, finite and shaped {finite}")
        result[precision] = {"rel_l2": gap, "one_process_peak_memory_bytes":
                             one[precision]["peak_memory_bytes"]}
    for r in ranks:
        bf = r["bf16"]
        result["ranks"].append({
            "rank": r["rank"], "backend": r["backend"], "device": r["device"],
            "launches_per_step": bf["step_launches"][-1],
            "launches_per_forecast_step": {k: n // STEPS for k, n in
                                           bf["forecast_launches"].items()},
            "losses": bf["losses"], "wall_ms_gloo_shared_card": bf["wall_ms"],
            "peak_memory_bytes": {p: r[p]["peak_memory_bytes"] for p in ("fp32", "bf16")},
            "exchanges": bf["exchanges"]})
    result["one_process_wall_ms"] = one["bf16"]["wall_ms"]
    print(f"[parallel] ranks {json.dumps(result['ranks'])}", flush=True)
    print(f"[parallel] wall ms a step, 2 ranks with gloo on one shared card (not NCCL's): "
          f"{[r['wall_ms_gloo_shared_card'] for r in result['ranks']]}; one process "
          f"{one['bf16']['wall_ms']}", flush=True)
    print(f"[parallel] peak memory: ranks {[r['peak_memory_bytes'] for r in result['ranks']]}; "
          f"one process {[one[p]['peak_memory_bytes'] for p in ('fp32', 'bf16')]}", flush=True)
    nccl = ranks[0]["nccl"]
    if not (nccl["backend"] == "nccl" and nccl["all_reduce"] == [0.0, 1.0, 2.0, 3.0]
            and math.isfinite(nccl["loss"]) and math.isfinite(nccl["grad_norm"])):
        raise RuntimeError(f"parallel one-rank NCCL group: {nccl}")
    result["nccl"] = nccl
    print(f"[parallel] one-rank NCCL group on the card: {nccl}", flush=True)
    del one

    # data 2 x model 2 against one process at batch 2, fp32
    world_4 = spawn(ranks_of_4, 4, args=(graph, workdir))
    dp = [r["data2_model2"] for r in world_4]
    lap("ranks of 4 (phases 31-32)")
    batch2 = {"data": torch.cat([batch["data"],
                                 training_batch(graph, device, seed=SEED + 3)["data"]])}
    iface = parallel_interface(graph, device)
    state, train_step = parallel_step(iface, graph, "fp32")
    want = []
    for _ in range(PARALLEL_DP_STEPS):
        state, metrics = train_step(state, batch2)
        want.append(float(metrics["loss"]))
    del iface, state, train_step
    torch.cuda.empty_cache()
    worst = max(abs(a - b) / abs(b) for r in dp for a, b in zip(r["losses"], want))
    print(f"[parallel] data 2 x model 2, fp32, {PARALLEL_DP_STEPS} steps: losses "
          f"{[r['losses'] for r in dp]} against one process at batch 2 {want}: worst relative "
          f"{worst:.3e} (tol {PARALLEL_DP_TOL})", flush=True)
    if not worst <= PARALLEL_DP_TOL:
        raise RuntimeError(f"parallel data 2 x model 2: losses off by {worst:.3e}")
    result["data2_model2"] = {"losses": [r["losses"] for r in dp], "one_process": want,
                              "worst_rel": worst,
                              "peak_memory_bytes": [r["peak_memory_bytes"] for r in dp]}
    lap("one process at batch 2")

    # cli train on a model group of 2 (the example on the flagship's graph:
    # the SFC order gives the halo of the flagship's rows), then cli predict
    # on one device
    with open(os.path.join(workdir, "example_o96_gt.json")) as f:
        config = json.load(f)
    config["output_dir"] = os.path.join(workdir, "parallel_run")
    config["graph"] = {"save_path": os.path.join(workdir, "flagship_graph.npz")}
    graph.save(config["graph"]["save_path"])
    config["model"]["processor"]["num_layers"] = CUT_LAYERS
    config["training"].update(max_steps=2, max_epochs=1)
    config["dataloader"]["validation_fraction"] = 0.02  # one validation batch
    config["diagnostics"]["callbacks"] = [{"name": "LearningRateMonitor"}]
    cfg_path = os.path.join(workdir, "parallel_example.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    t0 = time.perf_counter()
    rc = cli.main(["train", cfg_path, "hardware.num_devices=2",
                   "hardware.num_devices_per_model=2"])
    with open(os.path.join(config["output_dir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    if rc != 0 or len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"parallel cli train: rc {rc}, loss records {losses}")
    bundle = os.path.join(config["output_dir"], "inference")
    fc_path = os.path.join(workdir, "parallel_forecast.npz")
    kernels.reset_launches()
    rc = cli.main(["predict", bundle, "--steps", "2", "--output", fc_path])
    import numpy as np

    fc = np.load(fc_path)["data|forecast"]
    if rc != 0 or not np.isfinite(fc).all():
        raise RuntimeError(f"parallel cli predict on one device: rc {rc}")
    predict_launches = kernels.launch_counts()
    if predict_launches != {**NO_LAUNCHES, "K1": (CUT_LAYERS + 2) * STEPS}:
        raise RuntimeError(f"parallel cli predict on one device: launches {predict_launches}")
    result["cli"] = {"losses": losses, "seconds": time.perf_counter() - t0,
                     "predict_shape": list(fc.shape), "predict_launches": predict_launches}
    print(f"[parallel] cli train on 2 ranks: losses {losses}; cli predict on one device from "
          f"its bundle: {list(fc.shape)}, launches {result['cli']['predict_launches']}",
          flush=True)
    lap("cli train on 2 ranks, cli predict")

    result["seconds"] = seconds
    print(f"[parallel] seconds by part: {seconds}", flush=True)
    result["worlds"] = {"families": [r["families"] for r in world_2],
                        "routes": [r["routes"] for r in world_2],
                        "ensemble": [r["ensemble"] for r in world_4]}
    return result


FAMILY_PARTS = {  # part -> shard strategy on the model group of 2
    "flagship_heads": "heads", "transformer_heads": "heads", "transport_edges": "edges",
    "hierarchical_edges": "edges"}
FAMILY_BF16_STEPS = 2  # timed bf16 training steps of each rank and part
FAMILY_SAMPLING_STEPS = 4  # EDM-Heun sampling steps of the generative step (the presets: 20)
HEAD_SUBSET = HEADS // 2  # the heads one rank of a model group of 2 attends for


def family_config(part: str) -> dict:
    """The model of one part of phase 32 or 33, on the flagship's graph and
    variables (the hierarchical ones on phase 23's graph): the flagship
    (512 channels, 16 heads; phase 33's with a residual, a loss or mappers
    of its part), the Transformer preset (1 024 channels, 16 heads, w
    512), or the packaged preset's model section at its width; the
    processors at ``CUT_LAYERS`` (the ``hierarchical`` preset's at its
    2 a level, the ``point_wise`` preset's at its 4 point-wise layers)."""
    import copy

    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config

    layers = CUT_LAYERS
    if part in ("flagship_heads", "spectral", "projections", "dynamic", "transformer_mappers"):
        config = flagship_config(num_layers=layers)
        {"spectral": lambda c: c["model"].update(residual=SPECTRAL_RESIDUAL),
         "projections": lambda c: c["model"].update(residual={"name": "TruncatedConnection"}),
         "dynamic": with_dynamic_knn, "transformer_mappers": with_transformer_mappers,
         }.get(part, lambda c: None)(config)
        return config
    if part.startswith("transformer"):
        return transformer_config(num_layers=layers)
    config = flagship_config(num_layers=layers)
    if part == "gnn":  # the model group's file (phase 19 composes it on multi_scale)
        model = load_config(os.path.join(PACKAGED_CONFIG_DIR, "model", "gnn.yaml"), [],
                            search_paths=[PACKAGED_CONFIG_DIR]).to_dict()
    else:
        preset = {"transport_edges": "transport_edm_diffusion",
                  "transport_ensemble": "transport_edm_diffusion", "ensemble": "ensemble_crps",
                  "hierarchical_edges": "hierarchical", "hierarchical_heads": "hierarchical",
                  "point_wise": "point_wise"}[part]
        model = load_config(os.path.join(PACKAGED_CONFIG_DIR, f"{preset}.yaml"), [],
                            search_paths=[PACKAGED_CONFIG_DIR]).to_dict()["model"]
    config["model"] = {**copy.deepcopy(model), "inference_precision": "bf16"}
    if part in ("transport_edges", "transport_ensemble", "ensemble", "gnn"):
        config["model"]["processor"]["num_layers"] = layers
    return config


def family_interface(part: str, graph, device, mesh=None):
    """The part's training interface (float32 masters, the interface's own
    draws from ``context_seed("model-init")``), sharded over ``mesh``'s
    model group when it has more than one rank."""
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface

    config = family_config(part)
    if mesh is not None and mesh.size("model") > 1:
        config["model"].update(shard_strategy={**FAMILY_PARTS, **ROUTE_PARTS}.get(part, "edges"),
                               num_model_shards=mesh.size("model"))
    return AnemoiModelInterface(config=config, graph=graph, data_indices=flagship_indices(),
                                statistics=flagship_statistics(SEED), device=device,
                                training=True, mesh=mesh)


def family_step(iface, graph, part: str, precision: str):
    """(TrainState, train_step) as phase 31's, through the part's step: the
    EDM transport step, the 4-member ``KernelCRPS`` step, or the forecaster's."""
    from anemoi_tpu_torch.training.losses import get_loss_function
    from anemoi_tpu_torch.training.losses.scalers import create_scalers
    from anemoi_tpu_torch.training.optimizers import build_optimizer
    from anemoi_tpu_torch.training.step import COMPUTE_TYPES, TrainState, make_step_fns
    from anemoi_tpu_torch.training.transport_step import make_transport_step_fns

    iface.inference_dtype = COMPUTE_TYPES[precision] or torch.float32
    tx = build_optimizer({"gradient_clip": {"val": 32.0, "algorithm": "value"}},
                         schedule=lambda count: PARALLEL_RATE)
    if part in ROUTE_LOSSES:
        scalers = create_scalers({"area": {"name": "GraphNodeAttributeScaler",
                                           "nodes_name": "data",
                                           "attribute_name": "area_weight"}}, graph=graph)
        losses = {"data": get_loss_function(ROUTE_LOSSES[part], scalers, graph=graph)}
        train_step, _ = make_step_fns(iface, losses, rollout=1, precision=precision)
    elif part.startswith("transport"):
        train_step, _ = make_transport_step_fns(iface, training_losses(graph), objective="edm",
                                                precision=precision)
    elif part == "ensemble":
        scalers = create_scalers({"area": {"name": "GraphNodeAttributeScaler",
                                           "nodes_name": "data",
                                           "attribute_name": "area_weight"}}, graph=graph)
        losses = {"data": get_loss_function({"name": "KernelCRPS", "scalers": ["area"]},
                                            scalers)}
        train_step, _ = make_step_fns(iface, losses, rollout=1, precision=precision,
                                      ensemble_size=MEMBERS)
    else:
        train_step, _ = make_step_fns(iface, training_losses(graph), rollout=1,
                                      precision=precision)
    return TrainState.create(iface, tx), train_step


def family_output(iface, part: str, graph, device):
    """The part's forecast, float32, the whole grid: ``STEPS`` forecast
    steps; the transport model's one generative step of
    ``FAMILY_SAMPLING_STEPS`` EDM-Heun steps; the ensemble's
    ``predict_step`` of the window tiled to its members (noise and initial
    state from generators seeded as in phase 22)."""
    from anemoi_tpu_torch.inference import make_forecast_fn, make_transport_forecast_fn

    fbatch = forecast_batch(graph, device)
    gen = torch.Generator(device=device).manual_seed(TRANSPORT_SEED)
    if part.startswith("transport"):
        return make_transport_forecast_fn(iface, 1, num_steps=FAMILY_SAMPLING_STEPS)(
            fbatch, gen)["data"]
    if part == "ensemble":
        window = {"data": fbatch["data"][:, :2].expand(-1, -1, MEMBERS, -1, -1)}
        return iface.predict_step(window, generator=gen)["data"]
    return make_forecast_fn(iface, STEPS)(fbatch)["data"]


def shard_calls(shard) -> int:
    """The attention op's calls on one halo-sharded set: its interior and
    boundary rows (all its rows without ``halo_overlap``), where it has
    edges."""
    sets = (shard.interior, shard.boundary) if shard.overlap else (shard.full,)
    return sum(csr.num_edges > 0 for csr in sets)


def family_launches(model) -> dict:
    """A training step's and a forecast step's launches on this rank of a
    sharded model (or on one process), from its tables: K1 once a
    GraphTransformer mapper call (on a halo shard ``shard_calls``; on a
    runtime set of the rank's destinations one, where it has rows) and a
    GraphTransformer processor layer (under ``heads`` one call over the
    whole set, under ``edges`` ``shard_calls``); K6 once a dense processor
    layer (``heads`` or the band halo); none for the GNN, point-wise and
    cross-attention components; K3 and K4 with each K1 (no set reaches the
    2 GB rule), K7 with each K6."""
    from anemoi_tpu_torch.models.hierarchical import AnemoiModelEncProcDecHierarchical
    from anemoi_tpu_torch.parallel.halo import HaloShard
    from anemoi_tpu_torch.parallel.heads import HeadsShard
    from anemoi_tpu_torch.parallel.rows import BlockShard

    halo, names, g = model.halo, model.names, model.graph

    def gt_calls(name, shard, sub):
        if not name.startswith("GraphTransformer"):
            return 0
        if shard is None:
            return int(sub.num_edges > 0)
        if isinstance(shard, HaloShard):
            return shard_calls(shard)
        if isinstance(shard, BlockShard):
            return int(shard.dst_rows.stop > shard.dst_rows.start)
        return int(isinstance(shard, HeadsShard))

    def shard_of(kind, key=None):
        if halo is None:
            return None
        return halo[kind] if key is None else halo[kind][key]

    counts = {"gt": 0, "dense": 0}

    def processor(proc, shard, sub):
        if names["processor"] == "TransformerProcessor":
            counts["dense"] += len(proc.proc)
        else:
            counts["gt"] += len(proc.proc) * gt_calls(names["processor"], shard, sub)

    kinds = [("encoder", "encoder"), ("decoder", "decoder")]
    if isinstance(model, AnemoiModelEncProcDecHierarchical):
        kinds += [("down", "encoder"), ("up", "up")]
        for direction in ("down", "up"):
            for name, proc in getattr(model, f"{direction}_level_processor").items():
                processor(proc, shard_of("level", name), g.level[name])
        if hasattr(model, "processor"):
            deepest = model.hidden_names[-1]
            processor(model.processor, shard_of("level", deepest), g.level[deepest])
    else:
        processor(model.processor, shard_of("processor"), g.processor)
    for kind, part in kinds:
        for key, sub in getattr(g, kind).items():
            counts["gt"] += gt_calls(names[part], shard_of(kind, key), sub)
    gt, dense = counts["gt"], counts["dense"]
    step = {**NO_LAUNCHES, "K1": gt, "K3": gt, "K4": gt, "K6": dense, "K7_dq": dense,
            "K7_dkv": dense}
    forecast = {**NO_LAUNCHES, "K1": gt, "K6": dense}
    return {"step": step, "forecast": forecast}


def shard_bytes(name: str, shard, channels: int, elt: int, batch: int = 1) -> int:
    """Bytes this rank sends in one exchange of a component's route (its own
    block included in a buffer's size): a halo exchange of ``S h_pair`` rows
    (2C key and value channels for a GraphTransformer set, C source channels
    for a GNN block), a heads layer's four all-to-alls (``4 B n_local HD``),
    the band halo's ``S h`` rows of q, k and v, a gather of the whole source
    set (a runtime set's or a cross attention's keys and values: the rank's
    block to each of the S - 1 peers); 0 for a point-wise component."""
    from anemoi_tpu_torch.parallel.band import BandShard
    from anemoi_tpu_torch.parallel.halo import HaloShard
    from anemoi_tpu_torch.parallel.heads import HeadsShard
    from anemoi_tpu_torch.parallel.rows import BlockShard

    if isinstance(shard, HaloShard):
        width = 2 * channels if name.startswith("GraphTransformer") else channels
        return shard.num_shards * shard.h_pair * width * elt * batch
    if isinstance(shard, HeadsShard):
        return 4 * batch * shard.n_local * channels * elt
    if isinstance(shard, BandShard):
        return shard.num_shards * shard.h * 3 * channels * elt * batch
    if isinstance(shard, BlockShard) and not name.startswith("PointWise"):
        return (shard.num_shards - 1) * shard.n_local_src * 2 * channels * elt * batch
    return 0


def family_bytes(model, channels: int, elt: int, batch: int = 1) -> dict:
    """Bytes this rank sends in one forward (``shard_bytes``): each mapper's
    exchange or gather, and the processor's a layer (under ``heads`` and for
    the band halo, its ``n_local`` and the JAX padded length or the
    extended block)."""
    from anemoi_tpu_torch.parallel.band import BandShard
    from anemoi_tpu_torch.parallel.heads import HeadsShard

    halo, names = model.halo, model.names
    if halo is None:
        return {}
    mappers = {"encoder": "encoder", "decoder": "decoder", "down": "encoder", "up": "up"}
    out = {"mapper_exchanges": {
        f"{kind}/{key}": shard_bytes(names[part], sh, channels, elt, batch)
        for kind, part in mappers.items() if kind in halo for key, sh in halo[kind].items()}}
    proc = halo["processor"]
    out["processor_bytes_per_layer"] = shard_bytes(names["processor"], proc, channels, elt, batch)
    if isinstance(proc, HeadsShard):
        out["all_to_all_bytes_per_layer"] = out["processor_bytes_per_layer"]
        out["n_local"], out["padded_len_jax"] = proc.n_local, proc.padded_len
    if isinstance(proc, BandShard):
        out["n_local"], out["extended_block"] = proc.n_local, [proc.ext_rows.start,
                                                               proc.ext_rows.stop]
    return out


def replicas_equal(iface) -> bool:
    """Whether this rank's parameters equal every rank's of the world, bit
    for bit (the ranks of an ensemble group training a transport model)."""
    import torch.distributed as dist

    flat = torch.cat([p.detach().flatten() for p in iface.parameters()])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return all(torch.equal(flat, other) for other in parts)


def family_run(part, graph, device, mesh, workdir, save: bool) -> dict:
    """One part on this process (``mesh`` None) or this rank: per precision
    the step-1 gradient and the forecast (saved under ``workdir`` by rank 0
    with ``save``, kept in the result on one process), each with its
    launches; in bf16 then ``FAMILY_BF16_STEPS`` steps, each with its
    launches, loss and wall ms; peak memory."""
    from anemoi_tpu_torch import kernels

    iface = family_interface(part, graph, device, mesh)
    res = {"peak_memory_bytes": {}, "grad_launches": [], "output_launches": []}
    batch = training_batch(graph, device)
    for precision in ("fp32", "bf16"):
        state, train_step = family_step(iface, graph, part, precision)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launches()
        train_step.compute_gradients(state, batch)
        torch.cuda.synchronize()
        res["grad_launches"].append(kernels.launch_counts())
        grads = flat_grads(iface).cpu()
        kernels.reset_launches()
        y = family_output(iface, part, graph, device).cpu()
        torch.cuda.synchronize()
        res["output_launches"].append(kernels.launch_counts())
        res["output_shape"] = list(y.shape)
        if save:
            torch.save({"grads": grads, "output": y},
                       os.path.join(workdir, f"family_{part}_{precision}.pt"))
        elif mesh is None:
            res[precision] = {"grads": grads, "output": y}
        if precision == "bf16":
            res["step_launches"], res["losses"], res["wall_ms"] = [], [], []
            for _ in range(FAMILY_BF16_STEPS):
                t0 = time.perf_counter()
                kernels.reset_launches()
                state, metrics = train_step(state, batch)
                torch.cuda.synchronize()
                res["wall_ms"].append((time.perf_counter() - t0) * 1e3)
                res["step_launches"].append(kernels.launch_counts())
                res["losses"].append(float(metrics["loss"]))
        res["peak_memory_bytes"][precision] = torch.cuda.max_memory_allocated(device)
        del state, train_step, grads, y
        torch.cuda.empty_cache()
    if mesh is not None:
        res["launches_want"] = family_launches(iface.model)
        res["bytes"] = family_bytes(iface.model, iface.model.num_channels, 2)
        if mesh.size("ensemble") > 1 and part.startswith("transport"):
            res["replicas_equal"] = replicas_equal(iface)
        if mesh.size("ensemble") > 1 and part == "ensemble":
            # the member gather of one loss: the rank receives the other
            # ranks' [B, T, M / E, G_local, V_out] float32 predictions
            rows = iface.model.grid_rows("data")
            res["bytes"]["gather_bytes_per_loss"] = (
                (mesh.size("ensemble") - 1) * (MEMBERS // mesh.size("ensemble"))
                * (rows.stop - rows.start) * iface.model.n_step_output
                * iface.data_indices["data"].num_model_output_vars * 4)
    del iface
    torch.cuda.empty_cache()
    return res


def families_rank(graph, hierarchical_graph: str, workdir: str) -> dict:
    """One rank of a model group of 2 on the card (phase 32): each part of
    ``FAMILY_PARTS`` in turn (``family_run``)."""
    from anemoi_tpu_torch.graphs.graph import Graph
    from anemoi_tpu_torch.parallel import distributed
    from anemoi_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    launch = distributed.launch()
    device = launch.device
    mesh = create_mesh(MeshSpec(model=launch.world), device)
    out = {"rank": launch.rank, "backend": launch.backend}
    for part in FAMILY_PARTS:
        g = Graph.load(hierarchical_graph) if part == "hierarchical_edges" else graph
        t0 = time.perf_counter()
        out[part] = family_run(part, g, device, mesh, workdir, save=launch.rank == 0)
        out[part]["seconds"] = time.perf_counter() - t0
    return out


def ensemble_axis_rank(graph, workdir: str) -> dict:
    """One rank of ensemble 2 x model 2 (phase 32): the ensemble preset's
    model, 4 members, 2 a rank, ``edges`` over the model group."""
    from anemoi_tpu_torch.parallel import distributed
    from anemoi_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    launch = distributed.launch()
    mesh = create_mesh(MeshSpec(data=1, model=2, ensemble=2), launch.device)
    t0 = time.perf_counter()
    res = family_run("ensemble", graph, launch.device, mesh, workdir, save=launch.rank == 0)
    res.update(rank=launch.rank, coords=mesh.coords, seconds=time.perf_counter() - t0)
    return res


def head_subset_kernels(graph, device) -> dict:
    """The kernels on one rank's head subset under ``heads`` at a model
    group of 2: K1 and K3 + K4 at the processor set (the flagship's 8 of
    16 heads, HD 256, the whole set), K6 and K7 at the Transformer preset's
    8 of 16 heads over the whole mesh (N 10 242, D 64, w 512), each against
    its plain op and timed beside its bound."""
    from anemoi_tpu_torch.models.graph import extract_subgraph

    sub = extract_subgraph(graph, "hidden", "hidden", list(EDGE_ATTRIBUTES), device,
                           torch.float32)
    edge_set = f"hidden->hidden, {HEAD_SUBSET} of {HEADS} heads"
    hd = HD * HEAD_SUBSET // HEADS
    rows = {"K1": k1_set_rows("families", edge_set, sub.edge_index, sub.dst_ptr, sub.edge_attr,
                              sub.num_src, sub.num_dst, device, hd=hd, heads=HEAD_SUBSET)}
    rows.update(sparse_set_backward("families", edge_set, sub.edge_index, sub.dst_ptr,
                                    sub.source, sub.edge_attr, sub.num_src, sub.num_dst, device,
                                    hd=hd, heads=HEAD_SUBSET))
    case = f"{HEAD_SUBSET} of {WIN_H} heads"
    rows.update(window_phase(device, {case: (WIN_B, WIN_N, HEAD_SUBSET, WIN_D, WIN_W, None,
                                             False)}, "families", timed=(case,)))
    torch.cuda.empty_cache()
    return rows


def sharded_down_set(graph_file: str, device) -> dict:
    """K3 + K4 at model shard 2 of 2 of the V-cycle's down set (no
    ``halo_overlap``; its padded and halo source rows edgeless besides the
    sources no hidden_2 node reads), through ``sparse_set_backward``: dk and
    dv exactly 0 on every edgeless row."""
    from anemoi_tpu_torch.graphs.graph import Graph
    from anemoi_tpu_torch.models.graph import extract_subgraph

    sub = extract_subgraph(Graph.load(graph_file), *DOWN_SET, ["edge_length", "edge_dirs"],
                           device, torch.float32)
    shard = sub.sharded_edge_data(2, 1, None, overlap=False)
    csr = shard.full
    attr32 = sub.edge_attr[shard.edge_perm[: csr.num_edges]]
    return sparse_set_backward("families", "hidden_1->hidden_2, model shard 2 of 2",
                               csr.edge_index, csr.dst_ptr, csr.source, attr32, csr.num_src,
                               csr.num_dst, device)


def ensemble_axis_cli(workdir: str, losses_one_process: list) -> dict:
    """``cli train ensemble_crps.yaml`` with ``hardware.num_devices=2`` and
    ``num_devices_per_ensemble=2`` (its own 2 ranks, 2 members each) over
    phase 9's store, bf16, 2 steps: exit 0, finite records; the first
    step's loss (before any update) against phase 15's one-process run."""
    from anemoi_tpu_torch.training import cli
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    run_dir = os.path.join(workdir, "ensemble_axis_run")
    run = ["data.datasets.data.kind=zarr",
           f"data.datasets.data.path={os.path.join(workdir, 'example_o96.zarr')}",
           f"graph.save_path={os.path.join(workdir, 'graph.npz')}", f"output_dir={run_dir}",
           "training.max_steps=2", "training.max_epochs=1", "training.precision=bf16",
           "diagnostics.log_interval=1", "diagnostics.callbacks=[{name: LearningRateMonitor}]",
           "hardware.num_devices=2", "hardware.num_devices_per_ensemble=2", DEPTH_CUT]
    t0 = time.perf_counter()
    rc = cli.main(["train", os.path.join(PACKAGED_CONFIG_DIR, "ensemble_crps.yaml"), *run])
    seconds = time.perf_counter() - t0
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    if rc != 0 or len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"families cli train on the ensemble axis: rc {rc}, losses {losses}")
    first = abs(losses[0] - losses_one_process[0]) / abs(losses_one_process[0])
    print(f"[families] cli train ensemble_crps.yaml, ensemble group of 2 (2 members a rank): "
          f"losses {losses} against phase 15's one process {losses_one_process[:2]}: first "
          f"step relative {first:.3e} (tol {SERVING_TOL}); {seconds:.2f} s", flush=True)
    if not first <= SERVING_TOL:
        raise RuntimeError(f"families cli train on the ensemble axis: first loss off by {first}")
    return {"losses": losses, "one_process": losses_one_process[:2], "first_rel": first,
            "seconds": seconds}


def families_phase(workdir: str, graph, device, ensemble_losses: list, worlds: dict) -> dict:
    """Phase 32: the parallel families over ranks that share the card
    (gloo): ``FAMILY_PARTS`` on a model group of 2 and the ensemble preset
    on ensemble 2 x model 2 (``worlds``: each rank's results of
    ``families_rank`` and ``ensemble_axis_rank``, run in phase 31's
    worlds), each against one process on the same weights
    and batches (float32 and bf16 gradients and forecasts within phase 31's
    ``PARALLEL_TOL``; every rank's launches exactly ``family_launches``);
    ``cli train`` on
    the ensemble axis; the head-subset and sharded down-set kernel rows."""
    from anemoi_tpu_torch.graphs.graph import Graph

    seconds, t_part = {}, time.perf_counter()

    def lap(name):
        nonlocal t_part
        seconds[name] = round(time.perf_counter() - t_part, 2)
        t_part = time.perf_counter()

    hier_file = os.path.join(workdir, "graph_hierarchical.npz")
    parts = [*FAMILY_PARTS, "ensemble"]
    one = {}
    for part in parts:
        g = Graph.load(hier_file) if part == "hierarchical_edges" else graph
        one[part] = family_run(part, g, device, None, workdir, save=False)
    lap("one process")
    ranks, ens = worlds["families"], worlds["ensemble"]
    result = {"parts": {}, "seconds": seconds}
    for part in parts:
        per_rank = ens if part == "ensemble" else [r[part] for r in ranks]
        for i, res in enumerate(per_rank):
            want = res["launches_want"]
            steps = res["step_launches"] + res["grad_launches"]
            want_out = dict(want["forecast"])
            if part == "transport_edges":  # 2 N - 1 evaluations of EDM-Heun
                want_out["K1"] *= 2 * FAMILY_SAMPLING_STEPS - 1
            elif part != "ensemble":
                want_out = {k: n * STEPS for k, n in want_out.items()}
            if (any(c != want["step"] for c in steps)
                    or any(c != want_out for c in res["output_launches"])):
                raise RuntimeError(f"families {part} rank {i}: want {want['step']} a step and "
                                   f"{want_out} an output, got {steps} and "
                                   f"{res['output_launches']}")
        gap = {}
        for precision in ("fp32", "bf16"):
            saved = torch.load(os.path.join(workdir, f"family_{part}_{precision}.pt"))
            ref = one[part][precision]
            gap[precision] = {"grads": rel_l2(saved["grads"], ref["grads"]),
                              "output": rel_l2(saved["output"], ref["output"])}
            fc_tol, grad_tol = PARALLEL_TOL[precision]
            finite = bool(torch.isfinite(saved["output"]).all()) and (
                saved["output"].shape == ref["output"].shape)
            print(f"[families] {part} {precision}: against one process, relative L2 "
                  f"{gap[precision]} (tol output {fc_tol}, gradients {grad_tol}); output "
                  f"{list(saved['output'].shape)}", flush=True)
            if not (finite and gap[precision]["grads"] <= grad_tol
                    and gap[precision]["output"] <= fc_tol):
                raise RuntimeError(f"families {part} {precision}: {gap[precision]}, finite "
                                   f"and shaped {finite}")
        result["parts"][part] = {
            "rel_l2": gap, "strategy": FAMILY_PARTS.get(part, "edges"),
            "launches_per_step": per_rank[0]["step_launches"][-1],
            "launches_per_output": per_rank[0]["output_launches"][-1],
            "output_shape": per_rank[0]["output_shape"],
            "wall_ms_gloo_shared_card": [r["wall_ms"] for r in per_rank],
            "losses_bf16": [r["losses"] for r in per_rank],
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in per_rank],
            "one_process_peak_memory_bytes": one[part]["peak_memory_bytes"],
            "one_process_wall_ms": one[part]["wall_ms"],
            "one_process_losses_bf16": one[part]["losses"],
            "bytes": per_rank[0]["bytes"], "seconds": [r["seconds"] for r in per_rank],
            **({"coords": [r["coords"] for r in per_rank]} if part == "ensemble" else {})}
        print(f"[families] {part} {json.dumps(result['parts'][part])}", flush=True)
    del one
    result["cli_ensemble_axis"] = ensemble_axis_cli(workdir, ensemble_losses)
    lap("cli train on the ensemble axis")
    rows = head_subset_kernels(graph, device)
    for name, extra in sharded_down_set(hier_file, device).items():
        rows.setdefault(name, []).extend(extra)
    lap("head-subset and down-set kernels")
    result["rows"] = rows
    print(f"[families] seconds by part: {seconds}", flush=True)
    return result


# --- phase 33: the rest of item 9's routes -----------------------------------
ROUTE_PARTS = {  # part -> shard strategy of the model on a model group of 2
    "spectral": "edges", "projections": "edges", "transformer_edges": "edges", "gnn": "edges",
    "transformer_mappers": "edges", "dynamic": "edges", "point_wise": "gspmd",
    "transport_ensemble": "none", "hierarchical_heads": "heads"}
ROUTE_ENSEMBLE = {"transport_ensemble": 2}  # parts on an ensemble group of 2 (model 1)
SPECTRAL_RESIDUAL = {"name": "SpectralOrnsteinConnection", "gaussian_n": 96,
                     "grid_kind": "octahedral", "theta_init": 0.3}
ROUTE_LOSSES = {  # the parts' losses (the others: the bench's area-weighted MSE)
    "spectral": {"name": "CombinedLoss", "loss_weights": [1.0, 0.5], "losses": [
        {"name": "WeightedMSELoss", "scalers": ["area"]},
        {"name": "SpectralAMSELoss", "transform": "octahedral_sht", "gaussian_n": 96,
         "scalers": []}]},
    "projections": {"name": "MultiscaleLossWrapper", "native_weight": 1.0,
                    "loss": {"name": "WeightedMSELoss", "scalers": ["area"]},
                    "scales": [{"nodes": "truncation", "weight": 0.5,
                                "weight_attribute": "gauss_weight"}]},
}


def projections_graph(path: str):
    """The flagship's graph with phase 25's ``truncation`` set (o32, KNN-3
    both ways, ``GaussianDistanceWeights`` l1), saved at ``path``."""
    from anemoi_tpu_torch.graphs.create import GraphCreator

    recipe = flagship_recipe("o96", 5)
    cfg = {"graph": {"recipe": recipe}, "model": {}, "training": {"loss": {}}}
    with_projections(cfg)
    return GraphCreator(recipe).create(path)


def routes_rank(graph, projections_file: str, hierarchical_file: str, workdir: str) -> dict:
    """One rank of phase 33: each part of ``ROUTE_PARTS`` in turn
    (``family_run``) on a model group of 2, or on an ensemble group of 2."""
    from anemoi_tpu_torch.graphs.graph import Graph
    from anemoi_tpu_torch.parallel import distributed
    from anemoi_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    launch = distributed.launch()
    device = launch.device
    meshes = {e: create_mesh(MeshSpec(model=launch.world // e, ensemble=e), device)
              for e in (1, 2)}
    graphs = {"projections": Graph.load(projections_file),
              "hierarchical_heads": Graph.load(hierarchical_file)}
    out = {"rank": launch.rank, "backend": launch.backend}
    for part in ROUTE_PARTS:
        t0 = time.perf_counter()
        mesh = meshes[ROUTE_ENSEMBLE.get(part, 1)]
        out[part] = family_run(part, graphs.get(part, graph), device, mesh, workdir,
                               save=launch.rank == 0)
        out[part].update(seconds=time.perf_counter() - t0, coords=mesh.coords)
    return out


def extended_block_kernels(device) -> dict:
    """K6 and K7 on rank 0's extended block of the Transformer preset under
    ``edges`` on a model group of 2 (its 5 128 rows and the window's 512 of
    rank 1's, 16 heads of 64, w 512), against the plain op and timed beside
    the operation bound and SDPA with the band mask (``window_phase``)."""
    from anemoi_tpu_torch.parallel.band import BandShard

    rows = BandShard.build(None, 2, 0, WIN_N, WIN_W, "xla", "cpu").ext_rows
    case = f"extended block {rows.stop - rows.start} of {WIN_N}"
    return window_phase(device, {case: (WIN_B, rows.stop - rows.start, WIN_H, WIN_D, WIN_W, None,
                                        False)}, "routes", timed=(case,))


def routes_phase(workdir: str, graph, device, worlds: dict) -> dict:
    """Phase 33: the rest of item 9's routes over ranks that share the card
    (gloo): ``ROUTE_PARTS`` on a model group of 2 (the transport model on
    an ensemble group of 2; ``worlds``: each rank's results of
    ``routes_rank``, run in phase 31's world of 2), each against one
    process on the same weights
    and batches (float32 and bf16 gradients and forecasts within phase 31's
    ``PARALLEL_TOL``; every rank's launches exactly ``family_launches``);
    the transport replicas' parameters equal after the steps and their
    first loss one process's; K6 and K7 on the extended block."""
    from anemoi_tpu_torch.graphs.graph import Graph

    seconds, t_part = {}, time.perf_counter()

    def lap(name):
        nonlocal t_part
        seconds[name] = round(time.perf_counter() - t_part, 2)
        t_part = time.perf_counter()

    hier_file = os.path.join(workdir, "graph_hierarchical.npz")  # phase 23's
    proj_file = os.path.join(workdir, "graph_routes_projections.npz")  # phase 31's
    graphs = {"projections": Graph.load(proj_file), "hierarchical_heads": Graph.load(hier_file)}
    one = {}
    for part in ROUTE_PARTS:
        one[part] = family_run(part, graphs.get(part, graph), device, None, workdir, save=False)
    lap("one process")
    ranks = worlds["routes"]
    result = {"parts": {}, "seconds": seconds}
    for part in ROUTE_PARTS:
        per_rank = [r[part] for r in ranks]
        for i, res in enumerate(per_rank):
            want = res["launches_want"]
            steps = res["step_launches"] + res["grad_launches"]
            want_out = dict(want["forecast"])
            if part.startswith("transport"):  # 2 N - 1 evaluations of EDM-Heun
                want_out["K1"] *= 2 * FAMILY_SAMPLING_STEPS - 1
            else:
                want_out = {k: n * STEPS for k, n in want_out.items()}
            if (any(c != want["step"] for c in steps)
                    or any(c != want_out for c in res["output_launches"])):
                raise RuntimeError(f"routes {part} rank {i}: want {want['step']} a step and "
                                   f"{want_out} an output, got {steps} and "
                                   f"{res['output_launches']}")
        gap = {}
        for precision in ("fp32", "bf16"):
            saved = torch.load(os.path.join(workdir, f"family_{part}_{precision}.pt"))
            ref = one[part][precision]
            gap[precision] = {"grads": rel_l2(saved["grads"], ref["grads"]),
                              "output": rel_l2(saved["output"], ref["output"])}
            fc_tol, grad_tol = PARALLEL_TOL[precision]
            finite = bool(torch.isfinite(saved["output"]).all()) and (
                saved["output"].shape == ref["output"].shape)
            print(f"[routes] {part} {precision}: against one process, relative L2 "
                  f"{gap[precision]} (tol output {fc_tol}, gradients {grad_tol}); output "
                  f"{list(saved['output'].shape)}", flush=True)
            if not (finite and gap[precision]["grads"] <= grad_tol
                    and gap[precision]["output"] <= fc_tol):
                raise RuntimeError(f"routes {part} {precision}: {gap[precision]}, finite and "
                                   f"shaped {finite}")
        extra = {}
        if part in ROUTE_ENSEMBLE:
            first = [r["losses"][0] for r in per_rank]
            extra = {"replicas_equal": [r["replicas_equal"] for r in per_rank],
                     "first_loss_rel": max(abs(x - one[part]["losses"][0])
                                           / abs(one[part]["losses"][0]) for x in first)}
            print(f"[routes] {part}: replicas' parameters equal after "
                  f"{FAMILY_BF16_STEPS} bf16 steps {extra['replicas_equal']}; first loss "
                  f"{first} against one process's {one[part]['losses'][0]}", flush=True)
            if not (all(extra["replicas_equal"]) and extra["first_loss_rel"] <= 1e-6):
                raise RuntimeError(f"routes {part}: replicas {extra}")
        result["parts"][part] = {
            "rel_l2": gap, "strategy": ROUTE_PARTS[part], "coords": per_rank[0]["coords"],
            "launches_per_step": per_rank[0]["step_launches"][-1],
            "launches_per_output": per_rank[0]["output_launches"][-1],
            "launches_per_step_by_rank": [r["step_launches"][-1] for r in per_rank],
            "output_shape": per_rank[0]["output_shape"],
            "wall_ms_gloo_shared_card": [r["wall_ms"] for r in per_rank],
            "losses_bf16": [r["losses"] for r in per_rank],
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in per_rank],
            "one_process_peak_memory_bytes": one[part]["peak_memory_bytes"],
            "one_process_wall_ms": one[part]["wall_ms"],
            "one_process_losses_bf16": one[part]["losses"],
            "bytes": [r["bytes"] for r in per_rank], "seconds": [r["seconds"] for r in per_rank],
            **extra}
        print(f"[routes] {part} {json.dumps(result['parts'][part])}", flush=True)
    del one
    result["rows"] = extended_block_kernels(device)
    lap("extended-block kernels")
    print(f"[routes] seconds by part: {seconds} ({card_line()})", flush=True)
    return result


# --- phase 34: the auxiliary modules through the CLI ------------------------------------
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "inference_ckpt_r2")
MIGRATED_TOL = 1e-4  # relative L2, the fixture's float32 forecast, card against CPU
AUX_PROFILE_STEPS = 20
# the kernels the profiler's trace must name: K1, K3 and K4
TRACE_KERNELS = {"K1": "gt_attention_fwd_kernel", "K3": "gt_attention_bwd_dst_kernel",
                 "K4": "gt_attention_bwd_src_sum_kernel"}


def fixture_copy(workdir: str, name: str, precision=None) -> str:
    """A copy of the committed round-2 bundle (one migration pending),
    serving in ``precision`` when given."""

    path = os.path.join(workdir, name)
    shutil.copytree(FIXTURE, path)
    if precision is not None:
        with open(os.path.join(path, "checkpoint.json")) as f:
            bundle = json.load(f)
        bundle["config"]["model"]["inference_precision"] = precision
        with open(os.path.join(path, "checkpoint.json"), "w") as f:
            json.dump(bundle, f)
    return path


def migrate_and_serve(workdir: str) -> dict:
    """(a): ``cli checkpoint migrate`` on a copy of the fixture, then ``cli
    predict`` on the card and on the CPU; an unmigrated copy loaded
    in-process forecasts the same bit for bit."""
    import numpy as np

    from anemoi_tpu_torch import kernels
    from anemoi_tpu_torch.data.dataset import open_dataset
    from anemoi_tpu_torch.inference import make_forecast_fn
    from anemoi_tpu_torch.training import cli
    from anemoi_tpu_torch.training.checkpoint import MIGRATION_NAMES, load_inference_checkpoint

    with open(os.path.join(FIXTURE, "checkpoint.json")) as f:
        fixture = json.load(f)
    data = {"kind": "synthetic", "nodes": {"name": "ReducedGaussianGridNodes", "grid": "o8"},
            "variables": list(fixture["data_indices"]["data"]["name_to_index"]),
            "num_times": 8}
    data_cfg = os.path.join(workdir, "fixture_data.json")
    with open(data_cfg, "w") as f:
        json.dump({"data": {"datasets": {"data": data}}}, f)
    layers = int(fixture["config"]["model"]["processor"]["num_layers"])
    want = {**NO_LAUNCHES, "K1": (2 + layers) * STEPS}  # encoder, processor, decoder a step
    result = {}
    for precision, tol in (("fp32", MIGRATED_TOL), (None, SERVING_TOL)):
        label = precision or "bundle's bf16"
        bundle = fixture_copy(workdir, f"fixture_{precision}", precision)
        if cli.main(["checkpoint", "migrate", bundle]) != 0:
            raise RuntimeError("auxiliary: cli checkpoint migrate failed")
        with open(os.path.join(bundle, "checkpoint.json")) as f:
            applied = json.load(f)["metadata"]["migrations"]
        if applied != list(MIGRATION_NAMES):
            raise RuntimeError(f"auxiliary: migrated bundle records {applied}")
        out, card_launches = {}, None
        for platform in ("cuda", "cpu"):
            path = os.path.join(workdir, f"fixture_{precision}_{platform}.npz")
            kernels.reset_launches()
            rc = cli.main(["predict", bundle, "--config", data_cfg, "--steps", str(STEPS),
                           "--output", path] + (["--platform", "cpu"] if platform == "cpu"
                                                else []))
            launches = kernels.launch_counts()
            if rc != 0:
                raise RuntimeError(f"auxiliary: cli predict ({platform}) returned {rc}")
            if launches != (want if platform == "cuda" else NO_LAUNCHES):
                raise RuntimeError(f"auxiliary: cli predict ({platform}) launched {launches}")
            card_launches = card_launches or launches
            out[platform] = np.load(path)["data|forecast"]
        gap = float(np.linalg.norm(out["cuda"] - out["cpu"]) / np.linalg.norm(out["cpu"]))
        print(f"[auxiliary] migrated fixture ({label}), cli predict on the card against "
              f"--platform cpu: relative L2 {gap:.3e} (tol {tol}); shape "
              f"{list(out['cuda'].shape)}; {card_launches['K1']} K1 in {STEPS} steps",
              flush=True)
        if not (np.isfinite(out["cuda"]).all() and gap <= tol):
            raise RuntimeError(f"auxiliary: the migrated fixture's forecast on the card is "
                               f"{gap:.3e} from the CPU's ({label})")
        result[label] = {"rel_l2_card_vs_cpu": gap, "launches": card_launches}
        if precision == "fp32":
            # the same bundle unmigrated, loaded in-process: migrated as it loads
            unmigrated = fixture_copy(workdir, "fixture_unmigrated", precision)
            iface = load_inference_checkpoint(unmigrated)
            window = open_dataset(dict(data)).get_window(0, iface.model.n_step_input + STEPS)
            batch = {"data": torch.from_numpy(window[None]).to(iface.device)}
            ref = make_forecast_fn(iface, steps=STEPS)(batch)["data"].cpu().numpy()
            if not np.array_equal(ref, out["cuda"]):
                raise RuntimeError("auxiliary: the unmigrated bundle's forecast differs from "
                                   "the migrated one's")
            print("[auxiliary] the unmigrated copy through load_inference_checkpoint: the "
                  "same forecast bit for bit", flush=True)
            del iface
    return result


def aux_config(workdir: str, label: str, steps: int, layers: int = CUT_LAYERS,
               **diagnostics) -> tuple:
    """Phase 9's example (its store and graph; the processor at ``layers``)
    for ``steps`` steps with one validation batch and no callbacks, into
    ``<workdir>/aux_<label>``."""
    with open(os.path.join(workdir, "example_o96_gt.json")) as f:
        config = json.load(f)
    config["model"]["processor"]["num_layers"] = layers
    config["output_dir"] = os.path.join(workdir, f"aux_{label}")
    config["training"].update(max_steps=steps, max_epochs=1)
    config["dataloader"]["validation_fraction"] = 0.02  # one validation batch
    config["diagnostics"]["callbacks"] = []
    config["diagnostics"].update(diagnostics)
    return config, os.path.join(workdir, f"aux_{label}.json")


def write_json(config: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def load_and_freeze(workdir: str) -> dict:
    """(b): ``cli train`` 3 steps from phase 9's bundle through
    ``[local, weights_only, freeze [encoder]]``."""
    from anemoi_tpu_torch.training import cli

    bundle = os.path.join(workdir, "run", "inference")
    config, path = aux_config(workdir, "freeze", 3, FLAGSHIP_LAYERS)  # phase 9's bundle
    config["training"]["checkpoint_pipeline"] = [
        {"stage": "source", "name": "local", "path": bundle},
        {"stage": "loading", "name": "weights_only"},
        {"stage": "modifier", "name": "freeze", "submodules": ["encoder"]}]
    with StepLaunches(snapshot=True) as counted:
        rc = cli.main(["train", write_json(config, path)])
    if rc != 0:
        raise RuntimeError(f"auxiliary: cli train with the pipeline returned {rc}")
    saved = torch.load(os.path.join(bundle, "params.pt"), map_location="cpu",
                       weights_only=True)
    initial = counted.initial
    if sorted(initial) != sorted(saved) or not all(torch.equal(initial[k], saved[k])
                                                   for k in saved):
        raise RuntimeError("auxiliary: the weights before step 1 differ from the bundle's")
    final = {k: v.detach().cpu() for k, v in counted.trainer.interface.state_dict().items()}
    encoder = [k for k in saved if k.startswith("model.encoder.")]
    processor = [k for k in saved if k.startswith("model.processor.")]
    moved = sum(not torch.equal(final[k], saved[k]) for k in processor)
    if not encoder or any(not torch.equal(final[k], saved[k]) for k in encoder):
        raise RuntimeError("auxiliary: a frozen encoder parameter moved")
    if moved != len(processor):
        raise RuntimeError(f"auxiliary: {len(processor) - moved} processor parameters did "
                           "not move")
    want = {**NO_LAUNCHES, "K1": LAUNCHES_PER_STEP, "K3": LAUNCHES_PER_STEP,
            "K4": LAUNCHES_PER_STEP}
    if len(counted.per_step) != 3 or any(c != want for c in counted.per_step):
        raise RuntimeError(f"auxiliary: expected {want} in each of 3 steps, got "
                           f"{counted.per_step}")
    print(f"[auxiliary] pipeline [local, weights_only, freeze [encoder]] on phase 9's bundle: "
          f"{len(saved)} tensors equal to params.pt before step 1; after 3 steps the "
          f"{len(encoder)} encoder tensors bit for bit, all {len(processor)} processor "
          f"tensors moved; {want['K1']} K1, K3 and K4 a step", flush=True)
    counted.trainer = counted.train_step = None
    torch.cuda.empty_cache()
    return {"launches_per_step": counted.per_step[-1], "frozen_tensors": len(encoder),
            "moved_processor_tensors": moved}


def profile_part(workdir: str, card: str) -> dict:
    """(c): ``cli profile`` 20 steps with ``--trace --benchmark-store``."""
    from anemoi_tpu_torch.training import cli
    from anemoi_tpu_torch.training.benchmark_store import BenchmarkStore, current_commit

    config, path = aux_config(workdir, "profile", AUX_PROFILE_STEPS)
    store = os.path.join(workdir, "aux_benchmark_store")
    with StepLaunches() as counted:
        rc = cli.main(["profile", write_json(config, path), "--steps", str(AUX_PROFILE_STEPS),
                       "--trace", "--benchmark-store", store,
                       "--output-dir", config["output_dir"]])
    if rc != 0:
        raise RuntimeError(f"auxiliary: cli profile returned {rc}")
    want = {**NO_LAUNCHES, "K1": CUT_LAYERS + 2, "K3": CUT_LAYERS + 2, "K4": CUT_LAYERS + 2}
    if len(counted.per_step) != AUX_PROFILE_STEPS or any(c != want for c in counted.per_step):
        raise RuntimeError(f"auxiliary: profile steps launched {counted.per_step}")
    profile_dir = os.path.join(config["output_dir"], "profile")
    with open(os.path.join(profile_dir, "profiler_report.json")) as f:
        report = json.load(f)
    if sorted(report) != ["config", "memory", "speed", "system", "time"]:
        raise RuntimeError(f"auxiliary: profiler report sections {sorted(report)}")
    name = torch.cuda.get_device_name(0)
    (device_key,) = [k for k in report["memory"] if k.startswith("cuda:")]
    memory = report["memory"][device_key]
    if not (memory["peak_bytes_in_use"] > 0 and memory["name"] == name
            and report["system"]["device_name"] == name):
        raise RuntimeError(f"auxiliary: memory report {memory}, system {report['system']}")
    trace_path = os.path.join(profile_dir, "trace", "trace.json")
    with open(trace_path) as f:
        trace = f.read()
    missing = [k for k, kernel in TRACE_KERNELS.items() if kernel not in trace]
    if missing:
        raise RuntimeError(f"auxiliary: the trace names none of the kernels {missing}")
    stored = BenchmarkStore(store).get(current_commit())
    speed = report["speed"]
    if stored is None or stored.get("avg_time_per_batch_s") != speed["avg_time_per_batch_s"] \
            or stored.get("num_steps") != AUX_PROFILE_STEPS - 1:
        raise RuntimeError(f"auxiliary: the benchmark store holds {stored}")
    ms = speed["avg_time_per_batch_s"] * 1e3
    print(f"[auxiliary] cli profile {AUX_PROFILE_STEPS} steps (trace on): "
          f"{ms:.3f} ms a step (mean of steps 2-{AUX_PROFILE_STEPS}, p50 "
          f"{speed['p50_time_per_batch_s'] * 1e3:.3f}), peak {memory['peak_bytes_in_use']} "
          f"bytes of {memory['bytes_limit']}; {card}; the trace ({os.path.getsize(trace_path)} "
          f"bytes) names {sorted(TRACE_KERNELS.values())}; the store holds "
          f"{len(stored)} numbers under {current_commit()[:12]}", flush=True)
    return {"ms_per_step": ms, "p50_ms": speed["p50_time_per_batch_s"] * 1e3,
            "peak_bytes": memory["peak_bytes_in_use"], "bytes_limit": memory["bytes_limit"],
            "time_report": report["time"], "launches_per_step": counted.per_step[-1],
            "trace_bytes": os.path.getsize(trace_path), "card": card}


def offline_mlflow(workdir: str) -> dict:
    """(d): ``cli train`` 2 steps with the ``mlflow_offline`` logger."""
    from anemoi_tpu_torch.training import cli
    from anemoi_tpu_torch.training.mlflow_store import read_offline_run

    config, path = aux_config(workdir, "mlflow", 2, loggers=[
        {"name": "mlflow_offline", "system_metrics_interval_s": 0.5}])
    if cli.main(["train", write_json(config, path)]) != 0:
        raise RuntimeError("auxiliary: cli train with the mlflow_offline logger failed")
    with open(os.path.join(config["output_dir"], "metrics.jsonl")) as f:
        losses = [(r["step"], r["loss"]) for r in map(json.loads, f) if "loss" in r]
    mlruns = os.path.join(config["output_dir"], "mlruns")
    (run_dir,) = [os.path.join(mlruns, exp, r) for exp in os.listdir(mlruns)
                  if os.path.isdir(os.path.join(mlruns, exp))
                  for r in os.listdir(os.path.join(mlruns, exp))
                  if os.path.isdir(os.path.join(mlruns, exp, r))]
    run = read_offline_run(run_dir)
    logged = [(m["step"], m["value"]) for m in run["metrics"] if m["key"] == "loss"]
    device = [m["value"] for m in run["metrics"] if m["key"] == "sys.device_mem_in_use_mib"]
    if logged != losses or len(losses) != 2:
        raise RuntimeError(f"auxiliary: offline run losses {logged}, metrics.jsonl {losses}")
    if not device or not all(v > 0 for v in device):
        raise RuntimeError("auxiliary: no card memory among the system metrics")
    print(f"[auxiliary] mlflow_offline: the run's losses {logged} equal metrics.jsonl's; "
          f"{len(device)} system samples with the card's memory (up to {max(device):.1f} MiB)",
          flush=True)
    return {"losses": logged, "device_mem_samples": len(device)}


def validate_presets() -> dict:
    """(e): ``cli validate`` on every packaged preset, and on one with a
    bad ``training.rollout``."""
    from anemoi_tpu_torch.training import cli
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    presets = sorted(f for f in os.listdir(PACKAGED_CONFIG_DIR) if f.endswith(".yaml"))
    failed = [p for p in presets if cli.main(["validate", os.path.join(PACKAGED_CONFIG_DIR, p)])]
    bad = cli.main(["validate", os.path.join(PACKAGED_CONFIG_DIR, "example_o96_gt.yaml"),
                    "training.rollout.start=4", "training.rollout.max=2"])
    if failed or bad == 0:
        raise RuntimeError(f"auxiliary: validate refused {failed}; the bad rollout gave {bad}")
    print(f"[auxiliary] cli validate: {len(presets)} presets accepted, the bad rollout "
          f"refused (exit {bad})", flush=True)
    return {"presets": len(presets), "bad_rollout_exit": bad}


def auxiliary_phase(workdir: str, card: str) -> dict:
    """Phase 34: checkpoint migrations, the checkpoint pipeline, the
    profiler and benchmark store, the offline MLflow logger and config
    validation, driven through the CLI."""
    result, seconds = {}, {}
    for name, fn, args in (("migrate", migrate_and_serve, (workdir,)),
                           ("freeze", load_and_freeze, (workdir,)),
                           ("profile", profile_part, (workdir, card)),
                           ("mlflow", offline_mlflow, (workdir,)),
                           ("validate", validate_presets, ())):
        t0 = time.perf_counter()
        result[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[auxiliary] {name}: {seconds[name]:.2f} s", flush=True)
    result["seconds"] = seconds
    print(f"[auxiliary] {json.dumps(result)}", flush=True)
    return result


MULTI_SETS = {  # the multi preset's edge sets: o96 ``era`` and o48 ``obs`` into ico-5
    ("era", "hidden"): 62980, ("obs", "hidden"): 17548, ("hidden", "hidden"): 81900,
    ("hidden", "era"): 120960, ("hidden", "obs"): 32832}
# a multi training step: K1 and K3 once a GT block (2 encoders, 16 processor
# layers, 2 decoders); K4 on all 20 sets, none over the 2 GB rule at 1024
# channels (the largest, hidden -> era: 120 960 * 1.7 * 3 * 1024 * 2 = 1.26 GB)
MULTI_LAUNCHES = {"K1": 20, "K3": 20, "K4": 20, "K5": 0}
O48_SETS = (("obs", "hidden"), ("hidden", "obs"))
TRANSPORT_PRESETS_LEFT = {  # as TRANSPORT_PRESETS, the other two
    "transport_edm_tendency": ("transport_edm_diffusion_tendency", "edm", 1),
    "transport_interpolant_gaussian": ("transport_stochastic_interpolant", "interpolant", 1),
}


def multi_part(workdir: str, device, card: str) -> dict:
    """``multi.yaml`` at its width (the ``graphtransformer`` model: 1024
    channels, 16 layers, 16 heads; o96 ``era`` and o48 ``obs``, both
    synthetic, into one ico-5 mesh, an encoder and a decoder a dataset),
    bf16, no callbacks: ``cli train`` ``FAMILY_STEPS`` steps with exactly
    ``MULTI_LAUNCHES`` a step (20 K1, 20 K3, 20 K4, no K5), which
    ``expected_launches`` must also derive from the graph, whose edge sets
    must be ``MULTI_SETS``; the gradient gate; ``cli predict`` 2 steps (20
    K1 a step), each dataset's forecast bit for bit with the in-process one
    and within the serving gate of the plain attention; then K3 + K4 at
    the two o48 sets at HD 1024 (``graph_set_backward``: timed, gated only
    against the plain backward)."""
    from anemoi_tpu_torch.graphs.graph import Graph
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR

    path = os.path.join(PACKAGED_CONFIG_DIR, "multi.yaml")
    graph_file = os.path.join(workdir, "graph_multi.npz")
    overrides = [f"graph.save_path={graph_file}", "diagnostics.callbacks=[]"]
    composed_preset(path, overrides, {
        "model.num_channels": 1024, "model.processor.num_layers": 16,
        "model.processor.num_heads": 16, "data.datasets.era.nodes.grid": "o96",
        "data.datasets.obs.nodes.grid": "o48",
        "graph.recipe.nodes.hidden.node_builder.resolution": 5})
    want = {**NO_LAUNCHES, **MULTI_LAUNCHES}

    def launches(trainer):
        edges = {key: trainer.graph[key].num_edges for key in MULTI_SETS}
        derived = expected_launches(trainer.config, trainer.graph, FLAGSHIP_LAYERS)
        if edges != MULTI_SETS or derived != want:
            raise RuntimeError(f"multi: edge sets {edges} (want {MULTI_SETS}), launches from "
                               f"the graph {derived} (want {want})")
        return want

    train, run_dir, _ = family_train(workdir, device, "multi", path, overrides, FAMILY_STEPS,
                                     launches, split=8, dataset="config")
    predict = family_predict(workdir, device, "multi", run_dir, MULTI_LAUNCHES["K1"], split=8,
                             bitwise=True)
    graph = Graph.load(graph_file)
    rows = {}
    for key in O48_SETS:
        for name, extra in graph_set_backward("multi", graph, key, device, hd=WIDE_HD).items():
            rows.setdefault(name, []).extend(extra)
    print(f"[multi] {card}: training step {train['ms_per_step']:.3f} ms (wall), peak "
          f"{train['peak_memory_bytes']} B; forecast step {predict['ms_per_step']:.3f} ms, "
          f"peak {predict['peak_memory_bytes']} B; edges {train['edges']}", flush=True)
    return {"train": train, "predict": predict, "o48_rows": rows}


def presets_left_phase(workdir: str, device, card: str) -> dict:
    """Phase 35: the presets no earlier phase runs: ``multi`` (``multi_part``)
    and the other two transport presets, ``transport_edm_diffusion_tendency``
    and ``transport_stochastic_interpolant``, trained and served as phase 22
    trains and serves its two (``transport_phase``: the steps, their
    launches and the gradient, evaluation and sample gates; ``cli predict``
    of one forecast step)."""
    result = {"multi": multi_part(workdir, device, card)}
    result.update(transport_phase(workdir, device, TRANSPORT_PRESETS_LEFT, FLAGSHIP_LAYERS))
    print(f"[presets left] {json.dumps({k: v for k, v in result.items() if k != 'multi'})}",
          flush=True)
    return result


KEPT_OUTPUTS = {"run", "example_o96.zarr"}  # phase 9's run and store: later phases read them


def discard_outputs(workdir: str, before: set) -> tuple:
    """Remove the directories that a phase made in ``workdir`` (its trainers'
    output directories with their checkpoints and bundles, its copies of
    bundles and stores), all but ``KEPT_OUTPUTS``, so that the disk holds one
    phase's outputs at a time.  Returns how many it removed and their bytes."""
    made = [os.path.join(workdir, name)
            for name in sorted(set(os.listdir(workdir)) - before - KEPT_OUTPUTS)]
    made = [path for path in made if os.path.isdir(path) and not os.path.islink(path)]
    size = sum(os.path.getsize(os.path.join(root, name))
               for path in made for root, _, names in os.walk(path) for name in names)
    for path in made:
        shutil.rmtree(path)
    return len(made), size


def report(kernel_rows: dict, serving: dict, training: dict, t_serving: dict,
           t_training: dict, trainer: dict, predict: dict, remat: dict, presets: dict,
           ens: dict, families: dict, transport: dict, hierarchy: dict,
           spectral: dict, later: dict, auxiliary: dict, left: dict) -> dict:
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
    ``predict_step``, each family path's training step and 2-step
    ``cli predict`` (phases 16-21), each transport preset's training
    step and generative ``cli predict`` (phase 22), each hierarchical
    preset's training step and ``cli predict`` and the ratio-2 step (phase
    23), the spectral and plain steps of phase 24, and the training steps
    and ``cli predict`` of phases 25-30 (``later``: projections, dynamic
    kNN, Transformer mappers; the hex, HEALPix and ICON meshes), phase
    31's rank 0's and each phase 32 part's rank 0's training step and
    forecast (``<part>_rank_0_train``, ``..._predict_2_steps``: 2 forecast
    steps, or the transport model's one generative step, or the
    ensemble's ``predict_step``), phase 34's (``auxiliary``) migrated
    fixture's 2-step ``cli predict``, pipeline training step and profiled
    step, and phase 35's (``left``) training steps and ``cli predict`` of
    ``multi`` and the other two transport presets."""
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
               "gnn_predict_2_steps": families["gnn"]["predict"]["launches"],
               **{f"{area}_{kind}": counts
                  for area in ("lam", "stretched")
                  for kind, counts in (
                      ("train", families[area]["train"]["launches_per_step"]),
                      ("rollout_2_step", families[area]["train"]["after"]["launches"]),
                      ("predict_2_steps", families[area]["predict"]["launches"]))},
               **{f"{label}_{kind}": counts
                  for presets, runs in ((TRANSPORT_PRESETS, transport),
                                        (TRANSPORT_PRESETS_LEFT, left))
                  for label, (_, _, steps) in presets.items()
                  for kind, counts in (
                      ("train", runs[label]["train"]["launches_per_step"]),
                      (f"predict_{steps}_steps", runs[label]["predict"]["launches"]))},
               **{f"{label}_{kind}": counts
                  for label in HIERARCHICAL_PRESETS
                  for kind, counts in (
                      ("train", hierarchy[label]["train"]["launches_per_step"]),
                      ("predict_2_steps", hierarchy[label]["predict"]["launches"]))},
               "hierarchical_ratio_2_step": hierarchy["ratio_2"]["launches"],
               "spectral_loss_and_residual_step": spectral["step"]["spectral"]["launches"],
               "spectral_plain_step": spectral["step"]["plain"]["launches"],
               **{f"{label}_{kind}": counts
                  for label, res in later.items()
                  for kind, counts in (("train", res["train"]["launches_per_step"]),
                                       ("predict_2_steps", res["predict"]["launches"]))},
               "aux_migrated_fixture_predict_2_steps": auxiliary["migrate"]["fp32"]["launches"],
               "aux_pipeline_freeze_train": auxiliary["freeze"]["launches_per_step"],
               "aux_profile_train": auxiliary["profile"]["launches_per_step"],
               "multi_train": left["multi"]["train"]["launches_per_step"],
               "multi_predict_2_steps": left["multi"]["predict"]["launches"]}
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
            # K1-K7: the kernel's design, its instantiation's ptxas
            # registers and spills, and its time back to back (K4: also
            # index_add_'s)
            **{key: head[key] for key in ("ms_back_to_back", "instantiation", "registers",
                                          "spill_stores", "spill_loads",
                                          "library_ms_back_to_back")
               if key in head},
            **({"route_detail": head["route"]} if "route" in head else {}),
            # K3, K5: the plain version is the whole plain backward
            # (gt_attention_bwd_plain); K4: gt_attention_bwd_src_plain; K6:
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
    phase_seconds, workdir = {}, None

    def phase(name, fn, *a):
        """Run and time one phase; once it has passed, remove the directories
        it made in the working directory (``discard_outputs``)."""
        t = time.perf_counter()
        before = set(os.listdir(workdir)) if workdir else None
        out = fn(*a)
        phase_seconds[name] = time.perf_counter() - t
        removed = ""
        if before is not None:
            t = time.perf_counter()
            n, size = discard_outputs(workdir, before)
            removed = f" ({n} directories, {size} B removed in {time.perf_counter() - t:.2f} s)"
        print(f"[phase] {name}: {phase_seconds[name]:.2f} s{removed}", flush=True)
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
            "lam": phase("lam", lam_phase, workdir, device),
            "stretched": phase("stretched", stretched_phase, workdir, device),
        }
        transport = phase("transport", transport_phase, workdir, device)
        hierarchy = phase("hierarchical", hierarchical_phase, workdir, device)
        spectral = phase("spectral", spectral_phase, workdir, device)
        slice_17 = {
            "projections": phase("projections", projections_phase, workdir, device),
            "dynamic": phase("dynamic", dynamic_phase, workdir, device),
            "transformer_mappers": phase("transformer mappers", transformer_mappers_phase,
                                         workdir, device),
        }
        meshes = {label: phase(label, mesh_phase, workdir, device, label)
                  for label in MESH_GRAPHS}
        parallel = phase("parallel", parallel_phase, workdir, graph, device)
        worlds = parallel.pop("worlds")
        shard_rows = phase("parallel shard kernels", halo_shard_kernels, graph, device)
        parallel_families = phase("parallel families", families_phase, workdir, graph, device,
                                  ens["losses"], worlds)
        routes = phase("parallel routes", routes_phase, workdir, graph, device, worlds)
        auxiliary = phase("auxiliary", auxiliary_phase, workdir, card)
        left = phase("presets left", presets_left_phase, workdir, device, card)
    for extra_rows in (shard_rows, left["multi"].pop("o48_rows"),
                       parallel_families.pop("rows"), routes.pop("rows"),
                       hierarchy["down_set_rows"],
                       slice_17["dynamic"]["runtime_sets"]["encoder_rows"],
                       *(m.pop("encoder_rows") for m in meshes.values())):
        for name, extra in extra_rows.items():
            rows[name] += extra
    rank_0 = parallel["ranks"][0]
    parallel_path = {"train": {"launches_per_step": rank_0["launches_per_step"]},
                     "predict": {"launches": {k: n * STEPS for k, n in
                                              rank_0["launches_per_forecast_step"].items()}}}
    family_paths = {f"{part}_rank_0": {"train": {"launches_per_step": res["launches_per_step"]},
                                       "predict": {"launches": res["launches_per_output"]}}
                    for part, res in [*parallel_families["parts"].items(),
                                      *routes["parts"].items()]}
    rep = report(rows, serving, training, t_serving, t_training, trainer, predict, remat, presets,
                 ens, families, transport, hierarchy, spectral,
                 {**slice_17, **meshes, "parallel_rank_0": parallel_path, **family_paths},
                 auxiliary, left)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "build_seconds": seconds, "phase_seconds": phase_seconds,
                       "serving": serving,
                       "training": training, "trainer": trainer, "predict": predict,
                       "transformer_serving": t_serving,
                       "transformer_training": t_training, "remat": remat, "presets": presets,
                       "ensemble": ens, "families": families, "transport": transport,
                       "hierarchical": hierarchy, "spectral": spectral, **slice_17,
                       "meshes": meshes, "parallel": parallel,
                       "parallel_families": parallel_families, "parallel_routes": routes,
                       "auxiliary": auxiliary, "presets_left": left,
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
