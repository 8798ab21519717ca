#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # Fig. 1 pair (1,048,576 rows), then
                                     # Zamba2-7B at full width and depth,
                                     # then the dense, gemma2 and MoE LMs
                                     # at full width (cut in depth), then
                                     # rwkv6-7b,
                                     # llama-3.2-vision-11b and
                                     # hubert-xlarge at full width and
                                     # depth (their timed prefills cut in
                                     # depth), then training: minicpm-2b's
                                     # train step at full width and depth,
                                     # then the mesh train step on a
                                     # one-rank NCCL (1, 1) mesh, then
                                     # decode on such a mesh

Phases, in order, one line each with its seconds; the first failure ends
the run with a nonzero exit code (nothing is caught):

 1. environment — nvidia-smi name and power limit, torch and CUDA versions;
 2. build       — nvcc compiles the sources of repro_torch/csrc (the four
                  SpMV kernels, and K5 ssd_chunk), one nvcc per source, all
                  at once, and links them into one library in
                  build/repro_torch/;
 3. kernels     — each SpMV kernel against its plain torch version on the
                  card at small random shapes, float32, float64 and bf16,
                  through
                  every body of K1-K4: σ-sorted SELL with empty slices at
                  C = 8, 32 and W = 8, 32, 128 (K1 at nv = 1, 3; K2 at
                  widths 1, 3, 4, 8, 16, 32, 33, 36, 64: its vector body at
                  k-tiles of 8, 16 and 32 with ragged and second tiles, its
                  scalar body at odd k), BCSR with
                  empty block rows and Block-ELL with padding blocks, each
                  at bm = 4, 8, 16 and bn = 16, 100, 128 (and 4 × 4) at
                  nv = 1, 3, 8, and every kernel once more with its values
                  off a 16-byte boundary (K2 also with x off one); then K5
                  through both of its bodies: single
                  chunks (T = 8 .. 128, several B·H, a nonzero incoming
                  state, f32 and bf16), scans of 3 and 4 chunks against
                  ssd_scan(use_kernel="ref"), a scan over batch-strided
                  views of a longer sequence, and the bf16 tensor-core
                  shape with its operands off a 16-byte boundary;
 4. main path   — the paper's four Fig. 1 cells as one spmv ExperimentSpec
                  through repro_torch.experiments.Runner (plan → build →
                  verify on the matrix and its structure twin → IOS/YAX →
                  instrumented CG → modelled-parallel time and structural
                  metrics at p = 8): fig1_shuffled with baseline and rcm,
                  fig1_banded with baseline, all engine="auto", and
                  fig1_shuffled + rcm at k = 8; then its reordered k = 1
                  cell (fig1_shuffled + rcm) on a fresh result store with
                  the same plan store (a plan-store hit, tune_ms = 0),
                  and the whole spec on the first result store (every
                  cell served from it), each with its seconds against the
                  first run's; then the Fig. 4
                  schedule spec on banded_m16384_bw8 and its shuffled
                  twin (static_default, static_c16, nnz_balanced and
                  metis_cut, p = 8; cut from the 65,536-row bandwidth-24
                  pair to keep the run inside its time: the pair and x
                  fit in L2, so its readings check the path and do not
                  answer Fig. 4's question). Plans, reorderings, operators, corpus
                  artifacts and records live in a temporary directory for
                  the run (no earlier run's entry is read);
4c. schemes     — the paper's scheme axis: one spmv ExperimentSpec on
                  stencil2d_shuf_256 (65,536 rows, 326,656 nnz; the
                  generator of loc_stencil2d_shuf at 256 x 256, cut to
                  keep the run inside its time; x and the matrix fit in
                  L2 at this size) over
                  paper_schemes() (baseline, rcm, metis, louvain, patoh,
                  random) and metis_nnzbal x {auto, sell (K1), bcsr (K3)},
                  the full policy, each cell with its host reorder ms and
                  IOS speedup over baseline; then the RCM-vs-METIS duel
                  (IOS, YAX, CG), pairwise win rates and speedup buckets;
4e. corpus      — every bundled fixture verified against the manifest's
                  dims; spmv cells on corpus://fix_banded_1k and the
                  stand-in of corpus://pwtk; plan(probe="learned") on the
                  stand-in of corpus://cant after the advisor has mined
                  the records of phases 4-4e, beside plan(probe=True);
4f. bench       — the figure drivers of repro_torch.bench on the card:
                  fig01_banded_shuffle on the Fig. 1 pair in memory (the
                  csr engine, timing only: the paper's banded / shuffled
                  GFLOP/s ratio), both cells then verified with their
                  structure twins against the float64 product (1e-4); the
                  views over the locality campaign (fig03, fig05, fig06,
                  fig07, fig11, table1, summarize_repro) on
                  stencil2d_shuf_256; fig04 (the parallel kind over four
                  partitioners), fig08 (every registered profile) and
                  fig09_10 (p = 64) on banded_m16384_bw8 and its shuffled
                  twin (L2-resident, as in phase 4: smoke readings, not
                  Figs. 4 and 8's answers); spmm_batch at its quick shapes (K1 and K2 must
                  launch); bell_formats on the same pair; run.py --smoke
                  twice, the second writing no record; then, each a path
                  of the kernels line with its seconds, the engines it
                  built and its launches by kernel: run.py --smoke-serve
                  (reject, shed-oldest and bursty degrade-to-k1 on
                  smoke_banded past a 0.02 MB budget: every record held
                  to serve_invariants, the campaign to overload, LRU
                  evictions and reloads and value swaps without a
                  replan, then the resume), run.py --smoke-workloads
                  (the MoE, attention and GNN streams under the
                  amortization invariants, then the resume),
                  workloads.run and moe_dispatch.run at their quick
                  sizes (every stream verified, no static stream
                  replanned, sorted and one-hot dispatch agree), and the
                  regress CLI on the fresh BENCH_spmv_torch.json (itself:
                  exit 0, every GFLOP/s halved: 1, a changed scale
                  stamp: 2).
                  Every CSV's header is held to the reference driver's;
                  each driver prints the cells it measured and those it
                  reused; a path that built a kernel engine must launch
                  its kernel;
 5. forced      — the kernel engines through make_engine on the structure
                  twin of the RCM-reordered fig1_shuffled (its sparsity
                  pattern, values U(-1, 1) from a seed; the order comes
                  from the plan store): sell (K1, and K2 at k = 8), bcsr
                  (K3) and bell (K4), each verified, then IOS-timed; then
                  the same engines in bf16, each operator called once and
                  held against the f64 product of the bf16-rounded
                  operands within 1e-2, and the bf16 csr engine held row
                  by row to its rounding bound γ_n·Σ|a·x| (see
                  bf16_row_bound) on 16 readings;
 6. kernel times — each SpMV kernel at the shape phase 5 gave it, against
                  its plain version (error; ms per call, see time_ms), its
                  byte bound and torch's CSR SpMV/SpMM on the same matrix
                  with int32 and with int64 indices (the faster is the
                  row's library_ms); then K2 once more at k = 32 (error,
                  ms, bound, library; kept in K2's row as "k32"); then the
                  bf16 kernels the same way (rows named <kernel>_bf16,
                  torch's bf16 CSR as the library, or none with its error);
6b. power law   — K1 (σ-sorted SELL), K2 at k = 8 and K3 (the largest
                  block shape under 8 GB of BCSR) on the structure twin of
                  the webbase-1M stand-in (1,000,005 rows, largest row
                  115,668 nonzeros), each path verified and IOS-timed, each
                  kernel timed as in phase 6 (rows <kernel>_powerlaw); K4's
                  Block-ELL bytes counted, not built;
 7. controls    — planted faults at the main-path shape must fail the
                  checks: each kernel, f32 and bf16, with its largest
                  stored chunk or block dropped, the bf16 csr engine with
                  one block of rows zeroed against its rounding bound, and
                  a diagonal-only operator under verify;
7s. serve       — repro_torch.serving.spmv_service on the Fig. 1 pair
                  (rcm, max_batch 8, window 20 ms): 48 seeded requests
                  over both matrices with engine sell (K2 per batch, K1
                  for the last, sent alone) and with bcsr (K3), every
                  response within 1e-4 of the float64 host product and
                  within 1e-5 of the unbatched op(x), fewer batches than
                  requests; where a dispatch's time goes; on one sell key
                  a value swap (x 1.01, no replan) and a 0.5% deletion
                  delta (Plan.apply_delta: no reorder, no tune), each
                  answered correctly, and the planted control (a response
                  after the swap held against the old product must
                  fail); an over-churn delta (a full replan) on a sell key
                  of the TRAFFIC_ROWS cut; then
                  a profiled stretch of 64 dispatches; open-loop traffic
                  (spmv_bench.run_serve_traffic: 4 keys, Zipf 1.1,
                  poisson, 200 arrivals, 10% value updates, 2% structure
                  deltas, a budget of 2.5 operators) on the Fig. 1
                  generator cut to TRAFFIC_ROWS rows: a sqrt(2) rate ramp
                  to the sustained rate (a step that is not sustained is
                  run once more, and fails only if that run fails too),
                  and the runs at 0.5x and 2x it
                  (every Future answered and none failed, budget kept,
                  counters balanced, operators reloaded, K2 launched,
                  rejects at 2x); one serve cell on fig1_shuffled at its
                  full size (8 arrivals with two value updates, the 0.5x
                  rate) through the Runner under torch.profiler, resumed
                  from its store;
7p. sharded     — sharded plans on fig1_shuffled at its full size, p = 8,
                  f32 (one card: every plan runs simulated): baseline and
                  rcm over 1d_rows and rcm over 2d_panels, engine and
                  partition auto, each printed with its decision (engine,
                  partitioner, schedule, halo, li, cut volume, bytes a
                  SpMV, h_pad), verified with its structure twin against
                  the float64 product (1e-4), held to the single-device
                  operator on its reordered matrix (1e-5), and its mesh
                  path on [cuda:0] * 8 held to its simulated path (1e-6);
                  the rcm 1d_rows plan also at k = 8 and through CG
                  against the single-device operator, and the host ms of
                  its partitioners, comm model, feature scan and layout;
                  then a parallel campaign through the Runner
                  (fig1_shuffled x {baseline, rcm} x {1d_rows:nnz_balanced,
                  2d_panels:nnz_balanced}, engine auto, and
                  rcm x bell x 1d_rows:nnz_balanced, whose modelled time
                  launches K4 on each panel, 40 calls a panel), one cell
                  again from the plan store and the whole resumed from the
                  result store; then K4 at the bell cell's own panel
                  shapes (rectangular, h x 1,048,576): each panel's y
                  from one counted K4 launch held to the plain Block-ELL
                  product (1e-5) and the float64 product (1e-4), and
                  each panel timed as in phase 6; and
                  one sharded key in SpmvService (4 requests against the
                  float64 product, update_values raising RoutedElsewhere);
7r. router      — repro_torch.router on the one card (a mesh of d > 1
                  devices runs its panels simulated; its per-device
                  budget is the accounting over those d devices): the
                  router soak (bench.run.smoke_route, run.py
                  --smoke-route, on the TRAFFIC_ROWS cut: a bin_pack
                  fleet of 2 meshes x 4
                  devices at 4 MiB a device with value swaps and deltas,
                  a comm_aware fleet, the sibling p99 and
                  delta-against-replan checks, the resume); the Fig. 1
                  pair (rcm) on meshes of Topology(devices=8): a budget
                  of 1.5x one key's largest per-device share with
                  requests alternating between the keys (evictions and
                  plan-store reloads, every answer within 1e-4 of
                  float64, every high-water mark within its budget), a
                  sharded value swap, a 0.5% deletion delta applied in
                  the background while the sibling key serves (its p99
                  before and during, held to 5x + 50 ms), comm_aware
                  placement over an 8- and a 2-device mesh; a fleet of
                  two one-device meshes (nnz_balance, sell: K1 for lone
                  requests, K2 for batches) on the cut; and routed
                  --serve-traffic on the cut at half 7s.3's sustained
                  rate;
7w. workloads   — repro_torch.workloads.run_stream(verify=True) over the
                  drift scenario: MoE routing at Qwen3-30B-A3B's router
                  (128 experts, top 8, d 2048, 4096 tokens; sell, K2; the
                  dispatch buffer bit for bit the one-hot one's), a GNN
                  of 262,144 rows (sell, K2; every step after the first
                  a StructureDelta, no replan) and block-sparse attention
                  at S = 8192 (bcsr 64 x 64, K3);
 8. lm prefill  — the SpMV tensors are freed; Zamba2-7B at full width and
                  depth (81 Mamba2 layers, the shared attention block after
                  each group of 6), random f32 parameters from a seeded
                  generator on the card (embedding scaled, see EMBED_SCALE),
                  B = 2 prompts of S = 4096 tokens through
                  repro_torch.serving.decode.prefill: with K5 (81
                  launches, one per layer) and with the plain SSD chunk, and as a witness
                  the plain SSD with chunks of 64 against that of 128 (the
                  same function, another rounding); every Mamba2 layer
                  of it held, on the input the K5 path gave it, against the
                  plain SSD within 1e-5; the same prefill cut to 15 layers
                  (2 groups and the tail), K5 against plain, logits within
                  1e-3 of the largest, with the witness beside it; then
                  the 81-layer bf16 prefill: each Mamba2 layer with K5
                  against the plain SSD on the same input within 1e-2,
                  then timed (CUDA events, median of 5) in tokens/s, and
                  profiled once (device busy share, device time by kernel
                  group);
 9. lm decode   — generate (greedy, f32, 81 layers) at B = 4, prompt 16,
                  32 new tokens, in tokens/s; one decode step profiled as
                  the prefill is; then 17 tokens decoded one by
                  one through the cache against a K5 prefill over the same
                  17 tokens (padded to one chunk), within rtol = atol =
                  2e-2, at 15 layers (and reported at 81);
10. ssd times   — K5 at the main-path shape, one layer's whole scan (the
                  first Mamba2 layer of phase 8: B = 2, S = 4096 in 32
                  chunks of T = 128, H = 112, N = P = 64, from the zero
                  state), bf16 and f32: error against
                  ssd_scan(use_kernel="ref"), ms per call (time_ms), the
                  per-layer bound, plain ms; beside it one chunk alone
                  (the second, with the state the first left);
11. ssd controls — K5 given xw with its last time step zeroed, and K5's
                  chain with the carried state zeroed between chunks, must
                  each fail the check against the intact plain result;
12. lm families — the Zamba2 tensors are freed; then, one at a time (each
                  freed before the next), six architectures at their
                  published widths with random f32 parameters from a seeded
                  generator on the card, cut in depth as LM_FAMILY_CELLS
                  says (the f32 draw under ~42 GB; qwen2-7b, minicpm-2b
                  and gemma2 further, for time): 12a qwen2-7b (GQA 28/4,
                  QKV bias) at 8 of 28 layers, 12b
                  minicpm-2b (MHA 36 x 64) at 8 of 40 layers (14a trains
                  it at full depth), 12c command-r-plus-104b at 4 of 64
                  layers, 12d gemma2-27b at 8 of 46 (4 local/global
                  pairs), 12e qwen3-moe-30b-a3b
                  at 16 of 48 (128 experts, top 8), 12f phi3.5-moe at 8 of
                  32 (16 experts, top 2). Each: decode through an f32
                  cache against an f32 prefill over the same tokens (17;
                  8 for MoE, which then cannot drop, drop_frac == 0
                  asserted on both sides) within 1e-3 of the largest
                  logit, at the cell's depth for 12a and 12b and at 2
                  layers for the others (on a miss the gap at every depth is
                  printed before the run fails); then the parameters cast
                  to bf16 and a bf16 prefill (qwen2-7b, minicpm-2b and
                  the MoE models B = 2 x S = 4096, command-r-plus 1 x
                  4096, gemma2 1 x 8192) timed by CUDA events (median of
                  5) in tokens/s, with its peak memory and, for MoE,
                  router_li and drop_frac. 12a also runs greedy generate
                  in f32 (B = 4, prompt 16, 32 new) in tokens/s, one f32
                  decode step and one bf16 prefill profiled (idle share,
                  device time by kernel group; attention's device time
                  from CUDA events around each flash_attention call), and
                  the f32 forward at 2 layers against the same forward
                  in float64 on the card within 1e-4. 12d holds the first
                  local layer's attention at S = 8192 through
                  flash_attention against a materialized masked softmax
                  in f32 within 1e-4 of the largest entry; the same
                  without the window must move the positions it binds
                  (q >= 4096) by more than 1e-2. 12e and 12f run every
                  MoE layer, on its own input in an f32 forward over the
                  prefill's 8192 tokens, with the sorted and the onehot
                  dispatch (a layer must drop): output within 1e-5 of the
                  largest entry, every metric equal. These families reach
                  no Pallas kernel in the reference (attention, MLP and
                  expert products are jnp there, torch ops here), so
                  phase 12 adds no kernel row;
13. lm tail     — then, one at a time (each freed before the next), the
                  last three architectures at their published widths and
                  full depth, random f32 parameters from a seeded
                  generator on the card: 13a rwkv6-7b (32 layers, 64 heads
                  of 64, WKV chunk 32): decode through an f32 cache against
                  an f32 prefill over 17 tokens (not a multiple of the
                  chunk: the prefill pads) within 1e-3 of the largest
                  logit, the 2-layer f32 forward over 100 tokens against
                  float64 on the card within 1e-4, f32 generate (B = 4,
                  prompt 16, 32 new) in tokens/s with one decode step
                  profiled; 13b llama-3.2-vision-11b (8 groups of 4 self
                  layers and 1 gated cross layer over 1600 image tokens),
                  its gates set to 0.5 first (they are 0 at init): decode
                  against prefill as 13a, and the witness that the gates
                  set back to 0 move the logits by more than 1e-2 of the
                  largest; 13c hubert-xlarge (48 layers, frame embeddings
                  in, untied head): the 2-layer float64 check, and the
                  witness that redrawing the last of 100 frames moves the
                  first frame's logits (the same forward made causal is
                  printed beside it). Each then casts to bf16 and times a
                  prefill (rwkv6 and the vlm B = 2 x S = 4096, the vlm with
                  image_embeds [2, 1600, 4096]; hubert 8 x 1500 frames) by
                  CUDA events (median of 5) in tokens/s with its peak
                  memory, and profiles it once (idle share, launches,
                  device time by kernel group), both cut in depth (rwkv6
                  at 2 of its 32 layers, the vlm at 2 of its 8 groups,
                  hubert at 12 of its 48 layers; see LM_TAIL_CELLS).
                  These families reach no
                  Pallas kernel in the reference, and phase 13 fails if
                  it launches any kernel of the kernels line;
14. lm train    — training on the card, each model freed before the next
                  (repro_torch.training, launch.train; TF32 off): 14a
                  minicpm-2b at full width and depth (40 layers), f32
                  master weights and Adam moments, bf16 compute, remat of
                  every layer, WSD (warmup 2, total 10), through
                  make_train_step on SyntheticLM.batch_for_model at B = 1
                  x S = 4096: one warm-up step and 3 timed by CUDA events
                  (median) in tokens/s, with the peak memory and MFU ((6
                  N T + 3 x the causal attention's products) / 989
                  TFLOP/s); then one step composed of the step's parts
                  (loss_and_grads, then adamw_update) that split its time
                  between them; each step's loss, grad_norm and lr
                  (finite; lr exactly lr_at's); one step profiled at 2 of
                  the 40 layers on copies of their state (idle share,
                  launches, device time by kernel group);
                  14b the same model at 2 layers, 1 x 256 tokens:
                  loss_fn's loss and gradients in f32 against float64 on
                  the card (1e-5 relative, each gradient leaf 1e-4 of its
                  largest float64 entry), then one adamw_update from the
                  same state and gradients in f32 and float64 (1e-5 of
                  each leaf's largest entry); 14c zamba2-7b at full width
                  cut to one group and its tail (9 Mamba2 layers and the
                  shared attention; embedding scaled as in phase 8), f32,
                  1 x 1024: loss and gradients with K5 against the plain
                  SSD (1e-4 relative, each leaf 1e-3 of its largest), the
                  plain scan at chunk 64 against 128 beside it, and K5
                  launched exactly 18 times (2 x 9: the forward and its
                  recomputation; the SSD's backward is torch ops); 14d
                  launch.train.train on small_lm_config(), 20 steps of 8 x
                  256, a checkpoint every 10: crashed at 10, resumed to
                  20, and 20 uninterrupted steps in another directory
                  (the checkpoints in a temporary directory): the resumed
                  losses within 1e-5 of the uninterrupted ones, the
                  final loss below the first by more than 0.3, and
                  restore_latest giving the last saved state bit for
                  bit. Only 14c may launch a kernel of the kernels line;
15. mesh        — the mesh paths (repro_torch.launch.mesh,
                  distributed.sharding) on one NCCL process group of one
                  rank (a HashStore: no network) and a (1, 1) ("data",
                  "model") mesh, destroyed when the phase ends; a failed
                  NCCL init or collective ends the run. One rank shows that
                  the path runs on the card and gives the plain path's
                  numbers, not what a collective costs. 15a minicpm-2b at
                  full width and 2 of its 40 layers (14a's state), 1 x
                  4096, f32 master weights, bf16 compute, WSD: two steps
                  through make_train_step(mesh=) and two through
                  mesh=None from the same state, loss, grad_norm and every
                  leaf of the state equal or within 1e-6 of the leaf's
                  largest entry, the largest difference printed, both
                  paths' ms (CUDA events) and peak memory; 15b
                  qwen3-moe-30b-a3b at full width (128 experts, top 8) and
                  2 of 48 layers, 1 x 4096: one step whose MoE layers take
                  moe_layer(mesh=) against mesh=None under the same gate,
                  with router_li and drop_frac (one expert-parallel rank:
                  no all_to_all runs, ep_exchange=false); 15c 14c's Zamba2 through
                  make_train_step(mesh=) in f32: K5 launched 18 times in
                  the step, the loss and the gradients (read from the
                  first AdamW step's mu) within 14c's gates of 14c's
                  plain-SSD step;
16. mesh decode — a second one-rank NCCL group and (1, 1) mesh, destroyed
                  when the phase ends: the sharded serve step
                  (make_serve_step(mesh=) over each cache leaf's block
                  under launch.specs.cache_specs) against the plain serve
                  step from the same cache, 4 tokens, f32, for kv_shard
                  "seq" and "hd": tokens equal, logits within 1e-5 of the
                  largest plain logit, every cache leaf within 1e-6 of its
                  largest entry. One rank: each split is whole, so the
                  lines say model_shards=1 combine_ranks=1 and show the
                  path, not what a combine over ranks costs. 16a qwen2-7b
                  at full width, 4 of 28 layers, B = 8 (decode_32k's 128
                  cut), 32,768 positions, all but the last 6 random keys
                  and values from a seed, 2 tokens through the plain step
                  (a plain fill of 32k tokens would outlast the phase);
                  then one warm-up and 3 bf16 steps of each path timed
                  (CUDA events, the median, ms a token) with their peak
                  memory; 16b Zamba2 at full width and 9 layers (the
                  conv and SSM states, the shared attention's KV cache;
                  the embedding scaled as in phase 8) and 16c rwkv6-7b at
                  2 layers (the WKV state and the token shifts), B = 8,
                  8 prompt tokens through the plain step. No kernel may
                  launch (decode takes Mamba2's one-step recurrence).
17. dry-run     — on the host: qwen2-7b x decode_32k on (16, 16) for both
                  kv_shards (hd's all-reduce bytes above seq's), whose
                  tensor-parallel per-rank flops must stay within 1.5e10
                  for each, qwen2-7b x prefill_32k, whose tensor-parallel
                  per-rank flops must stay within 1.5e14, the multi-pod
                  SpMV layouts and the roofline over those records.

`--tp-cards N` runs phases 15t and 16t alone instead, over N cards of one
host, each over NCCL on a (1, N) mesh (see `tp_cards_phase`): 15t, the
tensor-parallel mesh train step against the plain step on one card; 16t,
the tensor-parallel decode step (qwen2-7b at full width and 2 layers,
B = 8, a 32,768-position cache, kv_shard "seq" and "hd") against the
plain serve step on one card from the same filled cache, 4 tokens in
f32 (tokens equal, logits within 1e-5, the gathered cache within 1e-6),
then ms a token and peak memory of each in bf16.

Every kernel launch counter is set to 0 just before the first campaign of
phase 4, the campaign of phase 4c, the drivers of phase 4f (its fig. 1
cells, then the others, then each soak and workload driver), each forced
path of phase 5 (f32 and bf16) and of phase 6b, each service and
workload path of phases 7s and 7w, the parallel campaign of phase 7p,
the one-device fleet of phase 7r, the f32 prefill of phase 8, the
train step of phase 14c and the mesh train step of phase 15c, and read
just after it (and around each K4 panel check of phase 7p, which must
show one K4 launch; those launches are not the path's); a bell cell of
phase 7p that launched no K4, a forced path that
did not launch its kernel, a cell whose plan (or forced engine) is a
kernel engine that launched nothing in its own timed calls, a service or
workload path that did not launch its kernels, a prefill whose K5
count is not its number of Mamba2 layers (81), or a train step (14c,
15c) whose K5 count is not twice its Mamba2 layers (18), fails the run. The kernels
line reports, for each kernel, the launches of the path that feeds its
row and, for K1-K4 in f32, those of the bench paths of phase 4f (the
figure drivers, and each of its soaks and workload drivers), the
service, router, workload and parallel campaign paths, and for K5 the f32 prefill
and the train steps of phases 14c and 15c (`launches_paths`); spmm_batch in phase 4f
must launch K1 and K2.

Verification is against the numpy float64 oracle at rel err <= 1e-4 (the
error over the oracle's largest entry); a kernel against its plain version
at rel err <= 1e-5 in float32 (same terms, different summation order),
1e-12 in float64 and 1e-2 in bf16 (f32 sums in both, y rounded once). The generators give every row a diagonal
of m = 1,048,576 at this size, about 1e5 times the rest of the row, and an
error divided by that scale hides wrong off-diagonal terms; so every check
at the main-path shape also runs on the structure twin, where each term
counts (phase 7 shows that it catches what the original matrix hides). TF32
is off for every f32 product. The last lines are one JSON object with every
kernel's numbers, the nvidia-smi line, and the result line.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 1e-2}
LM_TOL = 1e-3                    # prefill logits, K5 against the plain SSD;
                                 # phase 12's decode against prefill
LAYER_TOL = 1e-5                 # one Mamba2 layer, K5 against the plain SSD
DECODE_TOL = 2e-2                # decode through the cache vs the prefill
VERIFY_TOL = 1e-4
ITERS = 20
BATCH = 20                       # kernel times: calls per CUDA event pair
BATCHES = 5                      # kernel times: event pairs, median taken
POWERLAW_BATCH = 5               # the power-law rows' calls take 9-40 ms each
K2_WIDTHS = (1, 3, 4, 8, 16, 32, 33, 36, 64)   # K2 at small shapes
K2_WIDE = 32                     # K2's second width at the main-path shape
PARALLEL_P = 8                   # modelled-parallel cores of the campaigns

KERNELS = {
    "sell_spmv": "src/repro/kernels/sell_spmv/kernel.py:50",
    "sell_spmm": "src/repro/kernels/sell_spmm/kernel.py:56",
    "bcsr_spmv": "src/repro/kernels/bcsr_spmv/kernel.py:42",
    "bell_spmv": "src/repro/kernels/bell_spmv/kernel.py:38",
    "ssd_chunk": "src/repro/kernels/ssd_chunk/kernel.py:54",
}
SOURCE = "src/repro_torch/csrc/spmv_kernels.cu"
SSD_SOURCE = "src/repro_torch/csrc/ssd_chunk.cu"
LM_ARCH = "zamba2-7b"
# The reference draws the embedding at std 0.02 and runs no residual around
# its Mamba2 blocks: at that scale each block's gated RMS norm sits under its
# eps, the activations shrink to 0 within a few layers at any width, and
# every logit of the 81-layer model is exactly 0, so no comparison could see
# a fault. The smoke run draws the reference's parameters and scales the
# embedding to std 0.2, past which every layer carries activations of RMS
# ~0.9. Those random layers, with no residual, amplify a difference in
# rounding by ~1.5x each (10x per group of 6), so two correct SSD paths
# decorrelate well before layer 81: the end-to-end comparisons run at a
# depth of 15 layers (2 groups and the tail), and the full-depth prefill
# holds K5 against the plain SSD layer by layer.
EMBED_SCALE = 10.0


def phase(name: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[phase] {name} {time.perf_counter() - t0:.2f}s {extra}",
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|), in float64."""
    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    return err, err / (float(want.abs().max()) + 1e-30)


def check_close(name: str, got, want, dtype) -> float:
    _, rel = rel_err(got, want)
    tol = KERNEL_TOL[str(dtype).replace("torch.", "")]
    if not rel <= tol:
        raise AssertionError(f"{name}: kernel vs plain rel err {rel:.3e} "
                             f"> {tol:.0e}")
    return rel


def time_ms(fn, batch: int = BATCH, batches: int = BATCHES) -> float:
    """Device ms per call of fn(): one CUDA event pair around each batch of
    `batch` back-to-back calls, the median over `batches` batches divided by
    `batch`. A batch of warm-up calls is left in the queue when the first
    event is recorded, so the events time the card's work and not the
    host's enqueue of the first call."""
    import numpy as np
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(batch):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(batches)]
    for start, end in ev:
        start.record()
        for _ in range(batch):
            fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev])) / batch


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def operator_bytes(op) -> int:
    import torch

    return sum(tensor_bytes(v) for v in vars(op).values()
               if isinstance(v, torch.Tensor))


def bound_ms(nbytes: int, flops: int,
             flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- the kernel calls, wrapper and plain version on the same inputs --------
def sell_calls(op, x, spmm: bool | None = None):
    """K1, or K2 when spmm is set (by default when x has more than one
    column)."""
    from repro_torch.kernels.sell_spmm.kernel import (pick_k_tile, sell_spmm,
                                                      sell_spmm_plain)
    from repro_torch.kernels.sell_spmv.kernel import (sell_spmv,
                                                      sell_spmv_plain)

    args = (op.chunk_vals, op.chunk_cols, op.chunk_slice)
    if not (x.shape[1] > 1 if spmm is None else spmm):
        return ("sell_spmv",
                lambda: sell_spmv(*args, op.slice_ptr, x, op.num_slices),
                lambda: sell_spmv_plain(*args, x, op.num_slices))
    kt = pick_k_tile(x.shape[1])
    return ("sell_spmm",
            lambda: sell_spmm(*args, op.slice_ptr, x, op.num_slices, kt),
            lambda: sell_spmm_plain(*args, x, op.num_slices))


def bcsr_calls(op, x2d):
    from repro_torch.kernels.bcsr_spmv.kernel import (bcsr_spmv,
                                                      bcsr_spmv_plain)

    args = (op.blocks, op.block_rows, op.block_cols)
    return ("bcsr_spmv",
            lambda: bcsr_spmv(*args, op.block_rowptr, x2d, op.nbr),
            lambda: bcsr_spmv_plain(*args, x2d, op.nbr))


def bell_calls(op, x2d):
    from repro_torch.kernels.bell_spmv.kernel import (bell_spmv,
                                                      bell_spmv_plain)

    return ("bell_spmv",
            lambda: bell_spmv(op.blocks, op.block_cols, x2d),
            lambda: bell_spmv_plain(op.blocks, op.block_cols, x2d))


def x2d_for(op, nv: int, gen, dtype, dev):
    bn = op.block_shape[1]
    return torch_randn((op.ncb, bn, nv), gen, dtype, dev)


def torch_generator(seed: int):
    import torch

    return torch.Generator().manual_seed(seed)


def torch_randn(shape, gen, dtype, dev):
    import torch

    return torch.randn(shape, generator=gen, dtype=torch.float64).to(
        dev, dtype)


# -- phase 3: small random shapes ------------------------------------------
def small_matrices():
    """Small host matrices that reach the formats' edge cases."""
    import numpy as np

    from repro_torch.core.sparse.csr import CSRMatrix
    from repro_torch.matrices import generators as G

    rng = np.random.default_rng(11)
    holes = rng.standard_normal((300, 280)) * (rng.random((300, 280)) < 0.05)
    holes[40:120] = 0.0                      # empty slices / block rows
    holes[200, :] = rng.standard_normal(280)  # one dense row (SELL padding)
    return {"power_law": G.power_law(700, alpha=1.9, seed=3),
            "holes": CSRMatrix.from_dense(holes)}


def misaligned(op, attr: str):
    """A shallow copy of `op` whose `attr` holds the same values one element
    past an aligned base (the allocator's blocks start on 512 bytes), which
    sends K1-K4 to their scalar bodies (and K5 in bf16 to its CUDA-core
    body)."""
    import copy

    out = copy.copy(op)
    setattr(out, attr, misaligned_tensor(getattr(op, attr)))
    return out


def misaligned_tensor(t):
    """The values of `t` in a buffer one element past an aligned base."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def kernels_small(dev) -> int:
    import torch

    from repro_torch.core.spmv.ops import make_engine

    gen = torch_generator(0)
    checked = 0

    def check(label, calls, op, x, **kw):
        nonlocal checked
        name, kern, plain = calls(op, x, **kw)
        check_close(f"{name} {label}", kern(), plain(), x.dtype)
        checked += 1

    for mname, mat in small_matrices().items():
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            # K1's bodies: 16-byte loads for W / kN a power of two <= 32
            # (f32 W = 8, 32, 128; f64 W = 8, 32), scalar loads otherwise.
            # K2's: the staged vector body for k a multiple of kN (k-tiles
            # of 8, 16 and 32 columns, 1 to 16 rows a lane; k = 4 and 36
            # leave a tile part empty, k = 64 takes two tiles; W = 128
            # takes 4 or 16 sub-chunks), the scalar body for k = 1, 3, 33
            # (f32) and a base off 16 bytes
            for i, shape in enumerate((c, w) for c in (8, 32)
                                      for w in (8, 32, 128)):
                op = make_engine(mat, "sell", dtype=dtype, block_shape=shape,
                                 sell_sigma=(64, mat.m)[i % 2], device=dev)
                for k, spmm in ((1, False), (3, False),
                                *((k, True) for k in K2_WIDTHS)):
                    x = torch_randn((mat.n, k), gen, dtype, dev)
                    check(f"{mname} {shape} k={k}", sell_calls, op, x,
                          spmm=spmm)
                bad_vals = misaligned(op, "chunk_vals")
                for k, spmm in ((1, False), (8, True)):
                    x = torch_randn((mat.n, k), gen, dtype, dev)
                    check(f"{mname} {shape} k={k} values misaligned",
                          sell_calls, bad_vals, x, spmm=spmm)
                x = misaligned_tensor(torch_randn((mat.n, 8), gen, dtype,
                                                  dev))
                check(f"{mname} {shape} k=8 x misaligned", sell_calls, op, x,
                      spmm=True)
            # K3's and K4's bodies: 16-byte loads at nv = 1 and bm <= 16
            # (R = 4, 8, 16), scalar loads for nv > 1, an odd bn or a
            # misaligned base
            for (eng, calls), shape in (
                    (ec, sh) for ec in (("bcsr", bcsr_calls),
                                        ("bell", bell_calls))
                    for sh in ((4, 4), *((bm, bn) for bm in (4, 8, 16)
                                         for bn in (16, 100, 128)))):
                op = make_engine(mat, eng, dtype=dtype, block_shape=shape,
                                 device=dev)
                for nv in (1, 3, 8):
                    check(f"{mname} {shape} nv={nv}", calls, op,
                          x2d_for(op, nv, gen, dtype, dev))
                check(f"{mname} {shape} misaligned", calls,
                      misaligned(op, "blocks"),
                      x2d_for(op, 1, gen, dtype, dev))
    return checked


# -- phases 4-5: the main path ---------------------------------------------
# the forced path that feeds each kernel's row of the kernels line
FEEDS = {"sell_spmv": "forced/sell/k1", "sell_spmm": "forced/sell/k8",
         "bcsr_spmv": "forced/bcsr/k1", "bell_spmv": "forced/bell/k1"}
KERNEL_OF = {"sell": ("sell_spmv", "sell_spmm"), "bcsr": ("bcsr_spmv",),
             "bell": ("bell_spmv",)}


def fig1_spec(shuffled: str, banded: str, iters: int, keep=None):
    """The paper's four Fig. 1 cells as one spmv ExperimentSpec: the
    product grid (both matrices x {baseline, rcm} x k in {1, 8}) cut to
    fig1_shuffled x {baseline, rcm}, fig1_banded x baseline (k = 1) and
    fig1_shuffled x rcm at k = 8 (or to `keep`, (matrix, scheme, k)
    triples); verified (matrix and structure twin), IOS, YAX, CG, the
    modelled-parallel time and the structural metrics at p = 8."""
    from repro_torch.experiments import ExperimentSpec, MeasurePolicy

    keep = keep or {(shuffled, "baseline", 1), (shuffled, "rcm", 1),
                    (banded, "baseline", 1), (shuffled, "rcm", 8)}

    class Fig1Spec(ExperimentSpec):
        def cells(self, matrices=None, device="cpu"):
            return [c for c in super().cells(matrices, device)
                    if (c.matrix, c.scheme, c.k) in keep]

    return Fig1Spec(
        name="fig1", matrices=(shuffled, banded), schemes=("baseline", "rcm"),
        ks=(1, 8), ps=(PARALLEL_P,),
        policy=MeasurePolicy(iters=iters, warmup=3, cg_profiles=("*",),
                             verify=True, verify_tol=VERIFY_TOL))


def cell_tag(rec) -> str:
    return f"{rec['matrix']}/{rec['scheme']}/k{rec['k']}"


def check_cell_launches(rec) -> None:
    """The engine a cell's plan picked launched its kernel in that cell's
    own timed calls (the record's `launches`, counted by the cell)."""
    kns = KERNEL_OF.get(rec["engine"], ())
    if kns and not any(rec["launches"][kn] > 0 for kn in kns):
        raise AssertionError(f"{cell_tag(rec)}: the plan picked "
                             f"{rec['engine']} but no kernel of it launched "
                             f"in the cell's timed calls: {rec['launches']}")


def campaign(dev, mats: dict, iters: int) -> tuple:
    """Phase 4: the Fig. 1 spec through the Runner on a fresh result store
    (every cell measured, plans from scratch), then twice more: on a fresh
    result store with the same plan store (every plan and operator from
    the plan store: plan_store_hit, tune_ms = 0), and on the first result
    store (every cell served from it). Launch counts are set to 0 before
    the first run and read after it; each record's own `launches` counts
    the launches of its timed IOS/YAX/CG calls alone, and the engine each
    plan picked must have launched its kernel there, in both measured
    runs. Returns the first report and the launches."""
    from repro_torch import kernels
    from repro_torch.experiments import ResultStore, Runner

    shuffled, banded = mats
    spec = fig1_spec(shuffled, banded, iters)
    ncells = len(spec.cells())
    results = os.environ["REPRO_TORCH_RESULT_STORE"]
    t0 = time.perf_counter()
    kernels.reset_launches()
    rep = Runner(spec, ResultStore(os.path.join(results, "first")),
                 get_matrix=mats.__getitem__, device=dev).run()
    launches = dict(kernels.LAUNCHES)
    first_s = time.perf_counter() - t0
    if rep.measured != ncells:
        raise AssertionError(f"fresh store: measured {rep.measured} of "
                             f"{ncells} cells")
    for rec in rep.records:
        tag = cell_tag(rec)
        check_cell_launches(rec)
        ios_ms = rec.get("seq_ios_ms", rec["spmm_ms"])
        phase(f"cell {tag}", time.perf_counter() - rec["runner_wall_s"],
              engine=rec["engine"], label=rec["plan_label"],
              plan_ms=f"{rec['plan_ms']:.1f}",
              reorder_ms=f"{rec['reorder_ms']:.1f}",
              tune_ms=f"{rec['tune_ms']:.1f}",
              build_ms=f"{rec['format_build_ms']:.1f}",
              verify=f"{rec['verify_rel_err']:.2e}",
              verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
              ios_ms=ios_ms,
              gflops=f"{rec.get('seq_ios_gflops', rec.get('spmm_gflops')):.2f}",
              yax_ms=rec.get("seq_yax_ms"), cg_ms=rec.get("cg_ms"),
              li_static=f"{rec['li_static']:.4f}",
              li_nnz_balanced=f"{rec['li_nnz_balanced']:.4f}",
              par_static_ms=rec["par_static_ms"],
              par_nnz_balanced_ms=rec["par_nnz_balanced_ms"],
              bandwidth=rec["bandwidth"], cut_volume=rec["cut_volume"],
              block_fill_8x128=f"{rec['block_fill_8x128']:.4f}",
              launches=json.dumps(rec["launches"]))
    phase("campaign fig1", t0, cells=ncells, measured=rep.measured,
          launches=json.dumps(launches))
    base = rep.value("seq_ios_ms", shuffled, "baseline", k=1)
    rcm = rep.value("seq_ios_ms", shuffled, "rcm", k=1)
    print(f"[result] rcm speedup over baseline on {shuffled} (IOS, auto "
          f"engine): {base / rcm:.3f}x", flush=True)

    # from the plan store: the reordered k = 1 cell, not all four, to keep
    # the run inside its time
    t1 = time.perf_counter()
    again_spec = fig1_spec(shuffled, banded, iters,
                           keep={(shuffled, "rcm", 1)})
    again = Runner(again_spec, ResultStore(os.path.join(results, "again")),
                   get_matrix=mats.__getitem__, device=dev).run()
    again_s = time.perf_counter() - t1
    for rec in again.records:
        if not (rec["plan_store_hit"] and rec["op_cache_hit"]
                and rec["tune_ms"] == 0.0 and rec["reorder_ms"] == 0.0):
            raise AssertionError(f"{cell_tag(rec)}: not served by the plan "
                                 f"store: plan_store_hit="
                                 f"{rec['plan_store_hit']} op_cache_hit="
                                 f"{rec['op_cache_hit']} tune_ms="
                                 f"{rec['tune_ms']}")
        check_cell_launches(rec)
        phase(f"cell {cell_tag(rec)} from the plan store",
              time.perf_counter() - rec["runner_wall_s"],
              plan_ms=f"{rec['plan_ms']:.1f}",
              load_ms=f"{rec['op_load_ms']:.1f}",
              verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
              ios_ms=rec.get("seq_ios_ms", rec["spmm_ms"]),
              launches=json.dumps(rec["launches"]))
    phase("campaign fig1 from the plan store", t1,
          plan_store_hits=f"{sum(r['plan_store_hit'] for r in again.records)}"
                          f"/{len(again.records)}", seconds=f"{again_s:.2f}",
          first_run_seconds=f"{first_s:.2f}")

    t1 = time.perf_counter()
    resumed = Runner(spec, ResultStore(os.path.join(results, "first")),
                     get_matrix=mats.__getitem__, device=dev).run()
    if resumed.measured != 0 or resumed.reused != ncells:
        raise AssertionError(f"resume: measured {resumed.measured}, reused "
                             f"{resumed.reused} of {ncells}")
    phase("campaign fig1 resumed", t1,
          result_store_hits=f"{resumed.reused}/{ncells}",
          seconds=f"{time.perf_counter() - t1:.2f}",
          first_run_seconds=f"{first_s:.2f}")
    return rep, launches


# a bench-tier pair, the first two matrices of the reference's quick set
# (16,384 rows): the METIS labels of the 65,536-row pair (bandwidth 24)
# this phase ran on before take 22-25 s a matrix on one host core. The
# pair (about 3.3 MB of CSR) and x fit in the 50 MB L2, so the timings
# read on it exercise the path and do not answer Fig. 4's question.
SCHEDULE_PAIR = ("banded_m16384_bw8", "banded_shuf_m16384_bw8")


def schedule_campaign(dev) -> None:
    """The Fig. 4 scheduling sweep on SCHEDULE_PAIR x {static_default,
    static_c16, nnz_balanced, metis_cut} at p = 8, csr panels; metis_cut
    groups the rows by their METIS 8-way labels and splits the grouped
    matrix into nnz-balanced panels."""
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner)

    t0 = time.perf_counter()
    spec = ExperimentSpec(
        name="fig4_schedule", kind="schedule",
        matrices=SCHEDULE_PAIR, engines=("csr",), ps=(PARALLEL_P,),
        variants=("static_default", "static_c16", "nnz_balanced",
                  "metis_cut"),
        policy=MeasurePolicy(iters=10, with_yax=False, with_parallel=False,
                             with_metrics=False))
    rep = Runner(spec, ResultStore(os.path.join(
        os.environ["REPRO_TORCH_RESULT_STORE"], "schedule")),
        device=dev).run()
    for rec in rep.records:
        print(f"[schedule] {rec['matrix']} {rec['variant']} p={rec['p']} "
              f"modelled_par_ms={rec['modelled_par_ms']:.4f} "
              f"gflops={rec['gflops']:.2f}", flush=True)
    if {r["variant"] for r in rep.records} != set(spec.variants):
        raise AssertionError(f"schedule spec: variants measured "
                             f"{sorted({r['variant'] for r in rep.records})}")
    phase("campaign fig4 schedule", t0, cells=len(rep.records))


# -- phase 4c: the paper's scheme axis -------------------------------------
# a shuffled 256 x 256 5-point grid: loc_stencil2d_shuf's generator at an
# eighth of its 524,176 rows (its METIS, PaToH and Louvain orders and the
# BCSR builds of the scattered orders took ~190 s of the run at full size).
# At this size x (256 KB) and the matrix (~4 MB) stay in the card's 50 MB
# L2, so the phase drives every scheme and engine through the Runner but
# its IOS speedups do not measure x locality beyond the cache; the Fig. 1
# cells of phase 4 do
SCHEME_MATRIX = "stencil2d_shuf_256"
SCHEME_ENGINES = ("auto", "sell", "bcsr")
DUEL_FIELDS = ("seq_ios_gflops", "seq_yax_gflops", "cg_gflops")
ONE_MATRIX = ("one matrix: a per-matrix answer, not the paper's counts "
              "over its corpus")


def scheme_campaign(dev, iters: int) -> None:
    """Phase 4c: one spmv ExperimentSpec through the Runner on
    SCHEME_MATRIX: paper_schemes() and metis_nnzbal x {auto, sell (K1),
    bcsr (K3)}, verified on the matrix and its structure twin, IOS, YAX, CG,
    the modelled-parallel time and the metrics at p = 8. Each cell prints its
    reorder ms (host), IOS ms and speedup over baseline on the same engine;
    each sell and bcsr cell must have launched its kernel in its own timed
    calls. Then the paper's views over the schemes: the RCM-vs-METIS duel
    under IOS, YAX and CG (Table 1's question), pairwise win rates (Fig. 7)
    and speedup buckets (Fig. 6). The plan store is off for these cells:
    the bcsr operators of the shuffled orders hold an 8 x 128 block for
    almost every scattered nonzero, which it would write to disk; the
    reorder cache stays on, so each scheme reorders once."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core.measure.profiles import BUCKET_LABELS
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner, paper_schemes)
    from repro_torch.matrices import suite

    t0 = time.perf_counter()
    mat = suite.get(SCHEME_MATRIX)
    phase(f"matrix {SCHEME_MATRIX}", t0, shape=f"{mat.m}x{mat.n}",
          nnz=mat.nnz)
    schemes = tuple(paper_schemes()) + ("metis_nnzbal",)
    spec = ExperimentSpec(
        name="schemes", matrices=(SCHEME_MATRIX,), schemes=schemes,
        engines=SCHEME_ENGINES, ps=(PARALLEL_P,),
        policy=MeasurePolicy(iters=iters, warmup=3, cg_profiles=("*",),
                             verify=True, verify_tol=VERIFY_TOL))
    ncells = len(spec.cells())
    t0 = time.perf_counter()
    plans = os.environ["REPRO_TORCH_PLAN_CACHE"]
    os.environ["REPRO_TORCH_PLAN_CACHE"] = "off"
    kernels.reset_launches()
    try:
        rep = Runner(spec, ResultStore(os.path.join(
            os.environ["REPRO_TORCH_RESULT_STORE"], "schemes")),
            get_matrix={SCHEME_MATRIX: mat}.__getitem__, device=dev).run()
    finally:
        os.environ["REPRO_TORCH_PLAN_CACHE"] = plans
    launches = dict(kernels.LAUNCHES)
    if rep.measured != ncells:
        raise AssertionError(f"scheme spec: measured {rep.measured} of "
                             f"{ncells} cells")
    reorder_ms = {}
    for rec in rep.records:
        check_cell_launches(rec)
        eng = rec["engine_request"]
        base = rep.value("seq_ios_ms", SCHEME_MATRIX, "baseline", engine=eng)
        # the first engine of a scheme reorders, the others hit the cache
        reorder_ms[rec["scheme"]] = max(reorder_ms.get(rec["scheme"], 0.0),
                                        rec["reorder_ms"])
        phase(f"cell {SCHEME_MATRIX}/{rec['scheme']}/{eng}",
              time.perf_counter() - rec["runner_wall_s"],
              engine=rec["engine"], label=rec["plan_label"],
              reorder_ms=f"{rec['reorder_ms']:.1f}",
              tune_ms=f"{rec['tune_ms']:.1f}",
              build_ms=f"{rec['format_build_ms']:.1f}",
              verify=f"{rec['verify_rel_err']:.2e}",
              verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
              ios_ms=rec["seq_ios_ms"],
              speedup=f"{base / rec['seq_ios_ms']:.3f}",
              yax_ms=rec["seq_yax_ms"], cg_ms=rec["cg_ms"],
              par_static_ms=rec["par_static_ms"],
              par_nnz_balanced_ms=rec["par_nnz_balanced_ms"],
              li_static=f"{rec['li_static']:.4f}",
              bandwidth=rec["bandwidth"], cut_volume=rec["cut_volume"],
              block_fill_8x128=f"{rec['block_fill_8x128']:.4f}",
              launches=json.dumps(rec["launches"]))
    phase("campaign schemes", t0, cells=ncells, measured=rep.measured,
          launches=json.dumps(launches))
    print(f"[reorder] host ms per scheme on {SCHEME_MATRIX} ({mat.m} rows, "
          f"{mat.nnz} nnz, numpy {np.__version__}, {os.cpu_count()} cores): "
          f"{json.dumps(reorder_ms)}", flush=True)
    for eng in SCHEME_ENGINES:
        duel = {}
        for field in DUEL_FIELDS:
            rcm, metis = (rep.value(field, SCHEME_MATRIX, s, engine=eng)
                          for s in ("rcm", "metis"))
            duel[field] = {"rcm": rcm, "metis": metis,
                           "winner": "rcm" if rcm > metis else "metis"}
        print(f"[view] table 1, rcm vs metis (GFLOP/s), engine={eng}, "
              f"{ONE_MATRIX}: {json.dumps(duel)}", flush=True)
        win = rep.pairwise_win_rates("seq_ios_gflops", [SCHEME_MATRIX],
                                     schemes, engine=eng)
        print(f"[view] fig. 7, pairwise win rates under IOS (row beats "
              f"column), engine={eng}, {ONE_MATRIX}: " + json.dumps(
                  {a: {b: float(win[i, j]) for j, b in enumerate(schemes)
                       if j != i} for i, a in enumerate(schemes)}),
              flush=True)
        buckets = rep.speedup_buckets("seq_ios_gflops", [SCHEME_MATRIX],
                                      schemes, engine=eng)
        print(f"[view] fig. 6, speedup buckets under IOS, engine={eng}, "
              f"{ONE_MATRIX}: " + json.dumps(
                  {s: dict(zip(BUCKET_LABELS, map(int, row)))
                   for s, row in zip(schemes, buckets)}), flush=True)


# -- phase 4e: the offline corpus and the learned probe ---------------------
CORPUS_CELLS = ("corpus://fix_banded_1k", "corpus://pwtk")
LEARNED_MATRIX = "corpus://cant"


def corpus_phase(dev, iters: int) -> None:
    """Phase 4e: `python -m repro_torch.corpus verify`'s check over every
    bundled fixture (its CSR held to the manifest's m, n, nnz); one spmv cell
    on fix_banded_1k and one on the stand-in of pwtk (217,918 rows, banded),
    engine auto, the full policy; then plan(probe="learned") on the stand-in
    of cant, after the advisor has mined every record phases 4-4e wrote,
    beside plan(probe=True) on the same matrix."""
    from repro_torch.core.spmv.plan import SpmvProblem, plan
    from repro_torch.corpus import advisor, manifest
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner)
    from repro_torch.matrices import suite

    t0 = time.perf_counter()
    entries = manifest.load_manifest()
    for name in sorted(n for n, e in entries.items() if e.fixture):
        rep = manifest.verify_entry(name)
        mat, e = manifest.resolve(name), entries[name]
        if not rep["ok"] or rep["standin"] or \
                (mat.m, mat.n, mat.nnz) != (e.m, e.n, e.nnz):
            raise AssertionError(f"corpus fixture {name}: {rep}, CSR "
                                 f"{(mat.m, mat.n, mat.nnz)} against the "
                                 f"manifest's {(e.m, e.n, e.nnz)}")
        print(f"[corpus] {e.qualified}: ok, m={mat.m} n={mat.n} "
              f"nnz={mat.nnz}", flush=True)
    phase("corpus fixtures verified", t0)

    results = os.environ["REPRO_TORCH_RESULT_STORE"]
    spec = ExperimentSpec(
        name="corpus", matrices=CORPUS_CELLS, schemes=("baseline",),
        ps=(PARALLEL_P,),
        policy=MeasurePolicy(iters=iters, warmup=3, cg_profiles=("*",),
                             verify=True, verify_tol=VERIFY_TOL))
    t0 = time.perf_counter()
    rep = Runner(spec, ResultStore(os.path.join(results, "corpus")),
                 device=dev).run()
    if rep.measured != len(CORPUS_CELLS):
        raise AssertionError(f"corpus spec: measured {rep.measured} of "
                             f"{len(CORPUS_CELLS)} cells")
    for rec in rep.records:
        check_cell_launches(rec)
        meta = manifest.ensure(rec["matrix"]).meta
        phase(f"cell {rec['matrix']}", time.perf_counter()
              - rec["runner_wall_s"], standin=bool(meta.get("standin")),
              m=rec["m"], nnz=rec["nnz"], engine=rec["engine"],
              label=rec["plan_label"], tune_ms=f"{rec['tune_ms']:.1f}",
              build_ms=f"{rec['format_build_ms']:.1f}",
              verify=f"{rec['verify_rel_err']:.2e}",
              verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
              ios_ms=rec["seq_ios_ms"], yax_ms=rec["seq_yax_ms"],
              cg_ms=rec["cg_ms"], par_static_ms=rec["par_static_ms"],
              launches=json.dumps(rec["launches"]))
    phase("campaign corpus", t0, cells=rep.measured)

    # the advisor mines the default result store: gather every record the
    # campaigns of phases 4-4e wrote into it
    t0 = time.perf_counter()
    kb = ResultStore(results)
    for sub in sorted(os.listdir(results)):
        if os.path.isdir(os.path.join(results, sub)):
            for key, entry in ResultStore(os.path.join(results,
                                                       sub)).entries():
                kb.put(key, entry["cell"], entry["record"])
    advisor.advisor_reset()
    known = advisor.default_advisor().knowledge_size()
    mat = suite.get(LEARNED_MATRIX)
    learned = plan(SpmvProblem(mat), reorder="baseline", probe="learned",
                   cache=False, device=dev)
    probed = plan(SpmvProblem(mat), reorder="baseline", probe=True,
                  cache=False, device=dev)
    info = learned.tune.advisor or {}
    if learned.tune.source != "learned" or not known:
        raise AssertionError(f"plan(probe='learned') on {LEARNED_MATRIX}: "
                             f"source {learned.tune.source!r} with "
                             f"{known} mined records")
    phase(f"learned plan {LEARNED_MATRIX}", t0, standin=bool(
              manifest.ensure(LEARNED_MATRIX).meta.get("standin")),
          mined_records=known, source=learned.tune.source,
          confidence=f"{learned.advisor_confidence:.4f}",
          predicted=info.get("predicted"), hit=info.get("hit"),
          probed=json.dumps(learned.tune.probe_ms),
          learned_choice=learned.tune.label(),
          probe_choice=probed.tune.label(),
          probe_probed=json.dumps(probed.tune.probe_ms),
          agree=learned.tune.label() == probed.tune.label())


# -- phase 4f: the paper's figure drivers (repro_torch.bench) ---------------
# the views over the locality campaign run on phase 4c's matrix (whose
# reorderings 4c left in the reorder cache); the ones over the bench tier,
# and bell_formats, on phase 4's schedule pair: the METIS and PaToH orders
# of a 65,536-row banded pair of bandwidth 24 take 29-34 s each on a host
# core, those of bell_formats' --quick set ~4 minutes in all (fig. 8 runs
# over every registered profile, fig. 9-10 at p = 64)
BENCH_LOCALITY_DRIVERS = ("fig03_ios_yax", "fig05_profiles",
                          "fig06_speedup_stacks", "fig07_pairwise",
                          "fig11_nnz_balanced", "table1_rcm_vs_metis")
BENCH_PAIR = SCHEDULE_PAIR
BENCH_PAIR_DRIVERS = ("fig04_scheduling", "fig08_consistency",
                      "fig09_10_load_imbalance")


def csv_rows(path: str, header: list) -> int:
    """The CSV's first line must be `header` (the reference driver's
    literal header); returns its number of rows."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines or lines[0] != ",".join(header):
        raise AssertionError(f"{path}: header {lines[:1]} is not "
                             f"{','.join(header)}")
    return len(lines) - 1


def driver_csvs(mod) -> list:
    """(file, header) of every CSV a driver writes (summarize_repro
    writes none)."""
    out = [(mod.CSV, mod.HEADER)] if hasattr(mod, "CSV") else []
    if hasattr(mod, "CSV_RELATIVE"):
        out.append((mod.CSV_RELATIVE, mod.HEADER_RELATIVE))
    return out


def bench_driver(dev, name: str, **kw) -> dict:
    """One driver's run() on the card, its CSVs checked against their
    headers; prints the driver's summary, its cells measured and reused,
    and its seconds."""
    import importlib

    from repro_torch import obs
    from repro_torch.bench import common

    mod = importlib.import_module(f"repro_torch.bench.{name}")
    measured = obs.counter("bench.cells_measured").value
    reused = obs.counter("bench.cells_reused").value
    t0 = time.perf_counter()
    out = mod.run(device=dev, **kw)
    rows = {f: csv_rows(common.result_path(f), h)
            for f, h in driver_csvs(mod)}
    phase(f"driver {name}", t0, csv_rows=json.dumps(rows),
          measured=obs.counter("bench.cells_measured").value - measured,
          reused=obs.counter("bench.cells_reused").value - reused)
    print(f"[bench] {name}: {json.dumps(out, default=str)}", flush=True)
    return out


def fig1_csr_verify(dev, mats: dict) -> None:
    """The fig. 1 driver's cells (csr engine, baseline order), verified as
    phase 4's cells are: each plan (from the plan store) built on the
    matrix and on its structure twin, each held to the float64 product."""
    from repro_torch.core.spmv.plan import SpmvProblem, plan
    from repro_torch.launch import spmv_bench

    for name, mat in mats.items():
        t0 = time.perf_counter()
        pl = plan(SpmvProblem(mat, k=1, dtype="float32",
                              hints={"seed": 0}),
                  reorder="baseline", engine="csr", device=dev)
        err = spmv_bench.verify(pl.build(device=dev), mat, device=dev,
                                tol=VERIFY_TOL)
        twin = spmv_bench.structure_twin(mat)
        twin_err = spmv_bench.verify(pl.build(device=dev, values=twin.vals),
                                     twin, device=dev, tol=VERIFY_TOL)
        phase(f"fig. 1 csr cell {name} verified", t0,
              plan_store_hit=pl.cache_hit, verify=f"{err:.2e}",
              verify_twin=f"{twin_err:.2e}")


def bench_phase(dev, mats: dict) -> dict:
    """Phase 4f: the figure drivers of repro_torch.bench on the card.
    fig01_banded_shuffle on the Fig. 1 pair in memory (the csr engine, the
    paper's headline ratio), each cell then verified; the locality views
    on SCHEME_MATRIX; fig. 4, 8 and 9-10 on BENCH_PAIR; spmm_batch at its
    quick shapes (K1 and K2 must launch); bell_formats on BENCH_PAIR; then
    `run.py --smoke` twice, the second measuring nothing (no record
    written). Every CSV's header is the reference driver's. Launch counts
    are set to 0 before the drivers and read after them, for the kernels
    line; returns them as the "bench" path."""
    from repro_torch import kernels, obs
    from repro_torch.bench import run as bench_run

    t_phase = time.perf_counter()
    measured = obs.counter("bench.cells_measured").value
    reused = obs.counter("bench.cells_reused").value
    kernels.reset_launches()
    fig1 = bench_driver(dev, "fig01_banded_shuffle",
                        get_matrix=mats.__getitem__)
    print(f"[result] fig. 1 on the csr engine ({' / '.join(mats)}, "
          f"baseline order): banded {fig1['banded_gflops']} GFLOP/s, "
          f"shuffled {fig1['shuffled_gflops']} GFLOP/s, "
          f"ratio_banded_over_shuffled {fig1['ratio']:.4f}", flush=True)
    launches = dict(kernels.LAUNCHES)
    fig1_csr_verify(dev, mats)
    kernels.reset_launches()
    for name in BENCH_LOCALITY_DRIVERS:
        bench_driver(dev, name, matrices=(SCHEME_MATRIX,))
    bench_driver(dev, "summarize_repro", matrices=(SCHEME_MATRIX,))
    for name in BENCH_PAIR_DRIVERS:
        bench_driver(dev, name, matrices=BENCH_PAIR)
    spmm = dict(kernels.LAUNCHES)
    bench_driver(dev, "spmm_batch", quick=True)
    spmm = {k: n - spmm[k] for k, n in kernels.LAUNCHES.items()}
    if not (spmm["sell_spmv"] and spmm["sell_spmm"]):
        raise AssertionError(f"spmm_batch: the sell engine launched "
                             f"{spmm}, not K1 and K2")
    bench_driver(dev, "bell_formats", matrices=BENCH_PAIR)
    for attempt in ("first", "again"):
        t0 = time.perf_counter()
        writes = obs.counter("result_store.writes").value
        if bench_run.smoke(device=dev):
            raise AssertionError(f"run.py --smoke ({attempt}) failed")
        written = obs.counter("result_store.writes").value - writes
        if attempt == "again" and written:
            raise AssertionError(f"run.py --smoke again measured {written} "
                                 f"cells; want every cell from the store")
        rows = csv_rows(bench_run.common.result_path(bench_run.SMOKE_CSV),
                        bench_run.SMOKE_HEADER)
        phase(f"run.py --smoke ({attempt})", t0, records_written=written,
              csv_rows=rows)
    for name, n in kernels.LAUNCHES.items():
        launches[name] += n
    paths = {"bench": launches}
    paths.update(bench_soaks(dev))
    phase("bench", t_phase, launches=json.dumps(launches),
          measured=obs.counter("bench.cells_measured").value - measured,
          reused=obs.counter("bench.cells_reused").value - reused)
    return paths


def built_engines(events) -> list:
    """The engines of the operators a traced run built (plan.build and
    plan.rebuild spans)."""
    return sorted({e["args"]["engine"] for e in events
                   if e["name"] in ("plan.build", "plan.rebuild")})


def bench_path(name: str, fn):
    """One driver of 4f's second half as a path of its own: the launch
    counts set to 0 and its plan builds traced around `fn()`; an engine
    it built that has a kernel must have launched it. Prints its seconds,
    the engines it built and its launches by kernel; returns fn()'s
    result and the launches."""
    from repro_torch import kernels, obs

    t0 = time.perf_counter()
    kernels.reset_launches()
    with obs.tracing() as buf:
        out = fn()
    launches = dict(kernels.LAUNCHES)
    engines = built_engines(buf.flush())
    for eng in engines:
        kns = KERNEL_OF.get(eng, ())
        if kns and not any(launches[kn] for kn in kns):
            raise AssertionError(f"{name}: built {eng} operators but no "
                                 f"kernel of it launched: {launches}")
    phase(f"bench {name}", t0, engines=json.dumps(engines),
          launches=json.dumps(launches))
    return out, launches


def bench_failures(name: str, failures: int) -> None:
    if failures:
        raise AssertionError(f"{name}: {failures} failures")


def regress_control() -> None:
    """The regress CLI on the fresh BENCH_spmv_torch.json of run.py
    --smoke: against itself it must exit 0, with every GFLOP/s halved 1,
    with a changed scale stamp 2."""
    import copy

    from repro_torch.bench import common, regress
    from repro_torch.experiments.report import SUMMARY_NAME

    t0 = time.perf_counter()
    fresh = common.result_path(SUMMARY_NAME)
    with open(fresh) as f:
        summary = json.load(f)
    halved = copy.deepcopy(summary)
    halved["geomean"] = {k: v / 2 for k, v in halved["geomean"].items()}
    rescaled = copy.deepcopy(summary)
    rescaled["scale"]["iters"] += 1
    codes = {}
    for label, obj, want in (("itself", summary, 0), ("halved", halved, 1),
                             ("rescaled", rescaled, 2)):
        path = common.result_path(f"regress_control_{label}.json")
        with open(path, "w") as f:
            json.dump(obj, f)
        codes[label] = regress.main(["--baseline", fresh, "--current", path])
        if codes[label] != want:
            raise AssertionError(f"regress control {label}: exit "
                                 f"{codes[label]}, want {want}")
    phase("bench regress control", t0, exit_codes=json.dumps(codes))


def bench_soaks(dev) -> dict:
    """4f's second half: run.py --smoke-serve and --smoke-workloads (each
    with its invariants and its resume), workloads.run and
    moe_dispatch.run at their quick sizes (sorted and one-hot dispatch
    must agree), and the regress control. Each driver is a path of the
    kernels line; every CSV's header is the reference driver's. Returns
    the launches by path. (corpus_scale.smoke is not run here: on the
    card its 1.05x pick-quality gate fails by chance, see PERF.md.)"""
    from repro_torch.bench import (common, moe_dispatch, run as bench_run,
                                   workloads)

    paths = {}
    fails, paths["bench/smoke-serve"] = bench_path(
        "smoke-serve", lambda: bench_run.smoke_serve(device=dev))
    bench_failures("run.py --smoke-serve", fails)
    csv_rows(common.result_path(bench_run.SMOKE_SERVE_CSV),
             bench_run.SMOKE_SERVE_HEADER)
    fails, paths["bench/smoke-workloads"] = bench_path(
        "smoke-workloads", lambda: workloads.smoke(device=dev))
    bench_failures("run.py --smoke-workloads", fails)
    csv_rows(common.result_path(workloads.SMOKE_CSV), workloads.CSV_HEADER)
    out, paths["bench/workloads"] = bench_path(
        "workloads", lambda: workloads.run(quick=True, device=dev))
    rows = csv_rows(common.result_path(workloads.CSV), workloads.CSV_HEADER)
    print(f"[bench] workloads ({rows} rows): {json.dumps(out)}", flush=True)
    if not out["verify_ok_all"] or out["static_replans_total"]:
        raise AssertionError(f"workloads: a stream failed its check or a "
                             f"static stream replanned: {out}")
    out, paths["bench/moe_dispatch"] = bench_path(
        "moe_dispatch", lambda: moe_dispatch.run(quick=True, device=dev))
    rows = csv_rows(common.result_path(moe_dispatch.CSV), moe_dispatch.HEADER)
    print(f"[bench] moe_dispatch ({rows} rows): {json.dumps(out)}",
          flush=True)
    if not (out["e16_k2_dispatch_agree"] and out["e64_k8_dispatch_agree"]):
        raise AssertionError(f"moe_dispatch: sorted and one-hot dispatch "
                             f"disagree: {out}")
    regress_control()
    return paths




def forced_paths(dev, rmat, iters: int) -> tuple:
    """Phase 5: the kernel engines on the structure twin of the RCM-ordered
    fig1_shuffled, each path run with the launch counts set to 0 just
    before it and read just after. Returns the forced operators, the twin
    and the records."""
    from repro_torch import kernels
    from repro_torch.core.sparse.sell import pick_chunk_width
    from repro_torch.core.spmv.ops import make_engine
    from repro_torch.launch import spmv_bench

    forced, recs = {}, {}
    vmat = spmv_bench.structure_twin(rmat, seed=1)
    w_fit = pick_chunk_width(vmat)
    for eng, shape, sigma, ks in (("sell", (8, w_fit), 64, (1, 8, K2_WIDE)),
                                  ("bcsr", (8, 128), None, (1,)),
                                  ("bell", (8, 128), None, (1,))):
        t0 = time.perf_counter()
        op = make_engine(vmat, eng, block_shape=shape, sell_sigma=sigma,
                         device=dev)
        forced[eng] = op
        phase(f"forced build {eng}", t0, block_shape=shape,
              device_bytes=operator_bytes(op))
        for k in ks:
            t0 = time.perf_counter()
            tag = f"forced/{eng}/k{k}"
            kernels.reset_launches()
            err = spmv_bench.verify(op, vmat, k, device=dev, tol=VERIFY_TOL)
            rec = spmv_bench.measure(op, vmat.nnz, vmat.n, k, device=dev,
                                     iters=iters)
            rec["launches"] = dict(kernels.LAUNCHES)
            rec["verify_rel_err"] = err
            recs[tag] = rec
            phase(tag, t0, verify=f"{err:.2e}", ios_ms=rec["ios_ms"],
                  gflops=f"{rec['ios_gflops']:.2f}",
                  launches=json.dumps(rec["launches"]))
    for name, tag in FEEDS.items():
        if recs[tag]["launches"][name] == 0:
            raise AssertionError(f"{tag} never launched {name}")
    return forced, vmat, recs


def rcm_order(dev, mat):
    """The RCM-reordered fig1_shuffled, from the plan store the campaign
    filled (a hit: no reordering, no tuning)."""
    from repro_torch.core.spmv.plan import SpmvProblem, plan

    pl = plan(SpmvProblem(mat, hints={"seed": 0}), reorder="rcm",
              device=dev)
    if not pl.cache_hit:
        raise AssertionError("the rcm plan of the campaign is not in the "
                             "plan store")
    return pl.reordered_matrix()


# -- phase 6: kernel times at the main-path shapes -------------------------
def kernel_inputs(forced, vmat, dev) -> list:
    """(nv, operator, calls, x, kernel-shaped x) per kernel, main-path
    shapes."""
    gen = torch_generator(1)
    out = []
    for nv, eng, calls in ((1, "sell", sell_calls), (8, "sell", sell_calls),
                           (1, "bcsr", bcsr_calls), (1, "bell", bell_calls)):
        op = forced[eng]
        if calls is sell_calls:
            x = xin = torch_randn((vmat.n, nv), gen, op.chunk_vals.dtype, dev)
        else:
            xin = x2d_for(op, nv, gen, op.blocks.dtype, dev)
            x = xin.reshape(-1, nv)[: vmat.n]
        out.append((nv, op, calls, x, xin))
    return out


def library_csr(vmat, index_dtype, dev, dtype=None):
    """torch's CSR of `vmat` on the card, `dtype` values (float32 by
    default) and `index_dtype` row pointers and columns (the library
    yardstick; the port never calls it)."""
    import torch

    return torch.sparse_csr_tensor(
        torch.as_tensor(vmat.rowptr).to(index_dtype),
        torch.as_tensor(vmat.cols).to(index_dtype),
        torch.as_tensor(vmat.vals), size=vmat.shape,
        check_invariants=False).to(dev, dtype or torch.float32)


def kernel_work(op, calls, nv: int, xin) -> tuple[int, int]:
    """(bytes, flops) the kernel's function needs on these inputs: the
    stored matrix read once, x read once, y written once."""
    if calls is sell_calls:
        t, c, w = op.chunk_vals.shape
        mat_bytes = tensor_bytes(op.chunk_vals, op.chunk_cols, op.slice_ptr)
        flops = 2 * t * c * w * nv
        y_elems = op.num_slices * c * nv
    else:
        mat_bytes = tensor_bytes(op.blocks, op.block_cols)
        if calls is bcsr_calls:
            mat_bytes += tensor_bytes(op.block_rowptr)
        flops = 2 * op.blocks.numel() * nv
        nbr = op.nbr if calls is bcsr_calls else op.blocks.shape[0]
        y_elems = nbr * op.block_shape[0] * nv
    return mat_bytes + tensor_bytes(xin) + y_elems * xin.element_size(), flops


def kernel_time(op, calls, nv: int, x, xin, csrs,
                plain_batch: int = BATCH, batch: int = BATCH):
    """One kernel at one shape: its error against its plain version (which
    must be within the f32 tolerance), its ms (one event pair per `batch`
    calls), the plain version's ms (one per min(`plain_batch`, `batch`)
    calls), its bound and torch's CSR product on the same matrix with int32
    and int64 indices."""
    name, kern, plain = calls(op, xin)
    abs_err, rel = rel_err(kern(), plain())
    dname = str(xin.dtype).replace("torch.", "")
    if not rel <= KERNEL_TOL[dname]:
        raise AssertionError(f"{name} {dname} nv={nv}: kernel vs plain rel "
                             f"err {rel:.3e} at the main-path shape")
    nbytes, flops = kernel_work(op, calls, nv, xin)
    bms, by = bound_ms(nbytes, flops)
    xl = x.contiguous() if nv > 1 else x[:, 0].contiguous()
    lib = library_times(csrs, xl)
    lib_index = min(lib, key=lib.get) if lib else None
    out = {"name": name, "max_abs_err": abs_err, "rel_err": rel,
           "ms": time_ms(kern, batch),
           "plain_ms": time_ms(plain, min(plain_batch, batch)),
           "bound_ms": bms, "bound_by": by, "bytes": nbytes, "flops": flops,
           "library_ms": lib[lib_index] if lib else None,
           "library_index": lib_index,
           "library_int32_ms": lib.get("int32"),
           "library_int64_ms": lib.get("int64")}
    if not lib:
        out["library_error"] = csrs["error"]
    lib_s = (f"{out['library_ms']:.4f} (CSR int32 {lib['int32']:.4f}, "
             f"int64 {lib['int64']:.4f})" if lib
             else f"none ({csrs['error']})")
    print(f"[kernel] {name} {dname} nv={nv} rel_err={rel:.2e} "
          f"ms={out['ms']:.4f} plain_ms={out['plain_ms']:.4f} "
          f"library_ms={lib_s} "
          f"bound_ms={bms:.4f} ({by}, {nbytes} B, {flops} flop)",
          flush=True)
    return out


def library_csrs(vmat, dev, dtype=None) -> dict:
    """torch's CSR of `vmat` with int32 and with int64 indices, or
    {"error": why} when torch cannot multiply it in `dtype` on the card."""
    import torch

    csrs = {str(d).replace("torch.", ""): library_csr(vmat, d, dev, dtype)
            for d in (torch.int32, torch.int64)}
    x = torch.ones(vmat.n, dtype=dtype or torch.float32, device=dev)
    try:
        for a in csrs.values():
            a @ x
        torch.cuda.synchronize()
    except RuntimeError as e:        # the yardstick only, never the port
        return {"error": str(e).splitlines()[0][:200]}
    return csrs


def library_times(csrs: dict, x) -> dict:
    if "error" in csrs:
        return {}
    return {ix: time_ms(lambda a=a: a @ x) for ix, a in csrs.items()}


def kernel_times(forced, vmat, dev, recs: dict, feeds: dict = FEEDS,
                 suffix: str = "") -> list:
    """Phase 6: each SpMV kernel at the shape phase 5 gave it, and in f32
    K2 once more at k = K2_WIDE (its numbers kept inside K2's row). A bf16
    row's name carries `suffix`."""
    import torch

    dtype = forced["sell"].chunk_vals.dtype
    csrs = library_csrs(vmat, dev, dtype)
    rows = []
    for nv, op, calls, x, xin in kernel_inputs(forced, vmat, dev):
        m = kernel_time(op, calls, nv, x, xin, csrs)
        name = m["name"]
        path = feeds[name]
        launches = recs[path]["launches"][name]
        row = {"name": name + suffix, "route": "cuda", "source": SOURCE,
               "replaces": KERNELS[name], "launches": launches,
               "launches_path": path, "max_abs_err": m["max_abs_err"],
               "ms": m["ms"], "plain_ms": m["plain_ms"],
               "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
               "library_ms": m["library_ms"],
               "library_index": m["library_index"],
               "dtype": str(dtype).replace("torch.", "")}
        if "library_error" in m:
            row["library_error"] = m["library_error"]
        print(f"[kernel] {name}{suffix} nv={nv} launches={launches} "
              f"({path})", flush=True)
        if name == "sell_spmm" and dtype == torch.float32:
            # the plain version at k = 32 gathers 4.3 GB and takes ~0.1 s a
            # call: one event pair per 2 calls
            xw = torch_randn((vmat.n, K2_WIDE), torch_generator(3),
                             op.chunk_vals.dtype, dev)
            wide = kernel_time(op, calls, K2_WIDE, xw, xw, csrs,
                               plain_batch=2)
            wide_path = f"forced/sell/k{K2_WIDE}"
            row[f"k{K2_WIDE}"] = dict({key: wide[key] for key in (
                "max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_int32_ms",
                "library_int64_ms")}, launches=recs[wide_path]["launches"][
                    name], launches_path=wide_path)
            del xw
        rows.append(row)
    return rows


# -- phase 6b: power-law rows, the paper's load-imbalance case -------------
POWERLAW = "corpus://webbase-1M"         # its stand-in: 1,000,005 rows
BCSR_CAP_BYTES = 8e9
BCSR_LADDER = ((8, 128), (8, 64), (8, 32), (8, 16), (4, 16), (2, 16),
               (1, 16))                  # block shapes, largest first
BELL_SHAPE = (8, 128)


def block_counts(mat, bm: int, bn: int) -> tuple[int, int]:
    """(nonempty blocks, blocks of the widest block row) of `mat` at bm x
    bn, counted from its CSR without building a block format."""
    import numpy as np

    from repro_torch.core.sparse.metrics import sorted_unique

    nbc = -(-mat.n // bn)
    rows = np.repeat(np.arange(mat.m, dtype=np.int64), mat.row_nnz())
    keys = sorted_unique(rows // bm * nbc + mat.cols.astype(np.int64) // bn)
    return int(keys.size), int(np.bincount(keys // nbc).max())


def powerlaw_phase(dev, iters: int) -> list:
    """Phase 6b: the kernels on power-law rows, the structure twin of the
    webbase-1M stand-in (median row 3 nonzeros, largest 115,668): K1 on
    SELL σ-sorted (C = 8, σ = m), K2 on it at k = 8, and K3 at the largest
    block shape of BCSR_LADDER whose BCSR bytes, counted before the build,
    stay under 8 GB. Each path is verified and IOS-timed with the launch
    counts set to 0 just before and read just after, then its kernel timed
    as in phase 6. K4's Block-ELL pads every block row to the widest: its
    bytes are counted, not built. Returns the kernels line's rows."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core.sparse.sell import pick_chunk_width
    from repro_torch.core.spmv.ops import make_engine
    from repro_torch.launch import spmv_bench
    from repro_torch.matrices import suite

    t0 = time.perf_counter()
    vmat = spmv_bench.structure_twin(suite.get(POWERLAW), seed=1)
    rn = vmat.row_nnz()
    phase(f"matrix {POWERLAW} (stand-in, structure twin)", t0,
          shape=f"{vmat.m}x{vmat.n}", nnz=vmat.nnz,
          row_nnz_median=float(np.median(rn)),
          row_nnz_p99=float(np.percentile(rn, 99)), row_nnz_max=int(rn.max()))

    t0 = time.perf_counter()
    sized, widest = {}, {}
    for bm, bn in BCSR_LADDER:
        nb, widest[(bm, bn)] = block_counts(vmat, bm, bn)
        # values, a block-row and a block-column id per block, row pointer
        sized[(bm, bn)] = nb * (bm * bn * 4 + 8) + 4 * (-(-vmat.m // bm) + 1)
        if sized[(bm, bn)] < BCSR_CAP_BYTES:
            bcsr_shape = (bm, bn)
            break
    else:
        raise AssertionError(f"no BCSR shape of {BCSR_LADDER} under "
                             f"{BCSR_CAP_BYTES:.0e} B: {sized}")
    nbr = -(-vmat.m // BELL_SHAPE[0])
    bell = nbr * widest[BELL_SHAPE] * (BELL_SHAPE[0] * BELL_SHAPE[1] * 4 + 4)
    phase("powerlaw sizes", t0, bcsr_bytes=json.dumps(
              {f"{bm}x{bn}": b for (bm, bn), b in sized.items()}),
          bcsr_shape=f"{bcsr_shape[0]}x{bcsr_shape[1]}",
          bcsr_shape_bytes=sized[bcsr_shape])
    print(f"[powerlaw] bell_spmv (K4) is not built on these rows: Block-ELL "
          f"at {BELL_SHAPE[0]}x{BELL_SHAPE[1]} pads each of {nbr} block rows "
          f"to the widest ({widest[BELL_SHAPE]} blocks), {bell} B in f32, "
          f"{bell / 80e9:.0f}x the card's 80 GB", flush=True)

    csrs = library_csrs(vmat, dev)
    gen = torch_generator(7)
    rows = []
    for eng, shape, sigma, ks in (
            ("sell", (8, pick_chunk_width(vmat)), vmat.m, (1, 8)),
            ("bcsr", bcsr_shape, None, (1,))):
        t0 = time.perf_counter()
        op = make_engine(vmat, eng, block_shape=shape, sell_sigma=sigma,
                         device=dev)
        phase(f"powerlaw build {eng}", t0, block_shape=shape, sigma=sigma,
              device_bytes=operator_bytes(op))
        for k in ks:
            t0 = time.perf_counter()
            path = f"powerlaw/{eng}/k{k}"
            kernels.reset_launches()
            err = spmv_bench.verify(op, vmat, k, device=dev, tol=VERIFY_TOL)
            rec = spmv_bench.measure(op, vmat.nnz, vmat.n, k, device=dev,
                                     iters=iters)
            launches = dict(kernels.LAUNCHES)
            phase(path, t0, verify=f"{err:.2e}", ios_ms=rec["ios_ms"],
                  gflops=f"{rec['ios_gflops']:.2f}",
                  launches=json.dumps(launches))
            if eng == "sell":
                calls = sell_calls
                x = xin = torch_randn((vmat.n, k), gen, torch.float32, dev)
            else:
                calls = bcsr_calls
                xin = x2d_for(op, k, gen, torch.float32, dev)
                x = xin.reshape(-1, k)[: vmat.n]
            m = kernel_time(op, calls, k, x, xin, csrs, batch=POWERLAW_BATCH)
            name = m["name"]
            if launches[name] == 0:
                raise AssertionError(f"{path} never launched {name}")
            rows.append({
                "name": f"{name}_powerlaw", "route": "cuda",
                "source": SOURCE, "replaces": KERNELS[name],
                "launches": launches[name], "launches_path": path,
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                "library_index": m["library_index"], "dtype": "float32",
                "matrix": f"{POWERLAW} (stand-in, structure twin)",
                "block_shape": list(shape), "sigma": sigma,
                "bytes": m["bytes"]})
            del x, xin
        del op
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# -- phase 5b: the bf16 kernels on the main path ---------------------------
BF16_FEEDS = {name: path.replace("forced/", "forced_bf16/")
              for name, path in FEEDS.items()}
BF16_ORACLE_TOL = 1e-2           # bf16 kernel operators vs the f64 product
BF16_U = 2.0 ** -8               # bf16 unit roundoff (8 significand bits)
BF16_CSR_REPEATS = 8             # calls of the csr engine on one x
BF16_CSR_OTHER_XS = 8            # then one call on each of 8 other x
BF16_CSR_DROPPED_ROWS = 64       # the planted control's zeroed rows


def bf16_oracle(vmat, dev):
    """x -> A·x in float64, A's values rounded to bf16 first (the f64
    product of the bf16-rounded operands), on the card."""
    import numpy as np
    import torch

    from repro_torch.core.spmv import ref

    rows = torch.as_tensor(np.repeat(np.arange(vmat.m), vmat.row_nnz()),
                           device=dev)
    cols = torch.as_tensor(vmat.cols, device=dev)
    vals = torch.as_tensor(vmat.vals).to(torch.bfloat16).to(dev,
                                                            torch.float64)
    return lambda x: ref.spmv_csr(rows, cols, vals, x.double(), vmat.m)


def bf16_row_bound(vmat, dev):
    """x -> the rounding bound of each row of the bf16 csr engine, in
    float64: |y_i - ŷ_i| <= γ_{n_i} · Σ_j |a_ij x_j| with γ_n = n·u / (1 -
    n·u), u = 2^-8, for a and x rounded to bf16 and y_i their exact
    product. The engine rounds each of the n_i products of row i to bf16
    and adds them into y_i in bf16, atomically in any order: each term
    passes at most n_i roundings (its product and up to n_i - 1 adds)."""
    import numpy as np
    import torch

    from repro_torch.core.spmv import ref

    nnz = vmat.row_nnz().astype(np.float64)
    if not (nnz * BF16_U).max() < 1:
        raise ValueError("a row too long for the bf16 rounding bound")
    gamma = torch.as_tensor(nnz * BF16_U / (1 - nnz * BF16_U), device=dev)
    rows = torch.as_tensor(np.repeat(np.arange(vmat.m), vmat.row_nnz()),
                           device=dev)
    cols = torch.as_tensor(vmat.cols, device=dev)
    absvals = torch.as_tensor(vmat.vals).to(torch.bfloat16).to(
        dev, torch.float64).abs()
    return lambda x: gamma * ref.spmv_csr(rows, cols, absvals,
                                          x.double().abs(), vmat.m)


def bf16_csr_ratio(y, want, bound) -> float:
    """The largest err_i / bound_i over the rows (a row whose bound is 0
    must be exact); the engine passes where it is <= 1."""
    import torch

    err = (y.double() - want).abs()
    ratio = torch.where(bound > 0, err / bound.clamp_min(1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(ratio.max())


def bf16_paths(dev, vmat) -> tuple:
    """The forced kernel engines of phase 5 in bf16 (values and x bf16,
    f32 sums, y rounded once): each operator called once with the launch
    counts set to 0 just before and read just after, held against the f64
    product of the bf16-rounded operands; then the csr engine in bf16.
    Returns the bf16 operators and records."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.sparse.sell import pick_chunk_width
    from repro_torch.core.spmv.ops import make_engine

    bf16 = torch.bfloat16
    oracle = bf16_oracle(vmat, dev)
    gen = torch_generator(5)
    forced, recs = {}, {}
    w_fit = pick_chunk_width(vmat)
    for eng, shape, sigma, ks in (("sell", (8, w_fit), 64, (1, 8)),
                                  ("bcsr", (8, 128), None, (1,)),
                                  ("bell", (8, 128), None, (1,))):
        t0 = time.perf_counter()
        op = make_engine(vmat, eng, dtype=bf16, block_shape=shape,
                         sell_sigma=sigma, device=dev)
        forced[eng] = op
        for k in ks:
            tag = f"forced_bf16/{eng}/k{k}"
            x = torch_randn((vmat.n, k), gen, bf16, dev)
            kernels.reset_launches()
            y = op(x[:, 0]) if k == 1 else op.matmul(x)
            launches = dict(kernels.LAUNCHES)
            _, rel = rel_err(y, oracle(x[:, 0] if k == 1 else x))
            if not rel <= BF16_ORACLE_TOL:
                raise AssertionError(f"{tag}: rel err {rel:.3e} against the "
                                     f"f64 product > {BF16_ORACLE_TOL:.0e}")
            recs[tag] = {"launches": launches, "oracle_rel_err": rel}
            phase(tag, t0, block_shape=shape, oracle_rel_err=f"{rel:.3e}",
                  launches=json.dumps(launches))
            del y, x
    for name, tag in BF16_FEEDS.items():
        if recs[tag]["launches"][name] == 0:
            raise AssertionError(f"{tag} never launched {name}")
    t0 = time.perf_counter()
    op = make_engine(vmat, "csr", dtype=bf16, device=dev)
    bound = bf16_row_bound(vmat, dev)
    xs = [torch_randn((vmat.n,), gen, bf16, dev)
          for _ in range(1 + BF16_CSR_OTHER_XS)]
    # 16 readings: the atomic bf16 sums add in another order on every call
    # (the same x again) and round other values (other x); every row of
    # every reading is held to its rounding bound
    ratios, rels = [], []
    for i, x in enumerate([xs[0]] * BF16_CSR_REPEATS + xs[1:]):
        y, want = op(x), oracle(x)
        ratios.append(bf16_csr_ratio(y, want, bound(x)))
        rels.append(rel_err(y, want)[1])
        if not ratios[-1] <= 1.0:
            raise AssertionError(f"csr bf16 reading {i}: a row's error is "
                                 f"{ratios[-1]:.3f} times its rounding "
                                 f"bound γ_n·Σ|a·x|")
    same, other = slice(0, BF16_CSR_REPEATS), slice(BF16_CSR_REPEATS, None)
    phase("bf16 csr engine", t0, readings=len(ratios),
          max_err_over_bound=f"{max(ratios):.4f}",
          same_x_ratio=" ".join(f"{r:.4f}" for r in ratios[same]),
          other_x_ratio=" ".join(f"{r:.4f}" for r in ratios[other]),
          same_x_rel_err=" ".join(f"{r:.3e}" for r in rels[same]),
          other_x_rel_err=" ".join(f"{r:.3e}" for r in rels[other]),
          max_rel_err=f"{max(rels):.3e}")
    return forced, recs


# -- phase 7: planted faults must fail the checks --------------------------
def dropped_block(op, attr: str):
    """A shallow copy of `op` whose stored chunk or block (the last two
    dims of `attr`) with the largest |value| is zeroed."""
    import copy

    vals = getattr(op, attr)
    flat = vals.reshape(-1, vals.shape[-2] * vals.shape[-1])
    g = int(flat.abs().amax(dim=1).argmax())
    bad = flat.clone()
    bad[g] = 0
    out = copy.copy(op)
    setattr(out, attr, bad.reshape(vals.shape))
    return out, g


def diagonal_only(mat, dev):
    """y = diag(mat) * x on the card: every off-diagonal term dropped."""
    import numpy as np
    import torch

    rows = np.repeat(np.arange(mat.m), mat.row_nnz())
    on = rows == mat.cols
    d = np.zeros(mat.m)
    d[rows[on]] = mat.vals[on]
    dt = torch.as_tensor(d, dtype=torch.float32, device=dev)
    return lambda x: dt * x


def planted_faults(forced_sets, rmat, vmat, dev) -> None:
    from repro_torch.launch import spmv_bench

    for forced in forced_sets:
        for nv, op, calls, _, xin in kernel_inputs(forced, vmat, dev):
            dname = str(xin.dtype).replace("torch.", "")
            tol = KERNEL_TOL[dname]
            attr = "chunk_vals" if calls is sell_calls else "blocks"
            bad, g = dropped_block(op, attr)
            name, kern, plain = calls(bad, xin)
            _, rel = rel_err(kern(), calls(op, xin)[2]())
            if not rel > tol:
                raise AssertionError(f"{name} {dname}: dropping stored block "
                                     f"{g} gave rel err {rel:.3e}, which "
                                     f"passes {tol:.0e}")
            print(f"[control] {name} {dname} nv={nv} with block {g} "
                  f"dropped: rel err {rel:.3e} > {tol:.0e}, caught",
                  flush=True)
            del bad
    bf16_csr_control(vmat, dev)
    inf = float("inf")
    hidden = spmv_bench.verify(diagonal_only(rmat, dev), rmat, tol=inf,
                               device=dev)
    seen = spmv_bench.verify(diagonal_only(vmat, dev), vmat, tol=inf,
                             device=dev)
    if not seen > VERIFY_TOL:
        raise AssertionError(f"a diagonal-only operator passes verify on the "
                             f"structure twin (rel err {seen:.3e})")
    verdict = "passes" if hidden <= VERIFY_TOL else "fails"
    print(f"[control] diagonal-only operator under verify: rel err "
          f"{hidden:.3e} on the matrix itself ({verdict} {VERIFY_TOL:.0e}), "
          f"{seen:.3e} on its structure twin, caught", flush=True)


def bf16_csr_control(vmat, dev) -> None:
    """The bf16 csr engine with the values of one block of rows zeroed must
    fail the per-row rounding gate against the intact product."""
    import dataclasses

    import torch

    from repro_torch.core.spmv.ops import make_engine

    r0 = vmat.m // 2
    r1 = r0 + BF16_CSR_DROPPED_ROWS
    vals = vmat.vals.copy()
    vals[vmat.rowptr[r0]:vmat.rowptr[r1]] = 0.0
    bad = make_engine(dataclasses.replace(vmat, vals=vals), "csr",
                      dtype=torch.bfloat16, device=dev)
    x = torch_randn((vmat.n,), torch_generator(6), torch.bfloat16, dev)
    ratio = bf16_csr_ratio(bad(x), bf16_oracle(vmat, dev)(x),
                           bf16_row_bound(vmat, dev)(x))
    if not ratio > 1.0:
        raise AssertionError(f"csr bf16 with rows {r0}..{r1 - 1} zeroed "
                             f"passes the rounding gate (largest err / "
                             f"bound {ratio:.3f})")
    print(f"[control] csr bf16 with the values of rows {r0}..{r1 - 1} "
          f"zeroed: largest err / rounding bound {ratio:.3f} > 1, caught",
          flush=True)


# -- phase 7s: the SpMV service --------------------------------------------
SERVE_REQUESTS = 48
SERVE_KW = {"reorder": "rcm", "max_batch": 8, "window_ms": 20.0}
SERVE_TOL = 1e-5                 # a response against the unbatched op(x)
# The rate ramp runs on the Fig. 1 generator cut to TRAFFIC_ROWS rows (the
# same band, seeds and shuffle; PERF.md lists the cut): at 1,048,576 rows a
# value swap rebuilds the operator in the submitting thread for ~6 s and an
# evicted key reloads its 1.1 GB operator, so the service answers about one
# request a second under this mix (the serve cell) and each ramp step there
# would take minutes. The serve cell (SERVE_CELL) runs at the full size.
TRAFFIC_ROWS = 65536
TRAFFIC_MATRIX = f"fig1_shuffled_m{TRAFFIC_ROWS}"
# max_queue: two batches a key, one dispatching and one filling; a request
# past that would wait out two more dispatches and is refused with a
# retry-after instead
TRAFFIC = {"arrival": "poisson", "requests": 200, "n_keys": 4,
           "zipf_s": 1.1, "update_frac": 0.1, "structure_frac": 0.02,
           "max_batch": 8, "window_ms": 2.0, "max_queue": 16,
           "overload": "reject", "engine": "sell", "reorder": "rcm"}
TRAFFIC_BUDGET_OPS = 2.5         # the memory budget, in operators
# the ramp's rates are RAMP_BASE * sqrt(2)**i: the runs at 0.5x and 2x a
# step are the steps two below and two above it. It starts at step
# RAMP_START and walks up while runs are sustained, or down until one is.
RAMP_BASE, RAMP_START, RAMP_STEPS = 10.0, 2, range(-4, 11)
# the serve cell at the full size: the first 8 arrivals of the schedule,
# with both value updates of its first 16 (arrivals 3 and 7; the cell kind
# has no structure deltas)
SERVE_CELL = {"requests": 8, "update_frac": 0.1}
OVER_CHURN = 0.16                # deletion fraction past delta.MAX_CHURN


def device_product(mat, x, dev):
    """float64 A @ x on the card (x [n] or [n, b]): the workloads' plain
    product (gather, scale, index_add_) over the port's host CSR arrays.
    The checker, no kernel under test."""
    import numpy as np
    import torch

    from repro_torch.workloads.adapters import _plain_product

    x2 = torch.as_tensor(np.asarray(x, np.float64).reshape(mat.n, -1),
                         device=dev)
    fn, args = _plain_product(mat, x2, dev)
    return fn(*args).cpu().numpy().reshape((mat.m,) + np.shape(x)[1:])


def scaled_err(got, want) -> float:
    """max |got - want| over the largest |want| (float64)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


def check_product(name: str, got, want, tol: float = VERIFY_TOL) -> float:
    err = scaled_err(got, want)
    if not err <= tol:
        raise AssertionError(f"{name}: rel err {err:.3e} > {tol:.0e}")
    return err


def serve_requests(dev, mats: dict) -> tuple:
    """SERVE_REQUESTS (matrix, x) requests from a seeded generator over
    the matrices, and each response's float64 product (device_product)."""
    import numpy as np

    names = list(mats)
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(SERVE_REQUESTS):
        name = names[rng.integers(len(names))]
        reqs.append((name, rng.standard_normal(mats[name].n)))
    want = [None] * len(reqs)
    for name in names:
        idx = [i for i, (n, _) in enumerate(reqs) if n == name]
        y = device_product(mats[name],
                           np.stack([reqs[i][1] for i in idx], axis=1), dev)
        for j, i in enumerate(idx):
            want[i] = y[:, j]
    return reqs, want


def serve_sim(dev, mats: dict, engine: str, reqs: list, want: list) -> dict:
    """7s.1: the requests of serve_requests through one SpmvService over
    both Fig. 1 matrices; the last one is sent after the burst has
    drained, so a lone request takes op(x). Every response is held
    against its float64 product (VERIFY_TOL of its largest entry) and
    against the unbatched op(x) (SERVE_TOL). Launch counts are set to 0
    just before the requests and read just after the last response; the
    op(x) comparisons come after. Returns the launches and the service
    (open: the dynamic checks of a sell run continue on it)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.spmv.opcache import operator_nbytes
    from repro_torch.serving.spmv_service import SpmvService

    t0 = time.perf_counter()
    names = list(mats)
    svc = SpmvService(engine=engine, device=dev, **SERVE_KW)
    for name, mat in mats.items():
        svc.register(name, mat)
    for name in names:            # plan + build before the clock starts
        svc.operator(name)
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    kernels.reset_launches()
    futs = [svc.submit(name, x) for name, x in reqs[:-1]]
    svc.flush(timeout=600)
    futs.append(svc.submit(*reqs[-1]))
    ys = [f.result(timeout=600) for f in futs]
    launches = dict(kernels.LAUNCHES)
    serve_s = time.perf_counter() - t1
    stats = svc.stats()
    errs, alone_errs = [], []
    for i, (name, x) in enumerate(reqs):
        errs.append(check_product(f"serve-sim {engine} {name} request {i}",
                                  ys[i], want[i]))
        alone = svc.operator(name)(torch.as_tensor(
            x, dtype=torch.float32, device=dev)).cpu().numpy()
        alone_errs.append(check_product(
            f"serve-sim {engine} {name} request {i} against op(x)", ys[i],
            alone, SERVE_TOL))
    if not stats["batches"] < SERVE_REQUESTS:
        raise AssertionError(f"serve-sim {engine}: {stats['batches']} "
                             f"batches for {SERVE_REQUESTS} requests")
    need = KERNEL_OF[engine]
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"serve-sim {engine}: the dispatches did not "
                             f"launch {need}: {launches}")
    phase(f"serve-sim {engine}", t0, requests=SERVE_REQUESTS,
          batches=stats["batches"], avg_batch=f"{stats['avg_batch']:.2f}",
          build_s=f"{build_s:.2f}", serve_s=f"{serve_s:.3f}",
          p50_ms=stats["slo"]["p50_ms"], p99_ms=stats["slo"]["p99_ms"],
          max_rel_err=f"{max(errs):.2e}",
          max_rel_err_vs_op=f"{max(alone_errs):.2e}",
          op_bytes=json.dumps({n: operator_nbytes(svc.operator(n))
                               for n in names}),
          launches=json.dumps(launches))
    return {"launches": launches, "service": svc}


def serve_dynamic(dev, svc, mat, key: str) -> None:
    """7s.2 on one sell key of the serve-sim service: a value swap (values
    x 1.01) and a 0.5% deletion delta (applied under the frozen plan),
    each followed by a request held against the new product; then the
    planted control: a response after the swap, held against the product
    before it, must fail. The over-churn delta runs on the cut
    (serve_over_churn)."""
    import dataclasses

    import numpy as np

    rng = np.random.default_rng(5)
    x = rng.standard_normal(mat.n)
    old_want = device_product(mat, x, dev)

    t0 = time.perf_counter()
    s0 = svc.stats()
    cur = dataclasses.replace(mat, vals=mat.vals * 1.01)
    svc.update_values(key, cur.vals)
    y = svc.submit(key, x).result(timeout=600)
    err = check_product("value swap", y, device_product(cur, x, dev))
    s1 = svc.stats()
    swaps = s1["value_swaps"] - s0["value_swaps"]
    replans = s1["replans"] - s0["replans"]
    if (swaps, replans) != (1, 0):
        raise AssertionError(f"value swap: value_swaps +{swaps}, replans "
                             f"+{replans} (want +1, +0)")
    phase("serve value swap", t0, rel_err=f"{err:.2e}", value_swaps=swaps,
          replans=replans,
          build_ms=f"{svc._build_info[key]['build_ms']:.1f}")
    stale = scaled_err(y, old_want)
    if stale <= VERIFY_TOL:
        raise AssertionError(f"control: the response after the 1.01 swap "
                             f"passes against the old product ({stale:.3e})")
    print(f"[control] response after the value swap held against the "
          f"product before it: rel err {stale:.3e} > {VERIFY_TOL:.0e}, "
          f"caught", flush=True)

    serve_delta(dev, svc, key, cur, x, rng, "delta", 0.005, "delta.applies")


def serve_delta(dev, svc, key: str, cur, x, rng, label: str, frac: float,
                counter: str) -> None:
    """One deletion delta of `frac` on `key` (current matrix `cur`): the
    replan lands, `counter` moves by one, a request is held against the
    new product; a delta.applies path is neither tuned nor reordered."""
    from repro_torch import obs
    from repro_torch.serving import traffic

    t0 = time.perf_counter()
    c0 = obs.counter(counter).value
    r0 = svc.stats()["replans"]
    d = traffic._deletion_delta(cur, rng, frac)
    churn = d.churn(cur)
    fut = svc.update_structure(key, delta=d)
    submit_s = time.perf_counter() - t0
    fut.result(timeout=900)
    landed_s = time.perf_counter() - t0
    cur = d.apply_to(cur)
    y = svc.submit(key, x).result(timeout=600)
    err = check_product(label, y, device_product(cur, x, dev))
    moved = obs.counter(counter).value - c0
    info = svc._build_info[key]
    pl = svc._plans[key][2]
    if moved != 1 or svc.stats()["replans"] - r0 != 1:
        raise AssertionError(f"{label}: {counter} +{moved}, replans "
                             f"+{svc.stats()['replans'] - r0}")
    if counter == "delta.applies" and not (
            info["tune_ms"] == 0.0 and pl.tune_ms == 0.0
            and pl.reorder_ms == 0.0):
        raise AssertionError(f"delta: the new operator was tuned or "
                             f"reordered: build tune_ms="
                             f"{info['tune_ms']} plan tune_ms="
                             f"{pl.tune_ms} reorder_ms={pl.reorder_ms}")
    phase(f"serve {label}", t0, deleted=d.churn_nnz,
          churn=f"{churn:.4f}", **{counter: moved},
          submit_s=f"{submit_s:.2f}", landed_s=f"{landed_s:.2f}",
          tune_ms=info["tune_ms"], reorder_ms=pl.reorder_ms,
          plan_ms=f"{pl.plan_ms:.1f}", rel_err=f"{err:.2e}")


def serve_over_churn(dev) -> None:
    """7s.2 (end): an over-churn delta (a full replan through the
    DeltaTooLarge fallback) on one sell key of TRAFFIC_MATRIX, served as
    the serve-sim service serves."""
    import numpy as np

    from repro_torch.serving.spmv_service import SpmvService

    mat = traffic_matrix()
    rng = np.random.default_rng(5)
    x = rng.standard_normal(mat.n)
    with SpmvService(engine="sell", device=dev, **SERVE_KW) as svc:
        svc.register(TRAFFIC_MATRIX, mat)
        svc.operator(TRAFFIC_MATRIX)
        serve_delta(dev, svc, TRAFFIC_MATRIX, mat, x, rng,
                    "over-churn delta", OVER_CHURN, "delta.fallbacks")


def ramp_rate(step: int) -> float:
    return RAMP_BASE * 2.0 ** (step / 2)


def sustained_at(rec) -> bool:
    """A traffic run kept pace: every request offered over the submit
    window was answered (none rejected, shed or failed), and the last
    answer came within the run's p95 latency of the last arrival. A
    backlog that grows through the run leaves its last request the
    longest wait, past the p95; a service that keeps up answers it as it
    answers the others."""
    return (not (rec["rejected"] or rec["shed"] or rec["errors"])
            and rec["drain_s"] - rec["submit_s"] <= rec["p95_ms"] / 1e3)


def traffic_matrix():
    """The Fig. 1 matrix's generator at TRAFFIC_ROWS rows, registered in
    the suite under TRAFFIC_MATRIX."""
    from repro_torch.matrices import generators as G
    from repro_torch.matrices import suite

    if TRAFFIC_MATRIX not in suite.names("large"):
        suite.register_matrix(
            TRAFFIC_MATRIX, "large",
            lambda: G.shuffle(G.banded(TRAFFIC_ROWS, 15, seed=7), seed=8))
    return suite.get(TRAFFIC_MATRIX)


def traffic_run(dev, matrix: str, rate: float, budget_mb: float,
                label: str) -> dict:
    """One run_serve_traffic run; fails on any failed, unanswered or
    unaccounted request, update or replan."""
    from repro_torch.launch import spmv_bench

    t0 = time.perf_counter()
    rec = spmv_bench.run_serve_traffic(
        matrix=matrix, rate_rps=rate, budget_mb=budget_mb, device=dev,
        **TRAFFIC)
    if not rec["ok"]:
        raise AssertionError(
            f"traffic {label}: unresolved={rec['unresolved']} "
            f"replan_unresolved={rec['replan_unresolved']} "
            f"errors={rec['errors']} replan_errors={rec['replan_errors']} "
            f"update_errors={rec['update_errors']} "
            f"structure_errors={rec['structure_errors']} "
            f"budget_ok={rec['budget_ok']} "
            f"counters_balanced={rec['counters_balanced']}")
    if rec["op_reloads"] < 1 or rec["launches"]["sell_spmm"] == 0:
        raise AssertionError(f"traffic {label}: op_reloads="
                             f"{rec['op_reloads']} launches="
                             f"{rec['launches']}")
    phase(f"traffic {label}", t0, rate_rps=rate, ok=rec["ok_count"],
          shed=rec["shed"], rejected=rec["rejected"], errors=rec["errors"],
          unresolved=rec["unresolved"],
          p50_ms=rec["p50_ms"], p95_ms=rec["p95_ms"], p99_ms=rec["p99_ms"],
          offered_rps=(rec["ok_count"] + rec["shed"] + rec["errors"]
                       + rec["unresolved"] + rec["rejected"])
          / rec["submit_s"],
          achieved_rps=rec["ok_count"] / rec["drain_s"],
          schedule_s=rec["schedule_s"], submit_s=rec["submit_s"],
          drain_s=rec["drain_s"], wall_s=rec["wall_s"],
          drain_after_last_s=rec["drain_s"] - rec["submit_s"],
          sustained=sustained_at(rec),
          coalesce=f"{rec['coalesce_ratio']:.3f}",
          evictions=rec["evictions"], reloads=rec["op_reloads"],
          builds=rec["op_builds"], swaps=rec["value_swaps"],
          replans_landed=rec["replans_landed"],
          structure_updates=rec["structure_updates"],
          resident_bytes_max=rec["resident_bytes_max"],
          budget_bytes=rec["memory_budget_bytes"],
          retry_after_positive=rec["retry_after_positive"],
          launches=json.dumps(rec["launches"]))
    return rec


def dispatch_stretch(svc, key: str) -> None:
    """One profiled stretch of dispatches: 64 requests on one resident
    key of the serve-sim service, under torch.profiler (device busy
    share)."""
    import numpy as np

    rng = np.random.default_rng(9)
    xs = [rng.standard_normal(svc.operator(key).shape[1])
          for _ in range(64)]

    def stretch():
        futs = [svc.submit(key, x) for x in xs]
        for f in futs:
            f.result(timeout=600)

    profile_call(f"serve dispatches {key} x{len(xs)}", stretch)


def serve_traffic(dev) -> dict:
    """7s.3 on TRAFFIC_MATRIX: the ramp (RAMP_*) finds the sustained rate,
    the highest step held sustained below one that is not; the runs at
    0.5x and 2x it are the steps two below and two above, run if the ramp
    did not reach them. The ramp's rule for a step: its run is sustained
    (sustained_at), or, if not, a second run at the same rate is; a step
    fails only when both runs fail (one chance reject in 200 arrivals
    does not set the rate), and then keeps its first run. The 0.5x and 2x
    runs are single runs. The 2x run must reject with a positive
    retry_after. The memory budget holds TRAFFIC_BUDGET_OPS operators,
    read from one built operator. Returns the launches of the 0.5x and 2x
    runs and the 0.5x rate."""
    from repro_torch.core.spmv.opcache import operator_nbytes
    from repro_torch.core.spmv.plan import SpmvProblem, plan

    mat = traffic_matrix()
    t0 = time.perf_counter()
    op = plan(SpmvProblem(mat, k=TRAFFIC["max_batch"]),
              reorder=TRAFFIC["reorder"], engine=TRAFFIC["engine"],
              device=dev).build(device=dev)
    nbytes = operator_nbytes(op)
    del op
    budget_mb = TRAFFIC_BUDGET_OPS * nbytes / (1 << 20)
    phase("traffic matrix", t0, matrix=TRAFFIC_MATRIX,
          shape=f"{mat.m}x{mat.n}", nnz=mat.nnz, operator_bytes=nbytes,
          budget_mb=f"{budget_mb:.3f}")
    runs = {}

    def run_step(step: int, label: str) -> dict:
        if step not in runs:
            runs[step] = traffic_run(dev, TRAFFIC_MATRIX, ramp_rate(step),
                                     budget_mb, label)
        return runs[step]

    def held(step: int) -> bool:
        if step in runs:
            return sustained_at(runs[step])
        rate = ramp_rate(step)
        if sustained_at(run_step(step, f"ramp {rate:.4g} rps")):
            return True
        again = traffic_run(dev, TRAFFIC_MATRIX, rate, budget_mb,
                            f"ramp {rate:.4g} rps again")
        if sustained_at(again):
            runs[step] = again
        return sustained_at(runs[step])

    step = RAMP_START
    up = held(step)
    while True:
        nxt = step + (1 if up else -1)
        if nxt not in RAMP_STEPS:
            raise AssertionError(f"traffic: the ramp left its steps at "
                                 f"{ramp_rate(step):.4g} rps")
        if held(nxt) != up:
            sustained = step if up else nxt
            break
        step = nxt
    launches = {}
    for mult, k in ((0.5, sustained - 2), (2.0, sustained + 2)):
        run_step(k, f"{mult:g}x sustained")
        for name, n in runs[k]["launches"].items():
            launches[name] = launches.get(name, 0) + n
    over, half = runs[sustained + 2], runs[sustained - 2]
    if not (over["rejected"] and over["retry_after_positive"]):
        raise AssertionError(f"traffic 2x sustained "
                             f"({ramp_rate(sustained + 2):.4g} rps): "
                             f"rejected={over['rejected']} "
                             f"retry_after_positive="
                             f"{over['retry_after_positive']}")
    print(f"[result] traffic on {TRAFFIC_MATRIX}: sustained "
          f"{ramp_rate(sustained):.4g} rps; 0.5x "
          f"({ramp_rate(sustained - 2):.4g} rps) p50/p99 "
          f"{half['p50_ms']:.1f}/{half['p99_ms']:.1f} ms; 2x "
          f"({ramp_rate(sustained + 2):.4g} rps) rejected "
          f"{over['rejected']} of {over['ok_count'] + over['rejected']}, "
          f"p50/p99 "
          f"{over['p50_ms']:.1f}/{over['p99_ms']:.1f} ms", flush=True)
    return {"launches": launches, "rate": ramp_rate(sustained - 2)}


def serve_cell(dev, name: str, mat, rate: float, op_bytes: int) -> None:
    """7s.4: one serve cell on the Fig. 1 matrix at its full size (sell,
    k = 8, K = 4 keys, SERVE_CELL's arrivals at the traffic's 0.5x rate, a
    budget of TRAFFIC_BUDGET_OPS of its operators) through the Runner on a
    fresh result store, under torch.profiler (the device's idle share
    under the value-update mix), then resumed from the store."""
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner)
    from repro_torch.experiments.cells import serve_variant

    t0 = time.perf_counter()
    budget_mb = TRAFFIC_BUDGET_OPS * op_bytes / (1 << 20)
    spec = ExperimentSpec(
        name="serve", kind="serve", matrices=(name,),
        schemes=(TRAFFIC["reorder"],), engines=(TRAFFIC["engine"],),
        ks=(TRAFFIC["max_batch"],),
        variants=(serve_variant(rate_rps=rate, n_keys=TRAFFIC["n_keys"],
                                budget_mb=budget_mb,
                                max_queue=TRAFFIC["max_queue"],
                                **SERVE_CELL),),
        policy=MeasurePolicy(iters=1, warmup=0, with_yax=False,
                             with_parallel=False, with_metrics=False))
    store = ResultStore(os.path.join(
        os.environ["REPRO_TORCH_RESULT_STORE"], "serve"))
    get = {name: mat}.__getitem__
    out = {}
    profile_call(f"serve cell {name}", lambda: out.update(
        rep=Runner(spec, store, get_matrix=get, device=dev).run()))
    (rec,) = out["rep"].records
    check_cell_launches(dict(rec, engine=rec["engine_request"]))
    if not (rec["budget_ok"] and rec["counters_balanced"]
            and rec["unresolved"] == 0 and rec["errors"] == 0
            and rec["update_errors"] == 0):
        raise AssertionError(f"serve cell: {rec}")
    again = Runner(spec, store, get_matrix=get, device=dev).run()
    if again.measured != 0 or again.reused != 1:
        raise AssertionError(f"serve cell resume: measured "
                             f"{again.measured}, reused {again.reused}")
    phase("serve cell", t0, variant=spec.variants[0], ok=rec["ok"],
          rejected=rec["rejected"], updates=rec["updates"],
          p50_ms=rec["p50_ms"], p95_ms=rec["p95_ms"], p99_ms=rec["p99_ms"],
          offered_rps=(rec["submitted"] + rec["rejected"]) / rec["submit_s"],
          achieved_rps=rec["ok"] / rec["drain_s"],
          submit_s=rec["submit_s"], drain_s=rec["drain_s"],
          coalesce=f"{rec['coalesce_ratio']:.3f}",
          reloads=rec["op_reloads"], builds=rec["op_builds"],
          evictions=rec["evictions"], swaps=rec["value_swaps"],
          resident_bytes_max=rec["resident_bytes_max"],
          budget_bytes=rec["memory_budget_bytes"],
          resumed=f"{again.reused}/1", launches=json.dumps(rec["launches"]))


def dispatch_breakdown(dev, svc, key: str) -> None:
    """Where one dispatch of a batch of max_batch float64 requests goes at
    the Fig. 1 size, step by step as the service runs it (host clock
    around each step with the card synchronized, median of 10): host
    stack, host-to-device copy and cast, the perm gather, the kernel
    (inner.matmul), the iperm gather, device-to-host copy."""
    import numpy as np
    import torch

    op = svc.operator(key)
    n = op.shape[1]
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal(n) for _ in range(SERVE_KW["max_batch"])]
    steps = {k: [] for k in ("stack", "h2d_cast", "perm_gather", "kernel",
                             "iperm_gather", "d2h", "whole")}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name].append((time.perf_counter() - t) * 1e3)
        return out

    for _ in range(12):
        torch.cuda.synchronize()
        t = time.perf_counter()
        xb = timed("stack", lambda: np.stack(xs, axis=1))
        xd = timed("h2d_cast", lambda: torch.as_tensor(
            xb, dtype=torch.float32, device=dev))
        xp = timed("perm_gather", lambda: xd.index_select(0, op._perm))
        yp = timed("kernel", lambda: op.inner.matmul(xp))
        yd = timed("iperm_gather", lambda: yp.index_select(0, op._iperm))
        timed("d2h", lambda: yd.cpu().numpy())
        steps["whole"].append((time.perf_counter() - t) * 1e3)
    med = {k: float(np.median(v[2:])) for k, v in steps.items()}
    print(f"[serve] dispatch breakdown {key} batch="
          f"{SERVE_KW['max_batch']} float64 ms: {json.dumps(med)}",
          flush=True)


def serve_phase(dev, mats: dict) -> tuple:
    """Phase 7s; returns the launches of its service paths by kernel, and
    the traffic ramp's rate at half the sustained one."""
    from repro_torch import kernels
    from repro_torch.core.spmv.opcache import operator_nbytes

    paths = {}
    shuffled = next(iter(mats))
    reqs, want = serve_requests(dev, mats)
    for engine in ("sell", "bcsr"):
        out = serve_sim(dev, mats, engine, reqs, want)
        paths[f"serve-sim/{engine}"] = out["launches"]
        svc = out["service"]
        if engine == "sell":
            op_bytes = operator_nbytes(svc.operator(shuffled))
            dispatch_breakdown(dev, svc, shuffled)
            dispatch_stretch(svc, shuffled)
            serve_dynamic(dev, svc, mats[shuffled], shuffled)
            serve_over_churn(dev)
        svc.close()
    del svc, out
    traffic = serve_traffic(dev)
    paths["serve-traffic"] = traffic["launches"]
    kernels.reset_launches()
    serve_cell(dev, shuffled, mats[shuffled], traffic["rate"], op_bytes)
    paths["serve-cell"] = dict(kernels.LAUNCHES)
    return paths, traffic["rate"]


# -- phase 7p: sharded plans at the Fig. 1 size ----------------------------
SHARDED_P = 8
# the plans of the phase: (scheme, layout), engine auto, partition auto
SHARDED_PLANS = (("baseline", "1d_rows"), ("rcm", "1d_rows"),
                 ("rcm", "2d_panels"))
# (1d_rows:static left the campaign to make room for phase 7r: the auto
# partition of 7p.1's 1d_rows plans resolves to static, so those plans
# already verify that split)
SHARDED_VARIANTS = ("1d_rows:nnz_balanced", "2d_panels:nnz_balanced")
SHARDED_BELL_VARIANTS = ("1d_rows:nnz_balanced",)
# the cell the plan-store rerun repeats (scheme, engine request, variant):
# one of five, to keep the run inside its time (each cell took 8-36 s,
# mostly host work, in the first runs on the card)
SHARDED_AGAIN = ("rcm", "auto", "1d_rows:nnz_balanced")
SINGLE_TOL = 1e-5        # a sharded operator against the single-device one
MESH_TOL = 1e-6          # the mesh path against the simulated path
CG_ITERS = 50
CG_RTOL = 1e-6           # CG stops at ||r|| <= CG_RTOL * ||b|| (the
#                          diagonal, m, is ~1e5x the rest of a row: one step
#                          leaves ~3e-6, so this asks for a second)
CG_RES_TOL = 1e-6        # |r_sharded - r_single| <= CG_RES_TOL * ||b||
SHARDED_ITERS = 6        # modelled-parallel iterations of each cell
# the bell cell's: each is one event pair around one call, so its median
# needs more of them to settle (6 gave 0.113-0.185 ms between runs)
SHARDED_BELL_ITERS = 40


def sharded_plan(dev, mat, scheme: str, layout: str):
    from repro_torch.core.spmv.plan import SpmvProblem, plan
    from repro_torch.core.spmv.topology import Topology

    return plan(SpmvProblem(mat, hints={"seed": 0}), reorder=scheme,
                topology=Topology(devices=SHARDED_P, layout=layout),
                partition="auto", device=dev)


def mesh_check(dev, op, x) -> dict:
    """The mesh path on [dev] * p (one card: a check of the mesh path's
    code, not of multi-card speed) against the simulated path."""
    import torch

    op.force_simulated = True
    sim = op(x)
    op.force_simulated = False
    op.mesh_devices = [dev] * op.topology.devices
    if op.simulated:
        raise AssertionError("mesh_devices set, but the operator simulates")
    mesh = op(x)
    op.mesh_devices = None
    err = scaled_err(mesh.cpu().numpy(), sim.cpu().numpy())
    if not err <= MESH_TOL:
        raise AssertionError(f"mesh path vs simulated path: rel err "
                             f"{err:.3e} > {MESH_TOL:.0e}")
    return {"mesh_rel_err": err, "mesh_bitwise": bool(torch.equal(mesh,
                                                                  sim))}


def sharded_cg(dev, op, single) -> None:
    """CG (k = 1) through the sharded rcm operator and the single-device
    one from the same b, both in the reordered space: the same iterations,
    residuals within CG_RES_TOL * ||b||, solutions within SINGLE_TOL."""
    import torch

    from repro_torch.core.measure import cg

    b = torch_randn((op.shape[0],), torch_generator(11), torch.float32, dev)
    tol = CG_RTOL * float(torch.linalg.vector_norm(b))
    t0 = time.perf_counter()
    got = cg.cg_solve(op.unwrap(), b, max_iter=CG_ITERS, tol=tol)
    got_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = cg.cg_solve(single, b, max_iter=CG_ITERS, tol=tol)
    want_s = time.perf_counter() - t0
    bn = float(torch.linalg.vector_norm(b))
    dres = abs(float(got.residual) - float(want.residual))
    xerr = scaled_err(got.x.cpu().numpy(), want.x.cpu().numpy())
    if got.iters != want.iters or got.iters >= CG_ITERS \
            or not dres <= CG_RES_TOL * bn or not xerr <= SINGLE_TOL:
        raise AssertionError(
            f"CG sharded vs single device: iters {got.iters} vs "
            f"{want.iters} (max {CG_ITERS}), |dres| {dres:.3e} > "
            f"{CG_RES_TOL * bn:.3e} or x rel err {xerr:.3e}")
    phase("sharded cg rcm", time.perf_counter() - got_s - want_s,
          iters=got.iters, residual=float(got.residual),
          single_residual=float(want.residual), b_norm=bn,
          x_rel_err=f"{xerr:.2e}", sharded_s=f"{got_s:.3f}",
          single_s=f"{want_s:.3f}")


def sharded_host_costs(pl) -> None:
    """Where a sharded plan's host time goes, on the rcm order: each
    partitioner, the comm model, the feature scan, the layout build."""
    from repro_torch.core.sparse import partition
    from repro_torch.core.spmv import topology, tune

    rmat = pl.reordered_matrix()
    topo = pl.topology
    ms = {}
    for name in ("static", "nnz_balanced"):
        t0 = time.perf_counter()
        starts = partition.resolve_partitioner(name)[1](
            rmat, topo.row_devices, 0)[1]
        ms[f"partition_{name}"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        topology.comm_model(rmat, starts, topo, 4, 1, (8, 128))
        ms[f"comm_model_{name}"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tune.matrix_features(rmat)
    ms["features"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pl._sharded_layout(rmat)
    ms["layout_build"] = (time.perf_counter() - t0) * 1e3
    print(f"[sharded] host ms on {pl.label()}: "
          f"{json.dumps({k: round(v, 1) for k, v in ms.items()})}",
          flush=True)


def sharded_plans(dev, mat) -> None:
    """7p.1: each plan of SHARDED_PLANS on the card: its decision, its
    operator and its structure twin's against the float64 product, the
    operator against the single-device operator of the same scheme and
    engine, and the mesh path against the simulated path; k = 8 and CG on
    the rcm 1d_rows plan."""
    import torch

    from repro_torch.core.spmv.ops import make_engine
    from repro_torch.launch import spmv_bench

    twin = spmv_bench.structure_twin(mat, 0)
    x = torch_randn((mat.n,), torch_generator(5), torch.float32, dev)
    for scheme, layout in SHARDED_PLANS:
        t0 = time.perf_counter()
        pl = sharded_plan(dev, mat, scheme, layout)
        plan_s = time.perf_counter() - t0
        op = pl.build(device=dev)
        info = op.build_info
        err = spmv_bench.verify(op, mat, 1, torch.float32, dev, VERIFY_TOL)
        twin_op = pl.build(device=dev, values=twin.vals)
        twin_err = spmv_bench.verify(twin_op, twin, 1, torch.float32, dev,
                                     VERIFY_TOL)
        del twin_op
        # the single-device operator of the same scheme and engine, on the
        # plan's reordered matrix (the sharded one runs permuted beside it)
        single = make_engine(pl.reordered_matrix(), pl.tune.engine,
                             device=dev)
        single_err = check_product(
            f"sharded {pl.label()} vs single device",
            op(x, permuted=True).cpu().numpy(), single(x).cpu().numpy(),
            SINGLE_TOL)
        mesh = mesh_check(dev, op, x)
        comm = pl.comm
        fields = {}
        if scheme == "rcm" and layout == "1d_rows":
            fields["verify_k8"] = "{:.2e}".format(spmv_bench.verify(
                op, mat, 8, torch.float32, dev, VERIFY_TOL))
            sharded_cg(dev, op, single)
            sharded_host_costs(pl)
        phase(f"sharded plan {scheme}/{layout}", t0, label=pl.label(),
              engine=pl.tune.engine, partitioner=pl.partitioner,
              schedule=comm["schedule"], halo=comm["halo"],
              halo_width=comm["halo_width"], li=comm["li"],
              cut_volume=comm["cut_volume"],
              bytes_per_spmv=comm["bytes_per_spmv"],
              gather_bytes=comm.get("gather_bytes"), h_pad=comm["h_pad"],
              simulated=op.simulated, plan_s=f"{plan_s:.2f}",
              reorder_ms=f"{pl.reorder_ms:.1f}",
              tune_ms=f"{pl.tune_ms:.1f}",
              build_ms=f"{info['build_ms']:.1f}",
              verify=f"{err:.2e}", verify_twin=f"{twin_err:.2e}",
              vs_single=f"{single_err:.2e}",
              mesh_rel_err=f"{mesh['mesh_rel_err']:.2e}",
              mesh_bitwise=mesh["mesh_bitwise"],
              partition_costs=json.dumps(pl.partition_costs), **fields)
        del op, single


def sharded_spec(name: str, matrix: str, schemes: tuple, engine: str,
                 variants: tuple, iters: int = SHARDED_ITERS):
    from repro_torch.experiments import ExperimentSpec, MeasurePolicy

    return ExperimentSpec(
        name=name, kind="parallel", matrices=(matrix,),
        schemes=schemes, engines=(engine,), ps=(SHARDED_P,),
        variants=variants,
        policy=MeasurePolicy(iters=iters, warmup=0, verify=True,
                             verify_tol=VERIFY_TOL, with_yax=False,
                             with_parallel=False, with_metrics=False))


def sharded_campaign(dev, name: str, mat) -> dict:
    """7p.2: the parallel campaign through the Runner: fig1_shuffled x
    {baseline, rcm} x SHARDED_VARIANTS, engine auto, and an rcm cell
    again with the bell engine (never on the shuffled order: its
    Block-ELL would hold ~130 GB), whose modelled time launches K4 on
    each panel; then the SHARDED_AGAIN cell from the plan store (a fresh
    result store) and the specs resumed from the first result store.
    Returns the launches of the first run and the bell cell's modelled
    parallel ms."""
    from repro_torch import kernels
    from repro_torch.experiments import ResultStore, Runner

    specs = (sharded_spec("sharded", name, ("baseline", "rcm"), "auto",
                          SHARDED_VARIANTS),
             sharded_spec("sharded_bell", name, ("rcm",), "bell",
                          SHARDED_BELL_VARIANTS, SHARDED_BELL_ITERS))
    results = os.environ["REPRO_TORCH_RESULT_STORE"]
    get = {name: mat}.__getitem__

    def run_specs(store: str, specs=specs):
        return [Runner(spec, ResultStore(os.path.join(results, store)),
                       get_matrix=get, device=dev).run() for spec in specs]

    t0 = time.perf_counter()
    kernels.reset_launches()
    reps = run_specs("sharded")
    launches = dict(kernels.LAUNCHES)
    first_s = time.perf_counter() - t0
    ncells = sum(len(s.cells()) for s in specs)
    bell_ms = {}
    for rep in reps:
        if rep.failures or rep.measured != len(rep.records):
            raise AssertionError(f"sharded campaign: {rep.failures}")
        for rec in rep.records:
            if rec["engine"] == "bell":
                if dev.type == "cuda" and not rec["launches"]["bell_spmv"] > 0:
                    raise AssertionError(f"{rec['variant']}: bell panels "
                                         f"launched no K4: "
                                         f"{rec['launches']}")
                bell_ms[rec["variant"]] = rec["modelled_par_ms"]
            phase(f"parallel cell {rec['scheme']}/{rec['engine']}/"
                  f"{rec['variant']}",
                  time.perf_counter() - rec["runner_wall_s"],
                  partitioner=rec["partitioner"], engine=rec["engine"],
                  schedule=rec["comm_schedule"], li=rec["li"],
                  cut_volume=rec["cut_volume"],
                  halo_width=rec["halo_width"], h_pad=rec["h_pad"],
                  bytes_per_spmv=rec["comm_bytes_per_spmv"],
                  modelled_par_ms=rec["modelled_par_ms"],
                  gflops=f"{rec['gflops']:.2f}",
                  verify=f"{rec['verify_rel_err']:.2e}",
                  verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
                  simulated=rec["simulated"],
                  reorder_ms=f"{rec['reorder_ms']:.1f}",
                  tune_ms=f"{rec['tune_ms']:.1f}",
                  build_ms=f"{rec['format_build_ms']:.1f}",
                  launches=json.dumps(rec["launches"]))
    phase("campaign sharded", t0, cells=ncells,
          launches=json.dumps(launches))

    t1 = time.perf_counter()
    scheme, engine, variant = SHARDED_AGAIN
    again, = run_specs("sharded_again", (sharded_spec(
        "sharded", name, (scheme,), engine, (variant,)),))
    for rec in again.records:
        if not (rec["plan_store_hit"] and rec["op_cache_hit"]
                and rec["tune_ms"] == 0.0 and rec["reorder_ms"] == 0.0):
            raise AssertionError(
                f"parallel {rec['variant']}: not served by the plan "
                f"store: plan_store_hit={rec['plan_store_hit']} "
                f"op_cache_hit={rec['op_cache_hit']}")
        phase(f"parallel cell {scheme}/{rec['engine']}/{variant} from the "
              f"plan store", time.perf_counter() - rec["runner_wall_s"],
              load_ms=f"{rec['op_load_ms']:.1f}",
              verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
              modelled_par_ms=rec["modelled_par_ms"])
    phase("campaign sharded from the plan store", t1,
          plan_store_hits=f"{len(again.records)}/1",
          seconds=f"{time.perf_counter() - t1:.2f}",
          first_run_seconds=f"{first_s:.2f}")

    t1 = time.perf_counter()
    resumed = run_specs("sharded")
    hits = sum(r.reused for r in resumed)
    if hits != ncells or any(r.measured for r in resumed):
        raise AssertionError(f"sharded resume: {hits} of {ncells} hits")
    phase("campaign sharded resumed", t1, result_store_hits=f"{hits}/"
          f"{ncells}", seconds=f"{time.perf_counter() - t1:.2f}")
    return launches, bell_ms


def sharded_bell_panels(dev, mat, cell_ms: dict) -> None:
    """7p.2b: K4 at the shapes the bell cells gave it. Each bell cell's
    plan (a plan-store hit) is cut into its row panels as
    modelled_parallel_ms cuts it (rectangular: h x n, h set by the
    partitioner); each panel's Block-ELL operator runs K4 once on x, with
    the launch counts reset just before and read just after (one K4
    launch and nothing else), and its y is held against the plain
    Block-ELL product on the same blocks (KERNEL_TOL) and the float64
    product of the panel's rows (VERIFY_TOL), and so is the same panel of
    the structure twin, where every term counts. Then each panel's call
    op(x) and its bare K4 launch (x already padded, as phase 6 times K4)
    are timed with one event pair per BATCH calls; the max over panels of
    each, plus ALPHA_SYNC_MS, is printed beside the cell's own per-call
    reading. These launches are not the path's: the campaign's counts
    were read before."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.measure.parallel_model import (ALPHA_SYNC_MS,
                                                         panel_submatrix)
    from repro_torch.core.spmv.ops import make_engine
    from repro_torch.core.spmv.plan import SpmvProblem, plan
    from repro_torch.core.spmv.topology import Topology
    from repro_torch.kernels.bcsr_spmv.ops import pad_x2d
    from repro_torch.kernels.bell_spmv.kernel import (bell_spmv,
                                                      bell_spmv_plain)
    from repro_torch.launch import spmv_bench

    x = torch_randn((mat.n,), torch_generator(17), torch.float32, dev)
    xh = x.double().cpu().numpy()
    for variant in SHARDED_BELL_VARIANTS:
        t0 = time.perf_counter()
        layout, part = variant.split(":")
        pl = plan(SpmvProblem(mat, hints={"seed": 0}), reorder="rcm",
                  engine="bell", partition=part, device=dev,
                  topology=Topology(devices=SHARDED_P, layout=layout))
        rmat = pl.reordered_matrix()
        # the same panels with values U(-1, 1): the diagonal of rmat's
        # rows (~1e5 x the rest) would hide wrong off-diagonal blocks
        vtwin = spmv_bench.structure_twin(rmat, seed=1)
        starts = pl.panel_starts
        panels = []
        for k in range(len(starts) - 1):
            r0, r1 = int(starts[k]), int(starts[k + 1])
            row = {"rows": r1 - r0}
            for src, tag in ((vtwin, "twin_"), (rmat, "")):
                sub = panel_submatrix(src, r0, r1)
                op = make_engine(sub, "bell", device=dev)
                name = f"K4 {'twin ' if tag else ''}panel {k}"
                kernels.reset_launches()
                y = op(x)
                got = dict(kernels.LAUNCHES)
                if dev.type == "cuda" and (got["bell_spmv"] != 1
                                           or sum(got.values()) != 1):
                    raise AssertionError(f"{name} ({r1 - r0} x {mat.n}): "
                                         f"launches {got}, not one K4")
                x2d = pad_x2d(x[:, None], op.ncb, op.block_shape[1])
                plain = bell_spmv_plain(op.blocks, op.block_cols,
                                        x2d).reshape(-1)[: r1 - r0]
                row[f"{tag}max_abs_err"] = rel_err(y, plain)[0]
                check_close(f"{name} vs plain Block-ELL", y, plain,
                            torch.float32)
                row[f"{tag}rel_err"] = check_product(
                    f"{name} vs the float64 product", y.cpu().numpy(),
                    device_product(sub, xh, dev))
                del y, plain, x2d
            # the path's panel (the plan's own values) is the one timed
            row["ms"] = time_ms(lambda: op(x))
            x2d = pad_x2d(x[:, None], op.ncb, op.block_shape[1])
            row["k4_ms"] = time_ms(lambda: bell_spmv(op.blocks,
                                                     op.block_cols, x2d))
            del x2d
            nbr, width = op.blocks.shape[:2]
            row.update(nbr=int(nbr), K=int(width))
            panels.append(row)
            del op
        resolved = max(p["ms"] for p in panels) + ALPHA_SYNC_MS
        k4_par = max(p["k4_ms"] for p in panels) + ALPHA_SYNC_MS
        phase(f"bell panels rcm/{variant}", t0, panels=len(panels),
              max_abs_err=f"{max(p['max_abs_err'] for p in panels):.3e}",
              max_rel_err=f"{max(p['rel_err'] for p in panels):.2e}",
              twin_max_abs_err="{:.3e}".format(
                  max(p["twin_max_abs_err"] for p in panels)),
              twin_max_rel_err="{:.2e}".format(
                  max(p["twin_rel_err"] for p in panels)),
              batched_par_ms=f"{resolved:.4f}",
              k4_par_ms=f"{k4_par:.4f}", cell_par_ms=cell_ms[variant],
              panel_ms=json.dumps([round(p["ms"], 4) for p in panels]),
              k4_panel_ms=json.dumps([round(p["k4_ms"], 4)
                                      for p in panels]),
              shapes=json.dumps([[p["rows"], mat.n, p["nbr"], p["K"]]
                                 for p in panels]))


def sharded_service(dev, mat) -> None:
    """7p.3: one sharded key in SpmvService (rcm, 1d_rows, p = 8, the
    plan store's operator): a few requests within VERIFY_TOL of the
    float64 product, and update_values raising RoutedElsewhere."""
    import numpy as np

    from repro_torch.core.spmv.topology import Topology
    from repro_torch.serving.errors import RoutedElsewhere
    from repro_torch.serving.spmv_service import SpmvService

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    xs = rng.standard_normal((mat.n, 4))
    want = device_product(mat, xs, dev)
    with SpmvService(engine="auto", reorder="rcm", max_batch=1,
                     window_ms=2.0, device=dev,
                     topology=Topology(devices=SHARDED_P),
                     partition="auto") as svc:
        svc.register("fig1/sharded", mat)
        futs = [svc.submit("fig1/sharded", xs[:, j]) for j in range(4)]
        errs = [check_product(f"sharded service request {j}",
                              f.result(timeout=600), want[:, j])
                for j, f in enumerate(futs)]
        op = svc.operator("fig1/sharded")
        try:
            svc.update_values("fig1/sharded", mat.vals)
        except RoutedElsewhere:
            pass
        else:
            raise AssertionError("update_values on a sharded key did not "
                                 "raise RoutedElsewhere")
        stats = svc.stats()
    if stats["errors"] or stats["results"] != 4:
        raise AssertionError(f"sharded service: {stats['results']} results, "
                             f"{stats['errors']} errors")
    phase("sharded service", t0, requests=4, max_rel_err=f"{max(errs):.2e}",
          reloads=stats["op_reloads"], simulated=op.simulated,
          label=op.plan.label())


def sharded_phase(dev, name: str, mat) -> dict:
    """Phase 7p; returns the launches of the parallel campaign."""
    t0 = time.perf_counter()
    sharded_plans(dev, mat)
    phase("sharded plans", t0)
    launches, bell_ms = sharded_campaign(dev, name, mat)
    sharded_bell_panels(dev, mat, bell_ms)
    sharded_service(dev, mat)
    return {"sharded/parallel campaign": launches}


# -- phase 7r: the multi-shard router --------------------------------------
# every mesh of a fleet runs on the one card: a mesh of d > 1 devices is a
# Topology whose panels run simulated, its per-device budget the
# accounting of operator_nbytes_per_device over those d devices
ROUTE_P = 8
ROUTE_BUDGET_SHARE = 1.5         # 7r.2.1: one key's largest share, x1.5
ROUTE_ALTERNATE = 3              # 7r.2.1: requests alternating two keys
ROUTE_SIBLING_BASE = 40          # 7r.2.3: sibling requests before the delta
ROUTE_DELTA_FRAC = 0.005         # 7r.2.3: the deletion delta's fraction
ROUTE_KW = {"engine": "auto", "reorder": "rcm", "partition": "auto",
            "max_batch": 1, "window_ms": 2.0}    # 7p's plans: k = 1
ROUTE_ONE_DEVICE = {"engine": "sell", "reorder": "rcm", "max_batch": 8,
                    "window_ms": 20.0}           # 7r.3: 7s.3's plans
ROUTE_TRAFFIC_REQUESTS = 60      # 7r.4, at half 7s.3's sustained rate


def route_campaign(dev) -> None:
    """7r.1: the router soak, bench.run.smoke_route, on TRAFFIC_MATRIX (two
    route cells on meshes of 4 devices, the sibling p99 and
    delta-against-replan checks, the resume); its CSV's header is the
    reference's."""
    from repro_torch.bench import run as bench_run

    t0 = time.perf_counter()
    traffic_matrix()
    fails = bench_run.smoke_route(matrices=(TRAFFIC_MATRIX,), device=dev)
    if fails:
        raise AssertionError(f"route soak: {fails} failures")
    rows = csv_rows(bench_run.common.result_path(bench_run.SMOKE_ROUTE_CSV),
                    bench_run.SMOKE_ROUTE_HEADER)
    phase("route campaign", t0, matrix=TRAFFIC_MATRIX, csv_rows=rows)


def route_request(rt, key: str, x):
    t0 = time.perf_counter()
    y = rt.submit(key, x).result(timeout=900)
    return y, time.perf_counter() - t0


def route_budget(dev, mats: dict, share: int) -> None:
    """7r.2.1-2: both Fig. 1 keys on one mesh whose per-device budget
    holds one operator (ROUTE_BUDGET_SHARE x the largest share), requests
    alternating between them (each evicts the other: reloads from the plan
    store), then a sharded value swap to the structure twin's values."""
    import numpy as np

    from repro_torch.core.spmv.topology import Topology
    from repro_torch.launch import spmv_bench
    from repro_torch.router import MeshSpec, RoutedSpmvService

    t0 = time.perf_counter()
    budget = int(ROUTE_BUDGET_SHARE * share)
    mesh = MeshSpec("m8", Topology(devices=ROUTE_P, layout="1d_rows"),
                    budget_per_device=budget)
    rng = np.random.default_rng(17)
    names = list(mats)
    xs = {n: rng.standard_normal(mats[n].n) for n in names}
    want = {n: device_product(mats[n], xs[n], dev) for n in names}
    with RoutedSpmvService([mesh], device=dev, **ROUTE_KW) as rt:
        for n in names:
            rt.register(n, mats[n])
        secs, errs = [], []
        for i in range(ROUTE_ALTERNATE):
            n = names[i % 2]
            y, s = route_request(rt, n, xs[n])
            errs.append(check_product(f"route budget request {i} ({n})",
                                      y, want[n]))
            secs.append(s)
        st = rt.stats()
        svc = st["per_mesh"]["m8"]["service"]
        if not (st["evictions"] >= 1 and svc["op_reloads"] >= 1):
            raise AssertionError(f"route budget: evictions="
                                 f"{st['evictions']} reloads="
                                 f"{svc['op_reloads']} (want >= 1 each)")
        if not (st["per_device_ok"]
                and svc["resident_bytes_max"] <= svc["memory_budget_bytes"]):
            raise AssertionError(
                f"route budget: per_device_ok={st['per_device_ok']} "
                f"resident_bytes_max={svc['resident_bytes_max']} > "
                f"{svc['memory_budget_bytes']}")
        phase("route budget", t0, budget_per_device=budget,
              share=share, evictions=st["evictions"],
              reloads=svc["op_reloads"], builds=svc["op_builds"],
              request_s=json.dumps([round(s, 3) for s in secs]),
              reload_s=f"{max(secs[2:]):.3f}",
              resident_bytes_max=svc["resident_bytes_max"],
              per_device_bytes=json.dumps(
                  st["per_mesh"]["m8"]["per_device_bytes"]),
              max_rel_err=f"{max(errs):.2e}")

        t0 = time.perf_counter()
        key = names[0]
        twin = spmv_bench.structure_twin(mats[key], 19)
        rt.update_values(key, twin.vals)
        swap_s = time.perf_counter() - t0
        y, s = route_request(rt, key, xs[key])
        err = check_product("route value swap", y,
                            device_product(twin, xs[key], dev))
        stale = scaled_err(y, want[key])
        if stale <= VERIFY_TOL:
            raise AssertionError(f"route value swap: the answer passes "
                                 f"against the old values ({stale:.3e})")
        st = rt.stats()
        if (st["value_swaps"], st["replans"]) != (1, 0):
            raise AssertionError(f"route value swap: value_swaps="
                                 f"{st['value_swaps']} replans="
                                 f"{st['replans']} (want 1, 0)")
        phase("route value swap", t0, swap_s=f"{swap_s:.3f}",
              request_s=f"{s:.3f}", rel_err=f"{err:.2e}",
              old_values_rel_err=f"{stale:.3e}",
              per_device_ok=st["per_device_ok"])


def route_delta(dev, rt, mats: dict) -> None:
    """7r.2.3 on the unbudgeted fleet: a ROUTE_DELTA_FRAC deletion delta
    on the first key while the second (its sibling on the same mesh)
    serves lone requests; the sibling's p99 before and during the
    background replan is held to the JAX package's criterion."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.bench import run as bench_run
    from repro_torch.serving import traffic

    hot, sib = list(mats)
    rng = np.random.default_rng(23)
    x = rng.standard_normal(mats[sib].n)
    want = device_product(mats[sib], x, dev)
    base, errs = [], []
    for _ in range(ROUTE_SIBLING_BASE):
        y, s = route_request(rt, sib, x)
        base.append(s * 1e3)
        errs.append(check_product("route sibling", y, want))
    d = traffic._deletion_delta(mats[hot], rng, ROUTE_DELTA_FRAC)
    applies0 = obs.counter("delta.applies").value
    fallbacks0 = obs.counter("delta.fallbacks").value
    r0 = rt.stats()["replans"]
    t0 = time.perf_counter()
    fut = rt.update_structure(hot, delta=d)
    submit_s = time.perf_counter() - t0
    during = []
    while not fut.done() or not during:
        y, s = route_request(rt, sib, x)
        during.append(s * 1e3)
        errs.append(check_product("route sibling during the replan", y,
                                  want))
    fut.result(timeout=900)
    landed_s = time.perf_counter() - t0
    applies = obs.counter("delta.applies").value - applies0
    fallbacks = obs.counter("delta.fallbacks").value - fallbacks0
    replans = rt.stats()["replans"] - r0
    if (applies, fallbacks, replans) != (1, 0, 1):
        raise AssertionError(f"route delta: delta.applies +{applies}, "
                             f"fallbacks +{fallbacks}, replans +{replans} "
                             f"(want +1, +0, +1)")
    new = d.apply_to(mats[hot])
    xh = rng.standard_normal(new.n)
    y, _ = route_request(rt, hot, xh)
    err = check_product("route delta", y, device_product(new, xh, dev))
    p_base, p_during = bench_run.p99(base), bench_run.p99(during)
    print(f"[result] route sibling p99: {p_base:.2f} ms before, "
          f"{p_during:.2f} ms during the replan ({len(during)} requests; "
          f"criterion <= 5 x before + 50 ms)", flush=True)
    if not bench_run.sibling_p99_flat(p_base, p_during):
        raise AssertionError(f"route delta: sibling p99 {p_during:.2f} ms "
                             f"during the replan vs {p_base:.2f} ms before")
    phase("route delta", t0, deleted=d.churn_nnz,
          submit_s=f"{submit_s:.3f}", replan_s=f"{landed_s:.3f}",
          sibling_p99_before_ms=f"{p_base:.3f}",
          sibling_p99_during_ms=f"{p_during:.3f}",
          sibling_requests_during=len(during),
          sibling_max_ms=f"{max(during):.3f}", rel_err=f"{err:.2e}",
          sibling_max_rel_err=f"{max(errs):.2e}")


def route_comm_aware(dev, mats: dict) -> None:
    """7r.2.4: both keys registered under comm_aware on a fleet of one
    8-device and one 2-device mesh (placement only: no operator is
    built); the assignment and each mesh's modelled bytes a SpMV."""
    from repro_torch.core.sparse.partition import static_partition
    from repro_torch.core.spmv import topology as topo_mod
    from repro_torch.core.spmv.topology import Topology
    from repro_torch.router import MeshSpec, RoutedSpmvService

    t0 = time.perf_counter()
    meshes = [MeshSpec("m8", Topology(devices=ROUTE_P)),
              MeshSpec("m2", Topology(devices=2))]
    with RoutedSpmvService(meshes, policy="comm_aware", device=dev,
                           **ROUTE_KW) as rt:
        for n, m in mats.items():
            rt.register(n, m)
        register_s = time.perf_counter() - t0
        assignments = rt.stats()["routing"]["assignments"]
    modelled = {}
    for n, m in mats.items():
        for spec in meshes:
            topo = spec.topology
            model = topo_mod.comm_model(
                m, static_partition(m, topo.row_devices), topo,
                dtype_size=4, k=1, block_shape=(8, 128))
            modelled[f"{n}@{spec.name}"] = {
                "schedule": model["schedule"],
                "bytes_per_spmv": int(model["bytes_per_spmv"])}
    phase("route comm_aware", t0, register_s=f"{register_s:.3f}",
          assignments=json.dumps(assignments),
          modelled=json.dumps(modelled))


def route_fleet(dev, mats: dict) -> None:
    """7r.2: the Fig. 1 pair (rcm) on MeshSpecs of Topology(devices=8,
    layout="1d_rows"), 7p's topology: each key's operator once on an
    unbudgeted mesh (the shuffled one a plan-store hit), then the budget,
    the value swap, the delta and comm_aware."""
    from repro_torch.core.spmv import opcache
    from repro_torch.core.spmv.topology import Topology
    from repro_torch.router import MeshSpec, RoutedSpmvService

    t0 = time.perf_counter()
    mesh = MeshSpec("m8", Topology(devices=ROUTE_P, layout="1d_rows"))
    with RoutedSpmvService([mesh], device=dev, **ROUTE_KW) as rt:
        shares, hits = {}, {}
        for n, m in mats.items():
            t1 = time.perf_counter()
            rt.register(n, m)
            op = rt.operator(n)
            shares[n] = max(opcache.operator_nbytes_per_device(op))
            hits[n] = bool(op.build_info.get("cache_hit"))
            print(f"[route] {n}: {op.plan.label()} plan_store_hit="
                  f"{hits[n]} largest per-device share {shares[n]} B "
                  f"({time.perf_counter() - t1:.2f} s)", flush=True)
            del op
        phase("route operators", t0, plan_store_hit=json.dumps(hits),
              shares=json.dumps(shares))
        route_budget(dev, mats, max(shares.values()))
        route_delta(dev, rt, mats)
    route_comm_aware(dev, mats)


def route_one_device(dev) -> dict:
    """7r.3: a fleet of two one-device meshes under nnz_balance, engine
    sell, both keys TRAFFIC_MATRIX: the keys must land on both meshes;
    lone requests (K1) and coalesced batches (K2) each within VERIFY_TOL
    of the float64 product. Launch counts are set to 0 just before the
    fleet and read just after it; returns them."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core.spmv.topology import Topology
    from repro_torch.router import MeshSpec, RoutedSpmvService

    t0 = time.perf_counter()
    mat = traffic_matrix()
    keys = [f"{TRAFFIC_MATRIX}#{i}" for i in range(2)]
    nb = ROUTE_ONE_DEVICE["max_batch"]
    rng = np.random.default_rng(29)
    xs = rng.standard_normal((mat.n, nb))
    want = device_product(mat, xs, dev)
    meshes = [MeshSpec(f"d{i}", Topology(devices=1)) for i in range(2)]
    kernels.reset_launches()
    with RoutedSpmvService(meshes, policy="nnz_balance", device=dev,
                           **ROUTE_ONE_DEVICE) as rt:
        for k in keys:
            rt.register(k, mat)
        errs = []
        for k in keys:
            y = rt.submit(k, xs[:, 0]).result(timeout=600)
            errs.append(check_product(f"one-device fleet lone {k}", y,
                                      want[:, 0]))
            futs = [rt.submit(k, xs[:, j]) for j in range(nb)]
            for j, f in enumerate(futs):
                errs.append(check_product(f"one-device fleet batch {k}",
                                          f.result(timeout=600),
                                          want[:, j]))
        st = rt.stats()
    launches = dict(kernels.LAUNCHES)
    assignments = st["routing"]["assignments"]
    batch_max = max(m["service"]["batch_size_max"]
                    for m in st["per_mesh"].values())
    if len(set(assignments.values())) != 2:
        raise AssertionError(f"one-device fleet: nnz_balance did not "
                             f"spread the keys: {assignments}")
    if launches["sell_spmv"] == 0 or launches["sell_spmm"] == 0 \
            or batch_max < 2:
        raise AssertionError(f"one-device fleet: launches {launches}, "
                             f"largest batch {batch_max}")
    phase("route one-device fleet", t0, assignments=json.dumps(assignments),
          batch_size_max=batch_max, max_rel_err=f"{max(errs):.2e}",
          launches=json.dumps(launches))
    return launches


def route_traffic(dev, rate: float) -> None:
    """7r.4: spmv_bench's routed --serve-traffic on TRAFFIC_MATRIX, 2 meshes
    of 4 devices, at `rate` (half 7s.3's sustained rate); it exits
    nonzero unless its `ok` holds."""
    from repro_torch.launch import spmv_bench

    t0 = time.perf_counter()
    spmv_bench.main([
        "--serve-traffic", "--devices", "4", "--meshes", "2",
        "--matrix", TRAFFIC_MATRIX, "--rate", f"{rate:g}",
        "--requests", str(ROUTE_TRAFFIC_REQUESTS),
        "--keys", str(TRAFFIC["n_keys"]), "--zipf", str(TRAFFIC["zipf_s"]),
        "--update-frac", str(TRAFFIC["update_frac"]),
        "--structure-frac", str(TRAFFIC["structure_frac"]),
        "--max-batch", str(TRAFFIC["max_batch"]),
        "--window-ms", str(TRAFFIC["window_ms"]),
        "--max-queue", str(TRAFFIC["max_queue"]),
        "--serve-reorder", TRAFFIC["reorder"], "--device", str(dev)])
    phase("route traffic", t0, rate_rps=rate)


def route_phase(dev, mats: dict, rate: float) -> dict:
    """Phase 7r; returns the launches of its one-device fleet."""
    route_campaign(dev)
    t0 = time.perf_counter()
    route_fleet(dev, mats)
    phase("route fleet", t0)
    launches = route_one_device(dev)
    route_traffic(dev, rate)
    return {"route/one-device fleet": launches}


# -- phase 7w: the workload streams ----------------------------------------
WORKLOAD_CELLS = (
    # name, engine, use_deltas, the kernel its products run
    ("workload://moe-e128-k8-t4096-d2048-n4", "sell", False, "sell_spmm"),
    # 262,144 rows: at 1,048,576 each delta took ~11 s of host work
    ("workload://gnn-m262144-deg16-f64-n4-rw0.01", "sell", True,
     "sell_spmm"),
    ("workload://attn-s8192-b64-w2-g1-d128-n4", "bcsr", False, "bcsr_spmv"),
)


def workload_phase(dev) -> dict:
    """Phase 7w: each cell's drift stream through run_stream(verify=True);
    returns the launches of each cell's stream."""
    from repro_torch import kernels
    from repro_torch.workloads import (DynamicSparseProblem, WorkloadSession,
                                       run_stream)

    paths = {}
    for name, engine, deltas, kernel in WORKLOAD_CELLS:
        t0 = time.perf_counter()
        problem = DynamicSparseProblem(name, scenario="drift", seed=0)
        session = WorkloadSession(problem, engine=engine, use_deltas=deltas,
                                  device=dev)
        kernels.reset_launches()
        rec = run_stream(problem, session, iters=3, verify=True)
        launches = dict(kernels.LAUNCHES)
        paths[f"workload/{problem.wdef.kind}"] = launches
        fails = []
        if not rec["verify_ok"]:
            fails.append(f"max_rel_err {rec['max_rel_err']:.3e}")
        if problem.wdef.kind == "moe" and not rec["dispatch_bitwise_equal"]:
            fails.append("dispatch buffer differs from the one-hot one")
        if deltas and not (rec["replans"] == 0
                           and rec["deltas"] == rec["steps"] - 1):
            fails.append(f"replans {rec['replans']}, deltas "
                         f"{rec['deltas']} of {rec['steps']} steps")
        if launches[kernel] == 0:
            fails.append(f"{kernel} never launched: {launches}")
        if fails:
            raise AssertionError(f"{name}: " + "; ".join(fails))
        phase(f"workload {name}", t0, engine=engine,
              steps=rec["steps"], m=rec["m"], n=rec["n"], nnz=rec["nnz"],
              plans=rec["plans"], replans=rec["replans"],
              reuses=rec["reuses"], rebuilds=rec["rebuilds"],
              deltas=rec["deltas"], reuse_rate=rec["reuse_rate"],
              plan_cost_share=rec["plan_cost_share"],
              plan_ms_total=rec["plan_ms_total"],
              sparse_ms=rec["sparse_ms"], ref_ms=rec["ref_ms"],
              max_rel_err=f"{rec['max_rel_err']:.2e}",
              dispatch_bitwise_equal=rec.get("dispatch_bitwise_equal"),
              launches=json.dumps(launches))
        del session
    return paths


def add_path_launches(rows: list, paths: dict) -> None:
    """Fold the launches of the service and workload paths into the
    kernels line: each row's `launches` becomes the sum over its forced
    path and these, `launches_paths` lists each."""
    for row in rows:
        name = row["name"]
        if name not in FEEDS:           # the f32 rows of K1-K4
            continue
        by = {row["launches_path"]: row["launches"]}
        by.update({p: n[name] for p, n in paths.items() if n.get(name)})
        row["launches_paths"] = by
        row["launches"] = sum(by.values())


# -- K5 ssd_chunk: small shapes, the Zamba2 path, times, control -----------
def ssd_inputs(b, t, h, n, p, gen, dtype, dev):
    """la, xw, B, C and a nonzero incoming state, drawn as
    tests/test_ssd_kernel.py draws them (la in [-0.2, -0.001])."""
    import torch

    la = -(torch.rand((b, t, h), generator=gen, dtype=torch.float64)
           * 0.199 + 0.001)
    rest = [torch_randn(shape, gen, dtype, dev)
            for shape in ((b, t, h, p), (b, t, n), (b, t, n), (b, h, n, p))]
    return (la.to(dev, torch.float32), *rest)


def ssd_errors(got, want) -> tuple[float, float]:
    """(max abs error, max rel error) over both outputs, y and the state."""
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def ssd_small(dev) -> int:
    """K5 at small shapes through both bodies, against its plain version:
    single chunks (the S = T case), scans of 3 and 4 chunks from a nonzero
    state (one launch each, against ssd_scan(use_kernel="ref")), a scan over
    batch-strided views, and operands off a 16-byte boundary."""
    import torch

    from repro_torch.kernels.ssd_chunk.kernel import (ssd_chunk,
                                                      ssd_chunk_plain)
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan

    gen = torch_generator(2)
    checked = 0

    def check(label, got, want, dtype):
        nonlocal checked
        for part, g, w in zip(("y", "state"), got, want):
            check_close(f"{label} {part} {dtype}", g, w, dtype)
        checked += 1

    def scan(args, t):
        return (ssd_scan(*args, chunk=t),
                ssd_scan(*args, chunk=t, use_kernel="ref"))

    for dtype in (torch.float32, torch.bfloat16):
        for b, t, h, n, p in ((2, 8, 4, 4, 16), (2, 16, 3, 8, 8),
                              (1, 16, 1, 64, 64), (2, 64, 3, 64, 64),
                              (3, 128, 5, 16, 32), (2, 128, 112, 64, 64)):
            args = ssd_inputs(b, t, h, n, p, gen, dtype, dev)
            check(f"ssd_chunk B={b} T={t} H={h} N={n} P={p}",
                  ssd_chunk(*args), ssd_chunk_plain(*args), dtype)
        for b, t, nc, h, n, p in ((2, 16, 3, 3, 8, 8), (1, 16, 3, 2, 64, 64),
                                  (2, 32, 4, 3, 64, 64),
                                  (2, 128, 4, 6, 64, 64),
                                  (1, 128, 3, 4, 16, 32)):
            args = ssd_inputs(b, t * nc, h, n, p, gen, dtype, dev)
            check(f"ssd_scan B={b} S={t * nc} T={t} H={h} N={n} P={p}",
                  *scan(args, t), dtype)
        # chunks 1-2 of a 3-chunk sequence, as views with its batch stride
        args = ssd_inputs(2, 384, 6, 64, 64, gen, dtype, dev)
        check("ssd_scan views S=256 of 384",
              *scan([a[:, 128:] for a in args[:4]] + [args[4]], 128), dtype)
        # every operand one element off a 16-byte boundary
        args = ssd_inputs(2, 256, 4, 64, 64, gen, dtype, dev)
        check("ssd_scan misaligned S=256",
              ssd_scan(*map(misaligned_tensor, args), chunk=128),
              ssd_scan(*args, chunk=128, use_kernel="ref"), dtype)
    return checked


def tree_bytes(tree) -> tuple[int, int]:
    """(elements, bytes) of every tensor in a nested dict."""
    if isinstance(tree, dict):
        parts = [tree_bytes(v) for v in tree.values()]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)
    return tree.numel(), tensor_bytes(tree)


def cut_depth(cfg, params, groups: int):
    """The first `groups` groups and the tail of a Zamba2 model: the config
    and views of the same parameters (no copy)."""
    import dataclasses

    from repro_torch.models.model import _layer

    period = cfg.hybrid_attn_period
    tail = params["tail_layers"]["in_proj"]["w"].shape[0]
    cut = dict(params, layers=_layer(params["layers"],
                                     slice(0, groups * period)))
    return dataclasses.replace(cfg, n_layers=groups * period + tail), cut


def logits_check(name, got, want, shape) -> tuple[float, float]:
    """Shape, finiteness and max error of `got` over the largest |want|."""
    import torch

    for lg in (got, want):
        if tuple(lg.shape) != shape or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{name}: logits {tuple(lg.shape)} (want "
                                 f"{shape}) or not finite")
    err = float((got - want).abs().max())
    return err, err / float(want.abs().max())


def chunk_witness(cfg, params, batch, want, shape) -> tuple[float, float]:
    """The plain SSD with chunks of 64 against `want`, the plain SSD with the
    config's chunks of 128: the same function summed in another order, so
    its error is what rounding alone does to the logits at this depth."""
    import dataclasses

    from repro_torch.serving.decode import prefill

    half = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk=cfg.ssm.chunk // 2))
    _, logits = prefill(params, batch, half, use_kernel="ref")
    return logits_check(f"{cfg.n_layers}-layer plain prefill, chunk "
                        f"{half.ssm.chunk}", logits, want, shape)


def layerwise_ssd(cfg, params, tokens) -> tuple[float, int]:
    """Every Mamba2 layer of the full-depth prefill, on the input that the
    K5 path gave it, with K5 and with the plain SSD chunk, in the
    parameters' type; the walk is _zamba_forward's. Returns (largest rel err
    of a layer's output, layers checked)."""
    from repro_torch.models import model as MDL
    from repro_torch.models.layers import mamba2 as M
    from repro_torch.models.layers.common import embed

    worst, checked = 0.0, 0

    def mamba(lp, x):
        nonlocal worst, checked
        y = M.mamba2_block(lp, x, cfg.ssm, use_kernel="auto")[0]
        want = M.mamba2_block(lp, x, cfg.ssm, use_kernel="ref")[0]
        worst = max(worst, rel_err(y, want)[1])
        checked += 1
        return y

    x = embed(params["embed"], tokens)
    period = cfg.hybrid_attn_period
    for g in range(params["layers"]["in_proj"]["w"].shape[0] // period):
        for j in range(period):
            x = mamba(MDL._layer(params["layers"], g * period + j), x)
        x = MDL._shared_attn_block(params["shared_attn"], x, cfg)[0]
    for j in range(params["tail_layers"]["in_proj"]["w"].shape[0]):
        x = mamba(MDL._layer(params["tail_layers"], j), x)
    return worst, checked


def lm_prefill(dev) -> dict:
    """Phase 8: the Zamba2-7B prefill at full width and depth."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import registry
    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import prefill
    from repro_torch.training.tree import cast_tree

    cfg = registry.get(LM_ARCH)
    t0 = time.perf_counter()
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    params["embed"]["table"].mul_(EMBED_SCALE)
    torch.cuda.synchronize()
    nparams, nbytes = tree_bytes(params)
    phase("lm params", t0, arch=cfg.name, layers=cfg.n_layers,
          d_model=cfg.d_model, params=nparams, f32_bytes=nbytes)

    bsz, seq = 2, 4096
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (bsz, seq), generator=gen,
                           device=dev)
    batch = {"tokens": tokens}
    shape = (bsz, seq, cfg.padded_vocab)
    want_launches = cfg.n_layers      # one K5 launch per Mamba2 layer
    t0 = time.perf_counter()
    kernels.reset_launches()
    next_k, logits_k = prefill(params, batch, cfg, use_kernel="auto")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["ssd_chunk"] != want_launches:
        raise AssertionError(f"the prefill launched ssd_chunk "
                             f"{launches['ssd_chunk']} times, expected "
                             f"{want_launches}")
    phase("lm prefill f32 kernel", t0, tokens=f"{bsz}x{seq}",
          launches=json.dumps(launches), argmax=next_k.tolist())
    t0 = time.perf_counter()
    next_r, logits_r = prefill(params, batch, cfg, use_kernel="ref")
    torch.cuda.synchronize()
    if kernels.LAUNCHES != launches:
        raise AssertionError("the plain prefill launched a kernel")
    err, rel = logits_check("81-layer prefill", logits_k, logits_r, shape)
    phase("lm prefill f32 plain", t0, argmax=next_r.tolist(),
          logits_max_abs_err=f"{err:.3e}", rel=f"{rel:.3e}",
          note="random layers amplify any rounding difference; gated per "
               "layer and at 15 layers below")
    del logits_k
    t0 = time.perf_counter()
    err, rel = chunk_witness(cfg, params, batch, logits_r, shape)
    phase("lm prefill f32 witness", t0, pair="plain chunk 64 vs plain "
          "chunk 128", logits_max_abs_err=f"{err:.3e}", rel=f"{rel:.3e}")
    del logits_r

    t0 = time.perf_counter()
    worst, checked = layerwise_ssd(cfg, params, tokens)
    if not worst <= LAYER_TOL:
        raise AssertionError(f"a Mamba2 layer with K5 against the plain SSD: "
                             f"rel err {worst:.3e} > {LAYER_TOL:.0e}")
    phase("lm prefill f32 per layer", t0, layers=checked,
          worst_rel_err=f"{worst:.3e}")

    t0 = time.perf_counter()
    cfg15, params15 = cut_depth(cfg, params, 2)
    kernels.reset_launches()
    next_k, logits_k = prefill(params15, batch, cfg15, use_kernel="auto")
    k5 = kernels.LAUNCHES["ssd_chunk"]
    next_r, logits_r = prefill(params15, batch, cfg15, use_kernel="ref")
    torch.cuda.synchronize()
    if k5 != cfg15.n_layers \
            or kernels.LAUNCHES["ssd_chunk"] != k5:
        raise AssertionError(f"the 15-layer prefills launched ssd_chunk "
                             f"{kernels.LAUNCHES['ssd_chunk']} times")
    err, rel = logits_check("15-layer prefill", logits_k, logits_r, shape)
    if not rel <= LM_TOL:
        raise AssertionError(f"15-layer prefill logits, K5 against the "
                             f"plain SSD: rel err {rel:.3e} > {LM_TOL:.0e}")
    _, w_rel = chunk_witness(cfg15, params15, batch, logits_r, shape)
    phase(f"lm prefill f32 {cfg15.n_layers} layers", t0, launches=k5,
          argmax_kernel=next_k.tolist(), argmax_plain=next_r.tolist(),
          logits_max_abs_err=f"{err:.3e}", rel=f"{rel:.3e}",
          witness_rel=f"{w_rel:.3e}")
    del logits_k, logits_r

    t0 = time.perf_counter()
    params_bf = cast_tree(params, torch.bfloat16)
    worst, checked = layerwise_ssd(cfg, params_bf, tokens)
    if not worst <= KERNEL_TOL["bfloat16"]:
        raise AssertionError(f"a bf16 Mamba2 layer with K5 against the plain "
                             f"SSD: rel err {worst:.3e} > "
                             f"{KERNEL_TOL['bfloat16']:.0e}")
    phase("lm prefill bf16 per layer", t0, layers=checked,
          worst_rel_err=f"{worst:.3e}")

    t0 = time.perf_counter()
    kernels.reset_launches()
    prefill(params_bf, batch, cfg)                 # warm-up
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(5)]
    torch.cuda.reset_peak_memory_stats()
    for start, end in ev:
        start.record()
        next_b, _ = prefill(params_bf, batch, cfg)
        end.record()
    torch.cuda.synchronize()
    runs = [s.elapsed_time(e) for s, e in ev]
    ms = float(np.median(runs))
    phase("lm prefill bf16 timed", t0, ms=f"{ms:.3f}",
          runs_ms=json.dumps([round(r, 3) for r in runs]),
          tokens_per_s=f"{bsz * seq / (ms / 1e3):.1f}",
          ssd_launches_per_prefill=kernels.LAUNCHES["ssd_chunk"] / 6,
          argmax=next_b.tolist(),
          peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    t0 = time.perf_counter()
    profile_call("bf16 prefill", lambda: prefill(params_bf, batch, cfg))
    phase("lm prefill bf16 profiled", t0)
    return {"cfg": cfg, "params": params, "params_bf": params_bf,
            "tokens": tokens, "launches": launches["ssd_chunk"],
            "prefill_bf16_ms": ms}


def kernel_group(name: str) -> str:
    for group, keys in (("ssd_chunk (K5)", ("ssd_scan_",)),
                        ("nccl", ("nccl",)),
                        ("matmul", ("gemm", "nvjet", "xmma", "gemv")),
                        ("copy", ("copy",)),
                        ("elementwise", ("elementwise",)),
                        ("reduce", ("reduce",))):
        if any(k in name for k in keys):
            return group
    return "other"


def profile_call(label: str, fn):
    """fn() once under torch.profiler: device busy time against the wall
    time of the same call (CUDA events), device time by kernel group, and
    the kernels that take the most of it. Returns what it prints (None
    when the trace holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    if not kernels:
        print(f"[profile] {label}: the trace holds no device time: not "
              f"measured", flush=True)
        return None
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    groups: dict = {}
    for e in kernels:
        g = groups.setdefault(kernel_group(e.key), {"calls": 0, "ms": 0.0})
        g["calls"] += e.count
        g["ms"] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    summary = {
        "wall_ms": wall, "device_busy_ms": busy,
        "idle_share": 1 - busy / wall, "groups": groups,
        "launches": sum(g["calls"] for g in groups.values()),
        "top": [{"kernel": e.key[:80], "calls": e.count,
                 "ms": e.self_device_time_total / 1e3} for e in top]}
    print(f"[profile] {label}: " + json.dumps(summary), flush=True)
    return summary


def decode_vs_prefill(cfg, params, toks) -> tuple[int, float, float]:
    """Decode `toks` one by one through the cache; hold the last step's
    logits against a prefill over the same tokens. Returns (logits off by
    more than rtol = atol = DECODE_TOL, max abs err, max |logit|)."""
    import torch

    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import prefill

    _, full = prefill(params, {"tokens": toks}, cfg)
    cache = MDL.init_cache(cfg, 1, 32, dtype=torch.float32,
                           device=toks.device)
    for t in range(toks.shape[1]):
        logits, cache, _ = MDL.forward(params, {"tokens": toks[:, t:t + 1]},
                                       cfg, cache=cache)
    got, want = logits[0, 0], full[0, -1]
    diff = (got - want).abs()
    bad = int((diff > DECODE_TOL + DECODE_TOL * want.abs()).sum())
    return bad, float(diff.max()), float(want.abs().max())


def lm_decode(dev, lm: dict) -> None:
    """Phase 9: greedy generate in f32, then decode through the cache
    against the prefill."""
    import torch

    from repro_torch import kernels
    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import generate, make_serve_step

    cfg, params = lm["cfg"], lm["params"]
    gen = torch.Generator(device=dev).manual_seed(2)
    bsz, prompt_len, new = 4, 16, 32
    prompt = torch.randint(0, cfg.vocab, (bsz, prompt_len), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, params, prompt, new,
                   cache_len=prompt_len + new + 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if tuple(out.shape) != (bsz, new) or not bool(
            ((out >= 0) & (out < cfg.padded_vocab)).all()):
        raise AssertionError(f"generate gave {tuple(out.shape)} tokens "
                             f"outside the vocabulary")
    steps = prompt_len + new - 1
    phase("lm decode generate f32", t0, batch=bsz, prompt=prompt_len,
          new_tokens=new, steps=steps,
          tokens_per_s=f"{bsz * new / dt:.2f}",
          ms_per_step=f"{dt / steps * 1e3:.2f}", sample=out[0].tolist())

    t0 = time.perf_counter()
    step = make_serve_step(cfg, compute_dtype=torch.float32)
    cache = MDL.init_cache(cfg, bsz, prompt_len + 2, dtype=torch.float32,
                           device=dev)
    for t in range(prompt_len):
        tok, cache = step(params, {"tokens": prompt[:, t:t + 1]}, cache)
    profile_call("f32 decode step", lambda: step(
        params, {"tokens": tok[:, None]}, cache))
    phase("lm decode step profiled", t0, batch=bsz, position=prompt_len)

    toks = torch.randint(0, cfg.vocab, (1, 17), generator=gen, device=dev)
    t0 = time.perf_counter()
    cfg15, params15 = cut_depth(cfg, params, 2)
    kernels.reset_launches()
    bad, err, top = decode_vs_prefill(cfg15, params15, toks)
    if bad:
        raise AssertionError(f"{cfg15.n_layers}-layer decode through the "
                             f"cache: {bad} "
                             f"logits off the prefill's by more than rtol = "
                             f"atol = {DECODE_TOL}")
    phase(f"lm decode vs prefill {cfg15.n_layers} layers", t0, tokens=17,
          prefill_ssd_launches=kernels.LAUNCHES["ssd_chunk"],
          max_abs_err=f"{err:.3e}", max_abs_logit=f"{top:.3e}")
    t0 = time.perf_counter()
    bad, err, top = decode_vs_prefill(cfg, params, toks)
    phase(f"lm decode vs prefill {cfg.n_layers} layers", t0, tokens=17,
          logits_off=bad, max_abs_err=f"{err:.3e}",
          max_abs_logit=f"{top:.3e}", note="not gated, as the full-depth "
          "prefill comparison")


def ssd_main_inputs(cfg, params, tokens):
    """The first Mamba2 layer's SSD operands for the whole prefill (la, xw,
    B, C over S = 4096 and the zero state it starts from), and its second
    chunk alone with the state the kernel left after the first."""
    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk
    from repro_torch.models.layers import mamba2 as M
    from repro_torch.models.layers.common import embed
    from repro_torch.models.model import _layer

    lp = _layer(params["layers"], 0)
    _, xh, dt, b_mat, c_mat, _ = M._mix(lp, embed(params["embed"], tokens),
                                        cfg.ssm)
    la, xw = M._discretize(xh, dt, lp["a_log"])
    t = cfg.ssm.chunk
    bsz, _, h, p = xh.shape
    zero = xh.new_zeros((bsz, h, cfg.ssm.d_state, p))
    layer = [la, xw, b_mat.contiguous(), c_mat.contiguous(), zero]
    first = [a[:, :t].contiguous() for a in layer[:4]]
    _, state = ssd_chunk(*first, zero)
    chunk = [a[:, t:2 * t].contiguous() for a in layer[:4]] + [state]
    return layer, chunk


def ssd_flops(bsz: int, s: int, t: int, h: int, n: int, p: int) -> int:
    """The least work of the SSD over S steps in chunks of T: per chunk C·Bᵀ
    once per batch row (B and C do not depend on the head) and, like the
    decayed product with xw, on and below the diagonal only; C·state and
    the state update in full."""
    return s // t * (bsz * t * (t + 1) * n
                     + bsz * h * (t * (t + 1) * p + 4 * t * n * p))


def ssd_times(lm: dict) -> tuple[dict, list]:
    """Phase 10: K5 at the main-path shape, bf16 (the row) and f32: one
    layer's whole scan (one launch), and one chunk beside it."""
    import torch

    from repro_torch.kernels.ssd_chunk.kernel import (ssd_chunk,
                                                      ssd_chunk_plain)
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan

    cfg = lm["cfg"]
    t = cfg.ssm.chunk
    out, f32_args = {}, None
    for name, params in (("bfloat16", lm["params_bf"]),
                         ("float32", lm["params"])):
        layer, chunk = ssd_main_inputs(cfg, params, lm["tokens"])
        if name == "float32":
            f32_args = (layer, chunk)
        rate = BF16_FLOPS_PER_S if name == "bfloat16" else FP32_FLOPS_PER_S
        tol = KERNEL_TOL[name]
        rows = {}
        for part, args, kern, plain, batch in (
                ("layer", layer,
                 lambda a=layer: ssd_scan(*a, chunk=t),
                 lambda a=layer: ssd_scan(*a, chunk=t, use_kernel="ref"), 5),
                ("chunk", chunk, lambda a=chunk: ssd_chunk(*a),
                 lambda a=chunk: ssd_chunk_plain(*a), BATCH)):
            got = kern()
            abs_err, rel = ssd_errors(got, plain())
            if not rel <= tol:
                raise AssertionError(f"ssd {part} {name}: kernel vs plain rel "
                                     f"err {rel:.3e} > {tol:.0e} at the "
                                     f"main-path shape")
            bsz, s, h, p = args[1].shape
            n = args[2].shape[-1]
            nbytes = tensor_bytes(*args, *got)
            flops = ssd_flops(bsz, s, t, h, n, p)
            bms, by = bound_ms(nbytes, flops, rate)
            row = {"ms": time_ms(kern), "plain_ms": time_ms(plain, batch),
                   "bound_ms": bms, "bound_by": by, "max_abs_err": abs_err,
                   "rel_err": rel, "bytes": nbytes, "flops": flops}
            rows[part] = row
            print(f"[kernel] ssd_chunk {name} {part} B={bsz} S={s} T={t} "
                  f"H={h} N={n} P={p} rel_err={rel:.2e} ms={row['ms']:.4f} "
                  f"plain_ms={row['plain_ms']:.4f} library_ms=none "
                  f"bound_ms={bms:.4f} ({by}, {nbytes} B, {flops} flop) "
                  f"launches={lm['launches']} (lm prefill f32, B=2, "
                  f"S=4096)", flush=True)
            del got
        out[name] = dict(rows["layer"], chunk=rows["chunk"])
    bf = out["bfloat16"]
    row = {"name": "ssd_chunk", "route": "cuda", "source": SSD_SOURCE,
           "replaces": KERNELS["ssd_chunk"], "launches": lm["launches"],
           "launches_path": "lm prefill f32, B=2, S=4096",
           "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
           "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
           "bound_by": bf["bound_by"], "library_ms": None,
           "dtype": "bfloat16", "per": "layer (S=4096, 32 chunks)",
           "chunk": bf["chunk"], "float32": out["float32"]}
    return row, f32_args


def ssd_control(args) -> None:
    """Phase 11: K5 with the last time step of xw zeroed, and K5's chain
    with the carried state zeroed between chunks, must each fail the check
    against the intact plain result."""
    import torch

    from repro_torch.kernels.ssd_chunk.kernel import (ssd_chunk,
                                                      ssd_chunk_plain)
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan

    layer, chunk = args
    tol = KERNEL_TOL["float32"]
    la, xw, b_mat, c_mat, state = chunk
    bad = xw.clone()
    bad[:, -1] = 0
    _, rel = ssd_errors(ssd_chunk(la, bad, b_mat, c_mat, state),
                        ssd_chunk_plain(*chunk))
    if not rel > tol:
        raise AssertionError(f"ssd_chunk with xw's last step zeroed gave rel "
                             f"err {rel:.3e}, which passes {tol:.0e}")
    print(f"[control] ssd_chunk float32 with xw's last time step zeroed: "
          f"rel err {rel:.3e} > {tol:.0e}, caught", flush=True)

    t = chunk[0].shape[1]
    la, xw, b_mat, c_mat, zero = layer
    parts = [ssd_chunk(la[:, i:i + t], xw[:, i:i + t], b_mat[:, i:i + t],
                       c_mat[:, i:i + t], zero)
             for i in range(0, la.shape[1], t)]
    reset = (torch.cat([y for y, _ in parts], dim=1), parts[-1][1])
    _, rel = ssd_errors(reset, ssd_scan(*layer, chunk=t, use_kernel="ref"))
    if not rel > tol:
        raise AssertionError(f"the scan with its state zeroed between chunks "
                             f"gave rel err {rel:.3e}, which passes "
                             f"{tol:.0e}")
    print(f"[control] ssd_scan float32 with the carried state zeroed between "
          f"chunks: rel err {rel:.3e} > {tol:.0e}, caught", flush=True)


# -- phase 12: the dense, gemma2 and MoE language-model families -----------
# Each arch at its published widths, random f32 parameters drawn from a
# seeded generator on the card: (layers run, None = all; the bf16 prefill's
# B and S; layers of the f32 decode-against-prefill check, None = all). The
# depth cuts keep the f32 draw under ~42 GB, so that it, its bf16 copy (made
# one tensor at a time) and the prefill's activations fit in 80 GB: at full
# depth command-r-plus holds 419 GB of f32 parameters, gemma2-27b 109,
# qwen3-moe 122, phi3.5-moe 168. qwen2-7b, minicpm-2b and gemma2 are cut
# further to keep the run inside its time limit (14a trains minicpm-2b at
# full depth). B x S: command-r-plus and gemma2 have a
# 256,000-entry vocabulary, whose f32 logits take 1 GB a thousand tokens
# (and unembed an f32 copy of the table), so they prefill one sequence;
# gemma2's is 8192 long, so its 4096 window binds.
LM_FAMILY_CELLS = {
    "qwen2-7b": (8, 2, 4096, None),
    "minicpm-2b": (8, 2, 4096, None),
    "command-r-plus-104b": (4, 1, 4096, 2),
    "gemma2-27b": (8, 1, 8192, 2),
    "qwen3-moe-30b-a3b": (16, 2, 4096, 2),
    "phi3.5-moe-42b-a6.6b": (8, 2, 4096, 2),
}
FAMILY_DECODE_TOKENS = 17        # decode vs prefill (MoE: 8, see below)
MOE_DECODE_TOKENS = 8            # n <= 8 <= capacity: no assignment can drop
WINDOW_TOL = 1e-4                # flash attention vs the materialized mask
WINDOW_WITNESS = 1e-2            # the same attention without the window
DISPATCH_TOL = 1e-5              # MoE sorted vs onehot, of the largest entry


def family_model(dev, arch: str):
    """The arch's config cut to its cell's depth and its f32 parameters."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models import model as MDL

    full = registry.get(arch)
    layers = LM_FAMILY_CELLS[arch][0] or full.n_layers
    cfg = dataclasses.replace(full, n_layers=layers)
    t0 = time.perf_counter()
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    nparams, nbytes = tree_bytes(params)
    phase(f"lm12 {arch} params", t0, layers=f"{layers} of {full.n_layers}",
          d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.kv_heads}",
          vocab=cfg.padded_vocab, params=nparams, f32_bytes=nbytes,
          param_count_full=full.param_count(),
          active_param_count_full=full.active_param_count())
    return cfg, params


def family_cut(cfg, params, n: int):
    """The first n layers (gemma2: n // 2 pairs; the vlm: n // period
    groups, each its period - 1 self layers and its cross layer): the
    config and views of the same parameters."""
    import dataclasses

    from repro_torch.models.model import _layer

    cut = dict(params)
    if cfg.local_global_period:
        cut["layers"] = {part: _layer(params["layers"][part],
                                      slice(0, n // 2))
                         for part in ("local", "global")}
    elif cfg.cross_attn_period:
        groups, period = n // cfg.cross_attn_period, cfg.cross_attn_period
        n = groups * period
        cut["layers"] = _layer(params["layers"],
                               slice(0, groups * (period - 1)))
        cut["cross_layers"] = _layer(params["cross_layers"],
                                     slice(0, groups))
    else:
        cut["layers"] = _layer(params["layers"], slice(0, n))
    return dataclasses.replace(cfg, n_layers=n), cut


def to_bf16(tree):
    """Every floating tensor of a nested dict cast to bf16 in place, one at a
    time, so the f32 tree is freed as the copy grows. Views of the f32
    tensors held elsewhere keep them alive: drop them first."""
    import torch

    for k, v in tree.items():
        if isinstance(v, dict):
            to_bf16(v)
        elif v.is_floating_point():
            tree[k] = v.to(torch.bfloat16)
    return tree


def family_decode_gap(cfg, params, toks,
                      extra=None) -> tuple[float, float, float]:
    """Decode `toks` one by one through an f32 cache; the last step's logits
    against a prefill over the same tokens (`extra`: inputs every call
    takes, the vlm's image_embeds). Returns (max abs err, max |logit|, the
    largest drop_frac of the prefill and the steps; 0 for a model without
    MoE)."""
    import torch

    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import prefill

    extra = extra or {}
    _, full, fm = prefill(params, {"tokens": toks, **extra}, cfg,
                          with_metrics=True)
    cache = MDL.init_cache(cfg, toks.shape[0], toks.shape[1] + 1,
                           dtype=torch.float32, device=toks.device)
    drops = [fm.get("drop_frac", 0.0)]
    with torch.no_grad():
        for t in range(toks.shape[1]):
            logits, cache, m = MDL.forward(
                params, {"tokens": toks[:, t:t + 1], **extra}, cfg,
                cache=cache)
            drops.append(m.get("drop_frac", 0.0))
    err = float((logits[:, 0] - full[:, -1]).abs().max())
    return err, float(full[:, -1].abs().max()), max(float(d) for d in drops)


def family_decode_check(dev, arch, cfg, params) -> None:
    """Decode against prefill at the cell's check depth: the gap within
    LM_TOL of the largest logit; MoE on a prompt that cannot drop, with
    drop_frac == 0 asserted on both sides. On a miss, the gap at every
    depth up to the check's is printed before the run fails."""
    import torch

    depth = LM_FAMILY_CELLS[arch][3] or cfg.n_layers
    ntok = MOE_DECODE_TOKENS if cfg.moe else FAMILY_DECODE_TOKENS
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (1, ntok), generator=gen, device=dev)
    t0 = time.perf_counter()
    cut_cfg, cut = family_cut(cfg, params, depth)
    err, top, drop = family_decode_gap(cut_cfg, cut, toks)
    if drop != 0.0:
        raise AssertionError(f"{arch} decode vs prefill: drop_frac {drop} "
                             f"on a prompt of {ntok} tokens")
    if not err <= LM_TOL * top:
        for d in range(1, depth + 1):
            if cfg.local_global_period and d % 2:
                continue
            e, t, _ = family_decode_gap(*family_cut(cfg, params, d), toks)
            print(f"[growth] {arch} decode vs prefill at {d} layers: "
                  f"max abs err {e:.3e} of max |logit| {t:.3e}", flush=True)
        raise AssertionError(f"{arch} decode vs prefill at {depth} layers: "
                             f"max abs err {err:.3e} > {LM_TOL:.0e} x "
                             f"{top:.3e}")
    phase(f"lm12 {arch} decode vs prefill f32", t0, layers=depth,
          tokens=ntok, max_abs_err=f"{err:.3e}", max_abs_logit=f"{top:.3e}",
          rel=f"{err / top:.3e}", drop_frac=drop)


def attention_ms(fn) -> tuple[float, int]:
    """fn() once with a CUDA event pair around every flash_attention call:
    (device ms between the pairs, summed; calls)."""
    import torch

    from repro_torch.models.layers import attention as A

    plain, pairs = A.flash_attention, []

    def timed(*args, **kw):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = plain(*args, **kw)
        pair[1].record()
        pairs.append(pair)
        return out

    A.flash_attention = timed
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        A.flash_attention = plain
    return sum(s.elapsed_time(e) for s, e in pairs), len(pairs)


def timed_prefill(label: str, cfg, params_bf, batch) -> float:
    """The bf16 prefill of `batch`: a warm-up (its metrics reported, its
    logits checked finite), then 5 calls each timed by CUDA events; prints
    the median in tokens/s and the peak memory, and returns the median
    ms."""
    import numpy as np
    import torch

    from repro_torch.serving.decode import prefill

    bsz, seq = next(iter(batch.values())).shape[:2]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    nxt, logits, metrics = prefill(params_bf, batch, cfg, with_metrics=True)
    if tuple(logits.shape) != (bsz, seq, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{label} bf16 prefill: logits "
                             f"{tuple(logits.shape)} or not finite")
    del logits
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(5)]
    for start, end in ev:
        start.record()
        prefill(params_bf, batch, cfg)
        end.record()
    torch.cuda.synchronize()
    runs = [s.elapsed_time(e) for s, e in ev]
    ms = float(np.median(runs))
    phase(f"{label} prefill bf16 timed", t0, layers=cfg.n_layers,
          tokens=f"{bsz}x{seq}", ms=f"{ms:.3f}",
          runs_ms=json.dumps([round(r, 3) for r in runs]),
          tokens_per_s=f"{bsz * seq / (ms / 1e3):.1f}",
          argmax=nxt.tolist(),
          peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
          **{k: f"{float(v):.6f}" for k, v in metrics.items()})
    return ms


def family_prefill(dev, arch, cfg, params_bf, profile: bool = False):
    """The bf16 prefill of the cell's B x S, timed (timed_prefill); with
    `profile`, once more under torch.profiler and once with attention
    timed."""
    import torch

    from repro_torch.serving.decode import prefill

    _, bsz, seq, _ = LM_FAMILY_CELLS[arch]
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (bsz, seq),
                                     generator=gen, device=dev)}
    ms = timed_prefill(f"lm12 {arch}", cfg, params_bf, batch)
    if profile:
        t0 = time.perf_counter()
        profile_call(f"{arch} bf16 prefill",
                     lambda: prefill(params_bf, batch, cfg))
        att, calls = attention_ms(lambda: prefill(params_bf, batch, cfg))
        phase(f"lm12 {arch} prefill bf16 profiled", t0,
              attention_ms=f"{att:.3f}", attention_calls=calls,
              attention_share=f"{att / ms:.4f}")
    return ms


def family_generate(dev, label: str, cfg, params):
    """f32 serving at full depth: generate at B = 4 (prompt 16, 32 new) in
    tokens/s, then one decode step profiled. Returns the prompt."""
    import torch

    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import generate, make_serve_step

    gen = torch.Generator(device=dev).manual_seed(2)
    bsz, prompt_len, new = 4, 16, 32
    prompt = torch.randint(0, cfg.vocab, (bsz, prompt_len), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, params, prompt, new, cache_len=prompt_len + new + 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if tuple(out.shape) != (bsz, new) or not bool(
            ((out >= 0) & (out < cfg.padded_vocab)).all()):
        raise AssertionError(f"{label} generate gave {tuple(out.shape)} "
                             f"tokens outside the vocabulary")
    steps = prompt_len + new - 1
    phase(f"{label} generate f32", t0, batch=bsz, prompt=prompt_len,
          new_tokens=new, steps=steps, tokens_per_s=f"{bsz * new / dt:.2f}",
          ms_per_step=f"{dt / steps * 1e3:.2f}", sample=out[0].tolist())

    t0 = time.perf_counter()
    step = make_serve_step(cfg, compute_dtype=torch.float32)
    cache = MDL.init_cache(cfg, bsz, prompt_len + 2, dtype=torch.float32,
                           device=dev)
    with torch.no_grad():
        for t in range(prompt_len):
            tok, cache = step(params, {"tokens": prompt[:, t:t + 1]}, cache)
        profile_call(f"{label} f32 decode step", lambda: step(
            params, {"tokens": tok[:, None]}, cache))
    del cache
    phase(f"{label} decode step profiled", t0, batch=bsz,
          position=prompt_len)
    return prompt


def float64_gate(label: str, cfg, params, batch) -> None:
    """The f32 forward of the first 2 layers over `batch` against the same
    forward in float64 on the card, within VERIFY_TOL of the largest
    logit."""
    import torch

    from repro_torch.serving.decode import prefill
    from repro_torch.training.tree import cast_tree

    t0 = time.perf_counter()
    cut_cfg, cut = family_cut(cfg, params, 2)
    _, got = prefill(cut, batch, cut_cfg)
    _, want = prefill(cast_tree(cut, torch.float64), batch, cut_cfg)
    if want.dtype != torch.float64:
        raise AssertionError(f"the float64 forward gave {want.dtype} logits")
    err, rel = rel_err(got, want)
    if not rel <= VERIFY_TOL:
        raise AssertionError(f"{label} 2-layer f32 forward against float64: "
                             f"rel err {rel:.3e} > {VERIFY_TOL:.0e}")
    phase(f"{label} f32 vs float64", t0, layers=2,
          tokens=next(iter(batch.values())).shape[1],
          max_abs_err=f"{err:.3e}", rel=f"{rel:.3e}")


def qwen2_serving(dev, arch, cfg, params) -> None:
    """12a's f32 serving: generate and one decode step profiled
    (family_generate), and the 2-layer forward against the same in float64
    on the card."""
    prompt = family_generate(dev, f"lm12 {arch}", cfg, params)
    float64_gate(f"lm12 {arch}", cfg, params,
                 {"tokens": prompt[:1, :FAMILY_DECODE_TOKENS]})


def materialized_attention(q, k, v, window, softcap):
    """Causal softmax attention with every score materialized, in f32, one
    KV head (and its query group) at a time; the window and softcap as the
    reference applies them."""
    import math

    import torch

    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for j in range(kvh):
        qj = q[:, :, j * g:(j + 1) * g].float().permute(0, 2, 1, 3)
        kj = k[:, :, j].float()
        sc = (qj @ kj[:, None].transpose(-1, -2)) / math.sqrt(d)
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, :, j * g:(j + 1) * g] = (p @ v[:, :, j].float()[:, None]
                                        ).permute(0, 2, 1, 3)
        del sc, p
    return out


def gemma2_window(dev, arch, cfg, params) -> None:
    """12d: the first local layer's attention at S = 8192 (q, k and v from
    its own projections of the embedded tokens, in f32) through the port's
    flash_attention against materialized_attention, within WINDOW_TOL of
    the largest entry; and, as the witness, the same without the window,
    which must move the positions the window binds (q >= window) by more
    than WINDOW_WITNESS of their largest entry."""
    import math

    import torch

    from repro_torch.models.layers import attention as A
    from repro_torch.models.layers.common import (apply_rope, embed, linear,
                                                  rmsnorm)
    from repro_torch.models.model import _layer

    _, bsz, seq, _ = LM_FAMILY_CELLS[arch]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (bsz, seq), generator=gen, device=dev)
    lp = _layer(params["layers"]["local"], 0)
    hd = cfg.resolved_head_dim
    with torch.no_grad():
        x = embed(params["embed"], toks) * math.sqrt(cfg.d_model)
        h = rmsnorm(lp["attn_norm"], x, cfg.rmsnorm_eps)
        pos = torch.arange(seq, device=dev).expand(bsz, seq)
        q, k, v = (linear(lp["attn"][w], h).reshape(bsz, seq, -1, hd)
                   for w in ("wq", "wk", "wv"))
        q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(
            k, pos, cfg.rope_theta)
        del x, h
        got = A.flash_attention(q, k, v, causal=True,
                                window=cfg.sliding_window,
                                softcap=cfg.attn_softcap)
        want = materialized_attention(q, k, v, cfg.sliding_window,
                                      cfg.attn_softcap)
        err, rel = rel_err(got, want)
        if not rel <= WINDOW_TOL:
            raise AssertionError(f"{arch} windowed flash_attention at S = "
                                 f"{seq}: rel err {rel:.3e} > "
                                 f"{WINDOW_TOL:.0e}")
        bound = slice(cfg.sliding_window, None)
        unwindowed = A.flash_attention(q, k, v, causal=True, window=None,
                                       softcap=cfg.attn_softcap)
        _, moved = rel_err(unwindowed[:, bound], want[:, bound])
        if not moved > WINDOW_WITNESS:
            raise AssertionError(f"{arch}: the attention without its window "
                                 f"moved the bound positions by only "
                                 f"{moved:.3e}")
    phase(f"lm12 {arch} local attention S={seq}", t0,
          window=cfg.sliding_window, softcap=cfg.attn_softcap,
          max_abs_err=f"{err:.3e}", rel=f"{rel:.3e}",
          witness_rel=f"{moved:.3e}")


def moe_layer_inputs(cfg, params, toks) -> list:
    """The input of every MoE layer in an f32 forward over `toks` (each
    moe_layer call recorded on its way through)."""
    import torch

    from repro_torch.models import model as MDL
    from repro_torch.models.layers import moe as MOE

    plain, inputs = MOE.moe_layer, []

    def record(p, x, moe_cfg, **kw):
        inputs.append(x)
        return plain(p, x, moe_cfg, **kw)

    MOE.moe_layer = record
    try:
        with torch.no_grad():
            MDL.forward(params, {"tokens": toks}, cfg)
    finally:
        MOE.moe_layer = plain
    return inputs


def moe_dispatch_check(dev, arch, cfg, params) -> None:
    """12e/f: every MoE layer of the cut model on its own input in an f32
    forward over the cell's B x S tokens, with the sorted and the onehot
    dispatch: output within DISPATCH_TOL of the largest entry, every metric
    equal. The random routers of the deeper layers send most tokens to a
    few experts, so the drop path runs too (a layer must drop)."""
    import dataclasses

    import torch

    from repro_torch.models.layers import moe as MOE
    from repro_torch.models.model import _layer

    _, bsz, seq, _ = LM_FAMILY_CELLS[arch]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (bsz, seq), generator=gen, device=dev)
    inputs = moe_layer_inputs(cfg, params, toks)
    worst, drops, lis, ms = 0.0, [], [], {"sorted": 0.0, "onehot": 0.0}
    with torch.no_grad():
        for i, h in enumerate(inputs):
            lp = _layer(params["layers"]["moe"], i)
            out = {}
            for dispatch in ("sorted", "onehot"):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                y, m = MOE.moe_layer(lp, h, dataclasses.replace(
                    cfg.moe, dispatch=dispatch))
                end.record()
                torch.cuda.synchronize()
                ms[dispatch] += start.elapsed_time(end)
                out[dispatch] = y, {k: float(v) for k, v in m.items()}
            (ys, m_s), (yo, m_o) = out["sorted"], out["onehot"]
            _, rel = rel_err(yo, ys)
            if not rel <= DISPATCH_TOL or m_s != m_o:
                raise AssertionError(
                    f"{arch} MoE layer {i}, sorted vs onehot: rel err "
                    f"{rel:.3e} (tol {DISPATCH_TOL:.0e}); metrics {m_s} vs "
                    f"{m_o}")
            worst = max(worst, rel)
            drops.append(round(m_s["drop_frac"], 6))
            lis.append(round(m_s["router_li"], 4))
    if not max(drops) > 0:
        raise AssertionError(f"{arch}: no MoE layer dropped an assignment; "
                             f"the drop path went unchecked")
    phase(f"lm12 {arch} moe sorted vs onehot f32", t0, layers=len(inputs),
          tokens=bsz * seq, experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
          capacity=MOE.capacity(bsz * seq, cfg.moe),
          worst_rel=f"{worst:.3e}", drop_frac=json.dumps(drops),
          router_li=json.dumps(lis), sorted_ms=f"{ms['sorted']:.3f}",
          onehot_ms=f"{ms['onehot']:.3f}")


def lm_families(dev) -> None:
    """Phase 12: each family's architectures at full width, one at a time,
    every model freed before the next."""
    import torch

    t_phase = time.perf_counter()
    for arch in LM_FAMILY_CELLS:
        t_arch = time.perf_counter()
        cfg, params = family_model(dev, arch)
        family_decode_check(dev, arch, cfg, params)
        if arch == "qwen2-7b":
            qwen2_serving(dev, arch, cfg, params)
        if cfg.local_global_period:
            gemma2_window(dev, arch, cfg, params)
        if cfg.moe:
            moe_dispatch_check(dev, arch, cfg, params)
        t0 = time.perf_counter()
        params_bf = to_bf16(params)
        torch.cuda.synchronize()
        phase(f"lm12 {arch} bf16", t0,
              allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
        family_prefill(dev, arch, cfg, params_bf,
                       profile=arch == "qwen2-7b")
        del params, params_bf
        gc.collect()
        torch.cuda.empty_cache()
        phase(f"lm12 {arch}", t_arch)
    phase("lm families", t_phase)


# phase 13: arch -> (its bf16 prefill's B x S (hubert: 30 s clips at its
# 20 ms frame rate), the layers that prefill is timed and profiled at).
# Every arch runs its gates at full width and depth; the timed and
# profiled prefill is cut in depth to keep the run inside its time limit
# (the vlm to 2 of its 8 groups). rwkv6's at 2 of its 32 layers is also
# what the profiler can take: the WKV chunk loop launches ~142k kernels at
# full depth, whose trace takes it ~2 minutes to process on an H100 host.
LM_TAIL_CELLS = {
    "rwkv6-7b": (2, 4096, 2),
    "llama-3.2-vision-11b": (2, 4096, 10),
    "hubert-xlarge": (8, 1500, 12),
}
FLOAT64_TOKENS = 100             # several RWKV chunks of 32, plus padding
VLM_GATE = 0.5                   # the cross layers' gate (zero at init)
GATE_WITNESS = 1e-2              # the vlm's logits with the gates back at 0


def tail_model(dev, arch: str):
    """The arch at full width and depth, its f32 parameters on the card."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import model as MDL

    cfg = registry.get(arch)
    t0 = time.perf_counter()
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    nparams, nbytes = tree_bytes(params)
    phase(f"lm13 {arch} params", t0, layers=cfg.n_layers,
          d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.kv_heads}",
          vocab=cfg.padded_vocab, params=nparams, f32_bytes=nbytes,
          param_count_full=cfg.param_count())
    return cfg, params


def tail_inputs(dev, cfg, bsz: int, seq: int, seed: int) -> dict:
    """The forward batch of the arch from a seeded generator on the card:
    tokens, or frame embeddings (hubert); the vlm's image embeddings."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.embed_inputs:
        batch = {"tokens": torch.randint(0, cfg.vocab, (bsz, seq),
                                         generator=gen, device=dev)}
    else:
        batch = {"embeds": torch.randn((bsz, seq, cfg.d_model),
                                       generator=gen, device=dev)}
    if cfg.cross_attn_period:
        batch["image_embeds"] = torch.randn(
            (bsz, cfg.num_image_tokens, cfg.d_model), generator=gen,
            device=dev)
    return batch


def tail_decode_gate(label: str, cfg, params, batch) -> None:
    """Decode through an f32 cache against an f32 prefill over the same
    tokens at full depth, within LM_TOL of the largest logit."""
    t0 = time.perf_counter()
    extra = {k: v for k, v in batch.items() if k == "image_embeds"}
    err, top, _ = family_decode_gap(cfg, params, batch["tokens"], extra)
    if not err <= LM_TOL * top:
        raise AssertionError(f"{label} decode vs prefill at {cfg.n_layers} "
                             f"layers: max abs err {err:.3e} > "
                             f"{LM_TOL:.0e} x {top:.3e}")
    phase(f"{label} decode vs prefill f32", t0, layers=cfg.n_layers,
          tokens=batch["tokens"].shape[1], max_abs_err=f"{err:.3e}",
          max_abs_logit=f"{top:.3e}", rel=f"{err / top:.3e}")


def gate_witness(label: str, cfg, params, batch) -> None:
    """The vlm's f32 prefill with its gates at VLM_GATE and at 0: the
    cross-attention must move the logits by more than GATE_WITNESS of
    their largest entry."""
    from repro_torch.serving.decode import prefill

    t0 = time.perf_counter()
    gate = params["cross_layers"]["gate"]
    _, on = prefill(params, batch, cfg)
    saved = gate.clone()
    gate.zero_()
    _, off = prefill(params, batch, cfg)
    gate.copy_(saved)
    _, moved = rel_err(off, on)
    if not moved > GATE_WITNESS:
        raise AssertionError(f"{label}: the gates at 0 moved the logits by "
                             f"only {moved:.3e}")
    phase(f"{label} gate witness", t0, gate=float(saved[0]),
          tokens=batch["tokens"].shape[1], rel_moved=f"{moved:.3e}")


def bidirectional_witness(dev, label: str, cfg, params) -> None:
    """Redrawing the last frame must move the first frame's logits (the
    encoder attends both ways); the same forward made causal is printed
    beside it, where the first frame cannot see the last."""
    import dataclasses

    import torch

    from repro_torch.serving.decode import prefill

    t0 = time.perf_counter()
    batch = tail_inputs(dev, cfg, 1, FLOAT64_TOKENS, seed=5)
    moved = batch["embeds"].clone()
    moved[:, -1] = torch.randn(moved[:, -1].shape, device=dev,
                               generator=torch.Generator(
                                   device=dev).manual_seed(6))
    causal = dataclasses.replace(cfg, encoder_only=False)
    first = {}
    for name, c in (("bidirectional", cfg), ("causal", causal)):
        first[name] = [prefill(params, {"embeds": e}, c)[1][:, 0]
                       for e in (batch["embeds"], moved)]
    _, rel = rel_err(*first["bidirectional"])
    if not rel > 0:
        raise AssertionError(f"{label}: redrawing the last frame left the "
                             f"first frame's logits unchanged")
    a, b = first["causal"]
    phase(f"{label} bidirectional witness", t0, layers=cfg.n_layers,
          frames=FLOAT64_TOKENS, first_frame_rel_moved=f"{rel:.3e}",
          causal_first_frame_moved=f"{float((a - b).abs().max()):.3e}")


def lm_tail(dev) -> None:
    """Phase 13: rwkv6-7b, llama-3.2-vision-11b and hubert-xlarge at full
    width and depth, one at a time, every model freed before the next. No
    SpMV or SSD kernel may launch."""
    import torch

    from repro_torch import kernels
    from repro_torch.serving.decode import prefill

    t_phase = time.perf_counter()
    before = dict(kernels.LAUNCHES)
    for arch, (bsz, seq, timed_layers) in LM_TAIL_CELLS.items():
        t_arch = time.perf_counter()
        label = f"lm13 {arch}"
        cfg, params = tail_model(dev, arch)
        if cfg.cross_attn_period:
            params["cross_layers"]["gate"].fill_(VLM_GATE)
        if not cfg.encoder_only:
            batch = tail_inputs(dev, cfg, 1, FAMILY_DECODE_TOKENS, seed=3)
            tail_decode_gate(label, cfg, params, batch)
        if cfg.cross_attn_period:
            gate_witness(label, cfg, params, batch)
        else:
            float64_gate(label, cfg, params,
                         tail_inputs(dev, cfg, 1, FLOAT64_TOKENS, seed=4))
        if cfg.encoder_only:
            bidirectional_witness(dev, label, cfg, params)
        if cfg.rwkv:
            family_generate(dev, label, cfg, params)
        t0 = time.perf_counter()
        params_bf = to_bf16(params)
        torch.cuda.synchronize()
        phase(f"{label} bf16", t0,
              allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
        batch = tail_inputs(dev, cfg, bsz, seq, seed=1)
        prof_cfg, prof_params = family_cut(cfg, params_bf, timed_layers)
        timed_prefill(label, prof_cfg, prof_params, batch)
        t0 = time.perf_counter()
        prof = profile_call(f"{label} bf16 prefill",
                            lambda: prefill(prof_params, batch, prof_cfg))
        phase(f"{label} prefill bf16 profiled", t0,
              layers=prof_cfg.n_layers, **({"idle_share": "not measured"}
                                           if prof is None else {
                  "idle_share": f"{prof['idle_share']:.4f}",
                  "device_busy_ms": f"{prof['device_busy_ms']:.3f}",
                  "wall_ms": f"{prof['wall_ms']:.3f}",
                  "launches": prof["launches"]}))
        del prof_params
        del params, params_bf, batch
        gc.collect()
        torch.cuda.empty_cache()
        phase(label, t_arch)
    if kernels.LAUNCHES != before:
        raise AssertionError(f"phase 13 launched a kernel: {before} -> "
                             f"{dict(kernels.LAUNCHES)}")
    phase("lm tail families", t_phase)


# phase 14: training. 14a minicpm-2b at full width and depth (the model the
# reference's WSD schedule is named for), B x S = 1 x 4096, its context
TRAIN_ARCH = "minicpm-2b"
TRAIN_BATCH, TRAIN_SEQ = 1, 4096
TRAIN_TIMED_STEPS = 3            # after one warm-up step; median taken
                                 # (3 keeps the run inside its limit)
TRAIN_SPLIT_STEPS = 1            # then composed of the step's two parts
TRAIN_PROFILE_LAYERS = 2         # the profiled step's depth (trace cost)
TRAIN_OPT = {"warmup_steps": 2, "total_steps": 10, "schedule": "wsd"}
# 14b: minicpm-2b at 2 layers, 1 x 256 tokens, f32 against float64
GATE_LAYERS, GATE_SEQ = 2, 256
GATE_LOSS_TOL = 1e-5             # relative
GATE_GRAD_TOL = 1e-4             # of each leaf's largest float64 entry
GATE_ADAM_TOL = 1e-5             # new parameters, of each leaf's largest
# 14c: zamba2-7b cut to one group and its tail, 1 x 1024, f32
ZAMBA_TRAIN_SEQ = 1024
ZAMBA_LOSS_TOL = 1e-4            # K5 against the plain SSD, relative
ZAMBA_GRAD_TOL = 1e-3            # of each leaf's largest entry
# 14d: the training driver on small_lm_config
LOOP_STEPS, LOOP_CRASH, LOOP_EVERY = 20, 10, 10
LOOP_BATCH, LOOP_SEQ = 8, 256
LOOP_TOL = 1e-5                  # resumed losses against uninterrupted
LOOP_DROP = 0.3                  # the reference test's bar on the loss


def attention_flops(cfg, bsz: int, seq: int) -> int:
    """The causal attention's two products (Q K^T, P V) of one forward
    over the lower triangle: 2 products x 2 flop x B x H x hd x S(S+1)/2
    per layer."""
    return (4 * bsz * cfg.n_heads * cfg.resolved_head_dim
            * seq * (seq + 1) // 2 * cfg.n_layers)


def timed_steps(step_fn, state, batches):
    """step_fn(state, batch, mark) -> (state, metrics) over `batches`,
    where mark() records a CUDA event; each step also gets one at its
    start and one at its end. Returns (state, [metrics], [[ms between a
    step's consecutive events]])."""
    import torch

    marks, metrics = [], []

    def mark():
        marks[-1].append(torch.cuda.Event(enable_timing=True))
        marks[-1][-1].record()

    for batch in batches:
        marks.append([])
        mark()
        state, m = step_fn(state, batch, mark)
        mark()
        metrics.append(m)
    torch.cuda.synchronize()
    return state, metrics, [[a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
                            for ev in marks]


def train_step_phase(dev):
    """14a: minicpm-2b's train step at full width and depth, f32 master
    weights and Adam moments, bf16 compute, WSD. Returns (cfg, state)."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.training import data as DATA
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL
    from repro_torch.training.tree import tree_map

    cfg = registry.get(TRAIN_ARCH)
    t0 = time.perf_counter()
    state = TL.init_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    nparams, pbytes = tree_bytes(state["params"])
    phase("lm14a params", t0, arch=cfg.name, layers=cfg.n_layers,
          d_model=cfg.d_model, vocab=cfg.padded_vocab, params=nparams,
          param_count=cfg.param_count(),
          state_gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}",
          reckoned_gib=f"{(3 * pbytes + 2 * nparams * 2) / 2**30:.2f}",
          reckoning="f32 params, mu, nu + bf16 copy and its grads")

    opt_cfg = OPT.OptConfig(**TRAIN_OPT)
    step_fn, _, _ = TL.make_train_step(cfg, opt_cfg,
                                       compute_dtype=torch.bfloat16,
                                       device=dev)

    def split_step(state, batch, mark):
        # step_fn's own sequence, with an event between its two parts
        params_c = TL.cast_tree(state["params"], torch.bfloat16)
        loss, m, grads = TL.loss_and_grads(
            params_c, TL.batch_to_device(batch, dev), cfg)
        del params_c
        mark()
        params, opt, om = OPT.adamw_update(opt_cfg, state["params"], grads,
                                           state["opt"])
        return {"params": params, "opt": opt}, dict(m, loss=loss, **om)

    data = DATA.SyntheticLM(DATA.DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batches = [data.batch_for_model(k, cfg) for k in range(
        1 + TRAIN_TIMED_STEPS + TRAIN_SPLIT_STEPS)]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state, metrics, times = timed_steps(
        lambda s, b, mark: step_fn(s, b), state,
        batches[:1 + TRAIN_TIMED_STEPS])
    peak = torch.cuda.max_memory_allocated()
    state, split_metrics, split = timed_steps(
        split_step, state, batches[1 + TRAIN_TIMED_STEPS:])
    steps = []
    for k, m in enumerate(metrics + split_metrics, start=1):
        vals = {key: float(m[key]) for key in ("loss", "grad_norm", "lr")}
        want_lr = float(OPT.lr_at(opt_cfg, torch.tensor(k, device=dev)))
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"train step {k}: {vals} not finite")
        if vals["lr"] != want_lr:
            raise AssertionError(f"train step {k}: lr {vals['lr']!r} is not "
                                 f"lr_at's {want_lr!r}")
        steps.append(vals)
    if int(state["opt"]["step"]) != len(batches):
        raise AssertionError(f"the state counts {int(state['opt']['step'])} "
                             f"steps, not {len(batches)}")
    ms = float(np.median([t[0] for t in times[1:]]))
    fb = float(np.median([t[0] for t in split]))
    adam = float(np.median([t[1] for t in split]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * nparams * tokens + 3 * attention_flops(cfg, TRAIN_BATCH,
                                                       TRAIN_SEQ)
    phase("lm14a train step timed", t0, layers=cfg.n_layers,
          tokens=f"{TRAIN_BATCH}x{TRAIN_SEQ}", ms=f"{ms:.3f}",
          runs_ms=json.dumps([round(t[0], 3) for t in times[1:]]),
          warmup_ms=f"{times[0][0]:.3f}",
          forward_backward_ms=f"{fb:.3f}", adamw_ms=f"{adam:.3f}",
          split_runs_ms=json.dumps([[round(x, 3) for x in t]
                                    for t in split]),
          tokens_per_s=f"{tokens / (ms / 1e3):.1f}",
          mfu=f"{flops / (ms / 1e3) / BF16_FLOPS_PER_S:.4f}",
          mfu_formula="(6*N*T + 3*causal attention products) / 989e12 "
                      "per s",
          flops=flops, peak_gib=f"{peak / 2**30:.2f}",
          steps=json.dumps(steps))

    t0 = time.perf_counter()

    def cut(tree):
        # copies: the profiled steps must not update 14a's state
        return tree_map(torch.clone,
                        family_cut(cfg, tree, TRAIN_PROFILE_LAYERS)[1])

    cut_cfg = family_cut(cfg, state["params"], TRAIN_PROFILE_LAYERS)[0]
    opt = state["opt"]
    cut_state = {"params": cut(state["params"]), "opt": {
        "step": opt["step"].clone(), "mu": cut(opt["mu"]),
        "nu": cut(opt["nu"])}}
    cut_step, _, _ = TL.make_train_step(cut_cfg, opt_cfg,
                                        compute_dtype=torch.bfloat16,
                                        device=dev)
    cut_step(cut_state, batches[0])                # warm-up at this depth
    prof = profile_call(f"lm14a {cfg.name} train step at "
                        f"{TRAIN_PROFILE_LAYERS} layers",
                        lambda: cut_step(cut_state, batches[0]))
    del cut_state
    phase("lm14a train step profiled", t0, layers=cut_cfg.n_layers,
          **({"idle_share": "not measured"} if prof is None else {
              "idle_share": f"{prof['idle_share']:.4f}",
              "device_busy_ms": f"{prof['device_busy_ms']:.3f}",
              "wall_ms": f"{prof['wall_ms']:.3f}",
              "launches": prof["launches"]}))
    return cfg, state


def grad_gate(dev, cfg, state) -> None:
    """14b: minicpm-2b at 2 layers and full width, 1 x 256 tokens: loss_fn's
    loss and gradients in f32 against float64 on the card, then one
    adamw_update from the same state and gradients in f32 and in
    float64."""
    import torch

    from repro_torch.training import data as DATA
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL
    from repro_torch.training.tree import (cast_tree, leaves_with_paths,
                                           tree_map)

    t0 = time.perf_counter()
    cut_cfg, p32 = family_cut(cfg, state["params"], GATE_LAYERS)
    batch = TL.batch_to_device(DATA.SyntheticLM(DATA.DataConfig(
        vocab=cfg.vocab, seq_len=GATE_SEQ, global_batch=1)).batch_for_model(
        0, cfg), dev)
    p64 = cast_tree(p32, torch.float64)
    loss32, _, g32 = TL.loss_and_grads(p32, batch, cut_cfg)
    loss64, _, g64 = TL.loss_and_grads(p64, batch, cut_cfg)
    if g64["embed"]["table"].dtype != torch.float64:
        raise AssertionError("the float64 gradients are not float64")
    loss_rel = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    worst, where = 0.0, ""
    for (path, a), (_, b) in zip(leaves_with_paths(g32),
                                 leaves_with_paths(g64)):
        rel = rel_err(a, b)[1]
        if rel > worst:
            worst, where = rel, path
    if not (loss_rel <= GATE_LOSS_TOL and worst <= GATE_GRAD_TOL):
        raise AssertionError(f"14b f32 against float64: loss rel "
                             f"{loss_rel:.3e} (tol {GATE_LOSS_TOL:.0e}), "
                             f"gradient {where} rel {worst:.3e} (tol "
                             f"{GATE_GRAD_TOL:.0e})")
    phase("lm14b f32 vs float64 loss and grads", t0, layers=GATE_LAYERS,
          tokens=f"1x{GATE_SEQ}", loss=f"{float(loss64):.6f}",
          loss_rel=f"{loss_rel:.3e}", worst_grad_rel=f"{worst:.3e}",
          worst_leaf=json.dumps(where))

    t0 = time.perf_counter()
    opt = state["opt"]
    mu = family_cut(cfg, opt["mu"], GATE_LAYERS)[1]
    nu = family_cut(cfg, opt["nu"], GATE_LAYERS)[1]
    new = {}
    for dtype in (torch.float32, torch.float64):
        def copy(tree, dtype=dtype):
            return tree_map(lambda t: t.to(dtype, copy=True), tree)

        params = copy(p32)
        OPT.adamw_update(OPT.OptConfig(**TRAIN_OPT), params, copy(g64), {
            "step": opt["step"].clone(), "mu": copy(mu), "nu": copy(nu)})
        new[dtype] = dict(leaves_with_paths(params))
    worst_p = max(rel_err(new[torch.float32][k], v)[1]
                  for k, v in new[torch.float64].items())
    if not worst_p <= GATE_ADAM_TOL:
        raise AssertionError(f"14b adamw_update f32 against float64: rel "
                             f"{worst_p:.3e} > {GATE_ADAM_TOL:.0e}")
    phase("lm14b adamw f32 vs float64", t0, step=int(opt["step"]) + 1,
          worst_param_rel=f"{worst_p:.3e}",
          inputs="the same state and float64 gradients")


def zamba_train_phase(dev):
    """14c: zamba2-7b at full width cut to one group and its tail (9 Mamba2
    layers and the shared attention block), embedding scaled as in phase 8,
    f32, 1 x 1024: loss_fn(train=True) and its gradients with K5
    (use_kernel="auto") against the plain SSD, the same pair with the plain
    scan's chunks of 64 and 128 beside it. Returns (K5's launches in the
    step: two per Mamba2 layer, the forward and its recomputation in
    backward, the SSD's backward running torch ops; and for 15c the cut
    config, a copy of its parameters, the batch and the plain SSD's loss
    and gradients)."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs import registry
    from repro_torch.models import model as MDL
    from repro_torch.training import train_loop as TL
    from repro_torch.training.tree import leaves_with_paths, tree_map

    t0 = time.perf_counter()
    full = registry.get(LM_ARCH)
    params = MDL.init_params(full, seed=0, dtype=torch.float32, device=dev)
    params["embed"]["table"].mul_(EMBED_SCALE)
    cfg, cut = cut_depth(full, params, 1)
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, ZAMBA_TRAIN_SEQ),
                                     generator=gen, device=dev)}
    kernels.reset_launches()
    loss_k, _, g_k = TL.loss_and_grads(cut, batch, cfg, use_kernel="auto")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = 2 * cfg.n_layers
    if launches["ssd_chunk"] != want or sum(launches.values()) != want:
        raise AssertionError(f"the Zamba2 train step launched "
                             f"{json.dumps(launches)}; want ssd_chunk "
                             f"{want} (2 x {cfg.n_layers} Mamba2 layers) "
                             f"and nothing else")
    loss_r, _, g_r = TL.loss_and_grads(cut, batch, cfg, use_kernel="ref")
    half = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk=cfg.ssm.chunk // 2))
    loss_h, _, g_h = TL.loss_and_grads(cut, batch, half, use_kernel="ref")
    torch.cuda.synchronize()
    if kernels.LAUNCHES != launches:
        raise AssertionError("the plain Zamba2 train steps launched a "
                             "kernel")
    worst = {}
    for name, (loss, grads) in (("kernel", (loss_k, g_k)),
                                ("chunk64", (loss_h, g_h))):
        errs = [(rel_err(a, b)[1], path) for (path, a), (_, b) in zip(
            leaves_with_paths(grads), leaves_with_paths(g_r))]
        worst[name] = (abs(float(loss) - float(loss_r)) / abs(float(loss_r)),
                       *max(errs))
    loss_rel, grad_rel, where = worst["kernel"]
    if not (loss_rel <= ZAMBA_LOSS_TOL and grad_rel <= ZAMBA_GRAD_TOL):
        raise AssertionError(f"14c Zamba2 train step, K5 against the plain "
                             f"SSD: loss rel {loss_rel:.3e} (tol "
                             f"{ZAMBA_LOSS_TOL:.0e}), gradient {where} rel "
                             f"{grad_rel:.3e} (tol {ZAMBA_GRAD_TOL:.0e})")
    smallest = min(float(g.abs().max()) for _, g in leaves_with_paths(g_r))
    if not smallest > 0:
        raise AssertionError("a Zamba2 gradient leaf is all zeros")
    phase("lm14c zamba2 train step K5 vs plain", t0,
          layers=f"{cfg.n_layers} Mamba2 + shared attention",
          tokens=f"1x{ZAMBA_TRAIN_SEQ}", k5_launches=launches["ssd_chunk"],
          loss=f"{float(loss_r):.6f}", loss_rel=f"{loss_rel:.3e}",
          worst_grad_rel=f"{grad_rel:.3e}", worst_leaf=json.dumps(where),
          witness_loss_rel=f"{worst['chunk64'][0]:.3e}",
          witness_grad_rel=f"{worst['chunk64'][1]:.3e}",
          witness="plain chunk 64 vs plain chunk 128")
    keep = (cfg, tree_map(torch.clone, cut), batch, loss_r, g_r)
    del params, cut, g_k, g_h
    return launches["ssd_chunk"], keep


def train_loop_phase(dev) -> None:
    """14d: repro_torch.launch.train on small_lm_config(): LOOP_STEPS steps
    of 8 x 256 with a checkpoint every LOOP_EVERY, crashed at LOOP_CRASH and
    resumed to the end, beside an uninterrupted run in another
    directory."""
    import torch

    from repro_torch.launch.train import small_lm_config, train
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.tree import leaves

    cfg = small_lm_config()
    kw = dict(batch=LOOP_BATCH, seq=LOOP_SEQ, ckpt_every=LOOP_EVERY,
              device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        runs = {}
        for name, directory, crash in (("crashed", "a", LOOP_CRASH),
                                       ("resumed", "a", None),
                                       ("whole", "b", None)):
            t0 = time.perf_counter()
            runs[name] = train(cfg, LOOP_STEPS, os.path.join(tmp, directory),
                               crash_at=crash, **kw)
            torch.cuda.synchronize()
            phase(f"lm14d train {name}", t0, steps=len(runs[name]["losses"]),
                  first_loss=f"{runs[name]['losses'][0]:.6f}",
                  last_loss=f"{runs[name]['losses'][-1]:.6f}")
        t0 = time.perf_counter()
        step, saved, _ = CKPT.Checkpointer(
            os.path.join(tmp, "a")).restore_latest(runs["resumed"]["state"])
        same = all(torch.equal(a, b) for a, b in zip(
            leaves(saved), leaves(runs["resumed"]["state"])))
    crashed, resumed, whole = (runs[k] for k in ("crashed", "resumed",
                                                 "whole"))
    if crashed.get("crashed_at") != LOOP_CRASH or step != LOOP_STEPS \
            or not same:
        raise AssertionError(f"14d: crashed at {crashed.get('crashed_at')}, "
                             f"latest checkpoint step {step}, restored "
                             f"bit for bit: {same}")
    tail = whole["losses"][LOOP_CRASH:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], tail))
    drop = crashed["losses"][0] - resumed["final_loss"]
    if not (len(resumed["losses"]) == len(tail) and rel <= LOOP_TOL
            and drop > LOOP_DROP):
        raise AssertionError(f"14d: resumed losses against uninterrupted rel "
                             f"{rel:.3e} (tol {LOOP_TOL:.0e}), loss drop "
                             f"{drop:.4f} (bar {LOOP_DROP})")
    phase("lm14d crash and resume", t0, params=cfg.param_count(),
          resumed_vs_whole_rel=f"{rel:.3e}", loss_drop=f"{drop:.4f}",
          whole_drop=f"{whole['losses'][0] - whole['final_loss']:.4f}",
          restored_bit_for_bit=same)


def lm_train(dev):
    """Phase 14: training on the card, each model freed before the next.
    Only 14c may launch a kernel of the kernels line (K5). Returns K5's
    launches in 14c's train step, a copy of 14a's state cut to
    MESH_LAYERS layers (15a's) and what 15c takes from 14c."""
    import torch

    from repro_torch import kernels
    from repro_torch.training.tree import tree_map

    t_phase = time.perf_counter()
    before = dict(kernels.LAUNCHES)
    cfg, state = train_step_phase(dev)
    grad_gate(dev, cfg, state)
    opt = state["opt"]
    dense = (family_cut(cfg, state["params"], MESH_LAYERS)[0], {
        "params": tree_map(torch.clone, family_cut(
            cfg, state["params"], MESH_LAYERS)[1]),
        "opt": {"step": opt["step"].clone(),
                "mu": tree_map(torch.clone,
                               family_cut(cfg, opt["mu"], MESH_LAYERS)[1]),
                "nu": tree_map(torch.clone,
                               family_cut(cfg, opt["nu"], MESH_LAYERS)[1])}})
    del state, opt
    gc.collect()
    torch.cuda.empty_cache()
    if kernels.LAUNCHES != before:
        raise AssertionError(f"phases 14a-14b launched a kernel: {before} "
                             f"-> {dict(kernels.LAUNCHES)}")
    k5, zamba = zamba_train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    before = dict(kernels.LAUNCHES)
    train_loop_phase(dev)
    if kernels.LAUNCHES != before:
        raise AssertionError("phase 14d launched a kernel")
    gc.collect()
    torch.cuda.empty_cache()
    phase("lm train", t_phase)
    return k5, dense, zamba


# phase 15: the mesh paths on one card, a one-rank NCCL group and a (1, 1)
# ("data", "model") mesh. One rank shows that the path runs on the card and
# gives the plain path's numbers, not what a collective costs
MESH_SHAPE = (1, 1)
MESH_LAYERS = 2                  # 15a: of minicpm-2b's 40; 15b: of 48
MESH_STEPS = 2                   # 15a: steps through each path
MESH_TOL = 1e-6                  # of a leaf's largest entry, where not equal
MOE_MESH_ARCH = "qwen3-moe-30b-a3b"
MOE_MESH_SEQ = 4096


def state_diff(got, want) -> tuple[float, str, bool]:
    """(the largest |got - want| over its leaf's largest |want|, that
    leaf's path, every leaf equal) over two trees of the same leaves."""
    from repro_torch.training.tree import leaves_with_paths

    worst, where, equal = 0.0, "", True
    for (path, a), (_, b) in zip(leaves_with_paths(got),
                                 leaves_with_paths(want)):
        if a.shape != b.shape:
            raise AssertionError(f"{path}: shape {tuple(a.shape)} against "
                                 f"{tuple(b.shape)}")
        if a.dtype == b.dtype and bool((a == b).all()):
            continue
        equal = False
        rel = rel_err(a, b)[1]
        if rel > worst:
            worst, where = rel, path
    return worst, where, equal


def step_gate(label: str, got_m, want_m, got_state, want_state) -> dict:
    """The mesh step against the plain step: loss and grad_norm, and every
    leaf of the state, equal or within MESH_TOL of the leaf's largest
    entry. Returns what the phase line prints."""
    vals = {}
    for key in ("loss", "grad_norm", "lr"):
        a, b = float(got_m[key]), float(want_m[key])
        vals[key] = (a == b, abs(a - b) / max(abs(b), 1e-30))
    worst, where, equal = state_diff(got_state, want_state)
    if not (all(e or r <= MESH_TOL for e, r in vals.values())
            and worst <= MESH_TOL):
        raise AssertionError(f"{label}: mesh against plain: {vals}, state "
                             f"leaf {where} rel {worst:.3e} (tol "
                             f"{MESH_TOL:.0e})")
    return {"bitwise": equal and all(e for e, _ in vals.values()),
            "loss_rel": f"{vals['loss'][1]:.3e}",
            "grad_norm_rel": f"{vals['grad_norm'][1]:.3e}",
            "worst_state_rel": f"{worst:.3e}",
            "worst_leaf": json.dumps(where)}


def mesh_dense(dev, mesh, cfg, state) -> None:
    """15a: minicpm-2b at full width and MESH_LAYERS layers (14a's state),
    1 x 4096, f32 master weights, bf16 compute, WSD: MESH_STEPS steps
    through make_train_step(mesh=) and as many through mesh=None from the
    same state, each step's loss, grad_norm and the state after them held
    together; both paths' ms (CUDA events) and peak memory."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.training import data as DATA
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL

    t0 = time.perf_counter()
    opt_cfg = OPT.OptConfig(**TRAIN_OPT)
    data = DATA.SyntheticLM(DATA.DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batches = [data.batch_for_model(k, cfg) for k in range(MESH_STEPS)]
    runs = {}
    for name, kw in (("mesh", {"mesh": mesh, "dp_axes": ("data",)}),
                     ("plain", {})):
        step_fn, shardings, _ = TL.make_train_step(
            cfg, opt_cfg, compute_dtype=torch.bfloat16, device=dev, **kw)
        # the mesh path steps its own blocks (copies); the plain path
        # steps the state itself, after it
        start = (SH.shard_tree(state, shardings(state["params"]), mesh)
                 if shardings else state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        final, metrics, times = timed_steps(
            lambda s, b, mark: step_fn(s, b), start, batches)
        runs[name] = (final, metrics, [t[0] for t in times],
                      torch.cuda.max_memory_allocated())
        del start
    (got, got_m, got_ms, got_peak), (want, want_m, want_ms, want_peak) = (
        runs["mesh"], runs["plain"])
    steps = [step_gate(f"15a step {k + 1}", a, b, got, want)
             for k, (a, b) in enumerate(zip(got_m, want_m))]
    phase("mesh15a minicpm-2b train steps mesh vs plain", t0,
          layers=f"{cfg.n_layers} of 40", tokens=f"{TRAIN_BATCH}x{TRAIN_SEQ}",
          mesh=json.dumps(list(MESH_SHAPE)), steps=MESH_STEPS,
          loss=json.dumps([round(float(m["loss"]), 6) for m in got_m]),
          bitwise=all(s["bitwise"] for s in steps),
          worst_state_rel=steps[-1]["worst_state_rel"],
          worst_leaf=steps[-1]["worst_leaf"],
          mesh_ms=json.dumps([round(t, 3) for t in got_ms]),
          plain_ms=json.dumps([round(t, 3) for t in want_ms]),
          mesh_peak_gib=f"{got_peak / 2**30:.2f}",
          plain_peak_gib=f"{want_peak / 2**30:.2f}")


def mesh_moe(dev, mesh) -> None:
    """15b: qwen3-moe-30b-a3b at full width (128 experts, top 8) and
    MESH_LAYERS layers, 1 x 4096, f32 master weights, bf16 compute: one
    train step through make_train_step(mesh=), whose MoE layers take
    moe_layer(mesh=) (at one rank over "model" no token exchange), against
    mesh=None from the same state, with 15a's gate; router_li and
    drop_frac of both."""
    import dataclasses

    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.configs import registry
    from repro_torch.training import data as DATA
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL

    t0 = time.perf_counter()
    full = registry.get(MOE_MESH_ARCH)
    cfg = dataclasses.replace(full, n_layers=MESH_LAYERS)
    state = TL.init_state(cfg, seed=0, device=dev)
    batch = DATA.SyntheticLM(DATA.DataConfig(
        vocab=cfg.vocab, seq_len=MOE_MESH_SEQ,
        global_batch=1)).batch_for_model(0, cfg)
    opt_cfg = OPT.OptConfig(**TRAIN_OPT)
    step_m, shardings, _ = TL.make_train_step(
        cfg, opt_cfg, mesh=mesh, dp_axes=("data",),
        compute_dtype=torch.bfloat16, device=dev)
    step_p, _, _ = TL.make_train_step(cfg, opt_cfg,
                                      compute_dtype=torch.bfloat16,
                                      device=dev)
    got, got_m = step_m(SH.shard_tree(state, shardings(state["params"]),
                                       mesh), batch)
    want, want_m = step_p(state, batch)
    torch.cuda.synchronize()
    gate = step_gate("15b", got_m, want_m, got, want)
    # one rank over "model": moe_layer(mesh=) splits no sequence and runs
    # no all_to_all, only the expert gathers and the body
    ep_size = SH.axis_sizes(mesh)["model"]
    phase("mesh15b qwen3-moe-30b-a3b train step moe_layer(mesh=) vs plain",
          t0, layers=f"{cfg.n_layers} of {full.n_layers}",
          ep_size=ep_size, ep_exchange=str(ep_size > 1).lower(),
          experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
          tokens=f"1x{MOE_MESH_SEQ}", loss=f"{float(got_m['loss']):.6f}",
          router_li=f"{float(got_m['router_li']):.6f}",
          drop_frac=f"{float(got_m['drop_frac']):.6f}",
          plain_router_li=f"{float(want_m['router_li']):.6f}",
          plain_drop_frac=f"{float(want_m['drop_frac']):.6f}", **gate)


def mesh_zamba(dev, mesh, zamba) -> int:
    """15c: 14c's Zamba2 (9 Mamba2 layers and the shared attention, f32,
    1 x 1024) through make_train_step(mesh=), compute in f32: K5 launched
    18 times in the step and nothing else; the loss and the gradients
    within 14c's gates of 14c's plain-SSD step, the gradients read from
    the first AdamW step's mu (from zero moments mu = (1 - b1) x the
    clipped gradient). Returns K5's launches."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch import kernels
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL
    from repro_torch.training.tree import leaves_with_paths

    cfg, params, batch, loss_r, g_r = zamba
    t0 = time.perf_counter()
    opt_cfg = OPT.OptConfig()
    step_fn, shardings, _ = TL.make_train_step(
        cfg, opt_cfg, mesh=mesh, dp_axes=("data",),
        compute_dtype=torch.float32, device=dev)
    state = SH.shard_tree({"params": params,
                            "opt": OPT.init_opt_state(params)},
                           shardings(params), mesh)
    kernels.reset_launches()
    t_step = torch.cuda.Event(enable_timing=True)
    t_end = torch.cuda.Event(enable_timing=True)
    t_step.record()
    state, metrics = step_fn(state, batch)
    t_end.record()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = 2 * cfg.n_layers
    if launches["ssd_chunk"] != want or sum(launches.values()) != want:
        raise AssertionError(f"15c: the Zamba2 mesh train step launched "
                             f"{json.dumps(launches)}; want ssd_chunk {want} "
                             f"and nothing else")
    gnorm = float(metrics["grad_norm"])
    clip = min(1.0, opt_cfg.grad_clip / max(gnorm, 1e-9))
    loss_rel = abs(float(metrics["loss"]) - float(loss_r)) / abs(
        float(loss_r))
    grad_rel, where = max(
        (rel_err(mu.double() / ((1 - opt_cfg.b1) * clip), g)[1], path)
        for (path, mu), (_, g) in zip(leaves_with_paths(state["opt"]["mu"]),
                                      leaves_with_paths(g_r)))
    if not (loss_rel <= ZAMBA_LOSS_TOL and grad_rel <= ZAMBA_GRAD_TOL):
        raise AssertionError(f"15c Zamba2 mesh step against 14c's plain "
                             f"SSD: loss rel {loss_rel:.3e} (tol "
                             f"{ZAMBA_LOSS_TOL:.0e}), gradient {where} rel "
                             f"{grad_rel:.3e} (tol {ZAMBA_GRAD_TOL:.0e})")
    phase("mesh15c zamba2 train step mesh with K5 vs 14c plain", t0,
          layers=f"{cfg.n_layers} Mamba2 + shared attention",
          tokens=f"1x{ZAMBA_TRAIN_SEQ}", k5_launches=launches["ssd_chunk"],
          loss=f"{float(metrics['loss']):.6f}", loss_rel=f"{loss_rel:.3e}",
          worst_grad_rel=f"{grad_rel:.3e}", worst_leaf=json.dumps(where),
          grads="from mu after the first AdamW step",
          step_ms=f"{t_step.elapsed_time(t_end):.3f}")
    return launches["ssd_chunk"]


def mesh_phase(dev, dense, zamba) -> int:
    """Phase 15: one NCCL process group of one rank (a HashStore, no
    network) and a (1, 1) mesh, destroyed when the phase ends; 15a-15c.
    A failed NCCL init or collective ends the run. Deterministic
    algorithms are on for the phase: on the card the gradient of an
    index (the embedding, the MoE dispatch) adds atomically, so two runs
    of the plain step differ in their last bits, and the gate could not
    tell the paths apart from that. Returns 15c's K5 launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_mesh(MESH_SHAPE, ("data", "model"), dev)
        phase("mesh15 nccl group and mesh", t0, backend=dist.get_backend(),
              mesh=json.dumps(dict(zip(mesh.mesh_dim_names, mesh.shape))),
              deterministic=torch.are_deterministic_algorithms_enabled())
        mesh_dense(dev, mesh, *dense)
        dense[1].clear()                   # 15a's state, 4.9 GB
        gc.collect()
        torch.cuda.empty_cache()
        mesh_moe(dev, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        k5 = mesh_zamba(dev, mesh, zamba)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    phase("mesh", t_phase)
    return k5


# phase 16: decode on a mesh on one card, a one-rank NCCL group and a (1, 1)
# ("data", "model") mesh: the sharded serve step against the plain serve
# step from the same cache. One rank shows the path on the card, not what
# a combine over ranks costs: each line says model_shards=1
# combine_ranks=1
DECODE_ARCH, DECODE_BATCH, DECODE_CACHE = "qwen2-7b", 8, 32768
DECODE_LAYERS = 4                # 16a: of qwen2-7b's 28; decode_32k's batch
                                 # of 128 cut to 8
DECODE_STEPS = 4                 # decode tokens through each path
DECODE_PLAIN = 2                 # 16a: tokens the plain step writes after
                                 # the random-filled positions
DECODE_TIMED = 3                 # 16a bf16: steps timed after one warm-up,
                                 # then one profiled
DECODE_LOGIT_TOL = 1e-5          # of the largest plain logit, f32
DECODE_CACHE_TOL = 1e-6          # of each cache leaf's largest entry, f32
# 16b, 16c: arch -> (layers, batch, cache positions, prompt tokens through
# the plain step)
DECODE_STATE_CELLS = {"zamba2-7b": (9, 8, 1024, 8),
                      "rwkv6-7b": (2, 8, 1024, 8)}


def cache_copy(cache):
    """A copy of a decode cache: tensors cloned, `len` lists copied."""
    import copy

    import torch

    from repro_torch.training.tree import tree_map

    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else copy.deepcopy(t), cache)


def decode_paths(cfg, params, mesh, cache, tok, shape, kv_shard):
    """DECODE_STEPS tokens from `cache` (left as it is) through
    make_serve_step(mesh=) on its blocks under cache_specs(kv_shard) and
    through the plain serve step on a copy, in the parameters' type; the
    logits read from model.forward as each step calls it. Returns (tokens
    equal, the largest logit error over the largest plain logit, the
    worst cache leaf's error over its largest entry, that leaf)."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import specs as SP
    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import make_serve_step
    from repro_torch.training.tree import leaves_with_paths

    spec = SP.cache_specs(cache, cfg, shape, mesh, ("data",), kv_shard)
    dtype = params["final_norm"]["scale"].dtype
    blocks = SH.shard_tree(cache, spec, mesh)
    whole = cache_copy(cache)
    shards = SH.shard_tree(params, MDL.param_layout(cfg, mesh), mesh)
    mesh_step = make_serve_step(cfg, mesh=mesh, compute_dtype=dtype)
    plain_step = make_serve_step(cfg, compute_dtype=dtype)
    seen, forward = [], MDL.forward

    def spy(*a, **kw):
        out = forward(*a, **kw)
        seen.append(out[0])
        return out

    equal, logit_rel = True, 0.0
    t_mesh = t_plain = tok
    MDL.forward = spy
    try:
        for _ in range(DECODE_STEPS):
            n_mesh, blocks = mesh_step(shards, {"tokens": t_mesh}, blocks,
                                       spec)
            n_plain, whole = plain_step(params, {"tokens": t_plain}, whole)
            equal &= bool(torch.equal(n_mesh, n_plain))
            logit_rel = max(logit_rel, rel_err(seen[0], seen[1])[1])
            t_mesh, t_plain = n_mesh[:, None], n_plain[:, None]
            seen.clear()
    finally:
        MDL.forward = forward
    gathered = SH.unshard_tree(blocks, spec, mesh)
    worst, where = max((rel_err(g, w)[1], path) for (path, g), (_, w) in zip(
        leaves_with_paths(gathered), leaves_with_paths(whole))
        if isinstance(w, torch.Tensor))
    return equal, logit_rel, worst, where


def decode_gate(label: str, cfg, params, mesh, cache, tok, shape,
                **fields) -> None:
    """decode_paths in f32 for kv_shard "seq" and "hd", each against the
    gates: tokens equal, logits within DECODE_LOGIT_TOL, every cache leaf
    within DECODE_CACHE_TOL; one line each."""
    from repro_torch.distributed import sharding as SH

    for kv_shard in ("seq", "hd"):
        t0 = time.perf_counter()
        equal, logit_rel, worst, where = decode_paths(
            cfg, params, mesh, cache, tok, shape, kv_shard)
        if not (equal and logit_rel <= DECODE_LOGIT_TOL
                and worst <= DECODE_CACHE_TOL):
            raise AssertionError(
                f"{label} kv_shard={kv_shard}: mesh against plain: tokens "
                f"equal {equal}, logits rel {logit_rel:.3e} (tol "
                f"{DECODE_LOGIT_TOL:.0e}), cache leaf {where} rel "
                f"{worst:.3e} (tol {DECODE_CACHE_TOL:.0e})")
        phase(f"{label} decode mesh vs plain f32", t0, kv_shard=kv_shard,
              model_shards=SH.axis_sizes(mesh)["model"],
              combine_ranks=SH.mesh_size(mesh), steps=DECODE_STEPS,
              tokens_equal=equal, logit_rel=f"{logit_rel:.3e}",
              worst_cache_rel=f"{worst:.3e}", worst_leaf=json.dumps(where),
              **fields)


def timed_decode_steps(step, args, tok):
    """One warm-up and DECODE_TIMED steps of a serve step, args = (params,
    cache, *more), from the tokens `tok` [B, 1]: (the median ms a step,
    CUDA events around each; the peak memory over them; the memory held
    before the first; the last tokens [B, 1]; the cache after)."""
    import numpy as np
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    state, t, times = args[1], tok, []
    for k in range(1 + DECODE_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t, state = step(args[0], {"tokens": t}, state, *args[2:])
        end.record()
        t = t[:, None]
        if k:
            times.append((start, end))
    torch.cuda.synchronize()
    return (float(np.median([s.elapsed_time(e) for s, e in times])),
            torch.cuda.max_memory_allocated(), held, t, state)


def decode_timed(label: str, cfg, params, mesh, cache, tok, shape,
                 smi: str) -> None:
    """16a in bf16: one warm-up and DECODE_TIMED steps of the mesh serve
    step (kv_shard "seq") and of the plain one, each from its own copy of
    `cache`; ms a step (one token a row; CUDA events around each step,
    the median) and the peak memory of each path, with what the path held
    before its first step; then one more step of each under
    torch.profiler (`profile_call`: device time by kernel group, the
    NCCL kernels among them)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import specs as SP
    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import make_serve_step

    t0 = time.perf_counter()
    spec = SP.cache_specs(cache, cfg, shape, mesh, ("data",), "seq")
    runs = {}
    for name in ("mesh", "plain"):
        if name == "mesh":
            step = make_serve_step(cfg, mesh=mesh)
            args = (SH.shard_tree(params, MDL.param_layout(cfg, mesh), mesh),
                    SH.shard_tree(cache, spec, mesh), spec)
        else:
            step = make_serve_step(cfg)
            args = (params, cache_copy(cache))
        ms, peak, held, t, state = timed_decode_steps(step, args, tok)
        runs[name] = (ms, peak, held)
        profile_call(f"{label} {name} bf16 decode step model_shards="
                     f"{SH.axis_sizes(mesh)['model']} combine_ranks="
                     f"{SH.mesh_size(mesh)}",
                     lambda: step(args[0], {"tokens": t}, state, *args[2:]))
        del args, state
    phase(f"{label} decode mesh vs plain bf16 timed", t0, kv_shard="seq",
          model_shards=SH.axis_sizes(mesh)["model"],
          combine_ranks=SH.mesh_size(mesh), batch=tok.shape[0],
          positions=shape.seq_len, steps=DECODE_TIMED,
          mesh_ms_per_token=f"{runs['mesh'][0]:.3f}",
          plain_ms_per_token=f"{runs['plain'][0]:.3f}",
          mesh_peak_gib=f"{runs['mesh'][1] / 2**30:.2f}",
          plain_peak_gib=f"{runs['plain'][1] / 2**30:.2f}",
          mesh_held_gib=f"{runs['mesh'][2] / 2**30:.2f}",
          plain_held_gib=f"{runs['plain'][2] / 2**30:.2f}",
          card=json.dumps(smi))


def filled_decode_cache(cfg, params, dev):
    """16a's cache for `cfg`, f32: DECODE_BATCH rows of DECODE_CACHE
    positions, random keys and values from a seed before the last
    DECODE_PLAIN tokens and the steps after them, then DECODE_PLAIN
    tokens through the plain serve step. Returns (the cache, the last
    tokens [B, 1], the random positions)."""
    import torch

    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import make_serve_step

    cache = MDL.init_cache(cfg, DECODE_BATCH, DECODE_CACHE,
                           dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    start = DECODE_CACHE - DECODE_PLAIN - max(DECODE_STEPS, DECODE_TIMED + 2)
    cache["len"] = [start] * cfg.n_layers
    tok = torch.randint(0, cfg.vocab, (DECODE_BATCH, 1), generator=gen,
                        device=dev)
    plain = make_serve_step(cfg, compute_dtype=torch.float32)
    for _ in range(DECODE_PLAIN):
        tok, cache = plain(params, {"tokens": tok}, cache)
        tok = tok[:, None]
    return cache, tok, start


def mesh_decode_dense(dev, mesh, smi: str) -> None:
    """16a: qwen2-7b at full width (d_model 3584, 28 heads, 4 KV heads)
    and DECODE_LAYERS layers, B = DECODE_BATCH, a cache of DECODE_CACHE
    positions, filled by `filled_decode_cache` (a plain fill of 32k tokens
    would outlast the phase); decode_gate from there in f32, then
    decode_timed in bf16 from the same cache."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model as MDL
    from repro_torch.training.tree import cast_tree

    t0 = time.perf_counter()
    full = registry.get(DECODE_ARCH)
    cfg = dataclasses.replace(full, n_layers=DECODE_LAYERS)
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    cache, tok, start = filled_decode_cache(cfg, params, dev)
    torch.cuda.synchronize()
    label = f"mesh16a {DECODE_ARCH}"
    shape = ShapeConfig("decode_32k", DECODE_CACHE, DECODE_BATCH, "decode")
    phase(f"{label} model and cache", t0,
          layers=f"{cfg.n_layers} of {full.n_layers}", d_model=cfg.d_model,
          heads=f"{cfg.n_heads}/{cfg.kv_heads}", batch=DECODE_BATCH,
          positions=DECODE_CACHE,
          filled=f"{start} random + {DECODE_PLAIN} plain")
    decode_gate(label, cfg, params, mesh, cache, tok, shape,
                layers=cfg.n_layers, batch=DECODE_BATCH,
                positions=DECODE_CACHE)
    params = cast_tree(params, torch.bfloat16)
    cache = {"k": cache["k"].to(torch.bfloat16),
             "v": cache["v"].to(torch.bfloat16), "len": list(cache["len"])}
    decode_timed(label, cfg, params, mesh, cache, tok, shape, smi)


def mesh_decode_states(dev, mesh) -> None:
    """16b, 16c: Zamba2 (its Mamba2 conv and SSM states and the shared
    attention's KV cache; the embedding scaled as in phase 8) and rwkv6-7b
    (its WKV state and token shifts) at full width, cut in depth as
    DECODE_STATE_CELLS says: a prompt through the plain serve step fills
    the cache, then decode_gate in f32."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import make_serve_step

    for case, (arch, (layers, bsz, positions, prompt)) in zip(
            "bc", DECODE_STATE_CELLS.items()):
        t0 = time.perf_counter()
        full = registry.get(arch)
        cfg = dataclasses.replace(full, n_layers=layers)
        params = MDL.init_params(cfg, seed=0, dtype=torch.float32,
                                 device=dev)
        if cfg.ssm is not None:
            params["embed"]["table"].mul_(EMBED_SCALE)
        cache = MDL.init_cache(cfg, bsz, positions, dtype=torch.float32,
                               device=dev)
        gen = torch.Generator(device=dev).manual_seed(16)
        toks = torch.randint(0, cfg.vocab, (bsz, prompt + 1), generator=gen,
                             device=dev)
        plain = make_serve_step(cfg, compute_dtype=torch.float32)
        for t in range(prompt):
            _, cache = plain(params, {"tokens": toks[:, t:t + 1]}, cache)
        torch.cuda.synchronize()
        label = f"mesh16{case} {arch}"
        phase(f"{label} model and cache", t0,
              layers=f"{cfg.n_layers} of {full.n_layers}",
              d_model=cfg.d_model, batch=bsz, positions=positions,
              filled=f"{prompt} plain")
        decode_gate(label, cfg, params, mesh, cache, toks[:, prompt:],
                    ShapeConfig("decode", positions, bsz, "decode"),
                    layers=cfg.n_layers, batch=bsz, positions=positions)
        del params, cache
        gc.collect()
        torch.cuda.empty_cache()


def mesh_decode_phase(dev, smi: str) -> None:
    """Phase 16: one NCCL process group of one rank (a HashStore, no
    network) and a (1, 1) mesh, destroyed when the phase ends; 16a-16c.
    No SpMV or SSD kernel may launch: a decode step takes Mamba2's
    one-step recurrence, not K5."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    before = dict(kernels.LAUNCHES)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh(MESH_SHAPE, ("data", "model"), dev)
        mesh_decode_dense(dev, mesh, smi)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_decode_states(dev, mesh)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    if kernels.LAUNCHES != before:
        raise AssertionError(f"phase 16 launched a kernel: {before} -> "
                             f"{dict(kernels.LAUNCHES)}")
    phase("mesh decode", t_phase, card=json.dumps(smi))


# phase 17: the dry-run's counting half on the card's host (no device
# work): qwen2-7b x decode_32k on (16, 16) for both kv_shards, qwen2-7b x
# prefill_32k on (16, 16), the three multi-pod SpMV layouts on (16, 16)
# and the roofline over those records, each cell in a fake process group
# of 256 ranks of its own, opened after phase 16 destroyed its NCCL group.
# No train cell (about a minute on a host); the records and roofline.csv
# go to the run's temporary results directory and are printed here
DRYRUN_ARCH, DRYRUN_SHAPE = "qwen2-7b", "decode_32k"
# the tensor-parallel prefill's per-rank flops gate: 1788733619699712
# before the step split its matmuls over "model"; the gate holds only if
# the attention (28 heads, 4 KV heads on 16 ranks: the sequence split)
# splits too
PREFILL_SHAPE, PREFILL_MAX_FLOPS = "prefill_32k", 1.5e14
# the tensor-parallel decode step's per-rank flops gate, for both
# kv_shards: 1.10 x the reference's seq count (13,646,954,496); the step
# that gathered each layer's weights whole counted 119,701,241,856
DECODE_MAX_FLOPS = 1.5e10


def dryrun_phase() -> None:
    """Phase 17: status ok, collectives counted, each decode variant's
    per-rank flops within DECODE_MAX_FLOPS, the hd variant's all-reduce
    bytes above the seq variant's (the one-token rule holds for seq
    only), the prefill's per-rank flops within PREFILL_MAX_FLOPS,
    every SpMV layout communicating, and a roofline row per record;
    AssertionError otherwise."""
    from repro_torch.bench import roofline
    from repro_torch.experiments.store import result_path
    from repro_torch.launch import dryrun, spmv_bench

    t_phase = time.perf_counter()
    recs = {}
    for kv in ("seq", "hd"):
        rec = dryrun.run_cell(DRYRUN_ARCH, DRYRUN_SHAPE, False, kv_shard=kv)
        if rec["status"] != "ok":
            raise AssertionError(f"phase 17 {DRYRUN_ARCH} x {DRYRUN_SHAPE} "
                                 f"kv_shard={kv}: {rec['error']}\n"
                                 f"{rec['traceback']}")
        coll = rec["collectives"]
        if not coll.get("total", 0) > 0:
            raise AssertionError(f"phase 17 kv_shard={kv}: no collectives "
                                 f"counted: {coll}")
        print(f"[dryrun17] {DRYRUN_ARCH} x {DRYRUN_SHAPE} x 16x16 "
              f"kv_shard={kv}: flops={rec['walk_flops']} "
              f"bytes={rec['walk_bytes']} wire={coll['wire']} "
              f"collectives={json.dumps(coll)} "
              f"args={rec['argument_size_in_bytes']} "
              f"out={rec['output_size_in_bytes']} "
              f"lower_s={rec['lower_s']:.2f}", flush=True)
        if not rec["walk_flops"] <= DECODE_MAX_FLOPS:
            raise AssertionError(f"phase 17 {DRYRUN_SHAPE} kv_shard={kv}: "
                                 f"{rec['walk_flops']} flops a rank, over "
                                 f"{DECODE_MAX_FLOPS:.1e}")
        recs[kv] = rec
    ratio = (recs["hd"]["collectives"].get("all-reduce", 0)
             / max(recs["seq"]["collectives"].get("all-reduce", 0), 1))
    print(f"[dryrun17] hd/seq all-reduce bytes: {ratio}", flush=True)
    if not ratio > 1:
        raise AssertionError(f"phase 17: the hd all-reduce is not above "
                             f"the seq one ({ratio})")
    rec = dryrun.run_cell(DRYRUN_ARCH, PREFILL_SHAPE, False)
    if rec["status"] != "ok":
        raise AssertionError(f"phase 17 {DRYRUN_ARCH} x {PREFILL_SHAPE}: "
                             f"{rec['error']}\n{rec['traceback']}")
    model_over = roofline.model_flops_per_device(rec) / rec["walk_flops"]
    print(f"[dryrun17] {DRYRUN_ARCH} x {PREFILL_SHAPE} x 16x16: "
          f"flops={rec['walk_flops']} bytes={rec['walk_bytes']} "
          f"wire={rec['collectives']['wire']} "
          f"model_over_counted={model_over:.4f} "
          f"lower_s={rec['lower_s']:.2f}", flush=True)
    if not rec["walk_flops"] <= PREFILL_MAX_FLOPS:
        raise AssertionError(f"phase 17 {PREFILL_SHAPE}: {rec['walk_flops']}"
                             f" flops a rank, over {PREFILL_MAX_FLOPS:.1e}")
    spmv = spmv_bench.run_multi_pod()
    for name in ("1d", "2d", "halo"):
        if not spmv[name]["collectives"].get("total", 0) > 0:
            raise AssertionError(f"phase 17: spmv {name} counted no "
                                 f"collectives: {spmv[name]}")
    print(f"[dryrun17] spmv_distributed {json.dumps(spmv)}", flush=True)
    summary = roofline.run()
    with open(result_path(roofline.CSV)) as f:
        for line in f.read().splitlines():
            print(f"[roofline17] {line}", flush=True)
    if summary != {"cells_ok": 3, "cells_err": 0}:
        raise AssertionError(f"phase 17 roofline: {summary}")
    phase("dryrun", t_phase, hd_over_seq_all_reduce=f"{ratio:.2f}",
          decode_flops_seq=recs["seq"]["walk_flops"],
          decode_flops_hd=recs["hd"]["walk_flops"],
          prefill_flops=rec["walk_flops"],
          prefill_model_over_counted=f"{model_over:.4f}")


# phase 15t, only with --tp-cards N (N cards of one host; the default run
# needs one card and skips it): the tensor-parallel mesh train step over
# NCCL, one process a card (a TCP store on localhost), a (1, N) ("data",
# "model") mesh. qwen2-7b at full width cut to TP_LAYERS layers (its 28
# heads and 4 KV heads split over 4 ranks), and the same with TP_KV_SPLIT
# KV heads, which do not split, so its attention splits the sequence: one
# f32 step against the plain step on one card from the same state (loss,
# grad_norm and every leaf of mu, (1 - b1) x the clipped gradient, within
# TP_TOL of the leaf's largest entry), then TP_STEPS bf16 steps of each
# path timed with CUDA events, with their peak memory
TP_LAYERS, TP_BATCH, TP_SEQ, TP_STEPS = 2, 2, 4096, 3
TP_KV_SPLIT, TP_TOL = 2, 1e-4
# phase 16t, with --tp-cards N beside 15t: the tensor-parallel decode step
# over NCCL on the (1, N) mesh. qwen2-7b at full width and TP_LAYERS
# layers, DECODE_BATCH rows, a DECODE_CACHE-position cache filled as 16a
# fills it; decode_paths from there in f32 for kv_shard "seq" and "hd"
# (every card runs the plain step too and holds its own mesh step to it;
# rank 0's row is printed), then one warm-up and DECODE_TIMED bf16 steps
# of the mesh step on every card and of the plain step on card 0, ms a
# token (CUDA events, the median) and peak memory


def tp_cards_phase(world: int, smi: str) -> None:
    """Phases 15t and 16t over `world` cards; AssertionError past TP_TOL
    (15t) or the decode gates (16t), or if a rank fails."""
    import socket

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        mp.start_processes(_tp_worker, args=(world, port, out), nprocs=world,
                           join=True, start_method="spawn")
        with open(os.path.join(out, "tp.json")) as f:
            rows = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for name, row in rows["train"].items():
        phase(f"tp15t {name} train step on {world} cards vs one card",
              t_phase, **{k: json.dumps(v) if isinstance(v, list) else v
                          for k, v in row.items()}, card=json.dumps(smi))
        worst = max(row["loss_rel"], row["grad_norm_rel"], row["worst_mu_rel"])
        if not worst <= TP_TOL:
            raise AssertionError(f"phase 15t {name}: {row}")
    for kv, row in rows["decode"].items():
        phase(f"tp16t {DECODE_ARCH} decode step on {world} cards vs one "
              f"card", t_phase, kv_shard=kv, **row, card=json.dumps(smi))
        if not (row["tokens_equal"] and row["logit_rel"] <= DECODE_LOGIT_TOL
                and row["worst_cache_rel"] <= DECODE_CACHE_TOL):
            raise AssertionError(f"phase 16t kv_shard={kv}: {row}")
    phase("tp cards", t_phase, cards=world)


def _tp_worker(rank: int, world: int, port: int, out: str) -> None:
    """One card's process of phases 15t and 16t; rank 0 also runs the
    plain steps and writes the rows."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, device_id=dev,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh((1, world), ("data", "model"), dev)
        rows = {"train": {name: _tp_case(dev, mesh, rank, kv)
                          for name, kv in (("qwen2-7b", None),
                                           (f"qwen2-7b-kv{TP_KV_SPLIT}",
                                            TP_KV_SPLIT))}}
        gc.collect()
        torch.cuda.empty_cache()
        rows["decode"] = _tp_decode(dev, mesh, rank)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out, "tp.json"), "w") as f:
            json.dump(rows, f)


def _tp_case(dev, mesh, rank: int, kv_heads) -> dict:
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.training import data as DATA
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_loop as TL
    from repro_torch.training.tree import leaves_with_paths, tree_map

    cfg = dataclasses.replace(registry.get("qwen2-7b"), n_layers=TP_LAYERS,
                              kv_heads=kv_heads or registry.get(
                                  "qwen2-7b").kv_heads)
    state = TL.init_state(cfg, seed=0, device=dev)
    for _, t in leaves_with_paths(state):
        dist.broadcast(t, 0)                 # rank 0's draws on every card
    data = DATA.SyntheticLM(DATA.DataConfig(
        vocab=cfg.vocab, seq_len=TP_SEQ, global_batch=TP_BATCH))
    batches = [data.batch_for_model(k, cfg) for k in range(TP_STEPS)]
    opt_cfg = OPT.OptConfig(**TRAIN_OPT)

    def steps(dtype, mesh_):
        kw = {"mesh": mesh_, "dp_axes": ("data",)} if mesh_ else {}
        return TL.make_train_step(cfg, opt_cfg, compute_dtype=dtype,
                                  device=dev, **kw)

    f32, shardings, _ = steps(torch.float32, mesh)
    specs = shardings(state["params"])
    got, got_m = f32(SH.shard_tree(state, specs, mesh), batches[0])
    mu = SH.unshard_tree(got["opt"]["mu"], specs["opt"]["mu"], mesh)
    row = {}
    if rank == 0:
        want, want_m = steps(torch.float32, None)[0](
            tree_map(torch.clone, state), batches[0])
        worst, where = 0.0, ""
        for (path, a), (_, b) in zip(leaves_with_paths(mu),
                                     leaves_with_paths(want["opt"]["mu"])):
            rel = float((a.double() - b.double()).abs().max()
                        / max(float(b.abs().max()), 1e-30))
            worst, where = max((worst, where), (rel, path))
        row = {"layers": f"{TP_LAYERS} of 28", "kv_heads": cfg.kv_heads,
               "tokens": f"{TP_BATCH}x{TP_SEQ}",
               "loss": round(float(got_m["loss"]), 6),
               "loss_rel": abs(float(got_m["loss"]) - float(want_m["loss"]))
               / abs(float(want_m["loss"])),
               "grad_norm_rel": abs(float(got_m["grad_norm"])
                                    - float(want_m["grad_norm"]))
               / float(want_m["grad_norm"]),
               "worst_mu_rel": worst, "worst_leaf": where}
        row.update(_tp_timed("plain", steps(torch.bfloat16, None)[0], want,
                             batches))
        del want
    del mu, state
    dist.barrier()
    row.update(_tp_timed("mesh", steps(torch.bfloat16, mesh)[0], got,
                         batches))
    dist.barrier()
    return row


def _tp_decode(dev, mesh, rank: int) -> dict:
    """Phase 16t on this card: {kv_shard: row}."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model as MDL
    from repro_torch.training.tree import cast_tree, leaves_with_paths

    cfg = dataclasses.replace(registry.get(DECODE_ARCH), n_layers=TP_LAYERS)
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    for _, t in leaves_with_paths(params):
        dist.broadcast(t, 0)                 # rank 0's draws on every card
    cache, tok, _ = filled_decode_cache(cfg, params, dev)
    for t in (cache["k"], cache["v"], tok):
        dist.broadcast(t, 0)                 # card 0's filled cache
    shape = ShapeConfig("decode_32k", DECODE_CACHE, DECODE_BATCH, "decode")
    rows = {}
    for kv in ("seq", "hd"):
        t0 = time.perf_counter()
        equal, logit_rel, worst, where = decode_paths(cfg, params, mesh,
                                                      cache, tok, shape, kv)
        rows[kv] = {"layers": f"{TP_LAYERS} of 28", "batch": DECODE_BATCH,
                    "positions": DECODE_CACHE, "steps": DECODE_STEPS,
                    "tokens_equal": equal, "logit_rel": logit_rel,
                    "worst_cache_rel": worst, "worst_leaf": where,
                    "f32_s": round(time.perf_counter() - t0, 2)}
    params = cast_tree(params, torch.bfloat16)
    cache = {"k": cache["k"].to(torch.bfloat16),
             "v": cache["v"].to(torch.bfloat16), "len": list(cache["len"])}
    for kv in ("seq", "hd"):
        rows[kv].update(_tp_decode_timed(cfg, params, mesh, cache, tok,
                                         shape, kv, rank))
    return rows


def _tp_decode_timed(cfg, params, mesh, cache, tok, shape, kv: str,
                     rank: int) -> dict:
    """`timed_decode_steps` in bf16 of the mesh serve step on every card,
    then of the plain serve step on card 0 (the others wait): ms a token
    and the peak and held memory of each path on this card."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import specs as SP
    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import make_serve_step

    spec = SP.cache_specs(cache, cfg, shape, mesh, ("data",), kv)
    paths = [("mesh", make_serve_step(cfg, mesh=mesh), lambda: (
        SH.shard_tree(params, MDL.param_layout(cfg, mesh), mesh),
        SH.shard_tree(cache, spec, mesh), spec))]
    if rank == 0:
        paths.append(("plain", make_serve_step(cfg),
                      lambda: (params, cache_copy(cache))))
    row = {}
    for name, step, make_args in paths:
        args = make_args()
        ms, peak, held, _, _ = timed_decode_steps(step, args, tok)
        row.update({f"{name}_ms_per_token": round(ms, 3),
                    f"{name}_peak_gib": round(peak / 2**30, 2),
                    f"{name}_held_gib": round(held / 2**30, 2)})
        del args
    dist.barrier()
    return row


def _tp_timed(name: str, step_fn, state, batches) -> dict:
    """TP_STEPS bf16 steps of `step_fn` from `state`: each step's ms
    (CUDA events), loss and the peak memory over them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, metrics, times = timed_steps(lambda s, b, mark: step_fn(s, b), state,
                                    batches)
    return {f"{name}_ms": [round(t[0], 3) for t in times],
            f"{name}_loss": [round(float(m["loss"]), 6) for m in metrics],
            f"{name}_peak_gib": round(torch.cuda.max_memory_allocated()
                                      / 2**30, 2)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of repro_torch on "
                                             "one NVIDIA card")
    ap.add_argument("--shuffled", default="fig1_shuffled")
    ap.add_argument("--banded", default="fig1_banded")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--tp-cards", type=int, default=0,
                    help="run phases 15t and 16t alone over this many "
                         "cards of one host, instead of the one-card run")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run this script "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    # the Fig. 1 pair is generated in memory every run; no npz cache
    os.environ.setdefault("REPRO_TORCH_MATRIX_CACHE", "off")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    # hermetic stores: every plan, reordering, operator and campaign record
    # of this run lives in a temporary directory, removed at the end, so
    # every timed number of the first campaign includes its tune
    stores = tempfile.mkdtemp(prefix="chip_smoke_stores_")
    for var, sub in (("REPRO_TORCH_PLAN_CACHE", "plans"),
                     ("REPRO_TORCH_OPERATOR_CACHE", "opcache"),
                     ("REPRO_TORCH_REORDER_CACHE", "reorder"),
                     ("REPRO_TORCH_RESULT_STORE", "results"),
                     ("REPRO_TORCH_RESULTS_DIR", "bench"),
                     ("REPRO_TORCH_CORPUS_CACHE", "corpus")):
        os.environ[var] = os.path.join(stores, sub)
    try:
        return tp_run(args, torch) if args.tp_cards else run(args, torch)
    finally:
        shutil.rmtree(stores, ignore_errors=True)


def tp_run(args, torch) -> int:
    """`--tp-cards N`: the environment, phases 15t and 16t over N cards,
    the cards' name and power limit, and the contract's last line."""
    t_run = time.perf_counter()
    if torch.cuda.device_count() < args.tp_cards:
        print(f"chip_smoke: --tp-cards {args.tp_cards} needs as many cards; "
              f"this host has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    phase("environment", t_run, nvidia_smi=json.dumps(smi),
          torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count())
    tp_cards_phase(args.tp_cards, smi)
    phase("total", t_run)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(args, torch) -> int:
    t_run = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    smi = nvidia_smi()
    phase("environment", t0, nvidia_smi=json.dumps(smi),
          torch=torch.__version__, cuda=torch.version.cuda,
          device=json.dumps(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count())

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    info = _build.BUILD_INFO
    phase("build", t0, library=info["path"], compiled=info["compiled"],
          nvcc_s=f"{info['seconds']:.2f}")
    print(f"[ptxas]\n{info['log'].strip()}", flush=True)

    t0 = time.perf_counter()
    checked = kernels_small(dev)
    phase("kernels small shapes", t0, comparisons=checked)
    t0 = time.perf_counter()
    checked = ssd_small(dev)
    phase("kernels small shapes ssd_chunk", t0, comparisons=checked)

    from repro_torch.matrices import suite

    t0 = time.perf_counter()
    mats = {args.shuffled: suite.get(args.shuffled),
            args.banded: suite.get(args.banded)}
    phase("matrices", t0, **{n: f"{m.m}x{m.n}/nnz={m.nnz}"
                             for n, m in mats.items()})
    campaign(dev, mats, args.iters)
    t0 = time.perf_counter()
    rmat = rcm_order(dev, mats[args.shuffled])
    phase("rcm order from the plan store", t0)
    schedule_campaign(dev)
    scheme_campaign(dev, args.iters)
    corpus_phase(dev, args.iters)
    bench = bench_phase(dev, mats)

    forced, vmat, recs = forced_paths(dev, rmat, args.iters)
    forced16, recs16 = bf16_paths(dev, vmat)
    recs.update(recs16)
    print(f"[launches] per path: "
          f"{json.dumps({t: r['launches'] for t, r in recs.items()})}",
          flush=True)

    t0 = time.perf_counter()
    rows = kernel_times(forced, vmat, dev, recs)
    rows += kernel_times(forced16, vmat, dev, recs, BF16_FEEDS, "_bf16")
    phase("kernel times", t0)
    t0 = time.perf_counter()
    rows += powerlaw_phase(dev, args.iters)
    phase("powerlaw kernel times", t0)

    t0 = time.perf_counter()
    planted_faults((forced, forced16), rmat, vmat, dev)
    phase("controls", t0)

    t0 = time.perf_counter()
    paths, half_rate = serve_phase(dev, mats)
    paths.update(bench)
    phase("serve", t0)
    t0 = time.perf_counter()
    paths.update(sharded_phase(dev, args.shuffled, mats[args.shuffled]))
    phase("sharded", t0)
    t0 = time.perf_counter()
    paths.update(route_phase(dev, mats, half_rate))
    del mats
    phase("route", t0)
    t0 = time.perf_counter()
    paths.update(workload_phase(dev))
    phase("workloads", t0)
    add_path_launches(rows, paths)
    print(f"[launches] service and workload paths: {json.dumps(paths)}",
          flush=True)

    t0 = time.perf_counter()
    del forced, forced16, rmat, vmat
    gc.collect()
    torch.cuda.empty_cache()
    phase("free spmv", t0,
          allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")
    lm = lm_prefill(dev)
    lm_decode(dev, lm)
    t0 = time.perf_counter()
    row, f32_args = ssd_times(lm)
    rows.append(row)
    phase("ssd times", t0)
    t0 = time.perf_counter()
    ssd_control(f32_args)
    del lm, f32_args
    gc.collect()
    torch.cuda.empty_cache()
    phase("ssd control", t0,
          allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")
    lm_families(dev)
    lm_tail(dev)
    k5_train, dense, zamba = lm_train(dev)
    k5_mesh = mesh_phase(dev, dense, zamba)
    del dense, zamba
    mesh_decode_phase(dev, smi)
    dryrun_phase()
    for row in rows:
        if row["name"] == "ssd_chunk":
            row["launches_paths"] = {
                row["launches_path"]: row["launches"],
                f"lm14c train step, {LM_ARCH} at 9 layers, B=1, "
                f"S={ZAMBA_TRAIN_SEQ}": k5_train,
                f"mesh15c train step on a (1, 1) mesh, {LM_ARCH} at 9 "
                f"layers, B=1, S={ZAMBA_TRAIN_SEQ}": k5_mesh}
            row["launches"] = sum(row["launches_paths"].values())
    phase("total", t_run)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
