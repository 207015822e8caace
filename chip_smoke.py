#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed 0]

Phases, in order (each failure is reported and the script exits 1):

  1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
  2. build: every CUDA source of the port, compiled in parallel (the
     dispatch profiler's step_cost counts of the two profiled geometries
     run beside it, on the host);
  3. K1 paged decode against its plain version at qwen2-0.5b's decode
     shapes (B=8, KV=2, G=7, hd=64, bs=16), ragged lengths with 0, 1, a
     block boundary and a full table, NULL-block entries, and one case
     with a window and a softcap, in fp32 and bf16; then the split-KV
     grid's edges: lengths at split boundaries +-1, a window spanning
     several splits, B = 1, nbs = 1, bs 8, hd 128 with G = 1 and 16, hd
     112, and hd 36 (rows that are not 16-byte aligned: byte copies);
     every call repeated bit-equal;
  4. K2 mpgemm against its plain version for OS, OS with k_fold 2 and 4,
     WS and IS at the path's GEMM shapes and two ragged shapes (37, 1000,
     900: TMA refuses it; 37, 1000, 904: TMA takes it), fp32/bf16; on the
     Hopper route also mamba2's in_proj, out_proj and head at M = 8 and
     2048 and OS folds 2, 3, 4 and 8 (more bands than cluster ranks at
     (8, 2560, 3072): 3 ranks); every bf16 case repeated bit-equal, and
     each case on the route ``mpgemm_route`` names (bf16 TMA can
     describe: Hopper; fp32 and K = 900: CUDA cores);
  5. the main path: qwen2-0.5b at full width (random weights from
     ``--seed``) served by the paged engine, 8 requests of 64-512 prompt
     tokens and 32 new tokens, under gemm_backend "xla" and "scheduled"
     (each run's launch counts zeroed just before it and read just after);
  6. scaled-down fp32 qwen2 under both backends: greedy tokens identical
     (weights x5, so that the greedy tokens vary);
  7. each kernel timed at the path's shapes beside its bound, its plain
     version and one library call that computes the same function (K1
     and K1-int8 at 32, 512 and 1024 tokens, with the fixed cost and the
     cost per block fitted over the three);
  8. one full-width decode step profiled (torch.profiler): wall time,
     device time, kernel launches, the heaviest kernels and K1's and
     K3's share, for the fp and the int8 model under both backends, and
     one int8 scheduled chunk step (8 slots x 32 rows).

The int8 quantized path adds, after phase 4:

  K1-int8 against its plain version on the cases of phase 3 with int8
  pools and fp32 scales; K3 (quant_matmul) against its plain version at
  every projection shape of the path at M = 1, 8, 16, 64, 65, 256 and
  2048, ragged N and K that TMA takes and that it refuses, K not a
  multiple of 64 and an unaligned x, x in fp32 and bf16, and every
  chunk tile of the Hopper route asked for at (2048, 4864, 896) and
  (300, 1008, 904): each case on the
  route ``quant_matmul_route`` names (bf16 TMA can describe: Hopper;
  fp32 and the rest: CUDA cores), every bf16 case repeated bit-equal, the
  calls under ``torch.cuda.set_sync_debug_mode("error")``; and after
  phase 6:

  the int8 main path: the same model and requests as phase 5 with
  ``quant_serving`` (int8 weights, int8 KV blocks), under both backends,
  with per-run launch counts (K3 168 a step under scheduled, every one on
  the Hopper route, and 0 under xla, K1-int8 24 a decode step, the fp K1
  never), the pool audit after
  every step, no schedule-cache miss and the KV bytes against the fp
  pool; and the scaled-down fp32 int8 model at weights x5: tokens
  identical across backends, agreement with the fp engine reported, and
  the reference's >= 0.99 agreement gate at its own test geometry.

The exact multi-precision integer GEMM (paper §3.1) adds, after K3:

  k4_vs_plain: K4 (limb_gemm) against its plain versions, ``torch.equal``
  and every call repeated bit-equal.  The planes entry on every diagonal
  plane: 1, 2, 3 and 5 limbs a side and la != lb, M, N, K on and off the
  tile grid (M or N = 1 and 2, K = 1, 7, 64, 129 and 9216), every tile of
  each digit count, limbs over the whole digit range and the digits of
  int32 min and max.  The fused entry (``ops.limb_matmul``) against the
  unfused composition: int8, int16 and int32 at their extremes on the
  timed shapes and ragged ones (rows not 16-byte aligned), mixed dtypes
  with ``in_bits``, values wider than ``in_bits``, every tile of each
  dtype, K split over a cluster; both entries once under
  ``torch.cuda.set_sync_debug_mode("error")`` (``--phases k4_vs_plain``
  is the cheap first call after a kernel edit); and after the int8
  scaled-down phase:

  limb_path: ``ops.limb_matmul`` end to end on every integer p-GEMM of
  the MD (15 INT32 trailing updates), FFE (INT16 FIR) and ALI (INT8 fc6,
  fc7, fc8 at batch 32) workloads of the port's ``core.workloads``, the
  example's shape and kernels_bench's two: (hi, lo) bit-equal to the
  numpy ``int_matmul_mod64_ref`` on the host, ``combine_diagonals`` on
  the card bit-equal to its CPU result, the explorer's schedule printed
  beside each, and K4's launch count and the CUDA kernels
  ``torch.profiler`` sees (zeroed just before, read just after) both
  equal to the number of calls: one kernel a call.  Phase 7 times the
  fused entry (the whole ``limb_matmul``) and its host wall a call, the
  planes entry, the plain composition and la*lb ``torch._int_mm`` calls
  (context) at md.update960, ffe.fir and alexnet.fc6.

The Mamba2 (SSD) path adds, after K4:

  k5_vs_plain: K5 (ssd_intra) against its plain version within rtol =
  atol = 2e-4 at G in {1, 640}, Q in {32, 256}, P = 64, N = 128, a ragged
  case, the reference test's two shapes, a case whose cums fall by 300
  across the chunk (every masked exponent overflows exp: no NaN may
  appear) and a case with dt = 0 on a pad tail; the grouped entry
  ``ssd_intra_chunked`` (the path's call: x, dt, cums in (B, nc, Q, H, .),
  B and C per group) at full width (B 8, H 80, G 1, Q 256 and 32), with
  G = 2 and a ragged head block, cums falling by 300, a 100-row dt = 0
  tail, ragged Q, 4-byte copies and strided views, each launched twice
  and bit-equal; then the port's
  ``ssd_chunked`` (K5 inside) against a sequential fp64 recurrence at
  H = 80, P = 64, N = 128, S = 512 (two chunks of 256) with an initial
  state.  After the int8 main path:

  mamba2_path: mamba2-2.7b at full width (random weights from ``--seed``,
  bf16), 8 slots, max_len 1024, ``prefill_chunk=256`` (the published
  chunk), phase 5's request shape, under both backends with the pool
  audit after every step: K5 launches 64 a chunk step and none in decode,
  K2 129 a step (in_proj and out_proj of 64 layers, and the head) under
  scheduled and 0 under xla, K1 never.  After the int8 scaled-down phase:

  mamba2_scaled_down_fp32: scaled-down mamba2 (fp32, init-scale weights)
  at ``prefill_chunk`` 32 and 64: greedy tokens identical across
  backends, at least 4 distinct tokens a request.  Phase 7 times K5 at
  G = 640, Q = 32 and 256 (per-head layout) and at the path's grouped
  call (B 8, H 80, G 1, Q 256 and 32), and phase 8 profiles a full-width
  mamba2 decode step and prefill chunk step under both backends, with
  K5's device time and the aten ops behind the chunk step's device time.

The spill epilogue (K6, the partial-plane baseline of the scheduled GEMM)
adds, after K5:

  k6_vs_plain: K6 (``mpgemm_spill``) plane by plane against its plain
  version within rtol = atol = 1e-4 (fp32 planes): WS and IS at folds 1
  and 3 (ignored: one plane a K block), OS at folds 2 and 3, every tile,
  bk in {32, 64, 128}, fp32 and bf16, a ragged K (763: 24, 12 and 6 K
  blocks; the CUDA-core route); a transposed B; every dispatch of
  ``spill_path`` (bf16, the tiles ``ops.plan_blocks`` picks); on the
  Hopper route mamba2's GEMMs, (37, 1000, 904) at every Hopper tile and
  bk 64 and 128, and OS folds 2, 3, 4 and 8; two runs of K6 and of the
  whole spill ``ops.matmul`` bit-equal; and OS whose fold degrades to 1
  launching K2, not K6.  After limb_path:

  spill_path: the six GEMM shapes full-width qwen2-0.5b registers in
  ``ContinuousEngine._register_gemms`` (q, k/v, o, gate/up, down, head),
  bf16, at M = 8 (decode, 8 slots) and M = 256 (8 slots x the engine's
  default ``prefill_chunk`` 32), each through ``ops.matmul`` under OS
  ``k_fold=2``, WS and IS with ``epilogue="fused"`` and ``"spill"``
  (fp32 out): spill against fused and both against an fp64 product
  (|diff| / (1 + |ref|) <= 1e-4: bf16 products are exact in fp32, so only
  the order of the fp32 sums differs), the plane bytes of
  ``dispatch_plan`` against the ``max_memory_allocated`` rise over the
  call (spill >= the planes, fused <= the output + 1 MiB), K6 launched
  once per spill dispatch and never for fused, every launch on the
  Hopper route, then each dispatch timed.  Phase 7 times K6, its
  reduction, the whole spill matmul, the fused one, the plain version
  and ``torch.matmul`` at the down projection (256, 896, 4864).

The engine's request path (sampling, admission policies, speculative
decoding) adds, after spill_path, each full-width run on the scheduled
backend with the pool audit after every step:

  sampled_path: the sampler on fixed logits at the head's shape (8 x
  151936, N(0, 16)) at T 0.5-1.2, >= 20 000 draws a row, within
  ``sampling.softmax_tv_bound`` of softmax(logits / T) in total
  variation, greedy rows the argmax, its time beside argmax's; then four
  of phase 5's requests (rids 4-7, 8 tokens), two at T = 0.8, for the
  fp and the int8 model and mamba2-2.7b (prefill_chunk 256), beside a
  greedy run of the same requests: greedy rows equal to it (and to the
  main path's first 8 tokens), one seed twice the same tokens, another
  seed other sampled tokens, K1, K1-int8, K2, K3 and K5 launches equal
  to the greedy run's;

  policy_path: serve_bench's overload trace (``launch/traces.py``: 12
  requests, 4 slots, max_len 160) under fifo, best_fit, slo_preempt,
  model_fit and model_preempt in the 20-block pool where FIFO's
  oversized head blocks, and slo_preempt at 32 blocks, where its
  preemption is for a slot and the resumption maps the victim's cached
  blocks, and fifo in an unconstrained pool: fifo backs off,
  slo_preempt preempts, resumed requests skip their cached prefill, the
  non-preempting policies give fifo's tokens, no schedule-cache miss,
  and every request whose bf16 tokens part from fifo's parts where its
  two tokens lie within rounding (``divergences``: their gap in a third
  route's logits at most twice K2's bf16 tolerance); preemptions, mean
  pool utilisation, p95 TTFT in engine dispatches and token agreement
  reported; the same runs on scaled-down fp32 qwen2 (weights x4): every
  run token-identical;

  spec_path: serve_bench's repetition trace (8 requests, 8 slots,
  max_len 96) vanilla, with ``ngram`` k = 4, a self-drafting
  ``ModelDraft`` and a divergent one (weights from another seed, x4; 8
  tokens a request): accepted < drafted for the divergent draft,
  self-draft acceptance, no schedule-cache miss (the verify family, head
  (40, 151936, 896), registered at construction), bf16 divergences from
  vanilla within rounding as above; a verify call's logits at position 0
  against a decode step's on a copy of the same cache (``verify_gate``:
  in fp32 within K2's fp32 tolerance, in bf16 within twice the bf16
  decode's distance from the fp32 one); the same four runs on
  scaled-down fp32: tokens identical to
  vanilla; the device time of a verify step beside a decode step's.
  Phase 7 times K2 at the verify head too.

The families served since qwen1.5 add, after spec_path:

  families_path: qwen1.5-4b, chatglm3-6b, gemma2-9b, llava-next-
  mistral-7b (its text path) and zamba2-7b at their published widths
  (random weights from ``--seed``, bf16), one at a time, on the
  scheduled backend with the pool audit after every step: 4 of phase
  5's request shapes with 16 new tokens, 8 slots, max_len 1024,
  ``prefill_chunk`` 256; gemma2 adds a 4200-token prompt past its 4096
  window (max_len 4352, chunk 1024); qwen1.5 runs again int8 (K3 on
  every projection and the untied head, K1-int8).  Every request ok;
  K1 (or K1-int8) launched exactly once an attention layer a decode
  step (40, 28, 42, 32 and 13), K5 68 times a zamba2 chunk step and
  never in decode, K2 (or K3) exactly once a GEMM a step, every launch
  on the Hopper route; one chunk and one decode step of gemma2 and
  zamba2 profiled as in phase 8.  Then one phase an arch,
  ``<arch>_scaled_down_fp32``: the scaled-down fp32 model (gemma2 and
  llava at window 16) under both backends, greedy tokens identical and
  at least 4 distinct a request.  K1 at gemma2's heads (hd 256, G 2,
  window, softcap), K2 at each family's GEMMs, K3 at qwen1.5's int8
  shapes and K5 at zamba2's (H 112, N 64) join phases 3, 4, 4b and 4d;
  phase 7 times K1 at gemma2's heads (512 and 4200 tokens) and K5 at
  zamba2's call.  The end of the run prints these phases' seconds
  beside the others'.

The dense serving layout adds, after the families' phases:

  dense_path: full-width qwen2-0.5b, bf16, scheduled, through the paged
  engine, the dense engine (``paged=False``: batch-1 bucketed admissions
  into dense stripes) and ``WaveEngine`` on phase 5's requests (8 slots,
  max_len 1024) and on serve_bench's mixed trace (its ``--dry`` run: 8
  requests, 4 slots, max_len 160, ``launch/traces.py``), each after a warm-up: tok/s, TTFT
  p50 and TPOT p50 of each; serve_bench's four gates (dense fewer decode
  steps than the wave -- on the mixed trace: phase 5's requests fit one
  wave with one budget --, the wave as many tokens as dense, paged
  tokens the dense ones but for near-ties (``divergences``), paged peak
  KV below dense); every request ok; K1 never in dense or wave runs and
  once a layer a paged decode step; K2 once a GEMM a step (169), a
  prefill counting as a step; dense again int8 (K3 168 a step, K2 on the
  tied head); mamba2-2.7b and zamba2-7b through the dense engine (4
  requests, 16 new): K5 64 and 68 times a prefill, never in decode;
  every launch on the Hopper route;

  patches_path: llava-next at full width, bf16, scheduled: four rows of
  1152 stub patch embeddings (normal x 0.02) ahead of 256-512 text
  tokens through ``network.prefill``, 16 greedy dense decode steps, the
  same text behind zero patches (the first logits must move), then one
  row of 1152 + 3194 positions (max_len 4608) past the 4096 window: K2
  225 launches a step and one more (vision_proj) a prefill, all Hopper,
  K1 never, logits finite;

  dense_scaled_down_fp32: scaled-down fp32 qwen2 (x4), mamba2, zamba2
  and gemma2 (window 16): the dense engine token-identical across
  backends, the paged engine equal to it, the wave as many tokens; llava
  (window 16) with 8 patch positions: prefill and 8 decode steps
  token-identical across backends.

  K2 at the dense rows (admissions of 16, 512 and 1024 rows, a wave
  prefill of 4096, the one-row head, mamba2 at 512, vision_proj at
  (4608, 4096, 4096)) joins phase 4 and K5 at batch 1 with a pad tail
  in the last chunk phase 4d; phase 7 times K2 and K5 at those shapes
  and phase 8 profiles a dense decode step beside the paged one, with
  ``_flash``'s CUDA-event span.  The end of the run prints the time
  split of each slice: the families since qwen1.5 and this one.

The request lifecycle (the async API, the lifecycle tracer and the
resilience plane) adds, after dense_scaled_down_fp32:

  resilience_path: full-width qwen2-0.5b, bf16, scheduled, 8 slots,
  max_len 1024, phase 5's requests: a fault-free synchronous run with
  the tracer on, then the same engine through ``start()`` /
  ``submit()`` / ``get_result()`` / ``stop()`` under ``Telemetry.on()``
  with a fault schedule (a ``reserve`` denial, a transient ``dispatch``
  fault on a decode step of the trace's last stretch, a ``poison`` on
  one rid), a ``cancel`` of a running rid, a ``deadline_s`` half the
  fault-free latency of another and ``max_pending`` 8 with a ninth
  request submitted (shed).  Gates: one Result a request with the
  status and error its fault calls for; the pool audit after every step
  and at the end; ok tokens those of the fault-free run but for
  near-ties (``divergences``); the Chrome trace valid, its admit /
  preempt / finish counts the registry's; K1 launches a decode step and
  K2 launches a step those of the synchronous run; the fault counters.
  Prints a decode step's wall (8 slots decoding) under
  ``Telemetry.off()`` and ``on()``;

  restart_path: ``serve_with_restarts`` at full width through a
  ``crash`` in mid-trace on the same requests: one Result a request, all
  ok, tokens those of the uncrashed run but for near-ties,
  ``KVPool.from_snapshot(s).snapshot_state() == s`` for the dead pool's
  state, and a launch failure injected as a ``KernelError`` (from
  ``_build.check_launch``) leaving ``step()`` with no Result and no
  retry;

  resilience_scaled_down_fp32: both drills on scaled-down fp32 qwen2
  (x4): ok tokens equal to the fault-free run's, a cut request's a
  prefix of them;

  serve_cli_path: ``launch/serve.py`` at full width (scheduled) with
  ``--trace-out``, ``--metrics-out`` and ``--profile`` into a temporary
  directory: the trace valid, the Prometheus text written, K1 and K2
  launched; then ``python -m repro_torch.launch.trace_report <trace>
  --validate`` and ``python -m repro_torch.launch.plan_report drift`` on
  that trace, both returning 0.

The dispatch profiler and the planner add, after serve_cli_path:

  profile_path: full-width qwen2-0.5b, bf16, scheduled, 8 slots, max_len
  1024, phase 5's requests through ``run()`` under
  ``Telemetry.on(profile=True)``, right after an unprofiled engine on
  the same requests.  Gates: the tokens identical; calibration spans of
  all four dispatches; K1 24 launches a decode step and K2 169 a step
  while serving (counters zeroed after the profiler's attach); the
  unprofiled engine's caches, tables, cursors, pool, sampler and
  schedule statistics bit-identical across an ``attach`` after its run;
  a calibration fitted from the
  profiled run's own trace; the planner's replay of that trace giving
  the engine's ``steps`` and ``chunk_steps``, its construction moving no
  schedule hit or miss.  Prints each dispatch's mean wall (calibration
  and serve), modeled cycles, flops and bytes, the fitted
  ``ns_per_cycle``, ``host_us_per_dispatch`` and ``startup_us``, the
  TTFT p95 and TPOT drift against the reference's +-30% bound (not
  gated), and the profiled wall beside the unprofiled one;

  profile_scaled_down_fp32: scaled-down fp32 qwen2 (x4) and mamba2:
  profiled tokens equal to unprofiled ones, and every state of an
  engine attached mid-flight bit-identical.

policy_path also runs ``model_preempt`` on
``WorkloadModel(cfg, geom).step_costs()`` at the overload geometry,
beside the prior's row, and prints serve_bench's three ``policy_model``
gates (tokens equal to fifo's, p95 TTFT steps at most slo_preempt's,
mean pool utilization at least best_fit's).  The time split prints
this slice: its phases and its cases inside policy_path and
serve_cli_path.

Quantized SSM serving, MoE with llama4-scout and the paper's tables add,
after profile_scaled_down_fp32:

  ssm_quant_path: mamba2-2.7b and zamba2-7b at published width, int8
  under the engine's default policy (in_proj, out_proj, zamba2's shared
  attention and the untied heads; zamba2's shared attention on int8 KV
  blocks), phase 5's request shape at chunk 256, under both backends
  with the pool audit after every step: K3 once a GEMM a step under
  scheduled (mamba2 129, zamba2 189), none under xla, K5 once a MAMBA2
  layer a chunk step (64, 68), K1-int8 once a shared-attention layer a
  decode step (zamba2 13), K2 and the fp K1 never; tok/s, TTFT p50 and
  TPOT p50 beside the fp runs of mamba2_path and families_path;

  ssm_quant_scaled_down_fp32: scaled-down int8 mamba2 and zamba2 (every
  projection, init-scale weights): tokens identical across backends;

  moe_path: llama4-scout at its published widths (d 5120, 40 / 8 heads,
  hd 128, 16 experts of 8192 with top-1, the shared expert, vocab
  202048), the depth cut from 48 to 8 layers (about 37 GiB of bf16
  weights against 200.7 GiB, built layer by layer on the card), 8
  requests of 64-512 prompt tokens and 32 new, 8 slots, max_len 1024,
  chunk 256, under both backends, fp and then int8, the pool audit after
  every step: K1 (K1-int8) 8 a decode step, K2 65 a step under fp
  scheduled, K3 57 and K2 8 (the router) under int8 scheduled, every
  launch on the Hopper route, no slot dropped in a decode step, the
  dropped (token, expert) slots of each chunk step reported; one chunk
  and one decode step profiled;

  moe_scaled_down_fp32: scaled-down llama4 (x4), fp and int8: tokens
  identical across backends;

  paper_tables: ``repro_torch.launch.paper_tables`` on this machine,
  which has no JAX: every table's derived number equal to
  ``tests/_paper_expected.py`` (the values the CPU parity test holds),
  and its CLI.

  K1 at llama4's heads (G 5) and zamba2's 32 KV heads join phase 3 and
  4b, K2 at llama4's GEMMs (the router's N = 16 included) phase 4, K3 at
  the SSM in_proj / out_proj, zamba2's shared attention, the SSM heads
  (mamba2's on the CUDA cores) and llama4's int8 GEMMs phase 4b; phase 7
  times K1 and K1-int8 at those heads, K2 at the router and the shared
  expert, K3 at the SSM shapes (8 and 2048 rows) and the routed experts'
  ``torch.bmm`` as context.  The time split prints this slice.

Training adds, after mla_scaled_down_fp32:

  k5_bwd_vs_plain: K5-bwd (``ssd.ssd_intra_chunked_bwd``, the SSD
  intra-chunk backward: dx, d dt, d cums, dB, dC) against its plain
  version at mamba2's and zamba2's training calls (B 4, nc 4, Q 256; H
  80 / 112, N 128 / 64), G = 2 with a ragged head block, Q = 32, a ragged
  Q, strided operands with a permuted dy, an unaligned x and dy, and
  cums falling by 300: each output within 2e-4 of its max, finite, a
  repeat bit-equal; then the autograd Function on the card against the
  CPU (one K5 and one K5-bwd launch);

  train_scaled_down_fp32: the same CPU-made weights and batch on the
  card and on the CPU for scaled-down qwen2, mamba2, zamba2, hubert and
  deepseek-v2 (fp32, TF32 off): the loss within 1e-5 relative, every
  gradient leaf within 1e-4 of its max; K5 and K5-bwd once a MAMBA2
  layer; the restart drill (12 steps, a checkpoint every 4, a failure
  at step 6) at the clean run's final loss within 1e-5 abs;

  train_path: ``launch.train.train`` at full width (bf16, remat, xla,
  1024-token rows, ``N.init`` from --seed): qwen2-0.5b 8 steps at batch
  8 with a checkpoint every 4 and a failure at step 6 against a clean
  run (the resume at step 4, its batches byte-equal, the final loss
  equal), mamba2-2.7b 4 steps at batch 4, hubert-xlarge 4 steps at
  batch 8: finite losses, grad norms > 0, K5 2 x 64 and K5-bwd 64 a
  mamba2 step (remat: the forward and the recompute), K1, K2, K3 never;
  step wall, one profiled step's device time and busy share, tokens/s,
  6 N tokens / time against the bf16 dense peak, peak memory and the
  checkpoint's bytes and write time.

  Phase 7 times K5-bwd at mamba2's training call beside its bound, its
  plain version and autograd through the plain forward (context; no
  PyTorch call computes this backward).  The time split prints this
  slice.

The main paths (phase 5, mamba2_path, spill_path) report K2's launches
by route (``mpgemm.launches_by_route``) and fail when a bf16 GEMM took
the CUDA-core route; the int8 main path does the same for K3
(``quant_matmul.launches_by_route``).  Phase 7 times K2 at qwen2's and
mamba2's GEMMs (M = 8, 256 and 2048) with ``torch.matmul`` beside each,
and K3 at the int8 path's eight shapes with its route, tile and cluster
ranks, ``torch._weight_int8pack_mm`` and ``torch.mm`` over the
dequantized weight, the timing method's floor and the host time of a
call (``launch/quant_tiles.py``).

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without a CUDA card, or without the
port beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

K1_SOURCE = "src/repro_torch/kernels/csrc/paged_decode.cu"
K1_REPLACES = "src/repro/kernels/paged_attention.py:123"
K2_SOURCE = "src/repro_torch/kernels/csrc/mpgemm.cu"
K2_REPLACES = "src/repro/kernels/mpgemm.py:183"
K1I_REPLACES = "src/repro/kernels/paged_attention.py:87"
K3_SOURCE = "src/repro_torch/kernels/csrc/quant_matmul.cu"
K3_REPLACES = "src/repro/kernels/quant_matmul.py:45"
K4_SOURCE = "src/repro_torch/kernels/csrc/limb_gemm.cu"
K4_REPLACES = "src/repro/kernels/limb_gemm.py:61"
K5_SOURCE = "src/repro_torch/kernels/csrc/ssd_intra.cu"
K5_REPLACES = "src/repro/kernels/ssd.py:52"
# K6 lives in K2's source; it replaces _partial_kernel (:148) and
# _os_fold_spill_kernel (:157)
K6_REPLACES = "src/repro/kernels/mpgemm.py:148"
# K5-bwd replaces no Pallas kernel (the reference differentiates its plain
# jnp SSD): "replaces" names the reference function it differentiates
K5B_SOURCE = "src/repro_torch/kernels/csrc/ssd_intra_bwd.cu"
K5B_REPLACES = "src/repro/kernels/ssd.py:83"


class Smoke:
    def __init__(self, args):
        self.args = args
        self.failures: list[str] = []
        self.report: dict = {"phases": {}}
        self.kerr = {"paged_decode": 0.0, "mpgemm": 0.0,
                     "paged_decode_int8": 0.0, "quant_matmul": 0.0,
                     "limb_gemm": 0.0, "ssd_intra": 0.0,
                     "mpgemm_spill": 0.0, "ssd_intra_bwd": 0.0}

    def phase(self, name: str, fn) -> None:
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            status = "ok"
        except Exception:  # noqa: BLE001 - every phase reports, then exit 1
            traceback.print_exc()
            self.failures.append(name)
            status = "FAILED"
        dt = time.perf_counter() - t0
        self.report["phases"][name] = {"status": status, "seconds": dt}
        print(f"== {name}: {status} ({dt:.1f} s)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (device and build "
                         "always run); a partial run prints no result")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: the port (src/repro_torch) is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))     # _family_scales (no jax)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from _family_scales import ARCHS as FAMILIES
    from _family_scales import FAMILY_SCALES, WINDOW, WINDOWED, family_config
    from _cow_fork import forced_forks
    from repro_torch import configs as CONFIGS
    from repro_torch.core import workloads as WL
    from repro_torch.core.dataflow import Dataflow
    from repro_torch.core.pgemm import PGEMM, split_paths
    from repro_torch.core.precision import INT16, INT32, precision_for_dtype
    from repro_torch.core.scheduler import GTAConfig, ScheduleCache, explore
    from repro_torch.core.tiling import HOPPER_TILES, KERNEL_TILES
    from repro_torch.kernels import _build
    from repro_torch.kernels import accumulator as ACC
    from repro_torch.kernels import limb_gemm as LG
    from repro_torch.kernels import mpgemm as MP
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import ref as KREF
    from repro_torch.kernels import ssd as SSD
    from repro_torch.launch import limb_tiles as LT
    from repro_torch.launch import traces as TRACES
    from repro_torch.launch import quant_tiles as QT
    from repro_torch.launch import serve as SERVE
    from repro_torch.launch import ssd_tiles as SSD_T
    from repro_torch.launch.timing import (bound_ms, card_line, host_us,
                                           kernel_ms, time_ms, top_ops)
    from repro_torch.models import attention as ATT
    from repro_torch.models import network as N
    from repro_torch.models.config import BlockKind
    from repro_torch.models import ssm as SSM
    from repro_torch.models.layers import tree_map
    from repro_torch.obs import (DISPATCH_NAMES, DispatchProfiler,
                                 Telemetry, validate_chrome_trace)
    from repro_torch.planner import (EngineGeometry, WorkloadModel,
                                     calibration_from_events,
                                     requests_from_trace)
    from repro_torch.planner.calibrate import dispatch_spans, drift_rows
    from repro_torch.planner.model import measured_latencies
    from repro_torch.quant.policy import QuantPolicy, serving_quant_params
    from repro_torch.serving import sampling as SAMPLING
    from repro_torch.serving.engine import (ContinuousEngine, Request,
                                            WaveEngine)
    from repro_torch.serving.kv_pool import KVPool
    from repro_torch.serving.policy import POLICY_NAMES, ModelPreemptPolicy
    from repro_torch.serving.resilience import (FaultPlane, FaultSpec,
                                                ResilienceConfig,
                                                serve_with_restarts)
    from repro_torch.serving.spec import ModelDraft

    dev = torch.device("cuda")
    sm = Smoke(args)
    rep = sm.report
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    #: seconds of each slice's cases inside the earlier phases (K1, K2,
    #: K3 and K5 checks, timing rows), by slice and phase: the families
    #: since qwen1.5 and the dense path
    added_s: dict = {"families": {}, "dense": {}, "resilience": {},
                     "profile": {}, "moe": {}, "mla": {}, "train": {}}

    def added(phase, t0, slice_="families"):
        got = added_s[slice_]
        got[phase] = got.get(phase, 0.0) + time.perf_counter() - t0

    # -- 1. device ---------------------------------------------------------
    def p_device():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rep["device"] = {"name": kind, "count": torch.cuda.device_count(),
                         "nvidia_smi": card, "torch": torch.__version__,
                         "cuda": torch.version.cuda}
        print(card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
              f"TF32 off (matmul and cuDNN): fp32 products are true fp32")

    # -- 2. build ----------------------------------------------------------
    def warm_step_costs(out):
        """The dispatch profiler's step_cost counts (fake tensors, host
        only) at the two geometries this run profiles at full width,
        memoized by ``dispatch_costs``: computed while nvcc builds."""
        t0 = time.perf_counter()
        try:
            from repro_torch.launch.step_cost import dispatch_costs
            cfg = dataclasses.replace(CONFIGS.get("qwen2_0_5b"),
                                      gemm_backend="scheduled")
            for slots, max_len in ((4, 256), (8, 1024)):
                dispatch_costs(cfg, slots=slots, max_len=max_len,
                               block_size=16, prefill_chunk=32, spec_k=4)
        except Exception as e:  # noqa: BLE001 - re-raised by p_build
            out["error"] = e
        out["seconds"] = time.perf_counter() - t0

    def p_build():
        t0 = time.perf_counter()
        warm: dict = {}
        thread = threading.Thread(target=warm_step_costs, args=(warm,))
        thread.start()
        try:
            logs = _build.build(ptxas_info=True)
        finally:
            thread.join()
        rep["build_s"] = time.perf_counter() - t0
        rep["step_cost_warm_s"] = warm["seconds"]
        print(f"step_cost of the profiled geometries, beside nvcc: "
              f"{warm['seconds']:.1f} s")
        if "error" in warm:
            raise warm["error"]
        rep["build_logs"] = logs
        for name, log in logs.items():
            used = [ln.strip() for ln in log.splitlines() if "Used" in ln]
            print(f"{name}: {len(used)} kernels; " + (used[0] if used else ""))
        print(f"built {list(logs)} in {rep['build_s']:.1f} s (nvcc, parallel)")

    # -- 3. K1 against its plain version -----------------------------------
    def decode_inputs(dtype, lens, B=8, KV=2, G=7, hd=64, bs=16, nbs=64,
                      seed=1):
        gen = torch.Generator(device=dev).manual_seed(seed)
        nb = 1 + B * nbs
        q = torch.randn(B, KV, G, hd, generator=gen, device=dev)
        k = torch.randn(nb, bs, KV, hd, generator=gen, device=dev)
        v = torch.randn(nb, bs, KV, hd, generator=gen, device=dev)
        table = (1 + torch.randperm(nb - 1, generator=gen, device=dev)
                 [:B * nbs]).reshape(B, nbs).int()
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        for b in range(B):
            table[b, -(-lens[b] // bs):] = 0         # NULL past the length
        return [t.to(dtype) for t in (q, k, v)] + [table, lens_t]

    def int8_kv(shape, seed):
        """Random int8 K/V pools and fp32 scales of the size amax / 127
        takes for values of order 1."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        k8, v8 = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (0.001 + 0.03 * torch.rand(shape[:3], generator=gen,
                                            device=dev) for _ in range(2))
        return k8, v8, ks, vs

    # K1's split grid at its edges (B, KV, G, hd, bs, nbs, lengths, window,
    # softcap): qwen2 splits 64 positions (split_plan: 4 blocks of 16),
    # B = 1 splits 32, nbs = 1 is one split; hd 128 with G = 1 and 16 and
    # hd 112 with G = 1 are qwen1.5's, chatglm3's and zamba2's heads
    k1_split_cases = {
        "split_edges": (8, 2, 7, 64, 16, 64,
                        [63, 64, 65, 127, 128, 129, 0, 1024], None, None),
        "window_over_splits": (8, 2, 7, 64, 16, 64,
                               [1024, 700, 300, 129, 64, 5, 0, 1000], 200,
                               None),
        "B1": (1, 2, 7, 64, 16, 64, [777], None, 30.0),
        "nbs1": (8, 2, 7, 64, 16, 1, [0, 1, 15, 16, 8, 3, 2, 16], None,
                 None),
        "bs8": (8, 2, 7, 64, 8, 32, [0, 1, 31, 32, 33, 256, 100, 7], 50,
                None),
        "hd128_G1": (8, 4, 1, 128, 16, 64,
                     [0, 1, 63, 64, 65, 1024, 500, 9], None, None),
        "hd128_G16": (8, 2, 16, 128, 16, 64,
                      [0, 1, 63, 64, 65, 1024, 500, 9], None, None),
        "hd112_G1": (4, 2, 1, 112, 16, 32, [0, 33, 64, 512], 100, None),
        # 72-byte bf16 rows (36 fp32: 144): not all 16-byte aligned
        "hd36_bytes": (3, 2, 5, 36, 16, 8, [0, 40, 128], None, None),
        # qwen2's heads at the new paths' decode geometries: policy_path
        # (4 slots, max_len 160: 10 blocks a table) and spec_path (8
        # slots, max_len 96: 6 blocks)
        "qwen2_B4_nbs10": (4, 2, 7, 64, 16, 10, [0, 17, 100, 160], None,
                           None),
        "qwen2_B8_nbs6": (8, 2, 7, 64, 16, 6,
                          [0, 1, 26, 27, 50, 64, 95, 96], None, None),
        # families_path: gemma2's heads (hd 256 = MAX_HEAD_DIM, G 2,
        # window 4096, softcap 50; 272 blocks = max_len 4352, lengths on
        # both sides of the window) and llava's (hd 128, G 4, a window)
        "gemma2_hd256_G2": (8, 8, 2, 256, 16, 272,
                            [0, 1, 4095, 4096, 4097, 4200, 100, 4352], 4096,
                            50.0),
        "llava_hd128_G4": (8, 8, 4, 128, 16, 64,
                           [0, 1, 299, 300, 301, 1024, 700, 9], 300, None),
        # moe_path's llama4-scout heads (40 over 8 KV heads: G 5, hd 128)
        # and ssm_quant_path's zamba2 shared attention (32 KV heads, G 1,
        # hd 112, int8 KV there)
        "llama4_hd128_G5": (8, 8, 5, 128, 16, 64,
                            [0, 1, 63, 64, 65, 1024, 500, 9], None, None),
        "zamba2_hd112_G1_KV32": (8, 32, 1, 112, 16, 64,
                                 [0, 1, 63, 64, 65, 1024, 500, 9], None,
                                 None),
    }
    #: the slice each of the later split cases belongs to (time split)
    k1_case_slice = {"gemma2_hd256_G2": "families",
                     "llava_hd128_G4": "families",
                     "llama4_hd128_G5": "moe",
                     "zamba2_hd112_G1_KV32": "moe"}

    def check_k1(quant: bool):
        """K1 (or K1-int8) against its plain version: today's qwen2 cases
        (window and softcap on and off) and the split-grid cases, fp32 and
        bf16, each call repeated bit-equal, length-0 rows zeros."""
        name = "paged_decode_int8" if quant else "paged_decode"
        cases = [(f"{w}/{c}", 8, 2, 7, 64, 16, 64,
                  [0, 1, 16, 17, 1024, 300, 511, 64], w, c)
                 for w, c in ((None, None), (200, 30.0))]
        cases += [(k,) + v for k, v in k1_split_cases.items()]
        out = {}
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            for key, B, KV, G, hd, bs, nbs, lens, window, cap in cases:
                t0 = time.perf_counter()
                slice_ = k1_case_slice.get(key)
                q, k, v, table, lens_t = decode_inputs(
                    dtype, lens, B=B, KV=KV, G=G, hd=hd, bs=bs, nbs=nbs)
                kw = dict(scale=0.125, window=window, logit_cap=cap)
                if quant:
                    k, v, kw["k_scale"], kw["v_scale"] = int8_kv(k.shape, 2)
                got = PA.paged_decode(q, k, v, table, lens_t, **kw)
                again = PA.paged_decode(q, k, v, table, lens_t, **kw)
                want = PA.gather_fallback(q, k, v, table, lens_t, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                key = f"{str(dtype)[6:]} {key}"
                plan = PA.split_plan(B, KV, nbs, bs)
                out[key] = {"err": err, "split_plan": plan}
                sm.kerr[name] = max(sm.kerr[name], err)
                zeros = all(not got[b].any() for b in range(B)
                            if lens[b] == 0)
                equal = torch.equal(got, again)
                ok = err <= tol and zeros and equal \
                    and bool(torch.isfinite(got).all())
                print(f"{'K1-int8' if quant else 'K1'} {key} (blocks a "
                      f"split, splits {plan}): max|err| {err:.3e} (tol "
                      f"{tol}), repeat bit-equal {equal} "
                      f"{'ok' if ok else 'MISMATCH'}")
                if slice_:
                    added("k1_int8_vs_plain" if quant else "k1_vs_plain",
                          t0, slice_)
                if not ok:
                    raise AssertionError(f"{name} {key}: err {err} > {tol},"
                                         f" non-zero length-0 row or a "
                                         f"repeat that differs")
        rep["k1_int8_check" if quant else "k1_check"] = out

    def p_k1():
        check_k1(False)

    # -- 4. K2 against its plain version ------------------------------------
    path_nk = [(896, 896), (128, 896), (4864, 896), (896, 4864),
               (151936, 896)]
    # mamba2-2.7b's in_proj, out_proj and tied head (N, K)
    m2_nk = [(10576, 2560), (2560, 5120), (50280, 2560)]
    # families_path's projections (q, k/v, o, gate/up, down; zamba2's
    # shared attention and mamba in_proj and out_proj) and heads (N, K)
    fam_nk = {"qwen1_5_4b": [(2560, 2560), (6912, 2560), (2560, 6912),
                             (151936, 2560)],
              "chatglm3_6b": [(4096, 4096), (256, 4096), (13696, 4096),
                              (4096, 13696), (65024, 4096)],
              "gemma2_9b": [(4096, 3584), (2048, 3584), (3584, 4096),
                            (14336, 3584), (3584, 14336), (256000, 3584)],
              "llava_next_mistral_7b": [(1024, 4096), (14336, 4096),
                                        (4096, 14336), (32000, 4096)],
              "zamba2_7b": [(3584, 3584), (14576, 3584), (3584, 7168),
                            (32000, 3584)]}
    # moe_path's llama4-scout: q/o, k/v, the router (N = 16), the shared
    # expert's gate/up and down, and the head (N, K)
    moe_nk = [(5120, 5120), (1024, 5120), (16, 5120), (8192, 5120),
              (5120, 8192), (202048, 5120)]
    # mla_path's deepseek-v2 (N, K): wq_a, wq_b, wkv_a, wo, the wk_b / wv_b
    # decompression, the router, the 2 shared experts' gate/up and down,
    # the first block's MLP and the untied head
    mla_nk = [(1536, 5120), (24576, 1536), (576, 5120), (5120, 16384),
              (16384, 512), (160, 5120), (3072, 5120), (5120, 3072),
              (12288, 5120), (5120, 12288), (102400, 5120)]
    #: the (N, K) of mla_path's int8 leaves (K3 under --quant scheduled)
    mla_int8_nk = [(24576, 1536), (5120, 16384), (16384, 512),
                   (3072, 5120), (5120, 3072), (12288, 5120),
                   (5120, 12288)]
    HEADS = (151936, 50280, 65024, 256000, 32000, 202048, 102400)

    def gemm_inputs(M, N, K, dtype, seed):
        # a ~ N(0, 1/K), b ~ N(0, 1): products of order 1, as after RMSNorm
        gen = torch.Generator(device=dev).manual_seed(seed)
        a = (torch.randn(M, K, generator=gen, device=dev) / K ** 0.5
             ).to(dtype)
        if N in HEADS:      # the LM head: the (V, D) table, transposed view
            b = torch.randn(N, K, generator=gen, device=dev).to(dtype).t()
        else:
            b = torch.randn(K, N, generator=gen, device=dev).to(dtype)
        return a, b

    def p_k2():
        variants = [("OS", Dataflow.OS, 1), ("OS-fold2", Dataflow.OS, 2),
                    ("OS-fold4", Dataflow.OS, 4), ("WS", Dataflow.WS, 1),
                    ("IS", Dataflow.IS, 1)]
        # rows: decode at 4 (policy_path) and 8 slots, the verify step's
        # 40 (8 slots x (k + 1), spec_path), chunks of 4 x 32 and 8 x 32
        shapes = [(M, N, K) for M in (4, 8, 40, 128, 256)
                  for N, K in path_nk]
        shapes.append((37, 1000, 900))      # not a block multiple; TMA: no
        shapes.append((37, 1000, 904))      # ragged, but TMA can take it
        cases = [(s, d, v) for s in shapes
                 for d in (torch.float32, torch.bfloat16) for v in variants]
        # the Hopper route at mamba2's GEMMs (bf16: fp32 takes the CUDA-
        # core route, unchanged) and OS folds 2, 3, 4, 8 -- more bands
        # than cluster ranks at (8, 2560, 3072), 40 tiles: 3 ranks, and
        # at (512, 2048, 3072), 256 tiles: 1 rank
        cases += [(s, torch.bfloat16, v) for s in
                  [(M, N, K) for M in (8, 2048) for N, K in m2_nk]
                  for v in (("OS", Dataflow.OS, 1), ("IS", Dataflow.IS, 1))]
        cases += [((M, N, 3072), torch.bfloat16, (f"OS-fold{f}",
                                                  Dataflow.OS, f))
                  for M, N in ((8, 896), (8, 2560), (512, 2048))
                  for f in (2, 3, 4, 8)]
        # families_path's GEMMs at decode rows (8 slots) and, but for the
        # heads (which take 8 rows), chunk rows (8 slots x 256), under
        # every variant; then each as the engine calls it, through
        # ops.matmul under a schedule cache (gemma2's chunks of 1024 too:
        # 8 x 1024 rows), with the dataflow and fold the schedule picked
        fam_shapes = [(M, N, K) for nk in fam_nk.values() for N, K in nk
                      for M in (8, 2048) if M == 8 or N not in HEADS]
        n_fam = len(cases)
        cases += [(s, torch.bfloat16, v) for s in fam_shapes
                  for v in variants]
        cases += [(s, torch.bfloat16, ("scheduled", None, None))
                  for s in fam_shapes + [(8192, N, K) for N, K in
                                         fam_nk["gemma2_9b"]
                                         if N not in HEADS]]
        # dense_path's new rows, as the engine calls them: qwen2's
        # projections at dense admissions (batch 1, buckets of 16, 512
        # and 1024 rows) and a wave prefill (8 x 512), the head over an
        # admission's one row, mamba2's at a 512 bucket, and llava's
        # vision_proj over four rows of 1152 patches (patches_path)
        n_dense = len(cases)
        cases += [(s, torch.bfloat16, ("scheduled", None, None))
                  for s in [(M, N, K) for M in (16, 512, 1024, 4096)
                            for N, K in path_nk if N not in HEADS]
                  + [(512, N, K) for N, K in m2_nk if N not in HEADS]
                  + [(1, 151936, 896), (1, 50280, 2560),
                     (4608, 4096, 4096)]]
        # moe_path's GEMMs at decode rows and, but for the head, chunk rows
        # (8 x 256), under every variant and as the engine calls them
        n_moe = len(cases)
        moe_shapes = [(M, N, K) for N, K in moe_nk for M in (8, 2048)
                      if M == 8 or N not in HEADS]
        cases += [(s, torch.bfloat16, v) for s in moe_shapes
                  for v in variants]
        cases += [(s, torch.bfloat16, ("scheduled", None, None))
                  for s in moe_shapes]
        # mla_path's GEMMs at decode rows and, but for the head, chunk rows
        # (8 x 256) under every variant; as the engine calls them, and the
        # chunk step's decompression over the gathered table (8 x 1024
        # rows)
        n_mla = len(cases)
        mla_shapes = [(M, N, K) for N, K in mla_nk for M in (8, 2048)
                      if M == 8 or N not in HEADS]
        cases += [(s, torch.bfloat16, v) for s in mla_shapes
                  for v in variants]
        cases += [(s, torch.bfloat16, ("scheduled", None, None))
                  for s in mla_shapes + [(8192, 16384, 512)]]
        sched = ScheduleCache()
        rows, worst = [], {}
        for i, ((M, N, K), dtype, (name, df, fold)) in enumerate(cases):
            t0 = time.perf_counter()
            a, b = gemm_inputs(M, N, K, dtype, M + N + K)
            out_dtype = torch.float32 if N in HEADS else dtype
            if df is None:
                # the schedule's (dataflow, fold) as ops.matmul applies it;
                # the applied log holds the fold that executed
                choice = sched.resolve(M, N, K,
                                       OPS.precision_for_dtype(dtype))
                fold = choice.k_fold

                def run():
                    before = dict(MP.launches_by_route)
                    out = OPS.matmul(a, b, out_dtype=out_dtype,
                                     schedule=sched)
                    ran.append({r: MP.launches_by_route[r] - before[r]
                                for r in MP.ROUTES})
                    return out
                ran = []
                got = run()
                df, ef = sched.applied[-1][1].dataflow, \
                    sched.applied[-1][1].k_fold
                bm, bn, bk = OPS.plan_blocks(M, N, K, a.element_size(), df,
                                             fold)
            else:
                bm, bn, bk = OPS.plan_blocks(M, N, K, a.element_size(), df,
                                             fold)
                ef = MP.effective_fold(K, bk, fold)

                def run():
                    return MP.mpgemm(a, b, dataflow=df, bm=bm, bn=bn, bk=bk,
                                     k_fold=ef, out_dtype=out_dtype)
                ran = None
                got = run()
            route = MP.mpgemm_route(a, b, bk)
            want = MP.mpgemm_plain(a, b, bk=bk, k_fold=ef,
                                   out_dtype=out_dtype)
            same = True
            if dtype == torch.bfloat16:     # a repeat must be bit-equal
                same = bool(torch.equal(got, run()))
            torch.cuda.synchronize()
            if ran is not None:     # both calls launched once, on ``route``
                same = same and all(r == {**{x: 0 for x in MP.ROUTES},
                                          route: 1} for r in ran)
            diff = (got.float() - want.float()).abs()
            scale = 1.0 + want.float().abs()
            tol = 1e-4 if out_dtype == torch.float32 else 1e-2
            rel = (diff / scale).max().item()
            err = diff.max().item()
            sm.kerr["mpgemm"] = max(sm.kerr["mpgemm"], err)
            key = f"{name} {str(dtype)[6:]} {route}"
            w, n = worst.get(key, (0.0, 0))
            worst[key] = (max(w, rel), n + 1)
            rows.append({"M": M, "N": N, "K": K, "variant": name,
                         "dtype": str(dtype)[6:], "route": route,
                         "dataflow": df.name, "blocks": [bm, bn, bk],
                         "fold": ef, "max_abs_err": err, "max_rel_err": rel,
                         "bit_equal_repeat": same,
                         "ok": rel <= tol and same})
            del a, b, got, want
            if i >= n_mla:
                added("k2_vs_plain", t0, "mla")
            elif i >= n_moe:
                added("k2_vs_plain", t0, "moe")
            elif i >= n_dense:
                added("k2_vs_plain", t0, "dense")
            elif i >= n_fam:
                added("k2_vs_plain", t0)
        rep["k2_check"] = rows
        picked = {}
        for r in rows[n_fam:n_dense]:
            if r["variant"] == "scheduled":
                k = f"{r['dataflow']} fold {r['fold']}"
                picked[k] = picked.get(k, 0) + 1
        print(f"K2 at the families' shapes through ops.matmul under a "
              f"schedule cache: (dataflow, fold) that ran {picked}")
        for key, (rel, n) in worst.items():
            print(f"K2 {key}: worst |err|/(1+|ref|) {rel:.3e} over {n} "
                  f"shapes")
        bad = [r for r in rows if not r["ok"]]
        routes = {r: sum(x["route"] == r for x in rows) for r in MP.ROUTES}
        print(f"K2: {len(rows) - len(bad)}/{len(rows)} cases within "
              f"tolerance (fp32 out 1e-4, bf16 out 1e-2, relative to "
              f"1 + |ref|), bf16 repeats bit-equal; routes {routes}")
        if bad:
            raise AssertionError(f"K2 mismatches: {bad[:3]}")
        hopper_bf16 = [r for r in rows if r["dtype"] == "bfloat16"
                       and r["K"] != 900]
        if any(r["route"] != "hopper" for r in hopper_bf16) or any(
                r["route"] != "cuda_core" for r in rows
                if r["dtype"] == "float32" or r["K"] == 900):
            raise AssertionError("K2: a case took the other route")

    # -- 4b. K1-int8 and K3 against their plain versions --------------------
    # mamba2's and zamba2's in_proj and out_proj (N, K): int8 under
    # ssm_quant_path
    ssm_quant_nk = [(10576, 2560), (2560, 5120), (14576, 3584),
                    (3584, 7168)]
    # the rest of ssm_quant_path's K3 calls: zamba2's shared attention
    # q/k/v/o at decode and chunk rows, and the untied heads' (D, V)
    # payloads at 8 rows (mamba2's V = 50280 takes the CUDA-core route)
    ssm_quant_more = [(8, 3584, 3584), (2048, 3584, 3584),
                      (8, 50280, 2560), (8, 32000, 3584)]

    def p_k1_int8():
        check_k1(True)

    def quant_inputs(M, N, K, dtype, seed):
        # x ~ N(0, 1/K) as after RMSNorm; the weight quantized per channel
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = (torch.randn(M, K, generator=gen, device=dev) / K ** 0.5
             ).to(dtype)
        w8, sc = OPS.quantize_weights(
            0.02 * torch.randn(K, N, generator=gen, device=dev))
        return x, w8, sc

    def offset_x(M, K, dtype, seed):
        """x (M, K) contiguous, its base one element past an allocation's
        start: off 16-byte alignment, so TMA refuses it."""
        x, _w, _s = quant_inputs(M, 16, K, dtype, seed)
        buf = torch.empty(M * K + 1, dtype=dtype, device=dev)
        buf[1:].copy_(x.reshape(-1))
        return buf[1:].view(M, K)

    def p_k3():
        # the path's (N, K) at M = 1 .. 2048; ragged N and K that TMA takes
        # (N a multiple of 16, K of 8) and that it refuses; K not a
        # multiple of 64; M off the tile grid; every chunk tile asked for
        shapes = [(M, N, K) for M in (1, 8, 16, 64, 65, 256, 2048)
                  for N, K in path_nk[:4]]
        shapes += [(37, 1008, 904), (8, 896, 1000), (300, 4864, 904),
                   (37, 1000, 904), (37, 1008, 900), (300, 131, 77),
                   (5, 896, 896)]
        cases = [(s_, d, False, None) for s_ in shapes
                 for d in (torch.float32, torch.bfloat16)]
        cases += [((8, 896, 896), torch.bfloat16, True, None),  # unaligned x
                  ((256, 896, 904), torch.bfloat16, True, None)]
        cases += [(s_, torch.bfloat16, False, t)
                  for s_ in ((2048, 4864, 896), (300, 1008, 904))
                  for t in QM.QUANT_TILES if t[0] >= 64]
        # families_path's int8 qwen1.5: q/k/v/o, gate/up and down at decode
        # and chunk rows, and the untied head's (D, V) payload at 8 rows
        n_fam = len(cases)
        cases += [((M, N, K), torch.bfloat16, False, None)
                  for M in (8, 2048) for N, K in fam_nk["qwen1_5_4b"][:3]]
        cases.append(((8, 151936, 2560), torch.bfloat16, False, None))
        # ssm_quant_path's int8 in_proj and out_proj of mamba2 and zamba2
        # and moe_path's int8 llama4 (q/o, k/v, the shared expert, the
        # head's (D, V) payload), at decode and chunk rows
        n_moe = len(cases)
        cases += [((M, N, K), torch.bfloat16, False, None)
                  for M in (8, 2048) for N, K in ssm_quant_nk]
        cases += [(s_, torch.bfloat16, False, None) for s_ in ssm_quant_more]
        cases += [((M, N, K), torch.bfloat16, False, None)
                  for M in (8, 2048) for N, K in moe_nk
                  if N != 16 and (M == 8 or N not in HEADS)]
        # mla_path's int8 leaves at decode and chunk rows, the
        # decompression over the gathered table (8 x 1024 rows) and the
        # head's (D, V) payload at 8 rows
        n_mla = len(cases)
        cases += [((M, N, K), torch.bfloat16, False, None)
                  for M in (8, 2048) for N, K in mla_int8_nk]
        cases += [((8192, 16384, 512), torch.bfloat16, False, None),
                  ((8, 102400, 5120), torch.bfloat16, False, None)]
        rows, worst = [], {}
        for i, ((M, N, K), dtype, unaligned, tile) in enumerate(cases):
            t0 = time.perf_counter()
            x, w8, sc = quant_inputs(M, N, K, dtype, M + N + K)
            if unaligned:
                x = offset_x(M, K, dtype, M + N + K)
            tma = dtype == torch.bfloat16 and N % 16 == 0 and K % 8 == 0 \
                and not unaligned
            want_route = "hopper" if tma else "cuda_core"
            route = QM.quant_matmul_route(x, w8)
            plan = QM.quant_plan(M, N, K, route, tile)
            before = dict(QM.launches_by_route)
            torch.cuda.set_sync_debug_mode("error")   # no device read
            try:
                got = QM.quant_matmul(x, w8, sc, tile=tile)
                again = QM.quant_matmul(x, w8, sc, tile=tile) \
                    if dtype == torch.bfloat16 else got
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = QM.quant_matmul_ref(x, w8, sc)
            torch.cuda.synchronize()
            ran = {r: QM.launches_by_route[r] - before[r] for r in QM.ROUTES}
            diff = (got - want).abs()
            rel = (diff / (1.0 + want.abs())).max().item()
            err = diff.max().item()
            same = bool(torch.equal(got, again))
            sm.kerr["quant_matmul"] = max(sm.kerr["quant_matmul"], err)
            key = f"{str(dtype)[6:]} {route}"
            w_, n_ = worst.get(key, (0.0, 0))
            worst[key] = (max(w_, rel), n_ + 1)
            rows.append({"M": M, "N": N, "K": K, "dtype": str(dtype)[6:],
                         "unaligned_x": unaligned, "route": route,
                         "tile": list(plan.tile), "ranks": plan.ranks,
                         "launched": ran, "max_abs_err": err,
                         "max_rel_err": rel, "bit_equal_repeat": same,
                         "ok": rel <= 1e-4 and got.dtype == torch.float32
                         and same and route == want_route
                         and ran[route] == (2 if got is not again else 1)})
            del x, w8, sc, got, again, want
            if i >= n_mla:
                added("k3_vs_plain", t0, "mla")
            elif i >= n_moe:
                added("k3_vs_plain", t0, "moe")
            elif i >= n_fam:
                added("k3_vs_plain", t0)
        rep["k3_check"] = rows
        for key, (rel, n_) in worst.items():
            print(f"K3 x {key}: worst |err|/(1+|ref|) {rel:.3e} over "
                  f"{n_} shapes")
        bad = [r for r in rows if not r["ok"]]
        routes = {r: sum(x_["route"] == r for x_ in rows) for r in QM.ROUTES}
        print(f"K3: {len(rows) - len(bad)}/{len(rows)} cases within "
              f"|err|/(1+|ref|) <= 1e-4 (fp32 out) on the route "
              f"quant_matmul_route names, bf16 repeats bit-equal, no device "
              f"read (sync debug mode 'error'); routes {routes}")
        if bad:
            raise AssertionError(f"K3 mismatches: {bad[:3]}")

    # -- 4c. K4 (limb GEMM) against its plain version -----------------------
    def limbs(l, rows, cols, seed):
        """Balanced base-128 digits drawn over their whole range."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(-64, 64, (l, rows, cols), generator=gen,
                             device=dev, dtype=torch.int8)

    def raw_ints(dtype, shape, seed, lo=None, hi=None):
        """Integers over a dtype's whole range (or [lo, hi]), with its
        extremes in the first and last elements."""
        info = torch.iinfo(dtype)
        lo = info.min if lo is None else lo
        hi = info.max if hi is None else hi
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randint(lo, hi + 1, shape, generator=gen, device=dev,
                          dtype=torch.int64).to(dtype)
        x.view(-1)[0], x.view(-1)[-1] = lo, hi
        return x

    def p_k4():
        # the planes entry: (la, lb, M, N, K, blocks or None = the plan's)
        cases = [(2, 2, 64, 128, 64, None), (3, 3, 65, 130, 100, None),
                 (5, 5, 960, 960, 64, None), (5, 5, 33, 70, 1, None),
                 (2, 2, 32, 4096, 9216, None), (3, 3, 1000, 2, 128, None),
                 (5, 5, 777, 1, 64, None), (5, 5, 1, 300, 96, None),
                 (3, 3, 2, 257, 33, None), (2, 5, 100, 60, 70, None),
                 (5, 3, 61, 77, 160, None), (1, 1, 17, 19, 5, None),
                 (2, 2, 37, 45, 7, None), (3, 3, 20, 9, 129, None)]
        cases += [(l, l, 37, 45, 83, t) for l in (1, 2, 3, 5)
                  for t in LG.tiles_for(l)]
        rows = []
        for n, (la, lb, M, N_, K_, blocks) in enumerate(cases):
            a, b = limbs(la, M, K_, 2 * n), limbs(lb, K_, N_, 2 * n + 1)
            got = LG.limb_gemm_diagonals(a, b, blocks=blocks)
            again = LG.limb_gemm_diagonals(a, b, blocks=blocks)
            want = LG.limb_gemm_diagonals_ref(a, b)
            torch.cuda.synchronize()
            err = (got.long() - want.long()).abs().max().item()
            sm.kerr["limb_gemm"] = max(sm.kerr["limb_gemm"], err)
            plan = LG.limb_plan(M, N_, K_, la, lb, limbs=True, fused=False,
                                blocks=blocks)
            rows.append({"entry": "planes", "la": la, "lb": lb, "M": M,
                         "N": N_, "K": K_, "tile": list(plan.tile),
                         "ranks": plan.ranks, "max_abs_err": err,
                         "ok": bool(torch.equal(got, want)
                                    and torch.equal(got, again))})
        # the digits of int32 extremes, decomposed on the card and on the
        # host, through the planes entry
        ext = torch.tensor([-2 ** 31, 2 ** 31 - 1, -1, 0, 1, -2 ** 30],
                           dtype=torch.int32)
        x = ext.repeat(48 * 40 // len(ext)).reshape(48, 40)
        d_dev = LG.limb_decompose(x.to(dev), 5)
        d_cpu = LG.limb_decompose(x, 5)
        same_digits = torch.equal(d_dev.cpu(), d_cpu) and np.array_equal(
            d_cpu.numpy(), KREF.limb_decompose_ref(x.numpy(), 5))
        got = LG.limb_gemm_diagonals(d_dev, d_dev.transpose(1, 2)
                                     .contiguous())
        want = LG.limb_gemm_diagonals_ref(d_dev, d_dev.transpose(1, 2))
        torch.cuda.synchronize()
        err = (got.long() - want.long()).abs().max().item()
        sm.kerr["limb_gemm"] = max(sm.kerr["limb_gemm"], err)
        rows.append({"entry": "planes", "la": 5, "lb": 5, "M": 48, "N": 48,
                     "K": 40, "inputs": "digits of int32 min/max",
                     "max_abs_err": err,
                     "ok": bool(torch.equal(got, want)) and same_digits})
        # the fused entry: (a dtype, b dtype, in_bits or None, M, N, K,
        # blocks or None, value range or None), against its plain version
        # (the unfused composition) on the same tensors
        i8, i16, i32 = torch.int8, torch.int16, torch.int32
        fcases = [(i32, i32, None, 960, 960, 64, None, None),
                  (i16, i16, None, 48000, 2, 128, None, None),
                  (i8, i8, None, 32, 4096, 9216, None, None),
                  (i8, i8, None, 32, 1000, 4096, None, None),
                  (i32, i32, None, 96, 64, 160, None, None),
                  (i16, i16, None, 128, 128, 256, None, None),
                  (i32, i32, None, 1, 70, 64, None, None),
                  (i32, i32, None, 70, 1, 33, None, None),
                  (i16, i16, None, 2, 45, 7, None, None),
                  (i8, i8, None, 300, 2, 1, None, None),
                  (i32, i32, None, 37, 45, 129, None, None),
                  (i8, i8, None, 65, 131, 7, None, None),
                  (i16, i16, None, 33, 17, 129, None, None),
                  (i32, i16, 16, 50, 70, 90, None, (-2 ** 15, 2 ** 15 - 1)),
                  (i8, i32, 32, 40, 33, 100, None, None),
                  (i32, i8, 8, 70, 20, 65, None, None),
                  (i32, i32, 8, 30, 40, 50, None, None),
                  (i32, i32, 20, 64, 64, 300, None, None),
                  (i8, i8, 7, 20, 30, 40, None, None)]
        fcases += [(dt, dt, None, 37, 45, 83, t, None)
                   for dt, nl in ((i8, 2), (i16, 3), (i32, 5))
                   for t in LG.tiles_for(LG.digits_for(dt.itemsize * 8, nl, 83))]
        for n, (ta, tb, in_bits, M, N_, K_, blocks, rng) in enumerate(fcases):
            a = raw_ints(ta, (M, K_), 500 + 2 * n,
                         *(rng if rng and ta != i8 else (None, None)))
            b = raw_ints(tb, (K_, N_), 501 + 2 * n)
            bits = in_bits or ta.itemsize * 8
            nl = KREF.n_limbs_for(bits)
            got = OPS.limb_matmul(a, b, in_bits=in_bits, blocks=blocks)
            again = OPS.limb_matmul(a, b, in_bits=in_bits, blocks=blocks)
            want = LG.limb_matmul_fused_ref(a, b, nl, nl)
            torch.cuda.synchronize()
            ok = all(torch.equal(g, w) and torch.equal(g, r)
                     for g, w, r in zip(got, want, again))
            err = max((g.long() - w.long()).abs().max().item()
                      for g, w in zip(got, want))
            sm.kerr["limb_gemm"] = max(sm.kerr["limb_gemm"], err)
            plan = LG.limb_plan(M, N_, K_,
                                LG.digits_for(ta.itemsize * 8, nl, K_),
                                LG.digits_for(tb.itemsize * 8, nl, K_),
                                ta.itemsize, tb.itemsize, blocks=blocks)
            rows.append({"entry": "fused", "a": str(ta), "b": str(tb),
                         "in_bits": in_bits, "M": M, "N": N_, "K": K_,
                         "tile": list(plan.tile), "config": plan.config,
                         "ranks": plan.ranks, "stages": plan.stages,
                         "max_abs_err": err, "ok": bool(ok)})
        # int8 at K = 2^17, every value -128: each output 2^31, one CTA
        # summing the whole K (a single int8 digit would wrap its plane)
        K_ = LG.MAX_K
        a = torch.full((1024, K_), -128, dtype=i8, device=dev)
        b = torch.full((K_, 1024), -128, dtype=i8, device=dev)
        got = OPS.limb_matmul(a, b)
        want = LG.limb_matmul_fused_ref(a, b, 2, 2)
        torch.cuda.synchronize()
        err = max((g.long() - w.long()).abs().max().item()
                  for g, w in zip(got, want))
        sm.kerr["limb_gemm"] = max(sm.kerr["limb_gemm"], err)
        plan = LG.limb_plan(1024, 1024, K_, LG.digits_for(8, 2, K_),
                            LG.digits_for(8, 2, K_))
        rows.append({"entry": "fused", "a": "torch.int8", "b": "torch.int8",
                     "M": 1024, "N": 1024, "K": K_,
                     "inputs": "every value -128", "tile": list(plan.tile),
                     "config": plan.config, "ranks": plan.ranks,
                     "max_abs_err": err,
                     "ok": bool(all(torch.equal(g, w)
                                    for g, w in zip(got, want))
                                and got[0].eq(0).all().item()
                                and got[1].eq(-2 ** 31).all().item())})
        del a, b, got, want
        # no device value is read by the wrapper
        a = raw_ints(i32, (96, 160), 7)
        b = raw_ints(i32, (160, 64), 8)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            OPS.limb_matmul(a, b)
            LG.limb_gemm_diagonals(LG.limb_decompose(a, 5),
                                   LG.limb_decompose(b, 5))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        rep["k4_check"] = rows
        bad = [r for r in rows if not r["ok"]]
        nf = sum(r["entry"] == "fused" for r in rows)
        print(f"K4: {len(rows) - len(bad)}/{len(rows)} cases torch.equal to "
              f"the plain version and repeats bit-equal (tolerance 0: "
              f"integers; {len(rows) - nf} planes-entry cases, {nf} fused); "
              f"limb_decompose on the card equals the host and numpy: "
              f"{same_digits}; no device read (sync debug mode 'error')")
        if bad:
            raise AssertionError(f"K4 mismatches: {bad[:3]}")

    # -- 4d. K5 (SSD intra-chunk) against its plain version ------------------
    def ssd_case(G, Q, P, N_, seed, kind="init", pad=0, fall=None):
        """K5 operands: x, b, c ~ N(0, 1) and, for ``init``, dt =
        softplus(N(0, 1)) with A = -1 (the full-width init: A_log = 0,
        dt_bias = 0), cums = cumsum(dt * A); for ``test`` the reference
        kernel test's dt ~ U(0.01, 0.2) and cums = cumsum(-dt / 2).
        ``pad`` zeroes dt on the last rows (the engine's pad tail);
        ``fall`` makes cums fall linearly by that much over the chunk."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(G, Q, P, generator=gen, device=dev)
        if kind == "test":
            dt = 0.01 + 0.19 * torch.rand(G, Q, generator=gen, device=dev)
        else:
            dt = torch.nn.functional.softplus(
                torch.randn(G, Q, generator=gen, device=dev))
        if pad:
            dt[:, Q - pad:] = 0.0
        cums = torch.cumsum(-dt * (0.5 if kind == "test" else 1.0), dim=1)
        if fall is not None:
            cums = torch.linspace(0.0, -fall, Q, device=dev).expand(
                G, Q).contiguous()
        b = torch.randn(G, Q, N_, generator=gen, device=dev)
        c = torch.randn(G, Q, N_, generator=gen, device=dev)
        return x, dt, cums, b, c

    def p_k5():
        cases = [("G=1 Q=32", (1, 32, 64, 128), {}),
                 ("G=640 Q=32", (640, 32, 64, 128), {}),
                 ("G=1 Q=256", (1, 256, 64, 128), {}),
                 ("G=640 Q=256", (640, 256, 64, 128), {}),
                 ("ragged", (3, 100, 24, 40), {}),
                 ("reference test (4, 32, 16, 8)", (4, 32, 16, 8),
                  {"kind": "test"}),
                 ("reference test (6, 64, 32, 16)", (6, 64, 32, 16),
                  {"kind": "test"}),
                 ("cums fall by 300", (8, 256, 64, 128), {"fall": 300.0}),
                 ("dt = 0 on a 100-row pad tail", (8, 256, 64, 128),
                  {"pad": 100})]
        rows = []
        for n, (label, shape, kw) in enumerate(cases):
            args_ = ssd_case(*shape, seed=40 + n, **kw)
            got = SSD.ssd_intra(*args_)
            want = SSD.ssd_intra_ref(*args_)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            sm.kerr["ssd_intra"] = max(sm.kerr["ssd_intra"], err)
            cums = args_[2]
            # the largest masked exponent cums_s - cums_t (s < t)
            seg = cums[:, :, None] - cums[:, None, :]
            masked = seg.masked_fill(torch.ones_like(seg[0], dtype=torch.bool)
                                     .tril(), float("-inf")).max().item()
            ok = bool(torch.isfinite(got).all()) and bool(torch.allclose(
                got, want, rtol=2e-4, atol=2e-4))
            rows.append({"case": label, "G": shape[0], "Q": shape[1],
                         "P": shape[2], "N": shape[3], "max_abs_err": err,
                         "max_abs_y": want.abs().max().item(),
                         "max_masked_exponent": masked,
                         "exp_of_it_overflows": masked > 88.7, "ok": ok})
            print(f"K5 {label} {shape}: max|err| {err:.3e} (max|y| "
                  f"{rows[-1]['max_abs_y']:.1f}), largest masked exponent "
                  f"{masked:.1f}{' (exp overflows)' if masked > 88.7 else ''}"
                  f", finite {bool(torch.isfinite(got).all())} "
                  f"{'ok' if ok else 'MISMATCH'}")
        # the grouped entry (the path's call) at full width and its edges;
        # every case launched twice, bit-equal
        grouped = [("grouped B=8 H=80 G=1 Q=256", (8, 1, 256, 80, 1, 64, 128),
                    {}),
                   ("grouped Q=32", (8, 1, 32, 80, 1, 64, 128), {}),
                   ("grouped G=2, ragged head block",
                    (8, 2, 256, 26, 2, 64, 128), {}),
                   ("grouped cums fall by 300", (8, 1, 256, 80, 1, 64, 128),
                    {"fall": 300.0}),
                   ("grouped dt = 0 on a 100-row pad tail",
                    (8, 1, 256, 80, 1, 64, 128), {"pad": 100}),
                   ("grouped ragged Q", (2, 1, 100, 8, 2, 24, 40), {}),
                   ("grouped scalar copies", (2, 1, 100, 8, 2, 18, 10), {}),
                   ("grouped strided views", (2, 2, 256, 80, 1, 64, 128),
                    {"strided": True}),
                   # zamba2's SSD (families_path): H 112, P 64, N 64
                   ("grouped zamba2 H=112 N=64 Q=256",
                    (8, 1, 256, 112, 1, 64, 64), {}),
                   ("grouped zamba2 Q=32", (8, 1, 32, 112, 1, 64, 64), {}),
                   # dense admissions (dense_path): batch 1, a bucket's
                   # chunks, the prompt's pad tail (dt = 0) on the last
                   # rows of the last chunk only
                   ("dense admission mamba2 bucket 512",
                    (1, 2, 256, 80, 1, 64, 128), {"tail": 150}),
                   ("dense admission zamba2 bucket 1024",
                    (1, 4, 256, 112, 1, 64, 64), {"tail": 40}),
                   ("dense admission mamba2 bucket 64",
                    (1, 1, 64, 80, 1, 64, 128), {"tail": 20})]
        for n, (label, shape, kw) in enumerate(grouped):
            t0 = time.perf_counter()
            tail = kw.get("tail", 0)
            args_ = SSD_T.path_inputs(shape[2], 60 + n, dev, *shape[:2],
                                      *shape[3:], **{k: v for k, v in
                                                     kw.items()
                                                     if k != "tail"})
            if tail:
                x_, dt_, _c, b_, c_ = args_
                dt_[:, -1, shape[2] - tail:] = 0.0
                args_ = (x_, dt_, torch.cumsum(-dt_, dim=2), b_, c_)
            got = SSD.ssd_intra_chunked(*args_)
            again = SSD.ssd_intra_chunked(*args_)
            want = SSD.ssd_intra_chunked_ref(*args_)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            sm.kerr["ssd_intra"] = max(sm.kerr["ssd_intra"], err)
            plan = SSD.ssd_plan(*shape[:5])
            ok = bool(torch.isfinite(got).all()) and bool(torch.allclose(
                got, want, rtol=2e-4, atol=2e-4)) and torch.equal(got, again)
            rows.append({"case": label, "shape": list(shape), "kw": kw,
                         "head_block": plan.head_block, "grid": plan.grid,
                         "max_abs_err": err,
                         "max_abs_y": want.abs().max().item(),
                         "bit_equal_repeat": torch.equal(got, again),
                         "ok": ok})
            print(f"K5 {label} (B, nc, Q, H, G, P, N) = {shape}, head block "
                  f"{plan.head_block}, grid {plan.grid}: max|err| {err:.3e} "
                  f"(max|y| {rows[-1]['max_abs_y']:.1f}), repeat bit-equal "
                  f"{rows[-1]['bit_equal_repeat']} {'ok' if ok else 'MISMATCH'}")
            if "dense admission" in label:
                added("k5_vs_plain", t0, "dense")
            elif "zamba2" in label:
                added("k5_vs_plain", t0)
        # ssd_chunked with K5 inside against the sequential recurrence
        gen = torch.Generator(device=dev).manual_seed(7)
        B, S, H, P, G, N_, Q = 1, 512, 80, 64, 1, 128, 256
        x = torch.randn(B, S, H, P, generator=gen, device=dev)
        dt = 0.01 + 0.19 * torch.rand(B, S, H, generator=gen, device=dev)
        A = -(0.5 + 1.5 * torch.rand(H, generator=gen, device=dev))
        Bm = torch.randn(B, S, G, N_, generator=gen, device=dev)
        Cm = torch.randn(B, S, G, N_, generator=gen, device=dev)
        h0 = torch.randn(B, H, P, N_, generator=gen, device=dev)
        before = SSD.launches.count
        y, h = SSM.ssd_chunked(x, dt, A, Bm, Cm, Q, h0)
        torch.cuda.synchronize()
        k5_calls = SSD.launches.count - before
        hr, ys = h0.double(), []
        xd, dtd, Ad, Bd, Cd = (t.double() for t in (x, dt, A, Bm, Cm))
        for t in range(S):
            hr = hr * torch.exp(dtd[:, t] * Ad)[:, :, None, None] \
                + torch.einsum("bhp,bn->bhpn", xd[:, t] * dtd[:, t, :, None],
                               Bd[:, t, 0])
            ys.append(torch.einsum("bn,bhpn->bhp", Cd[:, t, 0], hr))
        yr = torch.stack(ys, dim=1)
        y_err = (y.double() - yr).abs().max().item()
        h_err = (h.double() - hr).abs().max().item()
        chunked_ok = k5_calls == 1 and bool(torch.allclose(
            y.double(), yr, rtol=2e-3, atol=2e-3)) and bool(
            torch.allclose(h.double(), hr, rtol=2e-3, atol=2e-3))
        rep["k5_check"] = {"cases": rows, "ssd_chunked": {
            "B": B, "S": S, "H": H, "P": P, "N": N_, "chunk": Q,
            "y_max_abs_err": y_err, "h_max_abs_err": h_err,
            "k5_launches": k5_calls, "ok": chunked_ok}}
        bad = [r["case"] for r in rows if not r["ok"]]
        print(f"K5: {len(rows) - len(bad)}/{len(rows)} cases within rtol = "
              f"atol = 2e-4 of the plain version, all finite, grouped "
              f"repeats bit-equal; ssd_chunked "
              f"(H={H}, P={P}, N={N_}, S={S}, two chunks of {Q}, with h0) "
              f"against the fp64 recurrence: y max|err| {y_err:.2e}, final "
              f"state {h_err:.2e} (tol 2e-3), K5 launches {k5_calls}")
        if bad:
            raise AssertionError(f"K5 mismatches: {bad}")
        if not chunked_ok:
            raise AssertionError("ssd_chunked disagrees with the sequential "
                                 "recurrence")

    # -- 4e. K6 (the spill epilogue) against its plain version -------------
    def spill_shapes():
        """(name, N, K) of the GEMMs ``ContinuousEngine._register_gemms``
        resolves for full-width qwen2-0.5b (the head's b is the (V, D)
        table's transposed view, as in the model)."""
        d, hd = full.d_model, full.hd
        return [("q", full.n_heads * hd, d), ("k/v", full.n_kv_heads * hd, d),
                ("o", d, full.n_heads * hd), ("gate/up", full.d_ff, d),
                ("down", d, full.d_ff), ("head", full.vocab, d)]

    spill_variants = (("OS k_fold=2", Dataflow.OS, 2), ("WS", Dataflow.WS, 1),
                      ("IS", Dataflow.IS, 1))

    def p_k6():
        rows = []

        def check(label, a, b, df, bm, bn, bk, fold):
            got = MP.mpgemm_spill(a, b, dataflow=df, bm=bm, bn=bn, bk=bk,
                                  k_fold=fold)
            want = MP.mpgemm_spill_plain(a, b, dataflow=df, bk=bk,
                                         k_fold=fold)
            torch.cuda.synchronize()
            planes = MP.spill_planes(a.shape[1], bk, df, fold)
            err = (got - want).abs().max().item()
            sm.kerr["mpgemm_spill"] = max(sm.kerr["mpgemm_spill"], err)
            rows.append({"case": label, "M": a.shape[0], "N": b.shape[1],
                         "K": a.shape[1], "dataflow": df.value,
                         "route": MP.mpgemm_route(a, b, bk),
                         "blocks": [bm, bn, bk], "fold": fold,
                         "planes": planes, "max_abs_err": err,
                         "ok": got.shape == want.shape == (
                             planes, a.shape[0], b.shape[1])
                         and bool(torch.allclose(got, want, rtol=1e-4,
                                                 atol=1e-4))})
            return got

        M, N_, K_ = 100, 150, 763          # 24, 12 and 6 K blocks: ragged
        variants = [(Dataflow.WS, 1), (Dataflow.WS, 3), (Dataflow.IS, 1),
                    (Dataflow.IS, 3), (Dataflow.OS, 2), (Dataflow.OS, 3)]
        for dtype in (torch.float32, torch.bfloat16):
            a, b = gemm_inputs(M, N_, K_, dtype, 61)
            for (df, fold), (bm, bn), bk in itertools.product(
                    variants, KERNEL_TILES, (32, 64, 128)):
                check(f"ragged {str(dtype)[6:]}", a, b, df, bm, bn, bk, fold)
            bt = b.t().contiguous().t()
            for df, fold in variants[::2]:
                check(f"transposed B {str(dtype)[6:]}", a, bt, df, 16, 64,
                      64, fold)
        # every spill dispatch of spill_path, at its tile
        for M in (8, 256):
            for name, N_, K_ in spill_shapes():
                a, b = gemm_inputs(M, N_, K_, torch.bfloat16, M + N_ + K_)
                for label, df, fold in spill_variants:
                    bm, bn, bk = OPS.plan_blocks(M, N_, K_, 2, df, fold)
                    check(f"path {name} {label}", a, b, df, bm, bn, bk,
                          MP.effective_fold(K_, bk, fold))
        # the Hopper route: mamba2's GEMMs, a ragged shape TMA can take at
        # every Hopper tile, OS folds 2, 3, 4, 8 (one band a CTA)
        for M, (N_, K_) in [(8, nk) for nk in m2_nk] + [(2048, m2_nk[1])]:
            a, b = gemm_inputs(M, N_, K_, torch.bfloat16, M + N_ + K_)
            for label, df, fold in spill_variants:
                if M == 2048 and df is Dataflow.WS:
                    continue                # IS covers the plane walk
                bm, bn, bk = OPS.plan_blocks(M, N_, K_, 2, df, fold)
                check(f"mamba2 {label}", a, b, df, bm, bn, bk,
                      MP.effective_fold(K_, bk, fold))
            del a, b
        a, b = gemm_inputs(37, 1000, 904, torch.bfloat16, 64)
        for (label, df, fold), (bm, bn), bk in itertools.product(
                spill_variants, HOPPER_TILES, (64, 128)):
            check(f"ragged TMA {label}", a, b, df, bm, bn, bk,
                  MP.effective_fold(904, bk, fold))
        for M, N_ in ((8, 896), (8, 2560), (512, 2048)):
            a, b = gemm_inputs(M, N_, 3072, torch.bfloat16, 65)
            bm, bn = OPS.plan_blocks(M, N_, 3072, 2, Dataflow.OS, 1)[:2]
            for f in (2, 3, 4, 8):
                check(f"OS fold {f}", a, b, Dataflow.OS, bm, bn, 128, f)
        # bit-equal repeats, of K6 and of the whole spill matmul
        a, b = gemm_inputs(256, 896, 4864, torch.bfloat16, 62)
        same = {}
        for label, df, fold in spill_variants:
            kw = dict(dataflow=df, k_fold=fold, epilogue="spill")
            bm, bn, bk = OPS.plan_blocks(256, 896, 4864, 2, df, fold)
            p1, p2 = (MP.mpgemm_spill(a, b, dataflow=df, bm=bm, bn=bn, bk=bk,
                                      k_fold=fold) for _ in range(2))
            same[label] = bool(torch.equal(p1, p2)) and bool(torch.equal(
                OPS.matmul(a, b, **kw), OPS.matmul(a, b, **kw)))
        # OS whose fold degrades to 1 (3 K blocks) is the fused kernel
        a, b = gemm_inputs(64, 256, 384, torch.float32, 63)
        MP.reset_launches()
        one = MP.mpgemm(a, b, dataflow=Dataflow.OS, bm=16, bn=64, bk=128,
                        k_fold=2, epilogue="spill")
        torch.cuda.synchronize()
        os1 = {"k2": MP.launches.count, "k6": MP.spill_launches.count,
               "equal_to_fused": bool(torch.equal(one, MP.mpgemm(
                   a, b, dataflow=Dataflow.OS, bm=16, bn=64, bk=128,
                   k_fold=2)))}
        rep["k6_check"] = {"cases": rows, "bit_equal_repeats": same,
                           "os_fold_1": os1}
        bad = [(r["case"], r["dataflow"], r["blocks"], r["fold"])
               for r in rows if not r["ok"]]
        print(f"K6: {len(rows) - len(bad)}/{len(rows)} cases within rtol = "
              f"atol = 1e-4 of the plain version, plane by plane (max "
              f"|err| {sm.kerr['mpgemm_spill']:.3e}); repeats bit-equal: "
              f"{same}; OS with fold 2 -> 1 under spill: {os1}")
        if bad:
            raise AssertionError(f"K6 mismatches: {bad[:3]}")
        wrong = [(r["case"], r["route"]) for r in rows if
                 (r["route"] == "hopper") != (r["case"].startswith(
                     ("path", "mamba2", "ragged TMA", "OS fold"))
                     and r["blocks"][2] % 64 == 0)]
        if wrong:
            raise AssertionError(f"K6 cases on the other route: {wrong[:3]}")
        if not all(same.values()):
            raise AssertionError(f"K6 or the spill matmul not bit-equal "
                                 f"across two runs: {same}")
        if os1 != {"k2": 1, "k6": 0, "equal_to_fused": True}:
            raise AssertionError(f"OS at fold 1 under spill: {os1}")

    # -- 5. the main path ---------------------------------------------------
    def requests(rng, n, lo, hi, new, vocab, prefix=0):
        pre = rng.integers(3, vocab, prefix).astype(np.int32)
        return [Request(i, np.concatenate(
            [pre, rng.integers(3, vocab, int(rng.integers(lo, hi)))
             .astype(np.int32)]), new, eos=-1) for i in range(n)]

    def serve(cfg, params, reqs, slots, max_len, audit, quant_policy=None,
              prefill_chunk=None, settle=0.0, **engine_kw):
        """One engine run; the schedule stats and the launch counts cover
        only this run (zeroed just before it, read just after).  With
        ``settle`` the whole trace is submitted, then ``settle`` seconds
        pass before the first step (the policies read waited time off the
        clock: every 1e-4 s SLO is then at risk from the first step)."""
        eng = ContinuousEngine(cfg, params, slots=slots, max_len=max_len,
                               audit=audit, quant_policy=quant_policy,
                               prefill_chunk=prefill_chunk, device=dev,
                               **engine_kw)
        return (eng,) + counted_run(eng, reqs, settle)

    def reset_launches():
        PA.launches.reset()
        PA.launches_int8.reset()
        MP.reset_launches()
        QM.reset_launches()
        SSD.launches.reset()
        SSD.bwd_launches.reset()

    def launch_counts():
        return {"paged_decode": PA.launches.count,
                "mpgemm": MP.launches.count,
                "mpgemm_by_dataflow": dict(MP.launches_by_dataflow),
                "mpgemm_by_route": dict(MP.launches_by_route),
                "mpgemm_spill": MP.spill_launches.count,
                "paged_decode_int8": PA.launches_int8.count,
                "quant_matmul": QM.launches.count,
                "quant_matmul_by_route": dict(QM.launches_by_route),
                "ssd_intra": SSD.launches.count,
                "ssd_intra_bwd": SSD.bwd_launches.count}

    def counted_run(eng, reqs, settle=0.0):
        """(results by rid, wall, launch counts) of one run of ``eng``
        (a continuous or a wave engine) over ``reqs``; the schedule stats
        and the counts cover only this run."""
        schedule = getattr(eng, "schedule", None) or getattr(
            N.gemm_backend(eng.cfg), "schedule", None)
        if schedule is not None:
            schedule.reset()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        if settle:
            for r in reqs:
                eng.submit(r)
            time.sleep(settle)
            res = []
            while len(res) < len(reqs):
                eng.step()
                res += eng.drain_results()
        else:
            res = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return sorted(res, key=lambda r: r.rid), wall, launch_counts()

    def summary(eng, res, wall):
        toks = sum(len(r.tokens) for r in res)
        tpot = [r.decode_s / (len(r.tokens) - 1) for r in res
                if len(r.tokens) > 1]
        schedule = getattr(eng, "schedule", None) or getattr(
            N.gemm_backend(eng.cfg), "schedule", None)
        st = schedule.stats() if schedule is not None else {
            "hits": None, "misses": None}
        pool = getattr(eng, "pool", None)
        return {"requests": len(res),
                "ok": sum(r.status == "ok" for r in res),
                "new_tokens": toks, "wall_s": wall,
                "tok_per_s": toks / wall,
                "ttft_p50_ms": float(np.percentile(
                    [r.ttft_s for r in res], 50)) * 1e3,
                "ttft_max_ms": max(r.ttft_s for r in res) * 1e3,
                "tpot_p50_ms": float(np.percentile(tpot, 50)) * 1e3,
                "decode_steps": eng.steps,
                "chunk_steps": getattr(eng, "chunk_steps", 0),
                "schedule_hits": st["hits"], "schedule_misses": st["misses"],
                "pool": pool.stats() if pool is not None else None}

    full = CONFIGS.get("qwen2_0_5b")
    main_launches: dict = {}
    main_tokens: dict = {}
    quant_launches: dict = {}
    quant_tokens: dict = {}
    full_params: dict = {}
    full_quant = dataclasses.replace(full, quant_serving=True)

    def params_full():
        if not full_params:
            full_params["p"] = N.init(full, args.seed, dev)
        return full_params["p"]

    def params_quant():
        """Phase 5's weights quantized once (the engine's default policy;
        an already-quantized tree passes through the engine unchanged)."""
        if "q" not in full_params:
            full_params["q"] = serving_quant_params(full_quant,
                                                    params_full())
        return full_params["q"]

    def prefill_once(cfg, params, toks):
        """Logits of a two-row prefill chunk (32 and 20 real tokens)."""
        table = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(2, 4)
        lens = torch.tensor([32, 20], dtype=torch.int32, device=dev)
        caches = N.expand_cache_pos(
            N.init_paged_caches(cfg, 2, 9, 16, device=dev), 2)
        logits, _ = N.prefill_paged_chunk(
            params, cfg, toks, caches, torch.arange(
                2, dtype=torch.int32, device=dev), table, lens, lens - 1)
        return logits

    def prefill_tokens(rng, vocab):
        return torch.from_numpy(rng.integers(3, vocab, (2, 32))
                                .astype(np.int32)).to(dev)

    def prefill_logits(cfgs, params, rng, tag):
        """Logits of a short two-row prefill under both backends."""
        toks = prefill_tokens(rng, cfgs["xla"].vocab)
        lx, ls = (prefill_once(cfgs[b], params, toks)
                  for b in ("xla", "scheduled"))
        rel = ((lx - ls).abs().max() / lx.abs().max()).item()
        rep[f"{tag}_logits_rel_diff"] = rel
        print(f"{tag}: prefill logits {tuple(lx.shape)} finite: "
              f"{bool(torch.isfinite(lx).all() and torch.isfinite(ls).all())}"
              f", max|xla - scheduled| / max|xla| = {rel:.2e}")
        return lx, ls

    def p_main():
        params = params_full()
        rng = np.random.default_rng(args.seed)
        reqs = requests(rng, 8, 64, 513, 32, full.vocab)
        cfgs = {b: dataclasses.replace(full, gemm_backend=b)
                for b in ("xla", "scheduled")}
        for b, cfg in cfgs.items():         # warm-up (allocator, cuBLAS)
            warm = requests(np.random.default_rng(99), 2, 40, 41, 4,
                            full.vocab)
            ContinuousEngine(cfg, params, slots=8, max_len=1024,
                             device=dev).run(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs, tokens = {}, {}
        for b, cfg in cfgs.items():
            eng, res, wall, counts = serve(cfg, params, reqs, 8, 1024,
                                           audit=False)
            runs[b] = summary(eng, res, wall)
            runs[b]["launches"] = counts
            main_launches[b] = counts
            tokens[b] = [r.tokens.tolist() for r in res]
        main_tokens.update(tokens)
        rep["main"] = runs
        rep["main_launches"] = main_launches
        rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        same = sum(x == y for tx, ts in zip(tokens["xla"],
                                            tokens["scheduled"])
                   for x, y in zip(tx, ts))
        total = sum(len(t) for t in tokens["xla"])
        rep["main_agreement"] = same / total
        for b, r in runs.items():
            print(f"[{card}] qwen2-0.5b full width, {b}: {r['ok']}/"
                  f"{r['requests']} ok, {r['new_tokens']} tokens in "
                  f"{r['wall_s']:.2f} s = {r['tok_per_s']:.1f} tok/s, TTFT "
                  f"p50 {r['ttft_p50_ms']:.1f} ms, TPOT p50 "
                  f"{r['tpot_p50_ms']:.2f} ms, schedule cache "
                  f"{r['schedule_hits']} hits / {r['schedule_misses']} "
                  f"misses, launches {r['launches']}")
        print(f"greedy agreement xla vs scheduled (bf16): {same}/{total}")
        lx, ls = prefill_logits(cfgs, params, rng, "main")
        bad = [b for b, r in runs.items()
               if r["ok"] != 8 or r["new_tokens"] != 8 * 32
               or r["schedule_misses"] != 0 or r["schedule_hits"] == 0]
        if bad:
            raise AssertionError(f"main path runs failed checks: {bad}")
        if any(c["paged_decode"] == 0 for c in main_launches.values()) \
                or main_launches["scheduled"]["mpgemm"] == 0:
            raise AssertionError(f"a kernel never launched: {main_launches}")
        if main_launches["xla"]["mpgemm"] != 0:
            raise AssertionError("the xla backend launched mpgemm")
        if main_launches["scheduled"]["mpgemm_by_route"]["cuda_core"]:
            raise AssertionError(f"a bf16 GEMM took the CUDA-core route: "
                                 f"{main_launches['scheduled']}")
        if any(c["quant_matmul"] or c["paged_decode_int8"]
               for c in main_launches.values()):
            raise AssertionError(f"the fp model launched an int8 kernel: "
                                 f"{main_launches}")
        if tuple(lx.shape) != (2, full.vocab) or not (
                torch.isfinite(lx).all() and torch.isfinite(ls).all()):
            raise AssertionError("full-width logits not finite / bad shape")

    # -- 5b. the int8 main path ----------------------------------------------
    def p_quant_main():
        params = params_quant()
        rng = np.random.default_rng(args.seed)
        reqs = requests(rng, 8, 64, 513, 32, full.vocab)   # phase 5's set
        cfgs = {b: dataclasses.replace(full_quant, gemm_backend=b)
                for b in ("xla", "scheduled")}
        for b, cfg in cfgs.items():         # warm-up
            warm = requests(np.random.default_rng(99), 2, 40, 41, 4,
                            full.vocab)
            ContinuousEngine(cfg, params, slots=8, max_len=1024,
                             device=dev).run(warm)
        torch.cuda.synchronize()
        runs, tokens, engines = {}, {}, {}
        for b, cfg in cfgs.items():
            eng, res, wall, counts = serve(cfg, params, reqs, 8, 1024,
                                           audit=True)
            runs[b] = summary(eng, res, wall)
            runs[b]["launches"] = counts
            quant_launches[b] = counts
            tokens[b] = [r.tokens.tolist() for r in res]
            engines[b] = eng
        quant_tokens.update(tokens)
        per_step = 7 * full.n_layers            # q k v o gate up down
        fp_eng = ContinuousEngine(full, params_full(), slots=8,
                                  max_len=1024, device=dev)
        q_alloc = engines["xla"].kv_bytes()["allocated"]
        fp_alloc = fp_eng.kv_bytes()["allocated"]
        del fp_eng
        rep["quant_kv_ratio"] = q_alloc / fp_alloc
        total = sum(len(t) for t in tokens["xla"])
        agree = {"xla_vs_scheduled": sum(
            x == y for tx, ts in zip(tokens["xla"], tokens["scheduled"])
            for x, y in zip(tx, ts)) / total}
        if main_tokens:
            agree["vs_fp_xla"] = sum(
                x == y for tx, tf in zip(tokens["xla"], main_tokens["xla"])
                for x, y in zip(tx, tf)) / total
        rep["quant_main"] = runs
        rep["quant_main_agreement"] = agree
        for b, r in runs.items():
            print(f"[{card}] qwen2-0.5b full width, int8, {b}: {r['ok']}/"
                  f"{r['requests']} ok, {r['new_tokens']} tokens in "
                  f"{r['wall_s']:.2f} s = {r['tok_per_s']:.1f} tok/s, TTFT "
                  f"p50 {r['ttft_p50_ms']:.1f} ms, TPOT p50 "
                  f"{r['tpot_p50_ms']:.2f} ms, schedule cache "
                  f"{r['schedule_hits']} hits / {r['schedule_misses']} "
                  f"misses, {r['decode_steps']} decode + "
                  f"{r['chunk_steps']} chunk steps, launches "
                  f"{r['launches']}")
        print(f"int8 KV pool bytes / bf16 KV pool bytes = "
              f"{q_alloc}/{fp_alloc} = {q_alloc / fp_alloc:.4f} "
              f"(expected (hd + 4) / (2 hd) = "
              f"{(full.hd + 4) / (2 * full.hd):.4f})")
        print(f"greedy agreement (bf16, random weights): {agree}")
        lx, ls = prefill_logits(cfgs, params, rng, "quant_main")
        bad = [b for b, r in runs.items()
               if r["ok"] != 8 or r["new_tokens"] != 8 * 32
               or r["schedule_misses"] != 0 or r["schedule_hits"] == 0]
        if bad:
            raise AssertionError(f"int8 main path runs failed checks: {bad}")
        for b, r in runs.items():
            c, steps = r["launches"], r["decode_steps"] + r["chunk_steps"]
            want = {"paged_decode": 0,
                    "paged_decode_int8": full.n_layers * r["decode_steps"],
                    "quant_matmul": per_step * steps if b == "scheduled"
                    else 0,
                    "mpgemm": steps if b == "scheduled" else 0}
            got = {k: c[k] for k in want}
            if got != want or r["decode_steps"] == 0:
                raise AssertionError(f"int8 {b} launches {got}, expected "
                                     f"{want}")
            if c["quant_matmul_by_route"]["cuda_core"]:
                raise AssertionError(f"int8 {b}: a bf16 K3 call took the "
                                     f"CUDA-core route: {c}")
        if q_alloc * 2 * full.hd != fp_alloc * (full.hd + 4):
            raise AssertionError(f"int8 KV bytes {q_alloc} vs bf16 "
                                 f"{fp_alloc}: not (hd + 4) / (2 hd)")
        if tuple(lx.shape) != (2, full.vocab) or not (
                torch.isfinite(lx).all() and torch.isfinite(ls).all()):
            raise AssertionError("int8 logits not finite / bad shape")

    # -- 5c. mamba2 at full width ---------------------------------------------
    m2 = CONFIGS.get("mamba2_2_7b")
    m2_params: dict = {}
    mamba_launches: dict = {}
    mamba_tokens: dict = {}

    def params_m2():
        if not m2_params:
            m2_params["p"] = N.init(m2, args.seed, dev)
        return m2_params["p"]

    def p_mamba():
        params = params_m2()
        rng = np.random.default_rng(args.seed)
        reqs = requests(rng, 8, 64, 513, 32, m2.vocab)    # phase 5's shape
        chunk = m2.ssm.chunk                              # 256, published
        cfgs = {b: dataclasses.replace(m2, gemm_backend=b)
                for b in ("xla", "scheduled")}
        warm = requests(np.random.default_rng(99), 2, 40, 41, 4, m2.vocab)
        ContinuousEngine(cfgs["xla"], params, slots=8, max_len=1024,
                         prefill_chunk=chunk, device=dev).run(warm)
        torch.cuda.synchronize()
        runs, tokens = {}, {}
        for b, cfg in cfgs.items():
            eng, res, wall, counts = serve(cfg, params, reqs, 8, 1024,
                                           audit=True, prefill_chunk=chunk)
            runs[b] = summary(eng, res, wall)
            runs[b]["launches"] = counts
            runs[b]["kv_allocated"] = eng.kv_bytes()["allocated"]
            runs[b]["share_prefixes"] = eng.pool.share_prefixes
            mamba_launches[b] = counts
            tokens[b] = [r.tokens.tolist() for r in res]
        mamba_tokens.update(tokens)
        same = sum(x == y for tx, ts in zip(tokens["xla"],
                                            tokens["scheduled"])
                   for x, y in zip(tx, ts))
        total = sum(len(t) for t in tokens["xla"])
        rep["mamba2"] = runs
        rep["mamba2_agreement"] = same / total
        for b, r in runs.items():
            print(f"[{card}] mamba2-2.7b full width, {b}, prefill_chunk "
                  f"{chunk}: {r['ok']}/{r['requests']} ok, {r['new_tokens']} "
                  f"tokens in {r['wall_s']:.2f} s = {r['tok_per_s']:.1f} "
                  f"tok/s, TTFT p50 {r['ttft_p50_ms']:.1f} ms, TPOT p50 "
                  f"{r['tpot_p50_ms']:.2f} ms, {r['decode_steps']} decode + "
                  f"{r['chunk_steps']} chunk steps, launches "
                  f"{r['launches']}")
        print(f"greedy agreement xla vs scheduled (bf16): {same}/{total}")
        lx, ls = prefill_logits(cfgs, params, rng, "mamba2")
        # the same prefill in fp32 (weights cast up, xla): how far each
        # backend's bf16 logits lie from it (reported, not gated)
        m32 = dataclasses.replace(m2, param_dtype="float32",
                                  compute_dtype="float32")
        toks = prefill_tokens(np.random.default_rng(args.seed), m2.vocab)
        l32 = prefill_once(m32, tree_map(lambda _p, a: a.float(), params),
                           toks)
        vs32 = {b: ((prefill_once(cfgs[b], params, toks) - l32).abs().max()
                    / l32.abs().max()).item() for b in cfgs}
        rep["mamba2_bf16_vs_fp32_logits_rel_diff"] = vs32
        print(f"mamba2 bf16 prefill logits against fp32 (same weights, "
              f"same tokens): max|bf16 - fp32| / max|fp32| = {vs32}")
        bad = [b for b, r in runs.items()
               if r["ok"] != 8 or r["new_tokens"] != 8 * 32
               or r["share_prefixes"] or r["kv_allocated"] != 0]
        if bad:
            raise AssertionError(f"mamba2 runs failed checks: {bad}")
        for b, r in runs.items():
            c, steps = r["launches"], r["decode_steps"] + r["chunk_steps"]
            want = {"ssd_intra": m2.n_layers * r["chunk_steps"],
                    "mpgemm": (2 * m2.n_layers + 1) * steps
                    if b == "scheduled" else 0,
                    "paged_decode": 0, "paged_decode_int8": 0,
                    "quant_matmul": 0}
            got = {k: c[k] for k in want}
            if got != want or r["chunk_steps"] == 0 \
                    or r["decode_steps"] == 0:
                raise AssertionError(f"mamba2 {b} launches {got}, expected "
                                     f"{want}")
            if c["mpgemm_by_route"]["cuda_core"]:
                raise AssertionError(f"mamba2 {b}: a bf16 GEMM took the "
                                     f"CUDA-core route: {c}")
        if tuple(lx.shape) != (2, m2.vocab) or not (
                torch.isfinite(lx).all() and torch.isfinite(ls).all()):
            raise AssertionError("mamba2 logits not finite / bad shape")

    # -- 6. scaled-down fp32: backends token-identical -----------------------
    def p_small():
        # at init scale a random model repeats one token per request; x5
        # weights make the greedy tokens vary, so identity means something
        base = CONFIGS.get("qwen2_0_5b").scaled_down()
        params = tree_map(lambda _p, a: a * 5.0, N.init(base, args.seed, dev))
        rng = np.random.default_rng(args.seed + 1)
        reqs = requests(rng, 8, 4, 64, 16, base.vocab, prefix=32)
        toks = {}
        for b in ("xla", "scheduled"):
            cfg = dataclasses.replace(base, gemm_backend=b)
            _eng, res, _, _ = serve(cfg, params, reqs, 4, 160, audit=True)
            if not all(r.status == "ok" for r in res):
                raise AssertionError(f"scaled-down {b}: a request failed")
            toks[b] = [r.tokens.tolist() for r in res]
        same = toks["xla"] == toks["scheduled"]
        distinct = len({t for seq in toks["xla"] for t in seq})
        rep["small"] = {"weights_scale": 5.0, "identical": same,
                        "distinct_tokens": distinct,
                        "tokens": sum(len(t) for t in toks["xla"])}
        print(f"scaled-down fp32, weights x5: greedy tokens identical "
              f"across backends: {same} ({distinct} distinct tokens over "
              f"{len(reqs)} requests)")
        if not same:
            raise AssertionError("scaled-down fp32 tokens differ between "
                                 "the xla and scheduled backends")
        if distinct < 4 * len(reqs):
            raise AssertionError(f"degenerate greedy output: {distinct} "
                                 f"distinct tokens over {len(reqs)} requests")

    # -- 6b. scaled-down fp32 int8: backends token-identical -----------------
    def p_quant_small():
        base = CONFIGS.get("qwen2_0_5b").scaled_down()
        qbase = dataclasses.replace(base, quant_serving=True)
        pol = QuantPolicy(min_size=0)    # every projection (small widths)
        params = tree_map(lambda _p, a: a * 5.0, N.init(base, args.seed, dev))
        rng = np.random.default_rng(args.seed + 1)
        reqs = requests(rng, 8, 4, 64, 16, base.vocab, prefix=32)
        toks, counts = {}, {}
        for b in ("xla", "scheduled"):
            cfg = dataclasses.replace(qbase, gemm_backend=b)
            eng, res, _, counts[b] = serve(cfg, params, reqs, 4, 160,
                                           audit=True, quant_policy=pol)
            if not all(r.status == "ok" for r in res) \
                    or eng.pool.stats()["quantized"] != 1:
                raise AssertionError(f"scaled-down int8 {b}: a request "
                                     f"failed or the pool is not int8")
            toks[b] = [r.tokens.tolist() for r in res]
        _eng, res, _, _ = serve(base, params, reqs, 4, 160, audit=True)
        fp = [r.tokens.tolist() for r in res]
        total = sum(len(t) for t in fp)
        agree_x5 = sum(x == y for tq, tf in zip(toks["xla"], fp)
                       for x, y in zip(tq, tf)) / total
        same = toks["xla"] == toks["scheduled"]
        distinct = len({t for seq in toks["xla"] for t in seq})
        # the reference's own agreement gate (tests/test_quant_serving.py:
        # init-scale weights, 2 slots, max_len 64, 4 requests sharing an
        # 8-token prefix, 4 new tokens), held at its geometry
        p1 = N.init(base, args.seed, dev)
        rng1 = np.random.default_rng(0)
        pre = rng1.integers(3, base.vocab, 8).astype(np.int32)
        reqs1 = [Request(i, np.concatenate(
            [pre, rng1.integers(3, base.vocab, 4 + i).astype(np.int32)]),
            4, eos=-1) for i in range(4)]
        _eng, r_fp, _, _ = serve(base, p1, reqs1, 2, 64, audit=True)
        _eng, r_q, _, _ = serve(qbase, p1, reqs1, 2, 64, audit=True,
                                quant_policy=pol)
        n1 = sum(len(r.tokens) for r in r_fp)
        agree_ref = sum(int(x == y) for a, b in zip(r_fp, r_q)
                        for x, y in zip(a.tokens.tolist(),
                                        b.tokens.tolist())) / n1
        rep["quant_small"] = {"weights_scale": 5.0, "identical": same,
                              "distinct_tokens": distinct,
                              "agreement_vs_fp_x5": agree_x5,
                              "agreement_vs_fp_reference_gate": agree_ref,
                              "launches": counts}
        print(f"scaled-down fp32 int8, weights x5: greedy tokens identical "
              f"across backends: {same} ({distinct} distinct tokens); "
              f"agreement with the fp engine {agree_x5:.3f} (x5, not "
              f"gated), {agree_ref:.3f} at the reference's gate geometry "
              f"(>= 0.99)")
        if not same:
            raise AssertionError("scaled-down int8 tokens differ between "
                                 "the xla and scheduled backends")
        if distinct < 32:
            raise AssertionError(f"degenerate greedy output: {distinct} "
                                 f"distinct tokens")
        if agree_ref < 0.99:
            raise AssertionError(f"int8 vs fp agreement {agree_ref} < 0.99 "
                                 f"at the reference's gate geometry")

    # -- 6b'. scaled-down fp32 mamba2: backends token-identical --------------
    def p_mamba_small():
        # init-scale weights: the streams of this model already vary
        base = m2.scaled_down()
        params = N.init(base, args.seed, dev)
        rng = np.random.default_rng(args.seed + 1)
        reqs = requests(rng, 8, 4, 100, 16, base.vocab)
        out = {}
        for chunk in (32, 64):
            toks, counts = {}, {}
            for b in ("xla", "scheduled"):
                cfg = dataclasses.replace(base, gemm_backend=b)
                eng, res, _, counts[b] = serve(cfg, params, reqs, 4, 160,
                                               audit=True,
                                               prefill_chunk=chunk)
                if not all(r.status == "ok" and len(r.tokens) == 16
                           for r in res):
                    raise AssertionError(f"scaled-down mamba2 {b}: a "
                                         f"request failed")
                if counts[b]["ssd_intra"] != base.n_layers * eng.chunk_steps:
                    raise AssertionError(f"scaled-down mamba2 {b}: K5 "
                                         f"launches {counts[b]}")
                toks[b] = [r.tokens.tolist() for r in res]
            same = toks["xla"] == toks["scheduled"]
            distinct = [len(set(t)) for t in toks["xla"]]
            out[chunk] = {"identical": same, "distinct_per_request": distinct,
                          "launches": counts}
            print(f"scaled-down fp32 mamba2, prefill_chunk {chunk}: greedy "
                  f"tokens identical across backends: {same}; distinct "
                  f"tokens a request {distinct}; K5 launches "
                  f"{counts['scheduled']['ssd_intra']}")
            if not same:
                raise AssertionError(f"scaled-down mamba2 tokens differ "
                                     f"between backends (chunk {chunk})")
            if min(distinct) < 4:
                raise AssertionError(f"degenerate greedy output: {distinct}")
        rep["mamba2_small"] = out

    # -- 6c. the exact integer GEMM path -------------------------------------
    limb_launches: dict = {}

    def limb_gemms():
        """Every integer p-GEMM of MD, FFE and ALI's fully connected layers
        (core.workloads), the example's shape and kernels_bench's two."""
        ops = []
        for name in ("MD", "FFE", "ALI"):
            gemms, _ = split_paths(WL.workload(name))
            ops += [g for g in gemms
                    if name != "ALI" or ".fc" in g.name]
        ops.append(PGEMM("example", M=96, N=64, K=160, precision=INT32))
        ops += [PGEMM(f"kernels_bench.{p.name}", M=128, N=128, K=256,
                      precision=p) for p in (INT16, INT32)]
        return ops

    def int_operands(op, seed):
        dt = {"INT8": np.int8, "INT16": np.int16, "INT32": np.int32}[
            op.precision.name]
        info = np.iinfo(dt)
        rng = np.random.default_rng(seed)
        return (rng.integers(info.min, info.max, (op.M, op.K), dtype=dt,
                             endpoint=True),
                rng.integers(info.min, info.max, (op.K, op.N), dtype=dt,
                             endpoint=True))

    def p_limb_path():
        ops = limb_gemms()
        inputs = [int_operands(op, 100 + n) for n, op in enumerate(ops)]
        dev_in = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
                  for a, b in inputs]
        torch.cuda.synchronize()
        LG.launches.reset()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            outs = [OPS.limb_matmul(a, b) for a, b in dev_in]
            torch.cuda.synchronize()
        launches = LG.launches.count
        limb_launches["limb_gemm"] = launches
        _, cuda_kernels = kernel_ms(prof)
        rows, cfg = [], GTAConfig(lanes=4)
        for op, (a, b), (ta, tb), (hi, lo) in zip(ops, inputs, dev_in, outs):
            rhi, rlo = KREF.int_matmul_mod64_ref(a, b)
            exact = np.array_equal(hi.cpu().numpy(), rhi) and \
                np.array_equal(lo.cpu().numpy(), rlo)
            nl = KREF.n_limbs_for(op.precision.bits)
            diags = LG.limb_gemm_diagonals_ref(LG.limb_decompose(ta, nl),
                                               LG.limb_decompose(tb, nl))
            chi, clo = ACC.combine_diagonals(diags, KREF.LIMB_BITS)
            hhi, hlo = ACC.combine_diagonals(diags.cpu(), KREF.LIMB_BITS)
            combine_same = torch.equal(chi.cpu(), hhi) and \
                torch.equal(clo.cpu(), hlo)
            choice = explore(op, cfg)
            sch = choice.best.schedule
            d = LG.digits_for(op.precision.bits, nl, op.K)
            plan = LG.limb_plan(op.M, op.N, op.K, d, d,
                                op.precision.bits // 8,
                                op.precision.bits // 8)
            rows.append({"name": op.name, "M": op.M, "N": op.N, "K": op.K,
                         "precision": op.precision.name, "limbs": nl,
                         "tile": list(plan.tile), "ranks": plan.ranks,
                         "exact": bool(exact),
                         "combine_cuda_equals_cpu": bool(combine_same),
                         "schedule": {"dataflow": sch.dataflow.value,
                                      "array": [sch.array.rows,
                                                sch.array.cols],
                                      "k_fold": sch.k_fold,
                                      "cycles": choice.cycles,
                                      "traffic_bytes": choice.traffic_bytes,
                                      "space": len(choice.space)}})
            print(f"limb_matmul {op.name} ({op.M}, {op.N}, {op.K}) "
                  f"{op.precision.name}: exact mod 2^64 {exact}, combine "
                  f"cuda == cpu {combine_same}; explorer: "
                  f"{sch.dataflow.value} {sch.array.rows}x{sch.array.cols} "
                  f"k_fold={sch.k_fold} {choice.cycles:.0f} cycles")
        rep["limb_path"] = {"calls": len(ops), "k4_launches": launches,
                            "cuda_kernels": cuda_kernels, "rows": rows}
        bad = [r["name"] for r in rows
               if not (r["exact"] and r["combine_cuda_equals_cpu"])]
        print(f"limb_path: {len(rows) - len(bad)}/{len(rows)} p-GEMMs exact; "
              f"K4 launches {launches} and CUDA kernels {cuda_kernels} "
              f"(torch.profiler) for {len(ops)} limb_matmul calls")
        if bad:
            raise AssertionError(f"limb_matmul not exact: {bad}")
        if launches != len(ops) or cuda_kernels != len(ops):
            raise AssertionError(f"K4 launched {launches} times and the "
                                 f"card ran {cuda_kernels} kernels for "
                                 f"{len(ops)} limb_matmul calls")

    # -- 6d. the spill-epilogue GEMM path at full width ---------------------
    spill_launches: dict = {}

    def p_spill_path():
        dispatches = []
        for M in (8, 256):
            for name, N_, K_ in spill_shapes():
                a, b = gemm_inputs(M, N_, K_, torch.bfloat16, M + N_ + K_)
                for label, df, fold in spill_variants:
                    dispatches.append((M, name, a, b, label, df, fold))
        torch.cuda.synchronize()
        MP.reset_launches()
        rows = []
        for M, name, a, b, label, df, fold in dispatches:
            N_, K_ = b.shape[1], a.shape[1]
            bm, bn, bk = OPS.plan_blocks(M, N_, K_, 2, df, fold)
            plan = MP.dispatch_plan(M, N_, K_, dataflow=df, bm=bm, bn=bn,
                                    bk=bk, k_fold=fold, epilogue="spill",
                                    abytes=2, bbytes=2)
            outs, rise = {}, {}
            for ep in ("fused", "spill"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                outs[ep] = OPS.matmul(a, b, dataflow=df, k_fold=fold,
                                      epilogue=ep)
                torch.cuda.synchronize()
                rise[ep] = torch.cuda.max_memory_allocated() - base
            ref = a.double() @ b.double()
            scale = 1.0 + outs["fused"].abs()
            rows.append({
                "M": M, "gemm": name, "N": N_, "K": K_, "variant": label,
                "blocks": [bm, bn, bk], "k_fold": plan["k_fold_effective"],
                "planes_bytes": plan["intermediate_hbm_bytes"],
                "out_bytes": M * N_ * 4,
                "rise_fused": rise["fused"], "rise_spill": rise["spill"],
                "spill_vs_fused": ((outs["spill"] - outs["fused"]).abs()
                                   / scale).max().item(),
                "fused_vs_fp64": ((outs["fused"].double() - ref).abs()
                                  / (1 + ref.abs())).max().item(),
                "spill_vs_fp64": ((outs["spill"].double() - ref).abs()
                                  / (1 + ref.abs())).max().item()})
            del outs, ref
        torch.cuda.synchronize()
        spill_launches["mpgemm_spill"] = MP.spill_launches.count
        spill_launches["mpgemm"] = MP.launches.count
        spill_launches["by_dataflow"] = dict(MP.spill_launches_by_dataflow)
        spill_launches["by_route"] = {"mpgemm": dict(MP.launches_by_route),
                                      "mpgemm_spill": dict(
                                          MP.spill_launches_by_route)}
        want_k6 = sum(r["planes_bytes"] > 0 for r in rows)
        # then each dispatch timed (launches counted above, not here)
        for r, (M, name, a, b, label, df, fold) in zip(rows, dispatches):
            iters = 5 if r["N"] == full.vocab else 20
            for ep in ("fused", "spill"):
                r[f"{ep}_ms"] = time_ms(lambda: OPS.matmul(
                    a, b, dataflow=df, k_fold=fold, epilogue=ep), iters)
            print(f"[{card}] spill_path ({r['M']}, {r['N']}, {r['K']}) "
                  f"{r['gemm']} {r['variant']} tile {r['blocks']} f="
                  f"{r['k_fold']}: planes {r['planes_bytes'] / 1e6:.2f} MB, "
                  f"memory rise spill {r['rise_spill'] / 1e6:.2f} MB / fused "
                  f"{r['rise_fused'] / 1e6:.2f} MB (out "
                  f"{r['out_bytes'] / 1e6:.2f} MB); |spill - fused|/(1+|fused|"
                  f") {r['spill_vs_fused']:.1e}, vs fp64 {r['spill_vs_fp64']:.1e}"
                  f" / {r['fused_vs_fp64']:.1e}; {r['spill_ms'] * 1e3:.1f} us "
                  f"spill, {r['fused_ms'] * 1e3:.1f} us fused")
        rep["spill_path"] = {"rows": rows, "launches": spill_launches}
        largest = max(rows, key=lambda r: r["planes_bytes"])
        print(f"spill_path: {len(rows)} dispatches; largest plane tensor "
              f"{largest['planes_bytes'] / 1e9:.3f} GB ({largest['gemm']} "
              f"M={largest['M']} {largest['variant']} bk="
              f"{largest['blocks'][2]}); launches {spill_launches} (K6 "
              f"expected {want_k6})")
        bad = [(r["M"], r["gemm"], r["variant"]) for r in rows
               if r["spill_vs_fused"] > 1e-4 or r["spill_vs_fp64"] > 1e-4
               or r["fused_vs_fp64"] > 1e-4
               or r["rise_spill"] < r["planes_bytes"]
               or r["rise_fused"] > r["out_bytes"] + (1 << 20)]
        if bad:
            raise AssertionError(f"spill_path failed checks: {bad}")
        if spill_launches["mpgemm_spill"] != want_k6 or want_k6 == 0 or \
                spill_launches["mpgemm"] != 2 * len(rows) - want_k6:
            raise AssertionError(f"spill_path launches {spill_launches}, "
                                 f"expected K6 {want_k6}")
        if any(by["cuda_core"] for by in spill_launches["by_route"].values()):
            raise AssertionError(f"spill_path: a bf16 GEMM took the CUDA-"
                                 f"core route: {spill_launches['by_route']}")

    # -- 6e. sampled decoding at full width -----------------------------------
    def sampled_requests(vocab, new_tokens):
        """Four of phase 5's requests (the shortest prompts, rids 4-7),
        ``new_tokens`` each, the odd ones at temperature 0.8."""
        reqs = requests(np.random.default_rng(args.seed), 8, 64, 513, 32,
                        vocab)[4:]
        return [dataclasses.replace(r, max_new_tokens=new_tokens,
                                    temperature=0.8 if r.rid % 2 else 0.0)
                for r in reqs]

    def p_sampled():
        # (1) the sampler on fixed logits at the head's shape: 8 rows of
        # 151936, each at its temperature, >= 20 000 draws a row, against
        # softmax(logits / T) in total variation
        V = full.vocab
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        z = torch.randn(8, V, generator=gen, device=dev) * 4.0
        row_t = torch.tensor([0.5, 0.8, 1.0, 1.2] * 2, device=dev)
        reps, calls = 256, 79
        rows, temps = z.repeat(reps, 1), row_t.repeat(reps)
        rid = torch.arange(8, device=dev).repeat(reps)
        counts = torch.zeros(8, V, dtype=torch.float64, device=dev)
        one = torch.ones(rows.shape[0], dtype=torch.float64, device=dev)
        draw_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        for _ in range(calls):
            tok = SAMPLING.sample(rows, temps, draw_gen)
            counts.index_put_((rid, tok.long()), one, accumulate=True)
        draws = reps * calls
        probs = torch.softmax(z.double() / row_t.double()[:, None], -1)
        tv = (0.5 * (counts / draws - probs).abs().sum(-1)).tolist()
        bounds = [SAMPLING.softmax_tv_bound(probs[r], draws) for r in range(8)]
        greedy_ok = bool(torch.equal(
            SAMPLING.sample(z, torch.zeros(8, device=dev), draw_gen),
            z.argmax(-1).int()))
        t_sample = time_ms(lambda: SAMPLING.sample(z, row_t, draw_gen), 100)
        t_argmax = time_ms(lambda: z.argmax(-1), 100)
        del rows, temps, rid, counts, one
        dist = {"draws_per_row": draws, "temperatures": row_t.tolist(),
                "tv": tv, "bound": bounds, "greedy_rows_argmax": greedy_ok,
                "sample_ms": t_sample, "argmax_ms": t_argmax}
        print(f"sampler on fixed logits (8 x {V}, N(0, 16) logits), "
              f"{draws} draws a row: TV to softmax(logits / T) "
              + ", ".join(f"T={t:.1f} {x:.4f} <= {b:.4f}" for t, x, b in
                          zip(row_t.tolist(), tv, bounds))
              + f"; greedy rows = argmax: {greedy_ok}; [{card}] sample "
              f"{t_sample * 1e3:.1f} us, argmax {t_argmax * 1e3:.1f} us a "
              f"(8, {V}) call")
        # (2) the engine: four of phase 5's requests, two at T = 0.8 mixed
        # in one batch with two greedy ones, 8 tokens each, on the
        # scheduled backend; a greedy-only run of the same requests gives
        # the tokens and launches to match
        models = {
            "fp": (dataclasses.replace(full, gemm_backend="scheduled"),
                   params_full, None, main_tokens),
            "int8": (dataclasses.replace(full_quant, gemm_backend="scheduled"),
                     params_quant, None, quant_tokens),
            "mamba2": (dataclasses.replace(m2, gemm_backend="scheduled"),
                       params_m2, m2.ssm.chunk, mamba_tokens)}
        keys = ("paged_decode", "paged_decode_int8", "mpgemm",
                "quant_matmul", "ssd_intra")
        out, bad, new = {"distribution": dist}, [], 8
        for name, (cfg, get_params, chunk, tok_ref) in models.items():
            params = get_params()
            mixed = sampled_requests(cfg.vocab, new)
            runs = {}
            for tag, seed, reqs in (
                    ("greedy", args.seed, [dataclasses.replace(
                        r, temperature=0.0) for r in mixed]),
                    ("a", args.seed, mixed), ("a again", args.seed, mixed),
                    ("b", args.seed + 1, mixed)):
                eng, res, wall, cnt = serve(cfg, params, reqs, 8, 1024,
                                            audit=True, prefill_chunk=chunk,
                                            seed=seed)
                runs[tag] = {"tokens": {r.rid: r.tokens.tolist()
                                        for r in res},
                             "launches": {k: cnt[k] for k in keys},
                             "wall_s": wall, "steps": [eng.steps,
                                                       eng.chunk_steps]}
            greedy = runs["greedy"]["tokens"]
            a, a2, b = (runs[t]["tokens"] for t in ("a", "a again", "b"))
            odd = [r.rid for r in mixed if r.temperature > 0]
            even = [r.rid for r in mixed if r.temperature == 0]
            checks = {
                "greedy rows = greedy run": all(a[i] == greedy[i]
                                                for i in even),
                "same seed, same tokens": a == a2,
                "other seed, other tokens": any(a[i] != b[i] for i in odd),
                "sampled rows differ from greedy": any(a[i] != greedy[i]
                                                       for i in odd),
                "launches = greedy run's": all(
                    runs[t]["launches"] == runs["greedy"]["launches"]
                    for t in runs),
                f"{new} tokens a request": all(len(x) == new for x in
                                           list(a.values())
                                           + list(b.values()))}
            if "scheduled" in tok_ref:
                # the greedy rows also open as in the 8-request run of
                # their main path (rows do not interact)
                checks["greedy rows = main path's"] = all(
                    a[i] == tok_ref["scheduled"][i][:new] for i in even)
            out[name] = {"runs": runs, "checks": checks}
            print(f"[{card}] sampled_path {name}: "
                  + ", ".join(f"{t} {r['wall_s']:.2f} s {r['steps']}"
                              for t, r in runs.items())
                  + f"; launches {runs['a']['launches']}; {checks}")
            bad += [f"{name}: {k}" for k, v in checks.items() if not v]
        rep["sampled_path"] = out
        if not greedy_ok or any(x > b for x, b in zip(tv, bounds)):
            raise AssertionError(f"sampler off its softmax: {dist}")
        if bad:
            raise AssertionError(f"sampled_path checks failed: {bad}")

    def small_fp32():
        """Scaled-down qwen2 in fp32 at weights x4 (the CPU parity tests'
        scale): where the token identity of preemption and speculation is
        gated -- in bf16 the KV a resumed prefill or a verify step writes
        is rounded apart from what decode steps write (reported below)."""
        if "small" not in full_params:
            base = CONFIGS.get("qwen2_0_5b").scaled_down()
            cfg = dataclasses.replace(base, gemm_backend="scheduled")
            full_params["small"] = (cfg, tree_map(
                lambda _p, a: a * 4.0, N.init(base, args.seed, dev)),
                tree_map(lambda _p, a: a * 4.0,
                         N.init(base, args.seed + 1, dev)))
        return full_params["small"]

    def agreement(runs, ref):
        """Share of tokens equal to the reference run's, per run (over
        the shorter of the two streams)."""
        return {k: sum(x == y for rid, t in r["tokens"].items()
                       for x, y in zip(t, ref[rid]))
                / sum(min(len(t), len(ref[rid]))
                      for rid, t in r["tokens"].items())
                for k, r in runs.items()}

    #: K2's bf16 tolerance, relative to 1 + |reference|; twice it (one
    #: deviation a run) bounds the gap of two tokens that part by rounding
    BF16_TOL = 1e-2

    def last_logits(cfg, params, seq):
        """Logits after ``seq``: one row prefilled in one chunk, a route
        neither compared run took."""
        n, bs = len(seq), 16
        nbs = -(-n // bs)
        caches = N.expand_cache_pos(
            N.init_paged_caches(cfg, 1, nbs + 1, bs, device=dev), 1)
        table = torch.arange(1, nbs + 1, dtype=torch.int32,
                             device=dev)[None]
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        toks = torch.tensor(np.asarray(seq, np.int32)[None], device=dev)
        logits, _ = N.prefill_paged_chunk(
            params, cfg, toks, caches,
            torch.zeros(1, dtype=torch.int32, device=dev), table, lens,
            lens - 1)
        return logits[0].float()

    def divergences(cfg, params, prompts, runs, ref):
        """Each request whose tokens part from ``ref``'s: the first
        position where they do, and the two tokens' logits there after
        the reference's own prefix.  Two runs that differ only in
        rounding part where those logits are within both runs'
        deviations of each other: ``gap <= 2 * BF16_TOL * (1 + |logit|)``;
        a fault (a wrong resume or rollback) picks a token far below."""
        out = []
        for name, r in runs.items():
            for rid, toks in r["tokens"].items():
                want = ref[rid]
                p = next((j for j, (x, y) in enumerate(zip(toks, want))
                          if x != y), None)
                if p is None:
                    continue
                lg = last_logits(cfg, params,
                                 [int(t) for t in prompts[rid]] + want[:p])
                a, b = want[p], toks[p]
                la, lb = lg[a].item(), lg[b].item()
                top = torch.topk(lg, 2).values.tolist()
                bound = 2 * BF16_TOL * (1 + max(abs(la), abs(lb)))
                out.append({"run": name, "rid": rid, "pos": p,
                            "tokens": [a, b], "logits": [la, lb],
                            "gap": abs(la - lb), "bound": bound,
                            "ranks": [int((lg > la).sum()),
                                      int((lg > lb).sum())],
                            "top2_gap": top[0] - top[1],
                            "logit_std": lg.std().item(),
                            "ok": abs(la - lb) <= bound})
        for d in out:
            print(f"  {d['run']} rid {d['rid']} parts at token {d['pos']}:"
                  f" {d['tokens']} ranked {d['ranks']}, gap "
                  f"{d['gap']:.4f} <= {d['bound']:.4f} {d['ok']} (top-2 "
                  f"gap {d['top2_gap']:.4f}, logit std "
                  f"{d['logit_std']:.3f})")
        return out

    # -- 6f. admission policies with preemption at full width ----------------
    def policy_runs(cfg, params, policies):
        """One overload run a (policy, kv_blocks) or (label, policy,
        kv_blocks) entry, keyed "<label> @<kv_blocks>"."""
        out = {}
        for entry in policies:
            label, policy, kv_blocks = (entry if len(entry) == 3
                                        else (entry[0],) + tuple(entry))
            eng, res, wall, cnt = serve(
                cfg, params, TRACES.overload_trace(12, cfg.vocab), 4,
                TRACES.POLICY_MAX_LEN, audit=True, settle=0.01,
                policy=policy, kv_blocks=kv_blocks)
            ps = eng.pool.stats()
            out[f"{label} @{kv_blocks or 'unconstrained'}"] = {
                "tokens": {r.rid: r.tokens.tolist() for r in res},
                "preemptions": eng.preemptions, "resumes": eng.resumes,
                "admissions": eng.admissions,
                "avg_pool_util": eng.avg_pool_util(),
                "p95_ttft_steps": float(np.percentile(
                    [r.ttft_steps for r in res], 95)),
                "steps": [eng.steps, eng.chunk_steps],
                "backoffs": ps["backoffs"],
                "shared_token_hits": ps["shared_token_hits"],
                "evictions": ps["evictions"], "wall_s": wall,
                "schedule_misses": eng.schedule.stats()["misses"],
                "launches": {k: cnt[k] for k in ("paged_decode", "mpgemm")}}
        return out

    def model_row(cfg):
        """model_preempt on the planner's step costs at the overload
        geometry (serve_bench's ``policy_model`` row)."""
        geom = EngineGeometry(slots=4, max_len=TRACES.POLICY_MAX_LEN,
                              kv_blocks=TRACES.OVERLOAD_KV_BLOCKS,
                              precision=precision_for_dtype(
                                  cfg.compute_dtype, default="FP32").name)
        costs = WorkloadModel(cfg, geom).step_costs()
        return costs, ("model_preempt[planner]", ModelPreemptPolicy(
            costs=costs), TRACES.OVERLOAD_KV_BLOCKS)

    def policy_model_gates(runs, tight):
        """serve_bench's three gates of the planner-costed row."""
        m = runs[f"model_preempt[planner] @{tight}"]
        return {"tokens equal to fifo's": m["tokens"] == runs[
                    f"fifo @{tight}"]["tokens"],
                "p95 TTFT steps <= slo_preempt's": m["p95_ttft_steps"]
                <= runs[f"slo_preempt @{tight}"]["p95_ttft_steps"],
                "pool util >= best_fit's": m["avg_pool_util"]
                >= runs[f"best_fit @{tight}"]["avg_pool_util"]}

    def p_policy():
        tight = TRACES.OVERLOAD_KV_BLOCKS
        # full width, bf16: the five policies where FIFO's head blocks,
        # slo_preempt at 32 blocks, where its preemption is for a slot
        # and the resumption maps the victim's cached blocks (at 20 the
        # at-risk admission itself evicts them), and an unconstrained pool
        cfg = dataclasses.replace(full, gemm_backend="scheduled")
        runs = policy_runs(cfg, params_full(),
                           [(p, tight) for p in POLICY_NAMES]
                           + [("slo_preempt", 32), ("fifo", None)])
        t0 = time.perf_counter()
        costs, row = model_row(cfg)
        runs.update(policy_runs(cfg, params_full(), [row]))
        added("policy_path", t0, "profile")
        ref = runs[f"fifo @{tight}"]["tokens"]
        agree = agreement(runs, ref)
        for k, r in runs.items():
            print(f"[{card}] policy_path {k}: {r['preemptions']} "
                  f"preemptions, {r['resumes']} resumes, mean pool util "
                  f"{r['avg_pool_util']:.4f}, p95 TTFT {r['p95_ttft_steps']}"
                  f" dispatches, {r['backoffs']} backoffs, "
                  f"{r['shared_token_hits']} shared-token hits, steps "
                  f"{r['steps']}, {r['wall_s']:.2f} s, launches "
                  f"{r['launches']}, tokens equal to fifo's {agree[k]:.4f}")
        prompts = {r.rid: r.prompt
                   for r in TRACES.overload_trace(12, full.vocab)}
        parted = divergences(cfg, params_full(), prompts, runs, ref)
        # scaled-down fp32: every run token-identical
        scfg, sparams, _ = small_fp32()
        small = policy_runs(scfg, sparams,
                            [(p, tight) for p in POLICY_NAMES]
                            + [("fifo", None), ("slo_preempt", 32)])
        t0 = time.perf_counter()
        scosts, srow = model_row(scfg)
        small.update(policy_runs(scfg, sparams, [srow]))
        gates = {"full_width": policy_model_gates(runs, tight),
                 "scaled_down_fp32": policy_model_gates(small, tight)}
        prior = runs[f"model_preempt @{tight}"]
        planned = runs[f"model_preempt[planner] @{tight}"]
        print(f"[{card}] policy_path model_preempt on WorkloadModel step "
              f"costs (chunk {costs.chunk_cost:.0f}, decode "
              f"{costs.decode_cost:.0f} cycles: ratio "
              f"{costs.chunk_cost / costs.decode_cost:.2f}; the prior's "
              f"3.00): p95 TTFT {planned['p95_ttft_steps']} dispatches "
              f"(prior {prior['p95_ttft_steps']}), pool util "
              f"{planned['avg_pool_util']:.4f} (prior "
              f"{prior['avg_pool_util']:.4f}), {planned['preemptions']} "
              f"preemptions; scaled-down ratio "
              f"{scosts.chunk_cost / scosts.decode_cost:.2f}")
        print(f"policy_path serve_bench policy_model gates (reported, not "
              f"gated here): {gates}")
        added("policy_path", t0, "profile")
        rep["policy_model"] = {
            "step_costs": dataclasses.asdict(costs),
            "step_costs_scaled_down": dataclasses.asdict(scosts),
            "gates": gates}
        sref = small[f"fifo @{tight}"]["tokens"]
        rep["policy_path"] = {"full_width": runs, "agreement": agree,
                              "divergences": parted,
                              "scaled_down_fp32": small}
        checks = {
            "non-preempting policies identical (bf16)": all(
                runs[f"{p} @{tight}"]["tokens"] == ref
                for p in ("best_fit", "model_fit")),
            "fifo head blocks": runs[f"fifo @{tight}"]["backoffs"] > 0,
            "slo_preempt preempts": runs[f"slo_preempt @{tight}"][
                "preemptions"] > 0,
            "resumes skip cached prefill": runs["slo_preempt @32"][
                "resumes"] > 0 and runs["slo_preempt @32"][
                "shared_token_hits"] > 0,
            "no schedule miss": all(r["schedule_misses"] == 0 for r in
                                    list(runs.values())
                                    + list(small.values())),
            "bf16: streams part only within rounding": all(
                d["ok"] for d in parted),
            "fp32: every run identical": all(r["tokens"] == sref
                                             for r in small.values()),
            "fp32: preempted": small[f"slo_preempt @{tight}"][
                "preemptions"] > 0,
            "fp32: varied tokens": len({t for v in sref.values()
                                        for t in v}) > 8}
        print(f"policy_path checks: {checks}")
        rep["policy_path_checks"] = checks
        bad = [k for k, v in checks.items() if not v]
        if bad:
            raise AssertionError(f"policy_path checks failed: {bad}")

    # -- 6g. speculative decoding at full width -------------------------------
    def spec_runs(cfg, params, other, slots, divergent_new=24):
        """Vanilla, ngram, self-draft and divergent draft on the
        repetition trace; the divergent draft (all rejected, k + 1 draft
        steps a token) decodes ``divergent_new`` tokens a request."""
        reqs = TRACES.rep_trace(8, cfg.vocab)
        out = {}
        for name, spec in (("vanilla", None), ("ngram", "ngram"),
                           ("self", ModelDraft(cfg, params)),
                           ("divergent", ModelDraft(cfg, other))):
            kw = {} if spec is None else {"spec": spec, "spec_k": 4}
            if name == "divergent":
                reqs = TRACES.rep_trace(8, cfg.vocab,
                                        max_new=divergent_new)
            eng, res, wall, cnt = serve(cfg, params, reqs, slots,
                                        TRACES.SPEC_MAX_LEN, audit=True,
                                        **kw)
            out[name] = {"tokens": {r.rid: r.tokens.tolist() for r in res},
                         "steps": [eng.steps, eng.chunk_steps],
                         "spec": eng.spec_stats(), "wall_s": wall,
                         "schedule_misses": eng.schedule.stats()["misses"],
                         "launches": {k: cnt[k] for k in
                                      ("paged_decode", "mpgemm")}}
        return out

    def verify_vs_decode(cfg, params, cur=None):
        """The repetition trace's 8 prompts prefilled into one cache;
        then a decode step of the next token (``cur``, else the prefill's
        argmax), and on a copy of the cache a verify call of that token
        and four drafts.  Returns position 0 of the verify, the decode
        step's logits and ``cur``: both see the same inputs."""
        prompts = np.stack([r.prompt for r in
                            TRACES.rep_trace(8, cfg.vocab)])
        B, n, bs = prompts.shape[0], prompts.shape[1], 16
        nbs = TRACES.SPEC_MAX_LEN // bs
        caches = N.expand_cache_pos(
            N.init_paged_caches(cfg, B, 1 + B * nbs, bs, device=dev), B)
        table = torch.arange(1, 1 + B * nbs, dtype=torch.int32,
                             device=dev).reshape(B, nbs)
        ids = torch.arange(B, dtype=torch.int32, device=dev)
        toks = torch.from_numpy(prompts.astype(np.int32)).to(dev)
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        first, caches = N.prefill_paged_chunk(params, cfg, toks, caches,
                                              ids, table, lens, lens - 1)
        if cur is None:
            cur = first.argmax(-1).to(torch.int32)
        twin = tree_map(lambda _p, a: a.clone(), caches)
        dec, _ = N.decode_step(params, cfg, cur[:, None], caches,
                               lens.clone(), table,
                               torch.ones(B, dtype=torch.int32, device=dev))
        ver, _ = N.verify_paged_chunk(
            params, cfg, torch.cat([cur[:, None], toks[:, 2:6]], 1), twin,
            ids, table, torch.full((B,), 5, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        if tuple(ver.shape) != (B, 5, cfg.vocab) or not bool(
                torch.isfinite(ver).all() and torch.isfinite(dec).all()):
            raise AssertionError(f"verify logits {tuple(ver.shape)} not "
                                 f"(8, 5, vocab) or not finite")
        return ver[:, 0].float(), dec.float(), cur

    def verify_gate(cfg, params):
        """Position 0 of a verify against a decode step on the same
        cache, in bf16 and, with the weights cast up, in fp32 (the same
        tokens).  In fp32 the two routes agree within K2's fp32
        tolerance; in bf16 they may differ by what rounding takes each
        from fp32: at most twice the bf16 decode's distance from the fp32
        decode."""
        v16, d16, cur = verify_vs_decode(cfg, params)
        c32 = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
        v32, d32, _ = verify_vs_decode(
            c32, tree_map(lambda _p, a: a.float(), params), cur)
        return {"fp32_rel": ((v32 - d32).abs() / (1 + d32.abs())).max()
                .item(),
                "bf16_abs": (v16 - d16).abs().max().item(),
                "bf16_rel": ((v16 - d16).abs() / (1 + d16.abs())).max()
                .item(),
                "bf16_vs_fp32_abs": (d16 - d32).abs().max().item(),
                "argmax_equal": int((v16.argmax(-1)
                                     == d16.argmax(-1)).sum())}

    def p_spec():
        from torch.profiler import ProfilerActivity, profile
        cfg = dataclasses.replace(full, gemm_backend="scheduled")
        params = params_full()
        # the divergent draft: weights from another seed, x4, so that its
        # greedy stream differs from the target's
        other = tree_map(lambda _p, a: a * 4, N.init(full, args.seed + 1,
                                                     dev))
        runs = spec_runs(cfg, params, other, 8, divergent_new=8)
        del other
        vref = runs["vanilla"]["tokens"]
        agree = agreement(runs, vref)
        for name, r in runs.items():
            print(f"[{card}] spec_path {name}: {r['steps']} steps, "
                  f"{r['wall_s']:.2f} s, {r['spec']}, launches "
                  f"{r['launches']}, tokens equal to vanilla's "
                  f"{agree[name]:.4f}")
        prompts = {r.rid: r.prompt
                   for r in TRACES.rep_trace(8, full.vocab)}
        parted = divergences(cfg, params, prompts, runs, vref)
        vd = verify_gate(cfg, params)
        print(f"[{card}] verify logits at position 0 against a decode "
              f"step's on the same cache (8 x {full.vocab}): fp32 max|diff|"
              f" / (1 + |decode|) {vd['fp32_rel']:.3e} (tol 1e-4); bf16 "
              f"max|diff| {vd['bf16_abs']:.4f} against the bf16 decode's "
              f"max|bf16 - fp32| {vd['bf16_vs_fp32_abs']:.4f} (bound: "
              f"twice), relative {vd['bf16_rel']:.3e}; argmax equal "
              f"{vd['argmax_equal']}/8")
        scfg, sparams, sother = small_fp32()
        small = spec_runs(scfg, sparams, sother, 4)
        for name, r in small.items():
            print(f"scaled-down fp32 spec_path {name}: {r['steps']} steps, "
                  f"{r['spec']}")

        def step_device_ms(eng):
            """Device time of one engine step under torch.profiler."""
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.step()
                torch.cuda.synchronize()
            return kernel_ms(prof)

        prof = {}
        for name, kw in (("decode", {}), ("verify (ngram, k = 4)",
                                         {"spec": "ngram", "spec_k": 4})):
            eng = ContinuousEngine(cfg, params, slots=8,
                                   max_len=TRACES.SPEC_MAX_LEN, device=dev,
                                   **kw)
            for r in TRACES.rep_trace(8, full.vocab):
                eng.submit(r)
            eng.step()                       # the prefill chunk
            eng.step()
            ms, kernels = step_device_ms(eng)
            prof[name] = {"device_ms": ms, "kernels": kernels}
        rep["spec_path"] = {"full_width": runs, "agreement": agree,
                            "divergences": parted, "verify_vs_decode": vd,
                            "scaled_down_fp32": small, "step_profile": prof}
        print(f"[{card}] spec_path step device time: "
              + ", ".join(f"{k} {v['device_ms']:.3f} ms ({v['kernels']} "
                          f"kernels)" for k, v in prof.items()))
        sref = small["vanilla"]["tokens"]
        checks = {
            "divergent draft rejected": runs["divergent"]["spec"][
                "accepted"] < runs["divergent"]["spec"]["drafted"],
            "self-draft accepted": runs["self"]["spec"][
                "avg_accept_len"] > 1,
            "no schedule miss": all(r["schedule_misses"] == 0 for r in
                                    list(runs.values())
                                    + list(small.values())),
            "fp32: verify logits = decode's": vd["fp32_rel"] <= 1e-4,
            "bf16: verify logits = decode's within rounding":
                vd["bf16_abs"] <= 2 * vd["bf16_vs_fp32_abs"],
            "bf16: streams part only within rounding": all(
                d["ok"] for d in parted),
            "fp32: tokens identical to vanilla": all(
                r["tokens"] == sref for r in small.values()),
            "fp32: divergent draft rejected": small["divergent"]["spec"][
                "accepted"] < small["divergent"]["spec"]["drafted"]}
        print(f"spec_path checks: {checks}")
        rep["spec_path_checks"] = checks
        bad = [k for k, v in checks.items() if not v]
        if bad:
            raise AssertionError(f"spec_path checks failed: {bad}")

    # -- 9. the families served since qwen1.5, at full width ---------------
    FAMILY_CHUNK = 256          # the published SSD chunk; one for all five

    def block_kinds(cfg):
        return list(cfg.pattern) * cfg.n_groups_scan + list(cfg.tail)

    def k2_per_step(cfg):
        """mpgemm launches a scheduled step: q, k, v, o, gate, up and down
        of an attention block, q, k, v and o of a shared one, in_proj and
        out_proj of a MAMBA2 block, and the head."""
        per = {BlockKind.MAMBA2: 2, BlockKind.SHARED_ATTN: 4}
        return 1 + sum(per.get(k, 7) for k in block_kinds(cfg))

    def family_serve(cfg, params, reqs, max_len, chunk):
        """A warm-up run, then the counted run (pool audit on)."""
        warm = requests(np.random.default_rng(99), 2, 40, 41, 2, cfg.vocab)
        ContinuousEngine(cfg, params, slots=8, max_len=max_len,
                         prefill_chunk=chunk, device=dev).run(warm)
        torch.cuda.synchronize()
        eng, res, wall, counts = serve(cfg, params, reqs, 8, max_len,
                                       audit=True, prefill_chunk=chunk)
        r = summary(eng, res, wall)
        r["launches"] = counts
        r["prompt_lens"] = [len(q.prompt) for q in reqs]
        return r

    def family_check(arch, cfg, r, n_req, quant=False):
        """Every request ok with 16 tokens; K1 (K1-int8 when quantized)
        launched once an attention layer a decode step; K5 68 times a
        chunk step on zamba2 and never in decode; K2 (or K3) once a GEMM
        a step, every launch on the Hopper route."""
        kinds = block_kinds(cfg)
        n_attn = sum(k is not BlockKind.MAMBA2 for k in kinds)
        n_ssm = len(kinds) - n_attn
        c, steps = r["launches"], r["decode_steps"] + r["chunk_steps"]
        k1 = n_attn * r["decode_steps"]
        want = {"paged_decode": 0 if quant else k1,
                "paged_decode_int8": k1 if quant else 0,
                "ssd_intra": n_ssm * r["chunk_steps"],
                "mpgemm": 0 if quant else k2_per_step(cfg) * steps,
                "quant_matmul": k2_per_step(cfg) * steps if quant else 0}
        got = {k: c[k] for k in want}
        bad = []
        if r["ok"] != n_req or r["new_tokens"] != 16 * n_req:
            bad.append(f"{r['ok']}/{n_req} ok, {r['new_tokens']} tokens")
        if got != want or not r["decode_steps"] or not r["chunk_steps"]:
            bad.append(f"launches {got}, expected {want}")
        if c["mpgemm_by_route"]["cuda_core"] \
                or c["quant_matmul_by_route"]["cuda_core"]:
            bad.append(f"a bf16 GEMM took the CUDA-core route: {c}")
        if not n_ssm and r["schedule_misses"]:
            bad.append(f"{r['schedule_misses']} schedule-cache misses")
        if bad:
            raise AssertionError(f"{arch}{' int8' if quant else ''}: "
                                 + "; ".join(bad))
        return {"attn_layers": n_attn, "ssm_layers": n_ssm,
                "k1_per_decode_step": n_attn, "k5_per_chunk_step": n_ssm,
                "k2_or_k3_per_step": k2_per_step(cfg)}

    def show_family(name, r, secs):
        print(f"[{card}] {name} full width, scheduled, bf16: {r['ok']}/"
              f"{r['requests']} ok, {r['new_tokens']} tokens in "
              f"{r['wall_s']:.2f} s = {r['tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{r['ttft_p50_ms']:.1f} ms, TPOT p50 {r['tpot_p50_ms']:.2f} "
              f"ms, {r['decode_steps']} decode + {r['chunk_steps']} chunk "
              f"steps, {secs:.1f} s in all; launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }")

    def family_profile(cfg, params):
        """One chunk step (8 slots x 256 rows) and one decode step under
        torch.profiler, as step_profile does for mamba2."""
        eng = ContinuousEngine(cfg, params, slots=8, max_len=1024,
                               prefill_chunk=FAMILY_CHUNK, device=dev)
        plen = 5 * FAMILY_CHUNK // 2
        for r in requests(np.random.default_rng(7), 8, plen, plen + 1, 16,
                          cfg.vocab):
            eng.submit(r)
        chunk = measure(eng, 1)
        eng.step()
        eng.step()
        decode = measure(eng, 5)
        return chunk, decode

    def p_families():
        t_phase = time.perf_counter()
        out = {}
        for arch in FAMILIES:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(CONFIGS.get(arch),
                                      gemm_backend="scheduled")
            params = N.init(cfg, args.seed, dev)
            rng = np.random.default_rng(args.seed)
            reqs = requests(rng, 4, 64, 513, 16, cfg.vocab)
            max_len, chunk = 1024, FAMILY_CHUNK
            if arch == "gemma2_9b":
                # one prompt past the 4096 window: it bites in the chunks
                # and in every decode step of this request
                reqs.append(Request(4, rng.integers(3, cfg.vocab, 4200)
                                    .astype(np.int32), 16, eos=-1))
                max_len, chunk = 4352, 1024
            r = family_serve(cfg, params, reqs, max_len, chunk)
            r["counts"] = family_check(arch, cfg, r, len(reqs))
            r["max_len"], r["prefill_chunk"] = max_len, chunk
            if arch == "gemma2_9b":
                r["window"] = cfg.local_window
                r["window_bites"] = max(r["prompt_lens"]) + 16 > \
                    cfg.local_window
                if not r["window_bites"]:
                    raise AssertionError("gemma2: no request past the window")
            if arch in ("gemma2_9b", "zamba2_7b"):
                chunk_p, decode_p = family_profile(cfg, params)
                r["step_profile"] = {"chunk": chunk_p, "decode": decode_p}
                for kind, pr in (("chunk", chunk_p), ("decode", decode_p)):
                    show(f"{cfg.name} {kind} step, scheduled", pr)
                n_attn = r["counts"]["attn_layers"]
                n_ssm = r["counts"]["ssm_layers"]
                if (chunk_p["k5_launches"], decode_p["k5_launches"],
                        decode_p["k1_launches"]) != (n_ssm, 0, n_attn):
                    raise AssertionError(
                        f"{arch} profiled steps: K5 {chunk_p['k5_launches']}"
                        f" a chunk step and {decode_p['k5_launches']} a "
                        f"decode step, K1 {decode_p['k1_launches']} a "
                        f"decode step")
            secs = time.perf_counter() - t0
            r["seconds"] = secs
            show_family(cfg.name, r, secs)
            out[arch] = r
            if arch == "qwen1_5_4b":
                # int8 weights (the untied head's (D, V) payload included:
                # K3) and int8 KV blocks (K1-int8), same requests
                t0 = time.perf_counter()
                qcfg = dataclasses.replace(cfg, quant_serving=True)
                qparams = serving_quant_params(qcfg, params)
                del params
                rq = family_serve(qcfg, qparams, reqs, max_len, chunk)
                rq["counts"] = family_check(arch, qcfg, rq, len(reqs),
                                            quant=True)
                secs = time.perf_counter() - t0
                rq["seconds"] = secs
                show_family(f"{cfg.name} int8", rq, secs)
                out[arch + "+int8"] = rq
                del qparams
            else:
                del params
            torch.cuda.empty_cache()
        rep["families"] = out
        rep["families_s"] = time.perf_counter() - t_phase

    def family_small(arch):
        """The scaled-down fp32 arch under both backends: greedy tokens
        identical and varied (gemma2 and llava with a window that the
        prompts exceed), its weights scaled as the CPU parity tests
        scale them (tests/_family_scales.py)."""
        def run():
            base = family_config(CONFIGS, arch)
            windowed = arch in WINDOWED
            emb, rest = FAMILY_SCALES[arch]
            params = tree_map(lambda path, a: a * (
                emb if path[0] == "embed" else rest),
                N.init(base, args.seed, dev))
            rng = np.random.default_rng(args.seed + 1)
            reqs = requests(rng, 8, 4, 100, 16, base.vocab)
            toks, counts = {}, {}
            for b in ("xla", "scheduled"):
                cfg = dataclasses.replace(base, gemm_backend=b)
                _eng, res, _, counts[b] = serve(cfg, params, reqs, 4, 160,
                                                audit=True,
                                                prefill_chunk=32)
                if not all(r.status == "ok" and len(r.tokens) == 16
                           for r in res):
                    raise AssertionError(f"scaled-down {arch} {b}: a "
                                         f"request failed")
                toks[b] = [r.tokens.tolist() for r in res]
            same = toks["xla"] == toks["scheduled"]
            distinct = [len(set(t)) for t in toks["xla"]]
            rep[f"{arch}_small"] = {"weights_scale": [emb, rest],
                                    "identical": same,
                                    "window": base.local_window
                                    if windowed else None,
                                    "distinct_per_request": distinct,
                                    "launches": counts}
            print(f"scaled-down fp32 {base.name} (embedding x{emb}, other "
                  f"weights x{rest}"
                  f"{f', window {WINDOW}' if windowed else ''}): greedy "
                  f"tokens identical across backends: {same}; distinct "
                  f"tokens a request {distinct}")
            if not same:
                raise AssertionError(f"scaled-down {arch} tokens differ "
                                     f"between the xla and scheduled "
                                     f"backends")
            if min(distinct) < 4:
                raise AssertionError(f"degenerate greedy output: {distinct}")
        return run

    # -- 10. the dense serving layout: dense stripes, waves, patches --------
    def engine_row(eng, res, wall, counts):
        r = summary(eng, res, wall)
        r["launches"] = counts
        r["tokens"] = {q.rid: q.tokens.tolist() for q in res}
        r["prefills"] = getattr(eng, "prefills", None)
        if hasattr(eng, "kv_bytes"):
            r["kv_bytes"] = eng.kv_bytes()
        return r

    def show_engine(name, r):
        print(f"[{card}] {name}: {r['ok']}/{r['requests']} ok, "
              f"{r['new_tokens']} tokens in {r['wall_s']:.2f} s = "
              f"{r['tok_per_s']:.1f} tok/s, TTFT p50 {r['ttft_p50_ms']:.1f} "
              f"ms, TPOT p50 {r['tpot_p50_ms']:.2f} ms, "
              f"{r['decode_steps']} decode + {r['chunk_steps']} chunk "
              f"steps, {r['prefills']} prefills; launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }")

    def dense_gates(name, cfg, r, n_req, new, quant=False):
        """Every request ok with ``new`` tokens; K1 and K1-int8 never; K5
        once an SSM layer a prefill and never in decode; K2 once a GEMM a
        step, a prefill counting as a step (under ``quant`` K3 on every
        projection and K2 on the tied head); every launch on the Hopper
        route."""
        n_ssm = sum(k is BlockKind.MAMBA2 for k in block_kinds(cfg))
        per = k2_per_step(cfg)
        steps = r["decode_steps"] + r["prefills"]
        want = {"paged_decode": 0, "paged_decode_int8": 0,
                "ssd_intra": n_ssm * r["prefills"],
                "mpgemm": steps if quant else per * steps,
                "quant_matmul": (per - 1) * steps if quant else 0}
        c = r["launches"]
        got = {k: c[k] for k in want}
        bad = []
        if r["ok"] != n_req or r["new_tokens"] != new * n_req:
            bad.append(f"{r['ok']}/{n_req} ok, {r['new_tokens']} tokens")
        if got != want or not r["decode_steps"]:
            bad.append(f"launches {got}, expected {want}")
        if c["mpgemm_by_route"]["cuda_core"] \
                or c["quant_matmul_by_route"]["cuda_core"]:
            bad.append(f"a bf16 GEMM took the CUDA-core route: {c}")
        if bad:
            raise AssertionError(f"{name}: " + "; ".join(bad))
        return {"k2_or_k3_per_step": per, "k5_per_prefill": n_ssm}

    def dense_engines(cfg, params, reqs, slots, max_len, audit=False,
                      prefill_chunk=None):
        """The paged, the dense and the wave engine over ``reqs``, each
        after a warm-up run: {engine: engine_row}."""
        makers = {
            "paged": lambda: ContinuousEngine(
                cfg, params, slots=slots, max_len=max_len, audit=audit,
                prefill_chunk=prefill_chunk, device=dev),
            "dense": lambda: ContinuousEngine(
                cfg, params, slots=slots, max_len=max_len, paged=False,
                device=dev),
            "wave": lambda: WaveEngine(cfg, params, slots=slots,
                                       max_len=max_len, device=dev)}
        out = {}
        for name, make in makers.items():
            make().run(requests(np.random.default_rng(99), 2, 40, 41, 2,
                                cfg.vocab))
            eng = make()
            out[name] = engine_row(eng, *counted_run(eng, reqs))
            if name == "wave":
                out[name]["prefills"] = -(-len(reqs) // slots)
        return out

    def token_agreement(a, b):
        same = sum(x == y for rid, t in a.items() for x, y in zip(t, b[rid]))
        return same, sum(len(t) for t in a.values())

    def engine_gates(tag, cfg, params, reqs, runs):
        """serve_bench's four engine gates on ``runs`` (paged, dense,
        wave): the dense engine fewer decode steps than the wave, as many
        tokens as it, the paged engine's tokens the dense engine's (at
        bf16 parted only at near-ties, ``divergences``), and paged peak KV
        below dense."""
        same, total = token_agreement(runs["paged"]["tokens"],
                                      runs["dense"]["tokens"])
        parted = divergences(cfg, params, [q.prompt for q in reqs],
                             {"paged": runs["paged"]},
                             runs["dense"]["tokens"])
        kv = {k: runs[k]["kv_bytes"]["peak"] for k in ("paged", "dense")}
        steps = {k: runs[k]["decode_steps"] for k in ("dense", "wave")}
        gates = {"dense_fewer_decode_steps_than_wave":
                 steps["dense"] < steps["wave"],
                 "wave_tokens_equal_dense":
                 runs["wave"]["new_tokens"] == runs["dense"]["new_tokens"],
                 "paged_tokens_equal_dense_but_near_ties":
                 all(d["ok"] for d in parted),
                 "paged_peak_kv_below_dense": kv["paged"] < kv["dense"]}
        print(f"{tag}: paged vs dense greedy agreement (bf16) "
              f"{same}/{total}; decode steps {steps}; peak KV {kv} B; "
              f"gates {gates}")
        return {"gates": gates, "agreement_paged_vs_dense": [same, total],
                "divergences": parted, "decode_steps": steps,
                "kv_peak_bytes": kv}

    def p_dense():
        """qwen2-0.5b at full width through the paged, dense and wave
        engines on phase 5's requests and on serve_bench's mixed trace,
        dense again int8, then mamba2-2.7b and zamba2-7b through the dense
        engine."""
        t_phase = time.perf_counter()
        cfg = dataclasses.replace(full, gemm_backend="scheduled")
        params = params_full()
        rng = np.random.default_rng(args.seed)
        reqs = requests(rng, 8, 64, 513, 32, full.vocab)   # phase 5's set
        runs = dense_engines(cfg, params, reqs, 8, 1024)
        for name, r in runs.items():
            show_engine(f"qwen2-0.5b full width, scheduled, {name}", r)
        checks = {k: dense_gates(f"qwen2 {k}", cfg, runs[k], 8, 32)
                  for k in ("dense", "wave")}
        main = engine_gates("phase 5's requests", cfg, params, reqs, runs)
        # one wave and one budget: both take budget - 1 decode steps, so
        # the first gate needs serve_bench's own trace (more requests than
        # slots, budgets of 2-31), run at its geometry
        mreqs = TRACES.mixed_trace(TRACES.MIXED_REQUESTS, TRACES.MIXED_SLOTS,
                                   full.vocab)
        mixed_runs = dense_engines(cfg, params, mreqs, TRACES.MIXED_SLOTS,
                                   TRACES.MIXED_MAX_LEN)
        for name, r in mixed_runs.items():
            show_engine(f"qwen2-0.5b full width, serve_bench's mixed trace, "
                        f"{name}", r)
        mixed = engine_gates("serve_bench's mixed trace", cfg, params,
                             mreqs, mixed_runs)
        gates = {f"{k} ({tag})": v
                 for tag, g in (("main", main), ("mixed", mixed))
                 for k, v in g["gates"].items()
                 if tag == "mixed" or not k.startswith("dense_fewer")}
        gates["paged_k1_per_decode_step"] = (
            runs["paged"]["launches"]["paged_decode"]
            == full.n_layers * runs["paged"]["decode_steps"])
        # dense again, int8 weights (the KV stripes stay bf16)
        qcfg = dataclasses.replace(full_quant, gemm_backend="scheduled")
        ContinuousEngine(qcfg, params_quant(), slots=8, max_len=1024,
                         paged=False, device=dev).run(
            requests(np.random.default_rng(99), 2, 40, 41, 2, full.vocab))
        eng = ContinuousEngine(qcfg, params_quant(), slots=8, max_len=1024,
                               paged=False, device=dev)
        rq = engine_row(eng, *counted_run(eng, reqs))
        show_engine("qwen2-0.5b int8, scheduled, dense", rq)
        checks["dense int8"] = dense_gates("qwen2 dense int8", qcfg, rq, 8,
                                           32, quant=True)
        runs["dense int8"] = rq
        # the SSM configs through the dense engine: 4 requests, 16 new
        for arch in ("mamba2_2_7b", "zamba2_7b"):
            acfg = dataclasses.replace(CONFIGS.get(arch),
                                       gemm_backend="scheduled")
            ap = params_m2() if arch == "mamba2_2_7b" else N.init(
                acfg, args.seed, dev)
            areqs = requests(np.random.default_rng(args.seed), 4, 64, 513,
                             16, acfg.vocab)
            ContinuousEngine(acfg, ap, slots=8, max_len=1024, paged=False,
                             device=dev).run(requests(
                                 np.random.default_rng(99), 2, 40, 41, 2,
                                 acfg.vocab))
            eng = ContinuousEngine(acfg, ap, slots=8, max_len=1024,
                                   paged=False, device=dev)
            ra = engine_row(eng, *counted_run(eng, areqs))
            show_engine(f"{acfg.name} full width, scheduled, dense", ra)
            checks[f"{arch} dense"] = dense_gates(f"{arch} dense", acfg, ra,
                                                  4, 16)
            runs[f"{arch} dense"] = ra
            del ap, eng
            torch.cuda.empty_cache()
        rep["dense_path"] = {"runs": runs, "mixed_runs": mixed_runs,
                             "main": main, "mixed": mixed, "gates": gates,
                             "counts": checks,
                             "seconds": time.perf_counter() - t_phase}
        if not all(gates.values()):
            raise AssertionError(f"dense_path gates failed: {gates}")

    def p_patches():
        """llava-next at full width: four rows of 1152 stub patch
        embeddings ahead of 256-512 text tokens through network.prefill
        (vision_proj on K2), 16 greedy dense decode steps, the same text
        behind zero patches, then one row past the 4096 window."""
        cfg = dataclasses.replace(CONFIGS.get("llava_next_mistral_7b"),
                                  gemm_backend="scheduled")
        params = N.init(cfg, args.seed, dev)
        P, D = cfg.frontend_prefix_len, cfg.d_model
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        rng = np.random.default_rng(args.seed)
        per = k2_per_step(cfg)

        def run(toks, patches, max_len, n_steps):
            """prefill, then ``n_steps`` greedy decode steps: (first
            logits, tokens (B, 1 + n_steps), prefill ms, decode ms a step,
            prefill launches, decode launches, all logits finite)."""
            B, T = toks.shape
            caches = N.init_caches(cfg, B, max_len, device=dev)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            logits, caches = N.prefill(
                params, cfg, {"tokens": toks, "patches": patches}, caches)
            first = logits
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pre = launch_counts()
            finite = bool(torch.isfinite(logits).all())
            reset_launches()
            tok = logits.argmax(-1)
            out = [tok]
            t2 = time.perf_counter()
            for i in range(n_steps):
                logits, caches = N.decode_step(
                    params, cfg, tok[:, None].to(torch.int32), caches,
                    torch.tensor(P + T + i, dtype=torch.int32, device=dev))
                finite = finite and bool(torch.isfinite(logits).all())
                tok = logits.argmax(-1)
                out.append(tok)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            return (first, torch.stack(out, 1), (t1 - t0) * 1e3,
                    (t3 - t2) * 1e3 / max(n_steps, 1), pre, launch_counts(),
                    finite)

        T = int(rng.integers(256, 513))
        toks = torch.from_numpy(rng.integers(3, cfg.vocab, (4, T))
                                .astype(np.int32)).to(dev)
        patches = 0.02 * torch.randn(4, P, D, generator=gen, device=dev)
        run(toks[:, :32], patches, 2048, 1)                    # warm-up
        first, out, pre_ms, dec_ms, pre, dec, finite = run(
            toks, patches, 2048, 16)
        zero, *_ = run(toks, torch.zeros_like(patches), 2048, 0)
        moved = (first - zero).abs().max().item()
        T_long = 4096 - P + 250                # 1152 + 3194 = 4346 > 4096
        toks_l = torch.from_numpy(rng.integers(3, cfg.vocab, (1, T_long))
                                  .astype(np.int32)).to(dev)
        _f, out_l, pre_l_ms, dec_l_ms, pre_l, dec_l, finite_l = run(
            toks_l, 0.02 * torch.randn(1, P, D, generator=gen, device=dev),
            4608, 16)
        res = {"rows": 4, "patch_positions": P, "text_tokens": T,
               "prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
               "prefill_launches": pre, "decode_launches": dec,
               "finite": finite, "max_abs_logit_change_zero_patches": moved,
               "tokens": out.tolist(),
               "long_row": {"text_tokens": T_long, "positions": P + T_long,
                            "window": cfg.local_window,
                            "window_bites": P + T_long > cfg.local_window,
                            "prefill_ms": pre_l_ms,
                            "decode_ms_per_step": dec_l_ms,
                            "prefill_launches": pre_l,
                            "decode_launches": dec_l, "finite": finite_l,
                            "tokens": out_l.tolist()}}
        rep["patches_path"] = res
        print(f"[{card}] llava-next full width, scheduled, bf16: 4 rows of "
              f"{P} patch positions + {T} text tokens, prefill "
              f"{pre_ms:.1f} ms, {dec_ms:.2f} ms a dense decode step (16 "
              f"steps); logits finite {finite}; zero patches move the "
              f"first logits by up to {moved:.4f}; long row {P} + {T_long} "
              f"= {P + T_long} positions (window {cfg.local_window}): "
              f"prefill {pre_l_ms:.1f} ms, {dec_l_ms:.2f} ms a step, "
              f"finite {finite_l}")
        bad = []
        for name, c, want in (("prefill", pre, per + 1),
                              ("long prefill", pre_l, per + 1),
                              ("decode", dec, per * 16),
                              ("long decode", dec_l, per * 16)):
            if c["mpgemm"] != want or c["mpgemm_by_route"]["cuda_core"] \
                    or c["paged_decode"]:
                bad.append(f"{name}: K2 {c['mpgemm']} (expected {want}, "
                           f"vision_proj one of a prefill's), routes "
                           f"{c['mpgemm_by_route']}, K1 {c['paged_decode']}")
        if not (finite and finite_l):
            bad.append("logits not finite")
        if moved == 0.0:
            bad.append("the patch prefix does not reach the logits")
        if not res["long_row"]["window_bites"]:
            bad.append("the long row stays inside the window")
        del params
        torch.cuda.empty_cache()
        if bad:
            raise AssertionError("patches_path: " + "; ".join(bad))

    def p_dense_small():
        """Scaled-down fp32 qwen2 (x4), mamba2, zamba2 and gemma2 (window
        16): the dense engine token-identical across backends, the paged
        engine equal to it, the wave serving as many tokens; llava with
        patches: prefill + decode identical across backends."""
        out = {}
        for arch in ("qwen2_0_5b", "mamba2_2_7b", "zamba2_7b", "gemma2_9b"):
            base = family_config(CONFIGS, arch)
            emb, rest = ((4.0, 4.0) if arch == "qwen2_0_5b"
                         else FAMILY_SCALES.get(arch, (1.0, 1.0)))
            params = tree_map(lambda path, a: a * (
                emb if path[0] == "embed" else rest),
                N.init(base, args.seed, dev))
            # family_small's requests
            reqs = requests(np.random.default_rng(args.seed + 1), 8, 4, 100,
                            16, base.vocab)
            toks = {}
            for b in ("xla", "scheduled"):
                cfg = dataclasses.replace(base, gemm_backend=b)
                eng = ContinuousEngine(cfg, params, slots=4, max_len=160,
                                       paged=False, device=dev)
                toks[f"dense {b}"] = engine_row(
                    eng, *counted_run(eng, reqs))["tokens"]
            cfg = dataclasses.replace(base, gemm_backend="scheduled")
            _eng, res, _, _ = serve(cfg, params, reqs, 4, 160, audit=True,
                                    prefill_chunk=32)
            toks["paged"] = {r.rid: r.tokens.tolist() for r in res}
            wave = WaveEngine(cfg, params, slots=4, max_len=160, device=dev)
            toks["wave"] = {r.rid: r.tokens.tolist() for r in wave.run(reqs)}
            ref = toks["dense scheduled"]
            r = {"backends_identical": toks["dense xla"] == ref,
                 "paged_equals_dense": toks["paged"] == ref,
                 "wave_tokens_equal_dense": sum(map(len, toks["wave"]
                                                    .values()))
                 == sum(map(len, ref.values())),
                 "distinct_per_request": [len(set(t)) for t in ref.values()],
                 # phase 6's measure: identity means something when the
                 # requests' tokens are varied, not each request's
                 "distinct": len({t for seq in ref.values() for t in seq}),
                 "requests": len(reqs), "weights_scale": [emb, rest]}
            out[arch] = r
            print(f"scaled-down fp32 {base.name} (x{emb}/x{rest}): dense "
                  f"xla == scheduled {r['backends_identical']}, paged == "
                  f"dense {r['paged_equals_dense']}, wave tokens == dense "
                  f"{r['wave_tokens_equal_dense']}; {r['distinct']} distinct "
                  f"tokens over {len(reqs)} requests (a request: "
                  f"{r['distinct_per_request']})")
        # llava with 8 stub patch positions and window 16
        base = family_config(CONFIGS, "llava_next_mistral_7b")
        params = tree_map(lambda _p, a: a * 4.0, N.init(base, args.seed, dev))
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        P = base.frontend_prefix_len
        patches = 0.02 * torch.randn(2, P, base.d_model, generator=gen,
                                     device=dev)
        text = torch.from_numpy(np.random.default_rng(args.seed).integers(
            3, base.vocab, (2, 24)).astype(np.int32)).to(dev)
        lv = {}
        for b in ("xla", "scheduled"):
            cfg = dataclasses.replace(base, gemm_backend=b)
            caches = N.init_caches(cfg, 2, 64, device=dev)
            logits, caches = N.prefill(
                params, cfg, {"tokens": text, "patches": patches}, caches)
            seq = [logits.argmax(-1)]
            for i in range(8):
                logits, caches = N.decode_step(
                    params, cfg, seq[-1][:, None].to(torch.int32), caches,
                    torch.tensor(P + 24 + i, dtype=torch.int32, device=dev))
                seq.append(logits.argmax(-1))
            lv[b] = torch.stack(seq, 1).tolist()
        out["llava_patches"] = {"identical": lv["xla"] == lv["scheduled"],
                                "tokens": lv["xla"]}
        print(f"scaled-down fp32 llava (x4, window 16, {P} patch positions "
              f"+ 24 tokens, 9 greedy tokens a row): xla == scheduled "
              f"{lv['xla'] == lv['scheduled']}")
        rep["dense_small"] = out
        bad = [a for a, r in out.items() if not all(
            v for k, v in r.items() if k in (
                "backends_identical", "paged_equals_dense",
                "wave_tokens_equal_dense", "identical"))]
        bad += [a for a, r in out.items()
                if "distinct" in r and r["distinct"] < 4 * r["requests"]]
        if bad:
            raise AssertionError(f"dense_scaled_down_fp32 failed: {bad}")

    # -- the async API, the lifecycle tracer and the resilience plane ---------
    def drill_requests(vocab):
        """Phase 5's requests (rids 0-7) and a ninth, rid 8, to be shed."""
        reqs = requests(np.random.default_rng(args.seed), 8, 64, 513, 32,
                        vocab)
        return reqs, dataclasses.replace(reqs[0], rid=8)

    def per_step(counts, eng):
        """K1 launches a decode step and K2 launches a step (decode and
        chunk steps both run every projection and the head)."""
        return [counts["paged_decode"] / max(eng.steps, 1),
                counts["mpgemm"] / max(eng.steps + eng.chunk_steps, 1)]

    def decode_walls(cfg, params, telemetry, n=16):
        """Host walls of ``n`` decode steps with all 8 slots decoding (64-
        token prompts: two chunk steps, then decode only); each step ends
        in its token readback."""
        eng = ContinuousEngine(cfg, params, slots=8, max_len=1024,
                               device=dev, telemetry=telemetry)
        for r in requests(np.random.default_rng(7), 8, 64, 65, n + 4,
                          cfg.vocab):
            eng.submit(r)
        eng.step()
        eng.step()
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            eng.step()
            walls.append(time.perf_counter() - t0)
        return walls

    def parted(cfg, params, reqs, got, base, exact):
        """Requests whose tokens part from ``base`` over their common
        length: any at all in fp32 (``exact``), else those ``divergences``
        does not rate a near-tie."""
        if exact:
            return [rid for rid, t in got.items()
                    if t != base[rid][:len(t)]]
        prompts = {r.rid: r.prompt for r in reqs}
        return [d["rid"] for d in divergences(
            cfg, params, prompts, {"drill": {"tokens": got}}, base)
            if not d["ok"]]

    def resilience_drill(cfg, params, exact):
        """Phase 5's requests through ``start()`` / ``submit()`` /
        ``get_result()`` under ``Telemetry.on()`` and a fixed fault
        schedule, beside a fault-free synchronous run of the same engine
        (see p_resilience)."""
        reqs, extra = drill_requests(cfg.vocab)
        by_len = sorted(reqs, key=lambda r: len(r.prompt))
        # the longest request is left alone: its decode tail is the
        # trace's last stretch, where the dispatch fault lands
        rid_deadline, rid_poison, rid_cancel = (r.rid for r in by_len[:3])
        eng0, res0, _, cnt0 = serve(cfg, params, reqs, 8, 1024, audit=True,
                                    telemetry=Telemetry.on())
        base = {r.rid: r.tokens.tolist() for r in res0}
        k_base = per_step(cnt0, eng0)
        ev0 = list(eng0.obs.tracer.events)
        last_chunk = max(e.step for e in ev0 if e.etype == "chunk_batch")
        last = max(e.step for e in ev0 if e.etype == "decode")
        decode_at = (last_chunk + last) // 2
        deadline = 0.5 * next(r.latency_s for r in res0
                              if r.rid == rid_deadline)
        plane = FaultPlane([FaultSpec("reserve", at=1),
                            FaultSpec("dispatch", at=decode_at),
                            FaultSpec("poison", rid=rid_poison)])
        eng = ContinuousEngine(cfg, params, slots=8, max_len=1024,
                               audit=True, device=dev,
                               telemetry=Telemetry.on(), faults=plane,
                               resilience=ResilienceConfig(max_pending=8))
        eng.schedule.reset()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(dataclasses.replace(
                r, deadline_s=deadline if r.rid == rid_deadline else None))
        eng.submit(extra)               # the queue is at its bound: shed
        eng.start()
        while not any(s is not None and s.req.rid == rid_cancel
                      for s in list(eng._slots)):
            if time.perf_counter() - t0 > 120:
                raise AssertionError("the cancel target never ran")
            time.sleep(0.002)
        cancelled = eng.cancel(rid_cancel)
        res = [eng.get_result(timeout=600) for _ in range(len(reqs) + 1)]
        eng.stop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cnt = launch_counts()
        eng.pool.check()
        trace = eng.obs.tracer.chrome_trace()
        kinds = {}
        for e in eng.obs.tracer.events:
            kinds[e.etype] = kinds.get(e.etype, 0) + 1
        queue_ends = sum(1 for e in eng.obs.tracer.events
                         if e.etype in ("timeout", "cancel") and e.slot < 0)
        v = eng.metrics.value
        got = {r.rid: r.tokens.tolist() for r in res}
        status = {r.rid: (r.status, r.error) for r in res}
        want = {rid: ("ok", None) for rid in base}
        want.update({8: ("shed", "pending queue at bound 8"),
                     rid_poison: ("failed", "injected:poison"),
                     rid_deadline: ("timeout", "deadline_s exceeded"),
                     rid_cancel: ("cancelled", None)})
        k_run = per_step(cnt, eng)
        fired = {f["kind"]: f for f in plane.fired}
        out = {
            "rids": {"deadline": rid_deadline, "poison": rid_poison,
                     "cancel": rid_cancel, "shed": 8},
            "deadline_s": deadline, "decode_at": decode_at,
            "status": {str(k): list(s) for k, s in status.items()},
            "statuses_ok": status == want and cancelled,
            "one_result_each": sorted(got) == list(range(9)),
            "tokens": {str(k): t for k, t in got.items()},
            "parted": parted(cfg, params, reqs, {
                rid: t for rid, t in got.items() if rid in base}, base,
                exact),
            "wall_s": wall, "fired": plane.fired,
            "dispatch_fault_on_decode":
                fired.get("dispatch", {}).get("dispatch") == "decode",
            "counters": {k: v(k) for k in (
                "resilience.faults_injected", "resilience.retries",
                "resilience.quarantined", "resilience.admit_failures",
                "resilience.shed", "resilience.cancelled",
                "resilience.timeouts", "engine.steps", "engine.chunk_steps",
                "engine.admissions", "engine.preemptions",
                "engine.requests_finished")},
            "trace_errors": validate_chrome_trace(json.loads(
                json.dumps(trace))),
            "trace_events": len(eng.obs.tracer),
            "trace_counts_match": (
                kinds.get("admit", 0) + kinds.get("resume", 0)
                == v("engine.admissions")
                and kinds.get("preempt", 0) == v("engine.preemptions")
                and kinds.get("finish", 0) + kinds.get("shed", 0)
                + queue_ends == v("engine.requests_finished")),
            "launches_per_step": k_run, "baseline_per_step": k_base,
            "launches_match": (
                k_run == k_base and k_base[0].is_integer()
                and k_base[1].is_integer() and cnt["paged_decode"] > 0
                and cnt["mpgemm"] > 0),
            "launches": {k: cnt[k] for k in ("paged_decode", "mpgemm")},
            "schedule_misses": eng.schedule.stats()["misses"]}
        out["counts_ok"] = (
            out["counters"]["resilience.faults_injected"] == 3
            and out["counters"]["resilience.retries"] == 1
            and out["counters"]["resilience.quarantined"] == 1
            and out["counters"]["resilience.admit_failures"] == 1
            and out["counters"]["resilience.shed"] == 1
            and out["counters"]["resilience.cancelled"] == 1
            and out["counters"]["resilience.timeouts"] == 1)
        return out, base, reqs, eng0

    def restart_drill(cfg, params, base, reqs, eng0, exact):
        """``serve_with_restarts`` through a crash in mid-trace, the dead
        pool's snapshot round trip, and a kernel launch failure leaving
        ``step()``."""
        crash_at = (eng0.steps + eng0.chunk_steps) // 2
        plane = FaultPlane([FaultSpec("crash", at=crash_at)])
        engines = []

        def make_engine():
            engines.append(ContinuousEngine(cfg, params, slots=8,
                                            max_len=1024, audit=True,
                                            device=dev, faults=plane))
            return engines[-1]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = serve_with_restarts(make_engine, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        engines[-1].pool.check()
        dead = engines[0].pool.snapshot_state()
        got = {r.rid: r.tokens.tolist() for r in res}
        out = {"crash_at": crash_at, "engines": len(engines),
               "wall_s": wall,
               "one_result_each": sorted(got) == sorted(base),
               "all_ok": all(r.status == "ok" for r in res),
               "parted": parted(cfg, params, reqs, got, base, exact),
               "restored": engines[-1].metrics.value("resilience.restored"),
               "pool_round_trip":
                   KVPool.from_snapshot(dead).snapshot_state() == dead,
               "dead_pool_used": sum(dead["n_slot_blocks"])}
        # a kernel launch failure (the kernels' own exception class) leaves
        # step(): never retried, never a failed Result
        eng = ContinuousEngine(cfg, params, slots=8, max_len=1024,
                               device=dev)
        eng.submit(reqs[0])
        orig, raised = _build.check_launch, None

        def refuse(rc, what):
            raise _build.KernelError(f"{what}: injected launch failure")

        _build.check_launch = refuse
        try:
            for _ in range(8):
                eng.step()
        except _build.KernelError as e:
            raised = e
        finally:
            _build.check_launch = orig
        torch.cuda.synchronize()
        out["kernel_error_propagated"] = (
            raised is not None and not eng.drain_results()
            and eng.metrics.value("resilience.retries") == 0
            and eng.metrics.value("resilience.quarantined") == 0)
        out["kernel_error"] = str(raised)
        return out

    def drill_failures(d):
        bad = [k for k in ("statuses_ok", "one_result_each",
                           "dispatch_fault_on_decode", "trace_counts_match",
                           "launches_match", "counts_ok") if not d[k]]
        bad += ["trace_errors"] if d["trace_errors"] else []
        bad += ["parted beyond near-ties"] if d["parted"] else []
        return bad

    def restart_failures(r):
        bad = [k for k in ("one_result_each", "all_ok", "pool_round_trip",
                           "kernel_error_propagated") if not r[k]]
        bad += ["parted beyond near-ties"] if r["parted"] else []
        bad += ["no restart"] if r["engines"] != 2 else []
        return bad

    def show_drill(tag, d):
        c = d["counters"]
        print(f"[{card}] {tag}: async run {d['wall_s']:.2f} s, "
              f"{c['engine.steps']:.0f} decode + {c['engine.chunk_steps']:.0f}"
              f" chunk steps; statuses {d['status']}; faults injected "
              f"{c['resilience.faults_injected']:.0f} (dispatch at step "
              f"{d['decode_at']} on the decode kind "
              f"{d['dispatch_fault_on_decode']}), retries "
              f"{c['resilience.retries']:.0f}, quarantined "
              f"{c['resilience.quarantined']:.0f}, admit failures "
              f"{c['resilience.admit_failures']:.0f}, shed "
              f"{c['resilience.shed']:.0f}, cancelled "
              f"{c['resilience.cancelled']:.0f}, timeouts "
              f"{c['resilience.timeouts']:.0f}; K1 / K2 a step "
              f"{d['launches_per_step']} (sync run "
              f"{d['baseline_per_step']}); trace {d['trace_events']} events,"
              f" valid {not d['trace_errors']}, counts = registry "
              f"{d['trace_counts_match']}; parted from the fault-free run "
              f"{d['parted']}")

    def show_restart(tag, r):
        print(f"[{card}] {tag}: crash at step {r['crash_at']}, "
              f"{r['engines']} engines, {r['restored']:.0f} entries "
              f"restored, {r['wall_s']:.2f} s; all ok {r['all_ok']}, parted "
              f"{r['parted']}; dead pool ({r['dead_pool_used']} blocks "
              f"mapped) round trip {r['pool_round_trip']}; kernel launch "
              f"failure propagated {r['kernel_error_propagated']}")

    drills: dict = {}

    def p_resilience():
        """Full-width qwen2-0.5b (bf16, scheduled, 8 slots, max_len 1024)
        on phase 5's requests and a ninth: the fault-free synchronous run
        (tracer on), then the same engine through start() / submit() /
        get_result() with a reserve denial, a transient fault on a decode
        step, a poisoned request, a deadline half the fault-free latency
        of one request, a cancel of a running one and max_pending 8 (the
        ninth is shed); the tracer's cost on a decode step."""
        cfg = dataclasses.replace(full, gemm_backend="scheduled")
        params = params_full()
        d, base, reqs, eng0 = resilience_drill(cfg, params, exact=False)
        drills["full"] = (base, reqs, eng0)
        walls = {"off": [], "on": []}
        for mode in ("off", "on", "off", "on"):
            walls[mode] += decode_walls(cfg, params, Telemetry.on()
                                        if mode == "on" else None)
        med = {k: float(np.median(w)) * 1e3 for k, w in walls.items()}
        d["decode_step_wall_ms"] = med
        d["tracer_cost"] = med["on"] / med["off"] - 1
        rep["resilience"] = d
        show_drill("resilience_path", d)
        print(f"[{card}] decode step wall (8 slots decoding, median of 32):"
              f" Telemetry.off() {med['off']:.2f} ms, Telemetry.on() "
              f"{med['on']:.2f} ms ({100 * d['tracer_cost']:+.1f}%)")
        bad = drill_failures(d)
        if bad:
            raise AssertionError(f"resilience_path failed: {bad}")

    def p_restart():
        """``serve_with_restarts`` at full width through a crash in
        mid-trace, on resilience_path's requests."""
        cfg = dataclasses.replace(full, gemm_backend="scheduled")
        params = params_full()
        if "full" not in drills:            # resilience_path did not run
            reqs = drill_requests(cfg.vocab)[0]
            eng0, res0, _, _ = serve(cfg, params, reqs, 8, 1024, audit=True)
            drills["full"] = ({r.rid: r.tokens.tolist() for r in res0},
                              reqs, eng0)
        base, reqs, eng0 = drills["full"]
        r = restart_drill(cfg, params, base, reqs, eng0, exact=False)
        rep["restart"] = r
        show_restart("restart_path", r)
        bad = restart_failures(r)
        if bad:
            raise AssertionError(f"restart_path failed: {bad}")

    def p_resilience_small():
        """Both drills on scaled-down fp32 qwen2 (x4): the ok tokens equal
        the fault-free run's exactly, a cut request's are a prefix."""
        cfg, params, _ = small_fp32()
        d, base, reqs, eng0 = resilience_drill(cfg, params, exact=True)
        r = restart_drill(cfg, params, base, reqs, eng0, exact=True)
        rep["resilience_small"] = {"drill": d, "restart": r}
        show_drill("resilience_scaled_down_fp32", d)
        show_restart("resilience_scaled_down_fp32", r)
        bad = drill_failures(d) + restart_failures(r)
        if bad:
            raise AssertionError(f"resilience_scaled_down_fp32 failed: {bad}")

    def report_clis(trace, geom):
        """``python -m repro_torch.launch.trace_report <trace> --validate``
        and ``plan_report drift`` on ``trace``, run side by side: (return
        codes, last lines of their output)."""
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cmds = {"trace_report": ["-m", "repro_torch.launch.trace_report",
                                 trace, "--validate"],
                "plan_report": ["-m", "repro_torch.launch.plan_report",
                                "drift", trace, *geom]}
        procs = {k: subprocess.Popen([sys.executable, *c], cwd=ROOT,
                                     env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                 for k, c in cmds.items()}
        out = {}
        for k, proc in procs.items():
            text, _ = proc.communicate(timeout=300)
            out[k] = (proc.returncode, text.strip().splitlines()[-4:])
        return out

    def p_serve_cli():
        """``launch/serve.py`` at full width (scheduled) with
        ``--trace-out``, ``--metrics-out`` and ``--profile`` into a
        temporary directory: the continuous engine through its async API,
        the trace valid, the Prometheus text written, K1 and K2 launched;
        then the two report CLIs on the trace."""
        with tempfile.TemporaryDirectory() as tmp:
            trace, prom = f"{tmp}/trace.json", f"{tmp}/metrics.prom"
            torch.cuda.synchronize()
            reset_launches()
            r = SERVE.main(["--arch", "qwen2_0_5b", "--gemm-backend",
                            "scheduled", "--requests", "8", "--slots", "4",
                            "--trace-out", trace, "--metrics-out", prom,
                            "--profile", "--seed", str(args.seed)])
            torch.cuda.synchronize()
            cnt = launch_counts()
            with open(trace) as f:
                errs = validate_chrome_trace(json.load(f))
            with open(prom) as f:
                text = f.read()
            t0 = time.perf_counter()
            clis = report_clis(trace, ["--arch", "qwen2_0_5b", "--slots",
                                       "4", "--max-len", "256",
                                       "--precision", "BP16"])
            reports_s = time.perf_counter() - t0
            added("serve_cli_path", t0, "profile")
            # the engine's construction (the profiler's step_cost count
            # and calibration inside it) counts to this slice too
            added_s["profile"]["serve_cli_path"] += r["build_s"]
        out = {"ok": r["ok"], "requests": r["requests"],
               "tok_per_s": r["tok_per_s"], "trace_errors": errs,
               "prometheus_lines": len(text.splitlines()),
               "profile_spans": r.get("profile_spans", 0),
               "report_clis": clis, "engine_build_s": r["build_s"],
               "reports_s": reports_s,
               "launches": {k: cnt[k] for k in ("paged_decode", "mpgemm")}}
        rep["serve_cli"] = out
        print(f"[{card}] launch/serve.py --trace-out --metrics-out "
              f"--profile: {out['ok']}/{out['requests']} ok, "
              f"{r['tok_per_s']:.1f} tok/s, trace valid {not errs}, "
              f"{out['prometheus_lines']} Prometheus lines, "
              f"{out['profile_spans']} dispatch spans, launches "
              f"{out['launches']}; engine construction (with the "
              f"profiler's attach) {r['build_s']:.2f} s, the two report "
              f"CLIs {reports_s:.2f} s")
        for k, (rc, tail) in clis.items():
            print(f"  python -m repro_torch.launch.{k}: rc {rc}; "
                  + " | ".join(tail))
        if (errs or out["ok"] != 8 or "engine_steps" not in text
                or not cnt["paged_decode"] or not cnt["mpgemm"]
                or not out["profile_spans"]
                or any(rc for rc, _ in clis.values())):
            raise AssertionError(f"serve_cli_path failed: {out}")

    # -- the dispatch profiler and the planner -------------------------------
    def engine_state(eng):
        """Everything a profiler attach must leave as it was: every cache
        leaf, the block table, cursors, pool, sampler and the schedule
        statistics (hits, misses, per key, the applied log)."""
        torch.cuda.synchronize()
        leaves = []
        tree_map(lambda _p, a: leaves.append(a.clone()), eng.caches)
        st = eng.schedule.stats()
        return {"caches": leaves, "bt": eng._bt.clone(),
                "pos": eng._pos.tolist(), "pool": eng.pool.snapshot_state(),
                "generator": eng.generator.get_state(),
                "schedule": (st["hits"], st["misses"], st["applied"],
                             eng.schedule.key_stats()),
                "counters": (eng.steps, eng.chunk_steps)}

    def attach_unchanged(eng):
        """Attach a profiler to ``eng`` and report which of its states
        moved (an empty list: bit-identical)."""
        before = engine_state(eng)
        prof = DispatchProfiler(reps=1)
        eng.obs.profiler = prof
        prof.attach(eng)
        after = engine_state(eng)
        moved = [i for i, (a, b) in enumerate(zip(before["caches"],
                                                  after["caches"]))
                 if not torch.equal(a, b)]
        moved = [f"cache leaf {i}" for i in moved]
        for k in ("bt", "generator"):
            if not torch.equal(before[k], after[k]):
                moved.append(k)
        moved += [k for k in ("pos", "pool", "schedule", "counters")
                  if before[k] != after[k]]
        return moved, prof

    def p_profile_path():
        cfg = dataclasses.replace(full, gemm_backend="scheduled")
        params = params_full()
        reqs = requests(np.random.default_rng(args.seed), 8, 64, 513, 32,
                        full.vocab)                     # phase 5's set
        k2_step = 7 * full.n_layers + 1
        # the unprofiled engine just before the profiled one: host walls
        # drift over a run, so the two are compared back to back
        eng0, res0, wall0, cnt0 = serve(cfg, params, reqs, 8, 1024,
                                        audit=False)
        tok0 = {r.rid: r.tokens.tolist() for r in res0}
        # a profiler attached to it after its run (pool, cursors and the
        # schedule statistics written): nothing may move
        moved, _ = attach_unchanged(eng0)
        t0 = time.perf_counter()
        eng = ContinuousEngine(cfg, params, slots=8, max_len=1024,
                               device=dev,
                               telemetry=Telemetry.on(profile=True))
        attach_s = time.perf_counter() - t0
        res, wall, cnt = counted_run(eng, reqs)
        tok = {r.rid: r.tokens.tolist() for r in res}
        prof = eng.obs.profiler
        events = eng.obs.tracer.chrome_trace()["traceEvents"]
        trace_errs = validate_chrome_trace({"traceEvents": events})
        cal = calibration_from_events(events, meta={
            "source": "chip_smoke profile_path", "card": card})
        groups = dispatch_spans(events)
        specs = requests_from_trace(events)
        meas = measured_latencies(events)
        geom = EngineGeometry.from_engine(eng)
        st0 = eng.schedule.stats()
        keys0 = eng.schedule.key_stats()
        model = WorkloadModel(cfg, geom, schedule=eng.schedule)
        plan = model.simulate(specs, calibration=cal)
        st1 = eng.schedule.stats()
        keys1 = eng.schedule.key_stats()
        ttft = [meas[s.rid]["ttft_us"] for s in specs]
        tpot = [meas[s.rid]["tpot_us"] for s in specs
                if meas[s.rid]["tpot_us"]]
        p95, tpot_m = float(np.percentile(ttft, 95)), float(np.mean(tpot))
        drift = {"bound": 0.30,
                 "ttft_p95_modeled_us": plan.p95_ttft_us(),
                 "ttft_p95_measured_us": p95,
                 "ttft_p95_drift": plan.p95_ttft_us() / p95 - 1.0,
                 "tpot_modeled_us": plan.mean_tpot_us(),
                 "tpot_measured_us": tpot_m,
                 "tpot_drift": plan.mean_tpot_us() / tpot_m - 1.0}
        drift["ttft_p95_within"] = abs(drift["ttft_p95_drift"]) <= 0.30
        drift["tpot_within"] = abs(drift["tpot_drift"]) <= 0.30
        rows = {}
        for r in drift_rows(events):
            d = groups[r["name"]]
            rows[r["name"]] = {
                "serve_mean_us": (float(np.mean(d["serve"]))
                                  if d["serve"] else None),
                "n_serve": len(d["serve"]),
                "calibration_mean_us": r["cal_us"], "n_cal": r["n_cal"],
                "modeled_cycles": r["cycles"], "flops": r["flops"],
                "bytes": r["bytes"]}
            print(f"[{card}] profile_path {r['name']}: calibration "
                  f"{r['cal_us']:.1f} us (x{r['n_cal']}), serve "
                  + (f"{rows[r['name']]['serve_mean_us']:.1f} us "
                     f"(x{len(d['serve'])})" if d["serve"] else "none")
                  + f", modeled {r['cycles']:.0f} cycles, "
                  f"{r['flops']:.4g} flops, {r['bytes']:.4g} bytes")
        out = {"tokens_equal": tok == tok0, "moved_by_attach": moved,
               "attach_s": attach_s, "wall_s": wall,
               "unprofiled_wall_s": wall0,
               "launches": {k: cnt[k] for k in ("paged_decode", "mpgemm")},
               "per_step": per_step(cnt, eng),
               "steps": [eng.steps, eng.chunk_steps],
               "plan_steps": [plan.steps, plan.chunk_steps],
               "schedule_moved_by_planning": (
                   (st0["hits"], st0["misses"], keys0)
                   != (st1["hits"], st1["misses"], keys1)),
               "calibration": cal.to_json(), "drift": drift,
               "dispatches": rows, "trace_errors": trace_errs,
               "spans": len(prof.spans)}
        rep["profile_path"] = out
        print(f"[{card}] profile_path: profiled {wall:.2f} s wall against "
              f"unprofiled {wall0:.2f} s ({100 * (wall / wall0 - 1):+.1f}%),"
              f" attach (step_cost and calibration) {attach_s:.2f} s; "
              f"ns_per_cycle {cal.ns_per_cycle:.6g}, host_us_per_dispatch "
              f"{cal.host_us_per_dispatch:.6g}, startup_us "
              f"{cal.startup_us:.6g}; steps {out['steps']} planned "
              f"{out['plan_steps']}; K1 {out['per_step'][0]:.6g} a decode "
              f"step, K2 {out['per_step'][1]:.6g} a step")
        print(f"[{card}] profile_path planner drift (reported, not gated; "
              f"bound +-30%): TTFT p95 modeled "
              f"{drift['ttft_p95_modeled_us']:.1f} us, measured "
              f"{p95:.1f} us ({100 * drift['ttft_p95_drift']:+.2f}%); TPOT "
              f"modeled {drift['tpot_modeled_us']:.1f} us, measured "
              f"{tpot_m:.1f} us ({100 * drift['tpot_drift']:+.2f}%)")
        cal_names = {s["name"] for s in prof.spans
                     if s["kind"] == "calibration"}
        checks = {
            "tokens identical": out["tokens_equal"],
            "all 8 ok": sum(r.status == "ok" for r in res) == 8,
            "calibration spans of all four dispatches":
                cal_names == set(DISPATCH_NAMES),
            "serve spans": all(groups[n]["serve"] for n in
                               ("decode_step", "prefill_paged_chunk")),
            "K1 24 a decode step": cnt["paged_decode"]
                == full.n_layers * eng.steps,
            "K2 169 a step": cnt["mpgemm"]
                == k2_step * (eng.steps + eng.chunk_steps),
            "unprofiled run's launches alike": cnt0["paged_decode"]
                == full.n_layers * eng0.steps and cnt0["mpgemm"]
                == k2_step * (eng0.steps + eng0.chunk_steps),
            "caches bit-identical across attach": not moved,
            "calibration fitted": set(cal.cycles) == set(DISPATCH_NAMES),
            "replay steps": plan.steps == eng.steps,
            "replay chunk steps": plan.chunk_steps == eng.chunk_steps,
            "planning moved no schedule statistic":
                not out["schedule_moved_by_planning"],
            "trace valid": not trace_errs}
        out["checks"] = checks
        print(f"profile_path checks: {checks}")
        bad = [k for k, v in checks.items() if not v]
        if bad:
            raise AssertionError(f"profile_path checks failed: {bad}; "
                                 f"moved {moved}")

    def p_profile_small():
        scfg, sparams, _ = small_fp32()
        mcfg = CONFIGS.get("mamba2_2_7b").scaled_down()
        models = {"qwen2 x4": (scfg, sparams),
                  "mamba2": (mcfg, N.init(mcfg, args.seed, dev))}
        out, bad = {}, []
        for name, (cfg, params) in models.items():
            reqs = requests(np.random.default_rng(3), 4, 20, 60, 12,
                            cfg.vocab)
            base = {r.rid: r.tokens.tolist() for r in ContinuousEngine(
                cfg, params, slots=4, max_len=128, device=dev).run(reqs)}
            eng = ContinuousEngine(cfg, params, slots=4, max_len=128,
                                   device=dev,
                                   telemetry=Telemetry.on(profile=True))
            prof_tok = {r.rid: r.tokens.tolist() for r in eng.run(reqs)}
            # attach mid-flight: prefill done, decode under way
            eng = ContinuousEngine(cfg, params, slots=4, max_len=128,
                                   device=dev, telemetry=Telemetry.on())
            for r in reqs:
                eng.submit(r)
            for _ in range(4):
                eng.step()
            moved, prof = attach_unchanged(eng)
            mid = {}
            while len(mid) < len(reqs):
                eng.step()
                mid.update({r.rid: r.tokens.tolist()
                            for r in eng.drain_results()})
            r = {"profiled_tokens_equal": prof_tok == base,
                 "mid_flight_tokens_equal": mid == base,
                 "moved_by_attach": moved,
                 "distinct_tokens": len({t for v in base.values()
                                         for t in v}),
                 "calibration_spans": sum(s["kind"] == "calibration"
                                          for s in prof.spans)}
            out[name] = r
            print(f"[{card}] profile_scaled_down_fp32 {name}: {r}")
            if (not r["profiled_tokens_equal"]
                    or not r["mid_flight_tokens_equal"] or moved
                    or r["distinct_tokens"] < 4):
                bad.append(name)
        rep["profile_small"] = out
        if bad:
            raise AssertionError(f"profile_scaled_down_fp32 failed: {bad}")

    # -- 7. timing -----------------------------------------------------------
    timing: dict = {}

    def k2_timing(shapes, sched, flush):
        """K2 at each bf16 (M, N, K) under its scheduled dataflow, beside
        its plain version, torch.matmul and its bound (the head's (V, D)
        table as a transposed view, fp32 out)."""
        rows = []
        for M, N_, K_ in shapes:
            a, b = gemm_inputs(M, N_, K_, torch.bfloat16, 7)
            out_dtype = torch.float32 if N_ in HEADS else torch.bfloat16
            choice = sched.resolve(M, N_, K_, "BP16")
            df = choice.dataflow
            bm, bn, bk = OPS.plan_blocks(M, N_, K_, 2, df, choice.k_fold)
            ef = MP.effective_fold(K_, bk, choice.k_fold)
            iters = 20 if N_ in HEADS or M >= 2048 else 100
            kern = time_ms(lambda: MP.mpgemm(a, b, dataflow=df, bm=bm, bn=bn,
                                             bk=bk, k_fold=ef,
                                             out_dtype=out_dtype),
                           iters, flush)
            plain = time_ms(lambda: MP.mpgemm_plain(a, b, bk=bk, k_fold=ef,
                                                    out_dtype=out_dtype),
                            max(5, iters // 4), flush)
            lib = time_ms(lambda: torch.matmul(a, b), iters, flush)
            nbytes = 2 * (M * K_ + K_ * N_) \
                + M * N_ * (4 if out_dtype == torch.float32 else 2)
            b_ms, b_by = bound_ms(nbytes, 2 * M * N_ * K_, "bfloat16")
            rows.append({"M": M, "N": N_, "K": K_, "dataflow": df.value,
                         "k_fold": ef, "blocks": [bm, bn, bk],
                         "route": MP.mpgemm_route(a, b, bk),
                         "ms": kern, "plain_ms": plain, "library_ms": lib,
                         "bound_ms": b_ms, "bound_by": b_by})
            del a, b
            print(f"K2 bf16 ({M}, {N_}, {K_}) {df.value} f={ef} tile "
                  f"{bm}x{bn}x{bk} ({rows[-1]['route']}): kernel "
                  f"{kern*1e3:.1f} us, plain {plain*1e3:.1f} us, "
                  f"torch.matmul {lib*1e3:.1f} us, bound {b_ms*1e3:.2f} us "
                  f"({b_by})")
        return rows

    def k1_timing(B, KV, G, hd, T, quant, flush, nbs=64, window=None,
                  logit_cap=None, plain_iters=50):
        """K1 (or K1-int8) at one head geometry, B rows of T tokens in an
        nbs-entry table of 16-position blocks: kernel, plain version,
        bound over the positions the window keeps, and SDPA over the kept,
        gathered, head-expanded KV: the library call, or context where no
        PyTorch call computes the same function (int8 KV with scales: SDPA
        over the dequantized KV; a softcap: SDPA without it)."""
        bs = 16
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q, k, v, table, lens = decode_inputs(torch.bfloat16, [T] * B, B=B,
                                             KV=KV, G=G, hd=hd, nbs=nbs,
                                             seed=T + hd)
        kw = dict(scale=hd ** -0.5)
        if window is not None:
            kw["window"] = window
        if logit_cap is not None:
            kw["logit_cap"] = logit_cap
        kept = T if window is None else min(T, window)
        kd, vd = k, v
        if quant:
            k, v, kw["k_scale"], kw["v_scale"] = int8_kv(k.shape, 3)
            kd, vd = ((x.float() * s_[..., None]).to(torch.bfloat16)
                      for x, s_ in ((k, kw["k_scale"]), (v, kw["v_scale"])))
        kg, vg = (PA.gather_pool_blocks(x, table)[:, T - kept:T]
                  .permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
                  .contiguous() for x in (kd, vd))
        kv_bytes = 2 * B * kept * KV * ((hd + 4) if quant else hd * 2)
        nbytes = 2 * 2 * q.numel() + kv_bytes + 4 * (table.numel() + B)
        b_ms, b_by = bound_ms(nbytes, 4 * B * KV * G * kept * hd, "bfloat16")
        sdpa_ms = time_ms(lambda: sdpa(q.reshape(B, KV * G, 1, hd), kg, vg,
                                       scale=hd ** -0.5), 200, flush)
        context = None
        if quant:
            context = "SDPA over the dequantized KV"
        elif logit_cap is not None:
            context = ("SDPA (no softcap) over the kept, gathered, "
                       "head-expanded KV")
        row = {"B": B, "KV": KV, "G": G, "hd": hd, "tokens": T,
               "kept": kept, "window": window, "softcap": logit_cap,
               "int8_kv": quant, "split_plan": PA.split_plan(B, KV, nbs, bs),
               "ms": time_ms(lambda: PA.paged_decode(q, k, v, table, lens,
                                                     **kw), 200, flush),
               "plain_ms": time_ms(lambda: PA.gather_fallback(
                   q, k, v, table, lens, **kw), plain_iters, flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None if context else sdpa_ms,
               "context_ms": sdpa_ms if context else None,
               "context": context}
        del q, k, v, kd, vd, kg, vg
        win = "" if window is None else f" (window {window} keeps {kept})"
        cap = "" if logit_cap is None else f" softcap {logit_cap}"
        print(f"[{card}] K1{'-int8' if quant else ''} B={B} KV={KV} G={G} "
              f"hd={hd} len={T}{win}{cap} (split_plan {row['split_plan']}): "
              f"kernel {row['ms']*1e3:.1f} us, plain "
              f"{row['plain_ms']*1e3:.1f} us, SDPA"
              f"{' (context)' if context else ''} {sdpa_ms*1e3:.1f} us, "
              f"bound {b_ms*1e3:.2f} us ({b_by})")
        return row

    def moe_timing(sched, flush):
        """This slice's rows: K1 at llama4-scout's heads and K1-int8 at
        zamba2's shared attention (512 tokens); K2 at llama4's router and
        shared expert; K3 at mamba2's and zamba2's int8 in_proj and
        out_proj; one of the routed experts' three bmm of a layer at
        decode (C 8) and chunk (C 160) capacity, as context."""
        timing["paged_decode_moe"] = [
            k1_timing(8, 8, 5, 128, 512, False, flush),
            k1_timing(8, 32, 1, 112, 512, True, flush)]
        timing["mpgemm_moe_shapes"] = k2_timing(
            [(M, N_, K_) for M in (8, 2048)
             for N_, K_ in ((16, 5120), (8192, 5120), (5120, 8192))],
            sched, flush)
        # 2048 rows: few iterations (_weight_int8pack_mm takes 60-240 ms
        # a call there)
        rows = QT.measure([(8, N_, K_) for N_, K_ in ssm_quant_nk], dev,
                          flush)
        rows += QT.measure([(2048, N_, K_) for N_, K_ in ssm_quant_nk], dev,
                           flush, iters=5)
        for r in rows:
            print(f"[{card}] " + QT.describe(r))
        timing["quant_matmul_ssm_shapes"] = rows
        E, D, F = 16, 5120, 8192
        gen = torch.Generator(device=dev).manual_seed(9)
        w = (0.02 * torch.randn(E, D, F, generator=gen, device=dev)
             ).to(torch.bfloat16)
        bmm_rows = []
        for C in (8, 160):
            x = (torch.randn(E, C, D, generator=gen, device=dev) / D ** 0.5
                 ).to(torch.bfloat16)
            ms = time_ms(lambda: torch.bmm(x, w), 20, flush)
            b_ms, b_by = bound_ms(2 * (x.numel() + w.numel() + E * C * F),
                                  2 * E * C * D * F, "bfloat16")
            bmm_rows.append({"E": E, "C": C, "D": D, "F": F, "ms": ms,
                             "bound_ms": b_ms, "bound_by": b_by})
            print(f"[{card}] routed experts' gate bmm (E {E}, C {C}, D {D}, "
                  f"F {F}) bf16 (context; torch.bmm): {ms*1e3:.1f} us, "
                  f"bound {b_ms*1e3:.1f} us ({b_by})")
            del x
        del w
        timing["moe_experts_bmm"] = bmm_rows

    #: deepseek-v2's GEMMs timed (tests/test_torch_kernels_gpu.py holds the
    #: same shapes): wq_a, wq_b, wkv_a, wo at decode rows, a decompression
    #: (wk_b / wv_b over 2048 gathered rows), the shared experts' gate and
    #: the first block's MLP gate
    MLA_TIMED = [(8, 1536, 5120), (8, 24576, 1536), (8, 576, 5120),
                 (8, 5120, 16384), (2048, 16384, 512), (8, 3072, 5120),
                 (8, 12288, 5120)]

    def mla_timing(sched, flush):
        """This slice's rows: K2 at ``MLA_TIMED`` (bf16) and K3 at those
        of them whose weight is int8 under --quant (wq_b, wo, the
        decompression, the shared expert, the first block's MLP)."""
        timing["mpgemm_mla_shapes"] = k2_timing(MLA_TIMED, sched, flush)
        int8 = [s_ for s_ in MLA_TIMED if s_[1:] in mla_int8_nk]
        rows = QT.measure(int8, dev, flush, iters=50)
        for r in rows:
            print(f"[{card}] " + QT.describe(r))
        timing["quant_matmul_mla_shapes"] = rows

    def p_timing():
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        # K1 and K1-int8: one layer's decode at B=8, bf16 q, contexts of
        # 32, 512 and 1024 tokens in a 64-entry table (max_len 1024);
        # SDPA over the pre-gathered, head-expanded KV beside K1 (for
        # K1-int8 over pre-dequantized bf16 KV: no PyTorch call takes int8
        # KV with scales).  512 is the row the kernels line reports.
        B, KV, G, hd, bs = 8, 2, 7, 64, 16
        k1_rows = []
        for T in (32, 512, 1024):
            fp = k1_timing(B, KV, G, hd, T, False, flush)
            q8 = k1_timing(B, KV, G, hd, T, True, flush)
            row = {"tokens": T, "blocks": T // bs,
                   "split_plan": fp["split_plan"],
                   "sdpa_ms": fp["library_ms"]}
            for name, r in (("paged_decode", fp), ("paged_decode_int8", q8)):
                row[name] = {k_: r[k_] for k_ in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by")}
            k1_rows.append(row)
        # fixed cost and cost per block: least squares over the three rows
        xs = np.array([r["blocks"] for r in k1_rows], dtype=float)
        fit = {}
        for name in ("paged_decode", "paged_decode_int8"):
            ys = np.array([r[name]["ms"] for r in k1_rows]) * 1e3
            per_block, fixed = np.polyfit(xs, ys, 1)
            fit[name] = {"fixed_us": fixed, "per_block_us": per_block}
            print(f"{name}: fixed {fixed:.2f} us + {per_block:.3f} us a "
                  f"block of {bs} positions (least squares over "
                  f"{[int(x) for x in xs]} blocks)")
        timing["k1_rows"] = k1_rows
        timing["k1_fit"] = fit
        mid = next(r for r in k1_rows if r["tokens"] == 512)
        shape = f"B={B} KV={KV} G={G} hd={hd} bs={bs} len=512 bf16"
        timing["paged_decode"] = dict(
            mid["paged_decode"], shape=shape, library_ms=mid["sdpa_ms"],
            library="F.scaled_dot_product_attention over the gathered, "
                    "head-expanded KV", split_plan=mid["split_plan"])
        timing["paged_decode_int8"] = dict(
            mid["paged_decode_int8"], shape=shape + " q, int8 KV",
            library_ms=None, library="none (no PyTorch call takes int8 KV "
                                     "with scales)",
            context_ms=mid["sdpa_ms"],
            context="SDPA over bf16 KV of the same shape (the K1 row)",
            split_plan=mid["split_plan"])

        t0 = time.perf_counter()
        # K1 at gemma2's heads (families_path): B 8, KV 8, G 2, hd 256,
        # window 4096, softcap 50, a 272-block table (max_len 4352), at 512
        # tokens and at 4200, where the window drops the first 104
        rows = [k1_timing(8, 8, 2, 256, T, False, flush, nbs=272,
                          window=4096, logit_cap=50.0, plain_iters=20)
                for T in (512, 4200)]
        timing["paged_decode_hd256"] = rows
        added("timing", t0)

        # K2: every GEMM shape of the path under its scheduled dataflow
        sched = ScheduleCache()
        shapes = []
        for M in (8, 256):
            shapes += [(M, N_, K_) for N_, K_ in path_nk[:4]]
        shapes.append((8, 151936, 896))      # head rows = slots
        shapes.append((40, 151936, 896))     # spec verify head, k = 4
        # mamba2's in_proj, out_proj and head at decode (8 slots) and
        # chunk rows (8 x 256)
        shapes += [(M, N_, K_) for M in (8, 2048) for N_, K_ in m2_nk]
        rows = k2_timing(shapes, sched, flush)
        timing["mpgemm_shapes"] = rows
        head = next(r for r in rows if (r["M"], r["N"]) == (8, 151936))
        timing["mpgemm"] = dict(head, shape="head (8, 151936, 896) bf16 "
                                "-> fp32", library="torch.matmul (bf16)")
        t0 = time.perf_counter()
        # dense_path's new K2 rows: qwen2's gate/up projection at dense
        # admissions (buckets of 16, 512 and 1024 rows) and a wave prefill
        # (8 x 512 rows), the head over an admission's one row, and
        # llava's vision_proj (patches_path)
        timing["mpgemm_dense_shapes"] = k2_timing(
            [(M, 4864, 896) for M in (16, 512, 1024, 4096)]
            + [(1, 151936, 896), (4608, 4096, 4096)], sched, flush)
        added("timing", t0, "dense")
        t0 = time.perf_counter()
        moe_timing(sched, flush)
        added("timing", t0, "moe")
        t0 = time.perf_counter()
        mla_timing(sched, flush)
        added("timing", t0, "mla")

        # K3: every int8 projection shape of the path, bf16 x, with its
        # route and plan (launch/quant_tiles.py), and the host time a call
        rows = QT.measure(QT.SHAPES, dev, flush)

        for r in rows:
            print(f"[{card}] " + QT.describe(r))
        floor = QT.floor_ms(dev, flush)
        print(f"[{card}] timing floor (one-element add_, same method): "
              f"{floor * 1e3:.1f} us")
        host = QT.host_row(dev)
        print(f"[{card}] K3 host time a call at (8, 896, 896), back to "
              f"back: quant_matmul {host['quant_matmul_us']:.1f} us (fp32 "
              f"x, CUDA-core route: {host['quant_matmul_fp32_x_us']:.1f} us), "
              f"ops.quant_matmul (scheduled) "
              f"{host['ops_quant_matmul_us']:.1f} us, torch.matmul "
              f"{host['torch_matmul_us']:.1f} us")
        timing["quant_matmul_shapes"] = rows
        timing["quant_matmul_host"] = host
        timing["floor_ms"] = floor
        timing["quant_matmul"] = dict(rows[3], shape="decode down projection "
                                      "(8, 896, 4864) bf16 x -> fp32")

        # K4 at three of limb_path's shapes (launch/limb_tiles.py): the
        # fused entry (the whole limb_matmul, one launch), its host wall, the
        # planes entry and the plain composition; no PyTorch call computes an
        # exact integer GEMM mod 2^64 (library: none); la*lb torch._int_mm
        # calls on the digits, where its shape rules allow, as context
        rows = LT.measure(dev, flush)
        for r in rows:
            M_, N_, K_, nl = r["M"], r["N"], r["K"], r["limbs"]
            a, b = LT.operands(M_, N_, K_, r["bits"], LT.SEED, dev)
            al, bl = LG.limb_decompose(a, nl), LG.limb_decompose(b, nl)
            ctx, ctx_name = None, "torch._int_mm x la*lb (int8 -> int32)"
            try:
                torch._int_mm(al[0].contiguous(), bl[0].contiguous())

                def int_mms():
                    for i in range(nl):
                        for j in range(nl):
                            torch._int_mm(al[i], bl[j])
                ctx = time_ms(int_mms, 20, flush, LT.SLEEP)
            except RuntimeError as e:
                ctx_name = f"none (torch._int_mm: {str(e)[:80]})"
            eb = r["bits"] // 8
            ops_ = 2 * nl * nl * M_ * N_ * K_       # the reference's digits
            b_ms, b_by = bound_ms(eb * (M_ * K_ + K_ * N_) + 8 * M_ * N_,
                                  ops_, "int8")
            p_ms, p_by = bound_ms(nl * (M_ * K_ + K_ * N_)
                                  + (2 * nl - 1) * M_ * N_ * 4, ops_, "int8")
            d = LG.digits_for(r["bits"], nl, K_)
            plan = LG.limb_plan(M_, N_, K_, d, d, eb, eb)
            pplan = LG.limb_plan(M_, N_, K_, nl, nl, limbs=True, fused=False)
            r.update({"digits": d, "tile": list(plan.tile),
                      "ranks": plan.ranks, "ctas": plan.ctas,
                      "ms": r["limb_matmul_ms"],
                      "planes_tile": list(pplan.tile),
                      "planes_bound_ms": p_ms, "planes_bound_by": p_by,
                      "library_ms": None,
                      "library": "none (no PyTorch call computes an exact "
                                 "integer GEMM mod 2^64 on CUDA)",
                      "context_ms": ctx, "context": ctx_name,
                      "bound_ms": b_ms, "bound_by": b_by})
            print(f"[{card}] K4 {LT.describe(r)}; fused: {d} digits, tile "
                  f"{plan.tile[:2]} x {plan.ranks} ranks, bound "
                  f"{b_ms*1e3:.2f} us ({b_by}); planes entry bound "
                  f"{p_ms*1e3:.2f} us ({p_by}); {ctx_name} "
                  f"{'-' if ctx is None else f'{ctx*1e3:.1f} us'}")
        timing["limb_gemm_shapes"] = rows
        timing["limb_gemm"] = dict(rows[0], shape="md.update960 (960, 960, "
                                   "64) INT32, 5 limbs a side, fused entry")

        # K5 at the mamba2 chunk shapes: 8 slots x 80 heads, Q = 32 (the
        # engine's default chunk) and 256 (the published one); no PyTorch
        # call computes this function (library: none); two fp32 bmm calls
        # with the precomputed decay mask between them are the context
        rows = []
        for Q in (32, 256):
            G, P, N_ = 640, 64, 128
            x, dt, cums, b, c = ssd_case(G, Q, P, N_, seed=Q)
            kern = time_ms(lambda: SSD.ssd_intra(x, dt, cums, b, c), 50,
                           flush)
            plain = time_ms(lambda: SSD.ssd_intra_ref(x, dt, cums, b, c),
                            20, flush)
            causal = torch.ones(Q, Q, dtype=torch.bool, device=dev).tril()
            seg = (cums[:, :, None] - cums[:, None, :]).masked_fill(
                ~causal, float("-inf"))
            ldt = torch.exp(seg) * dt[:, None, :]
            bt = b.transpose(1, 2)
            ctx = time_ms(lambda: torch.bmm(torch.bmm(c, bt) * ldt, x), 50,
                          flush)
            # restated as the path's row: 3xTF32 products (three TF32
            # products each) at 495 TFLOP/s, or the bytes
            b_ms, b_by = SSD_T.k5_bound_ms(G, Q, 1, 1, P, N_)
            rows.append({"G": G, "Q": Q, "P": P, "N": N_, "ms": kern,
                         "plain_ms": plain, "library_ms": None,
                         "library": "none (no PyTorch call computes the "
                                    "masked two-GEMM chain)",
                         "context_ms": ctx,
                         "context": "torch.bmm(torch.bmm(C, B^T) * L dt, X),"
                                    " fp32, TF32 off, mask precomputed",
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"K5 fp32 G={G} Q={Q} P={P} N={N_}: kernel "
                  f"{kern*1e3:.1f} us, plain {plain*1e3:.1f} us, two bmm "
                  f"(context) {ctx*1e3:.1f} us, bound {b_ms*1e3:.1f} us "
                  f"({b_by})")
        # the path's call (the grouped entry on the stored layout, B and C
        # per group) at Q = 256 and 32: the kernels line's row is Q = 256
        for Q in (256, 32):
            sh = SSD_T.PATH
            args_ = SSD_T.path_inputs(Q, 100 + Q, dev)
            kern = time_ms(lambda: SSD.ssd_intra_chunked(*args_), 50, flush)
            plain = time_ms(lambda: SSD.ssd_intra_chunked_ref(*args_), 20,
                            flush)
            b_ms, b_by = SSD_T.k5_bound_ms(sh["B"] * sh["nc"], Q, sh["H"],
                                           sh["G"], sh["P"], sh["N"])
            plan = SSD.ssd_plan(sh["B"], sh["nc"], Q, sh["H"], sh["G"])
            rows.append({"layout": "grouped", "Q": Q, **sh, "ms": kern,
                         "plain_ms": plain, "library_ms": None,
                         "library": "none (no PyTorch call computes the "
                                    "masked two-GEMM chain)",
                         "head_block": plan.head_block, "grid": plan.grid,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bound_counts": "x, y, dt, cums, B and C (per "
                                         "group) once; 3xTF32 products of "
                                         "the causal pairs at 495 TFLOP/s"})
            print(f"K5 grouped B={sh['B']} Q={Q} H={sh['H']} G={sh['G']} "
                  f"P={sh['P']} N={sh['N']} (head block {plan.head_block}, "
                  f"grid {plan.grid}): kernel {kern*1e3:.1f} us, plain "
                  f"{plain*1e3:.1f} us, bound {b_ms*1e3:.1f} us ({b_by})")
        timing["ssd_intra_shapes"] = rows
        timing["ssd_intra"] = dict(rows[2], shape="mamba2 chunk step's call "
                                   "(B 8, nc 1, Q 256, H 80, G 1, P 64, N "
                                   "128) fp32, grouped entry")
        # K5 at zamba2's chunk call (families_path): B 8, H 112, G 1, P 64,
        # N 64, Q 256 (the published chunk)
        t0 = time.perf_counter()
        zsh = dict(B=8, nc=1, H=112, G=1, P=64, N=64)
        args_ = SSD_T.path_inputs(256, 7, dev, **zsh)
        kern = time_ms(lambda: SSD.ssd_intra_chunked(*args_), 50, flush)
        plain = time_ms(lambda: SSD.ssd_intra_chunked_ref(*args_), 20, flush)
        b_ms, b_by = SSD_T.k5_bound_ms(8, 256, 112, 1, 64, 64)
        plan = SSD.ssd_plan(8, 1, 256, 112, 1)
        timing["ssd_intra_zamba2"] = {
            "layout": "grouped", "Q": 256, **zsh, "ms": kern,
            "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by, "head_block": plan.head_block,
            "grid": plan.grid}
        print(f"[{card}] K5 grouped zamba2 B=8 Q=256 H=112 G=1 P=64 N=64 "
              f"(head block {plan.head_block}, grid {plan.grid}): kernel "
              f"{kern*1e3:.1f} us, plain {plain*1e3:.1f} us, bound "
              f"{b_ms*1e3:.1f} us ({b_by})")
        del args_
        added("timing", t0)
        # K5 at dense admissions (dense_path): batch 1, the chunks of a
        # 512 bucket (mamba2) and of a 1024 bucket (zamba2)
        t0 = time.perf_counter()
        rows = []
        for arch, sh in (("mamba2", dict(B=1, nc=2, H=80, G=1, P=64,
                                         N=128)),
                         ("zamba2", dict(B=1, nc=4, H=112, G=1, P=64,
                                         N=64))):
            args_ = SSD_T.path_inputs(256, 9, dev, **sh)
            kern = time_ms(lambda: SSD.ssd_intra_chunked(*args_), 50, flush)
            plain = time_ms(lambda: SSD.ssd_intra_chunked_ref(*args_), 20,
                            flush)
            b_ms, b_by = SSD_T.k5_bound_ms(sh["nc"], 256, sh["H"], sh["G"],
                                           sh["P"], sh["N"])
            plan = SSD.ssd_plan(sh["B"], sh["nc"], 256, sh["H"], sh["G"])
            rows.append({"arch": arch, "layout": "grouped", "Q": 256, **sh,
                         "ms": kern, "plain_ms": plain, "library_ms": None,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "head_block": plan.head_block, "grid": plan.grid})
            print(f"[{card}] K5 grouped {arch} dense admission B=1 "
                  f"nc={sh['nc']} Q=256 H={sh['H']} (head block "
                  f"{plan.head_block}, grid {plan.grid}): kernel "
                  f"{kern*1e3:.1f} us, plain {plain*1e3:.1f} us, bound "
                  f"{b_ms*1e3:.1f} us ({b_by})")
            del args_
        timing["ssd_intra_dense"] = rows
        added("timing", t0, "dense")
        # K5-bwd at mamba2's training call (train_path)
        k5_bwd_timing(flush)

        # K6 at the down projection at chunk rows, bf16: WS at the path's
        # tile (bk = 64, 76 planes) and at bk = 128 (38 planes; bk = 32
        # would take the CUDA-core route), OS at fold 2; the kernel writes
        # the planes, the reduction (planes.sum) is timed apart; library:
        # one torch.matmul of the same product
        M_, N_, K_ = 256, 896, 4864
        a, b = gemm_inputs(M_, N_, K_, torch.bfloat16, 13)
        lib = time_ms(lambda: torch.matmul(a, b), 50, flush)
        rows = []
        for label, df, fold, bk_ in (("WS", Dataflow.WS, 1, None),
                                     ("WS bk=128", Dataflow.WS, 1, 128),
                                     ("OS k_fold=2", Dataflow.OS, 2, None)):
            bm, bn, bk = OPS.plan_blocks(M_, N_, K_, 2, df, fold)
            bk = bk_ or bk
            kw = dict(dataflow=df, bm=bm, bn=bn, bk=bk,
                      k_fold=MP.effective_fold(K_, bk, fold))
            planes = MP.mpgemm_spill(a, b, **kw)
            kern = time_ms(lambda: MP.mpgemm_spill(a, b, **kw), 50, flush)
            red = time_ms(lambda: planes.sum(0), 50, flush)
            whole = time_ms(lambda: MP.mpgemm(a, b, epilogue="spill", **kw),
                            30, flush)
            fused = time_ms(lambda: MP.mpgemm(a, b, **kw), 30, flush)
            plain = time_ms(lambda: MP.mpgemm_spill_plain(
                a, b, dataflow=df, bk=bk, k_fold=kw["k_fold"]), 10, flush,
                20_000_000)
            nbytes = 2 * (M_ * K_ + K_ * N_) + planes.numel() * 4
            b_ms, b_by = bound_ms(nbytes, 2 * M_ * N_ * K_, "bfloat16")
            rows.append({"M": M_, "N": N_, "K": K_, "variant": label,
                         "route": MP.mpgemm_route(a, b, bk),
                         "blocks": [bm, bn, bk], "k_fold": kw["k_fold"],
                         "planes": planes.shape[0],
                         "planes_bytes": planes.numel() * 4, "ms": kern,
                         "reduction_ms": red, "spill_matmul_ms": whole,
                         "fused_ms": fused, "plain_ms": plain,
                         "library_ms": lib, "library": "torch.matmul (bf16)",
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"K6 bf16 ({M_}, {N_}, {K_}) {label} tile {bm}x{bn}x{bk}, "
                  f"{planes.shape[0]} planes ({planes.numel() * 4 / 1e6:.1f} "
                  f"MB): kernel {kern * 1e3:.1f} us, reduction "
                  f"{red * 1e3:.1f} us, spill matmul {whole * 1e3:.1f} us, "
                  f"fused (K2) {fused * 1e3:.1f} us, plain {plain * 1e3:.1f}"
                  f" us, torch.matmul {lib * 1e3:.1f} us, bound "
                  f"{b_ms * 1e3:.1f} us ({b_by})")
            del planes
        timing["mpgemm_spill_shapes"] = rows
        timing["mpgemm_spill"] = dict(rows[0], shape="down projection at "
                                      "chunk rows (256, 896, 4864) bf16, WS "
                                      "-> fp32 planes")

    # -- 8. where one step's time goes --------------------------------------
    def measure(eng, n_wall):
        """Wall time a step over ``n_wall`` steps, then one more step
        under torch.profiler: device time, kernel launches, the
        heaviest kernels and K5's launches in that step."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_wall):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_wall * 1e3
        SSD.launches.reset()
        PA.launches.reset()
        PA.launches_int8.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        # kernel events only: aten ops carry their kernels' time too
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
        k1 = [e for e in ev if "paged_decode" in e.key]
        k3 = [e for e in ev if "quant_hopper" in e.key
              or "quant_matmul_core" in e.key]
        k5_ms, k5_kernels = kernel_ms(prof, "ssd_intra")
        return {"step_ms": wall, "device_ms": dev_ms,
                "device_busy_share": dev_ms / wall,
                "device_kernels": sum(e.count for e in ev),
                "k5_launches": SSD.launches.count,
                "k1_launches": PA.launches.count,
                "k1_int8_launches": PA.launches_int8.count,
                "k5_ms": k5_ms, "k5_kernels": k5_kernels,
                # the aten ops behind the device time (CPU-side names)
                "top_ops": top_ops(prof, 10),
                # K1 / K1-int8: the split and the combine kernel
                "k1_ms": sum(e.self_device_time_total for e in k1) / 1e3,
                "k1_kernels": {e.key[:60]: e.count for e in k1},
                "k3_ms": sum(e.self_device_time_total for e in k3) / 1e3,
                "k3_kernels": {e.key[:60]: e.count for e in k3},
                "top": [(e.key[:60], e.self_device_time_total / 1e3,
                         e.count) for e in top]}

    def flash_span_ms(eng, n):
        """Device time a step of ``_flash`` (CUDA events around each call,
        the module's function wrapped for these steps only), averaged over
        ``n`` steps, and its calls a step."""
        orig, spans = ATT._flash, []

        def timed(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            got = orig(*a, **kw)
            ev[1].record()
            spans.append(ev)
            return got
        ATT._flash = timed
        try:
            for _ in range(n):
                eng.step()
            torch.cuda.synchronize()
        finally:
            ATT._flash = orig
        return (sum(s.elapsed_time(e) for s, e in spans) / n,
                len(spans) // n)

    def show(name, r):
        print(f"[{card}] full-width {name}: {r['step_ms']:.2f} ms "
              f"wall, {r['device_ms']:.2f} ms on the device "
              f"({100 * r['device_busy_share']:.0f}% busy), "
              f"{r['device_kernels']} kernel launches; K1 kernels "
              f"{r['k1_ms']:.3f} ms {r['k1_kernels']}; K3 kernels "
              f"{r['k3_ms']:.3f} ms {r['k3_kernels']}; top: "
              + "; ".join(f"{k} {t:.2f} ms x{c}"
                          for k, t, c in r["top"]))

    def p_profile():
        out = {}
        for b, model in (("xla", full), ("scheduled", full),
                         ("xla", full_quant), ("scheduled", full_quant)):
            cfg = dataclasses.replace(model, gemm_backend=b)
            params = params_quant() if model.quant_serving else params_full()
            eng = ContinuousEngine(cfg, params, slots=8, max_len=1024,
                                   device=dev)
            if model.quant_serving:
                b = f"int8 {b}"
            for r in requests(np.random.default_rng(7), 8, 30, 31, 64,
                              full.vocab):
                eng.submit(r)
            for _ in range(3):        # one chunk step prefills all, then
                eng.step()            # every step is a decode step
            out[b] = measure(eng, 5)
            show(f"decode step, {b}", out[b])
        # the dense engine's decode step beside the paged one: the same
        # requests, all admitted by the first step (eight batch-1
        # prefills), then decode steps whose attention is _flash over
        # each slot's whole 1024-row stripe
        cfg = dataclasses.replace(full, gemm_backend="scheduled")
        eng = ContinuousEngine(cfg, params_full(), slots=8, max_len=1024,
                               paged=False, device=dev)
        for r in requests(np.random.default_rng(7), 8, 30, 31, 64,
                          full.vocab):
            eng.submit(r)
        for _ in range(3):
            eng.step()
        dense = measure(eng, 5)
        dense["flash_ms"], dense["flash_calls"] = flash_span_ms(eng, 5)
        dense["flash_share_of_step"] = dense["flash_ms"] / dense["step_ms"]
        out["dense scheduled"] = dense
        show("dense decode step, scheduled", dense)
        print(f"[{card}] dense decode step: _flash {dense['flash_ms']:.3f} "
              f"ms a step over {dense['flash_calls']} calls (CUDA-event "
              f"spans), {100 * dense['flash_share_of_step']:.0f}% of the "
              f"step's {dense['step_ms']:.2f} ms wall; the paged step's K1 "
              f"{out['scheduled']['k1_ms']:.3f} ms")
        if dense["k1_launches"] or dense["flash_calls"] != full.n_layers:
            raise AssertionError(f"dense decode step: K1 "
                                 f"{dense['k1_launches']}, _flash calls "
                                 f"{dense['flash_calls']}")
        # one int8 scheduled chunk step: 8 slots x 32 prompt rows (the
        # engine's default prefill_chunk); prompts of 2.5 chunks, step 1
        # timed, step 2 profiled
        cfg = dataclasses.replace(full_quant, gemm_backend="scheduled")
        eng = ContinuousEngine(cfg, params_quant(), slots=8, max_len=1024,
                               device=dev)
        plen = 5 * eng.prefill_chunk // 2
        for r in requests(np.random.default_rng(7), 8, plen, plen + 1, 8,
                          full.vocab):
            eng.submit(r)
        chunks0 = eng.chunk_steps
        out["int8 scheduled chunk"] = measure(eng, 1)
        show("int8 chunk step (8 x 32 rows), scheduled",
             out["int8 scheduled chunk"])
        ran = eng.chunk_steps - chunks0
        if ran != 2 or eng.steps != 0:
            raise AssertionError(f"int8 chunk profile: {ran} chunk and "
                                 f"{eng.steps} decode steps, expected 2 "
                                 f"chunk steps")
        # mamba2: prompts of three chunks (2.5 x 256 tokens); step 1
        # (chunk) is timed, step 2 (chunk) profiled, step 3 ends the
        # prefill, then decode steps
        plen = 5 * m2.ssm.chunk // 2
        for b in ("xla", "scheduled"):
            cfg = dataclasses.replace(m2, gemm_backend=b)
            eng = ContinuousEngine(cfg, params_m2(), slots=8, max_len=1024,
                                   prefill_chunk=m2.ssm.chunk, device=dev)
            for r in requests(np.random.default_rng(7), 8, plen, plen + 1,
                              16, m2.vocab):
                eng.submit(r)
            chunk = measure(eng, 1)
            eng.step()
            eng.step()
            decode = measure(eng, 5)
            for kind, r in (("chunk", chunk), ("decode", decode)):
                out[f"mamba2 {b} {kind}"] = r
                show(f"mamba2 {kind} step, {b}", r)
            print(f"mamba2 chunk step, {b}: K5 {chunk['k5_ms']:.2f} ms "
                  f"(x{chunk['k5_kernels']}); top aten ops by device time: "
                  + "; ".join(f"{k} {t:.2f} ms x{c}"
                              for k, t, c in chunk["top_ops"]))
            if chunk["k5_launches"] != m2.n_layers \
                    or decode["k5_launches"] != 0:
                raise AssertionError(f"mamba2 {b}: K5 launched "
                                     f"{chunk['k5_launches']} times in a "
                                     f"chunk step and {decode['k5_launches']}"
                                     f" in a decode step")
        rep["step_profile"] = out

    # -- 12. int8 serving of the SSM configs ----------------------------------
    def free_memory():
        """Collect unreachable engines (their reference cycles keep
        weights and pools alive until the collector runs), then return
        the cached blocks to the card."""
        import gc
        gc.collect()
        torch.cuda.empty_cache()

    def ssm_quant_want(cfg, r, backend):
        """Launches an int8 run should make: every projection and the
        head through K3 under scheduled (``k2_per_step``'s GEMMs), none
        under xla; K5 once a MAMBA2 layer a chunk step; K1-int8 once a
        shared-attention layer a decode step; K2 and the fp K1 never."""
        kinds = block_kinds(cfg)
        n_attn = sum(k is not BlockKind.MAMBA2 for k in kinds)
        steps = r["decode_steps"] + r["chunk_steps"]
        return {"quant_matmul": k2_per_step(cfg) * steps
                if backend == "scheduled" else 0,
                "mpgemm": 0, "paged_decode": 0,
                "paged_decode_int8": n_attn * r["decode_steps"],
                "ssd_intra": (len(kinds) - n_attn) * r["chunk_steps"]}

    def p_ssm_quant():
        """mamba2-2.7b and zamba2-7b at published width, int8 (the
        engine's default policy: in_proj, out_proj, zamba2's shared
        attention and the untied heads; zamba2's shared attention on
        int8 KV blocks), on phase 5's request shape at chunk 256, under
        both backends with the pool audit after every step."""
        out = {}
        fp_rows = {"mamba2_2_7b": rep.get("mamba2", {}).get("scheduled"),
                   "zamba2_7b": rep.get("families", {}).get("zamba2_7b")}
        for arch in ("mamba2_2_7b", "zamba2_7b"):
            base = CONFIGS.get(arch)
            params = params_m2() if arch == "mamba2_2_7b" else \
                N.init(base, args.seed, dev)
            qcfg = dataclasses.replace(base, quant_serving=True)
            qparams = serving_quant_params(qcfg, params)
            if arch != "mamba2_2_7b":
                del params
            reqs = requests(np.random.default_rng(args.seed), 8, 64, 513,
                            32, base.vocab)
            chunk = base.ssm.chunk
            warm = requests(np.random.default_rng(99), 2, 40, 41, 4,
                            base.vocab)
            ContinuousEngine(qcfg, qparams, slots=8, max_len=1024,
                             prefill_chunk=chunk, device=dev).run(warm)
            torch.cuda.synchronize()
            for b in ("xla", "scheduled"):
                cfg = dataclasses.replace(qcfg, gemm_backend=b)
                eng, res, wall, counts = serve(cfg, qparams, reqs, 8, 1024,
                                               audit=True,
                                               prefill_chunk=chunk)
                r = summary(eng, res, wall)
                r["launches"] = counts
                r["quantized_pool"] = eng.pool.stats()["quantized"]
                r["kv_allocated"] = eng.kv_bytes()["allocated"]
                r["tokens"] = [q.tokens.tolist() for q in res]
                want = ssm_quant_want(cfg, r, b)
                got = {k: counts[k] for k in want}
                r["expected_launches"] = want
                steps = r["decode_steps"] + r["chunk_steps"]
                r["per_step"] = {k: v / max(steps, 1) for k, v in got.items()
                                 if k in ("quant_matmul",)}
                out[f"{arch} {b}"] = r
                fp = fp_rows[arch]
                beside = "" if fp is None else (
                    f" (fp run: {fp['tok_per_s']:.1f} tok/s, TTFT p50 "
                    f"{fp['ttft_p50_ms']:.1f} ms, TPOT p50 "
                    f"{fp['tpot_p50_ms']:.2f} ms)")
                print(f"[{card}] {base.name} int8 full width, {b}, chunk "
                      f"{chunk}: {r['ok']}/{r['requests']} ok, "
                      f"{r['new_tokens']} tokens in {r['wall_s']:.2f} s = "
                      f"{r['tok_per_s']:.1f} tok/s, TTFT p50 "
                      f"{r['ttft_p50_ms']:.1f} ms, TPOT p50 "
                      f"{r['tpot_p50_ms']:.2f} ms{beside}; "
                      f"{r['decode_steps']} decode + {r['chunk_steps']} "
                      f"chunk steps; launches {got} (expected {want}), "
                      f"K3 by route {counts['quant_matmul_by_route']}, pool "
                      f"int8 {r['quantized_pool']}")
                bad = []
                if r["ok"] != 8 or r["new_tokens"] != 8 * 32:
                    bad.append(f"{r['ok']}/8 ok, {r['new_tokens']} tokens")
                if got != want or not r["decode_steps"] \
                        or not r["chunk_steps"]:
                    bad.append(f"launches {got}, expected {want}")
                # the untied head's (D, V) int8 payload takes K3's
                # CUDA-core kernel where TMA refuses its row stride
                # (mamba2's rows of V = 50280 bytes are not a multiple of
                # 16): one a step
                core = steps if b == "scheduled" and cfg.vocab % 16 else 0
                r["k3_cuda_core_expected"] = core
                if counts["quant_matmul_by_route"]["cuda_core"] != core:
                    bad.append(f"K3 by route "
                               f"{counts['quant_matmul_by_route']}, "
                               f"expected {core} on the CUDA cores (the "
                               f"head)")
                if r["quantized_pool"] != int(arch == "zamba2_7b"):
                    bad.append(f"pool int8 {r['quantized_pool']}")
                if bad:
                    raise AssertionError(f"{arch} int8 {b}: "
                                         + "; ".join(bad))
                del eng
            tx, ts = (out[f"{arch} {b}"]["tokens"]
                      for b in ("xla", "scheduled"))
            same = sum(x == y for a, c in zip(tx, ts)
                       for x, y in zip(a, c))
            out[f"{arch} agreement"] = same / sum(len(a) for a in tx)
            print(f"{base.name} int8 greedy agreement xla vs scheduled "
                  f"(bf16, not gated): {same}/{sum(len(a) for a in tx)}")
            del qparams
            free_memory()
        rep["ssm_quant"] = out

    def p_ssm_quant_small():
        """Scaled-down mamba2 and zamba2, fp32, int8 at every projection
        (``QuantPolicy(min_size=0)``), init-scale weights (the CPU parity
        tests' x1): greedy tokens identical across backends."""
        out = {}
        pol = QuantPolicy(min_size=0)
        for arch in ("mamba2_2_7b", "zamba2_7b"):
            base = dataclasses.replace(CONFIGS.get(arch).scaled_down(),
                                       quant_serving=True)
            params = N.init(base, args.seed, dev)
            reqs = requests(np.random.default_rng(args.seed + 1), 8, 4, 100,
                            16, base.vocab)
            toks, counts = {}, {}
            for b in ("xla", "scheduled"):
                cfg = dataclasses.replace(base, gemm_backend=b)
                _eng, res, _, counts[b] = serve(cfg, params, reqs, 4, 160,
                                                audit=True, quant_policy=pol,
                                                prefill_chunk=32)
                if not all(r.status == "ok" and len(r.tokens) == 16
                           for r in res):
                    raise AssertionError(f"scaled-down int8 {arch} {b}: a "
                                         f"request failed")
                toks[b] = [r.tokens.tolist() for r in res]
            same = toks["xla"] == toks["scheduled"]
            distinct = [len(set(t)) for t in toks["xla"]]
            out[arch] = {"identical": same, "distinct_per_request": distinct,
                         "launches": counts}
            print(f"scaled-down fp32 int8 {base.name}: greedy tokens "
                  f"identical across backends: {same}; distinct tokens a "
                  f"request {distinct}; K3 launches (scheduled) "
                  f"{counts['scheduled']['quant_matmul']}")
            if not same:
                raise AssertionError(f"scaled-down int8 {arch} tokens "
                                     f"differ between backends")
            if min(distinct) < 4:
                raise AssertionError(f"degenerate greedy output: {distinct}")
        rep["ssm_quant_small"] = out

    # -- 13. MoE: llama4-scout through the paged engine ----------------------
    #: moe_path's depth: every width of llama4-scout kept (d 5120, 40 / 8
    #: heads, hd 128, 16 experts of 8192, the shared expert, vocab 202048);
    #: 8 of its 48 layers, so that its bf16 weights (~39 GB) fit one card
    MOE_LAYERS = 8
    MOE_CHUNK = 256

    def moe_config():
        return dataclasses.replace(CONFIGS.get("llama4_scout_17b_a16e"),
                                   n_layers=MOE_LAYERS).validate()

    def init_layerwise(cfg, seed):
        """``cfg``'s random weights with ``network.init``'s scales, built
        on the card in the parameter dtype leaf by leaf and a stacked
        leaf layer by layer: no fp32 copy of a whole (L, E, D, F) expert
        leaf (10.7 GB in bf16 at full width) is ever held."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = getattr(torch, cfg.param_dtype)

        def make(_path, d):
            out = torch.empty(d.shape, dtype=dt, device=dev)
            if d.init == "zeros":
                return out.zero_()
            if d.init == "ones":
                return out.fill_(1.0)
            for part in (out if out.dim() >= 3 else (out,)):
                part.copy_(torch.randn(part.shape, generator=gen,
                                       device=dev) * d.scale)
            return out
        return tree_map(make, N.param_defs(cfg))

    def param_bytes(params):
        total = [0]

        def fn(_p, a):
            for t in ((a.q, a.scale) if hasattr(a, "q") else (a,)):
                total[0] += t.numel() * t.element_size()
            return a
        tree_map(fn, params)
        return total[0]

    def moe_want(cfg, r, backend, quant):
        """A step's launches: an attention layer's q, k, v and o, the
        router and the shared expert's gate, up and down (8 GEMMs a
        layer) and the head -- K2 under fp scheduled; under int8 all but
        the router through K3 (7 a layer and the head) and the router
        through K2; none under xla.  K1 (or K1-int8) once a layer a
        decode step."""
        L = cfg.n_layers
        steps = r["decode_steps"] + r["chunk_steps"]
        sched = backend == "scheduled"
        k1 = L * r["decode_steps"]
        return {"mpgemm": (L if quant else 8 * L + 1) * steps if sched
                else 0,
                "quant_matmul": (7 * L + 1) * steps if sched and quant
                else 0,
                "paged_decode": 0 if quant else k1,
                "paged_decode_int8": k1 if quant else 0,
                "ssd_intra": 0}

    def drops_by_step(drops, L, decode_slots=8):
        """(decode-step drops, per chunk step [drops, slots, capacity])
        from ``moe.record_drops``'s entries, L consecutive a step; a
        decode step's entries have ``decode_slots`` expanded slots (8
        slots x top_k)."""
        steps = [drops[i:i + L] for i in range(0, len(drops), L)]
        decode, chunks = 0, []
        for st in steps:
            n = int(sum(int(d) for _s, _c, d in st))
            slots, cap = st[0][0], st[0][1]
            if slots == decode_slots:   # 8 slots x top_k: a decode step
                decode += n
            else:
                chunks.append([n, slots, cap])
        return decode, chunks

    def p_moe():
        """llama4-scout at published widths, 8 layers: 8 requests of 64-512
        prompt tokens and 32 new, 8 slots, max_len 1024, chunk 256, under
        both backends, fp and then int8 (the engine's default policy), the
        pool audit after every step; then one chunk step and one decode
        step profiled."""
        from repro_torch.models import moe as MOE
        t_phase = time.perf_counter()
        # the earlier phases' engines (reference cycles: freed by the
        # collector, not by their last name) and mamba2's cached weights
        # go first: the run needs ~37 GiB of weights and ~12 GiB to
        # quantize the (202048, 5120) head
        m2_params.clear()
        free_memory()
        free_gib = torch.cuda.mem_get_info(dev)[0] / 2**30
        cfg0 = moe_config()
        t0 = time.perf_counter()
        params = init_layerwise(cfg0, args.seed)
        torch.cuda.synchronize()
        n_full = [0]
        tree_map(lambda _p, d: n_full.__setitem__(
            0, n_full[0] + int(np.prod(d.shape))),
            N.param_defs(CONFIGS.get("llama4_scout_17b_a16e")))
        full_gb = n_full[0] * 2 / 2**30
        out = {"layers": MOE_LAYERS, "of_layers": 48,
               "free_gib_before": free_gib,
               "weights_gib": param_bytes(params) / 2**30,
               "full_model_gib": full_gb,
               "init_s": time.perf_counter() - t0}
        print(f"[{card}] llama4-scout-17b-16e at published widths, depth "
              f"cut from 48 to {MOE_LAYERS} layers: weights "
              f"{out['weights_gib']:.1f} GiB in bf16 against "
              f"{full_gb:.1f} GiB for the whole model, built layer by "
              f"layer on the card in {out['init_s']:.1f} s ({free_gib:.1f} "
              f"GiB free before)")
        reqs = requests(np.random.default_rng(args.seed), 8, 64, 513, 32,
                        cfg0.vocab)
        qparams = None
        for quant in (False, True):
            qcfg = dataclasses.replace(cfg0, quant_serving=quant)
            if quant:
                free_memory()
                qparams = serving_quant_params(qcfg, params)
                out["int8_weights_gib"] = param_bytes(qparams) / 2**30
            tree = qparams if quant else params
            warm = requests(np.random.default_rng(99), 2, 40, 41, 4,
                            cfg0.vocab)
            ContinuousEngine(qcfg, tree, slots=8, max_len=1024,
                             prefill_chunk=MOE_CHUNK, device=dev).run(warm)
            torch.cuda.synchronize()
            for b in ("xla", "scheduled"):
                cfg = dataclasses.replace(qcfg, gemm_backend=b)
                tag = f"{'int8' if quant else 'fp'} {b}"
                with MOE.record_drops() as drops:
                    eng, res, wall, counts = serve(
                        cfg, tree, reqs, 8, 1024, audit=True,
                        prefill_chunk=MOE_CHUNK)
                r = summary(eng, res, wall)
                r["launches"] = counts
                r["tokens"] = [q.tokens.tolist() for q in res]
                r["quantized_pool"] = eng.pool.stats()["quantized"]
                want = moe_want(cfg, r, b, quant)
                got = {k: counts[k] for k in want}
                r["expected_launches"] = want
                decode_drops, chunk_drops = drops_by_step(drops,
                                                          cfg.n_layers)
                r["decode_drops"], r["chunk_drops"] = decode_drops, \
                    chunk_drops
                out[tag] = r
                print(f"[{card}] llama4-scout {MOE_LAYERS} layers, {tag}: "
                      f"{r['ok']}/{r['requests']} ok, {r['new_tokens']} "
                      f"tokens in {r['wall_s']:.2f} s = "
                      f"{r['tok_per_s']:.1f} tok/s, TTFT p50 "
                      f"{r['ttft_p50_ms']:.1f} ms, TPOT p50 "
                      f"{r['tpot_p50_ms']:.2f} ms, {r['decode_steps']} "
                      f"decode + {r['chunk_steps']} chunk steps; launches "
                      f"{got} (expected {want}); dropped (token, expert) "
                      f"slots: decode steps {decode_drops}, each chunk "
                      f"step [dropped, slots, capacity] {chunk_drops}; "
                      f"schedule misses {r['schedule_misses']}")
                bad = []
                if r["ok"] != 8 or r["new_tokens"] != 8 * 32:
                    bad.append(f"{r['ok']}/8 ok, {r['new_tokens']} tokens")
                if got != want or not r["decode_steps"] \
                        or not r["chunk_steps"]:
                    bad.append(f"launches {got}, expected {want}")
                if counts["mpgemm_by_route"]["cuda_core"] \
                        or counts["quant_matmul_by_route"]["cuda_core"]:
                    bad.append(f"a bf16 GEMM took the CUDA-core route: "
                               f"{counts}")
                if decode_drops:
                    bad.append(f"a decode step dropped {decode_drops} slots")
                if len(chunk_drops) != r["chunk_steps"]:
                    bad.append(f"{len(chunk_drops)} chunk-step drop "
                               f"records for {r['chunk_steps']} chunk steps")
                if r["quantized_pool"] != int(quant):
                    bad.append(f"pool int8 {r['quantized_pool']}")
                if bad:
                    raise AssertionError(f"llama4 {tag}: " + "; ".join(bad))
                del eng
            tx, ts = (out[f"{'int8' if quant else 'fp'} {b}"]["tokens"]
                      for b in ("xla", "scheduled"))
            same = sum(x == y for a, c in zip(tx, ts) for x, y in zip(a, c))
            out[f"{'int8' if quant else 'fp'} agreement"] = \
                same / sum(len(a) for a in tx)
            print(f"llama4 {'int8' if quant else 'fp'} greedy agreement xla "
                  f"vs scheduled (bf16, not gated): {same}/"
                  f"{sum(len(a) for a in tx)}")
        # logits of a short prefill, finite, under both backends
        cfgs = {b: dataclasses.replace(cfg0, gemm_backend=b)
                for b in ("xla", "scheduled")}
        lx, ls = prefill_logits(cfgs, params, np.random.default_rng(5),
                                "llama4")
        if tuple(lx.shape) != (2, cfg0.vocab) or not (
                torch.isfinite(lx).all() and torch.isfinite(ls).all()):
            raise AssertionError("llama4 logits not finite / bad shape")
        # one chunk step (8 x 256 rows) and one decode step profiled:
        # prompts of 2.5 chunks, step 1 timed, step 2 profiled, step 3 ends
        # the prefill, then decode steps
        cfg = dataclasses.replace(cfg0, gemm_backend="scheduled")
        eng = ContinuousEngine(cfg, params, slots=8, max_len=1024,
                               prefill_chunk=MOE_CHUNK, device=dev)
        plen = 5 * MOE_CHUNK // 2
        for r in requests(np.random.default_rng(7), 8, plen, plen + 1, 16,
                          cfg.vocab):
            eng.submit(r)
        chunk = measure(eng, 1)
        eng.step()
        eng.step()
        decode = measure(eng, 5)
        out["step_profile"] = {"chunk": chunk, "decode": decode}
        for kind, pr in (("chunk", chunk), ("decode", decode)):
            show(f"llama4-scout ({MOE_LAYERS} layers) {kind} step, "
                 f"scheduled", pr)
            print(f"llama4 {kind} step: top aten ops by device time: "
                  + "; ".join(f"{k} {t:.2f} ms x{c}"
                              for k, t, c in pr["top_ops"]))
        expert_bytes = 3 * cfg.moe.n_experts * cfg.d_model \
            * cfg.moe.d_ff_expert * 2 * cfg.n_layers
        out["decode_expert_read_bound_ms"] = expert_bytes / 3.35e12 * 1e3
        print(f"llama4 decode step: the routed experts' weights "
              f"({expert_bytes / 1e9:.1f} GB) bound it at "
              f"{out['decode_expert_read_bound_ms']:.2f} ms; device time "
              f"{decode['device_ms']:.2f} ms")
        if decode["k1_launches"] != cfg.n_layers or chunk["k1_launches"]:
            raise AssertionError(f"llama4 profiled steps: K1 "
                                 f"{decode['k1_launches']} a decode step, "
                                 f"{chunk['k1_launches']} a chunk step")
        del eng, params, qparams
        free_memory()
        out["seconds"] = time.perf_counter() - t_phase
        rep["moe"] = out

    def p_moe_small():
        """Scaled-down llama4 (8 experts, top-1, the shared expert, fp32)
        at weights x4 (the CPU parity tests' scale), fp and int8 (every
        projection: ``QuantPolicy(min_size=0)``): greedy tokens identical
        across backends and varied."""
        base = CONFIGS.get("llama4_scout_17b_a16e").scaled_down()
        params = tree_map(lambda _p, a: a * 4.0,
                          N.init(base, args.seed, dev))
        reqs = requests(np.random.default_rng(args.seed + 1), 8, 4, 100, 16,
                        base.vocab)
        out = {}
        for quant in (False, True):
            qbase = dataclasses.replace(base, quant_serving=quant)
            toks, counts = {}, {}
            for b in ("xla", "scheduled"):
                cfg = dataclasses.replace(qbase, gemm_backend=b)
                _eng, res, _, counts[b] = serve(
                    cfg, params, reqs, 4, 160, audit=True, prefill_chunk=32,
                    quant_policy=QuantPolicy(min_size=0))
                if not all(r.status == "ok" and len(r.tokens) == 16
                           for r in res):
                    raise AssertionError(f"scaled-down llama4 {b}: a "
                                         f"request failed")
                toks[b] = [r.tokens.tolist() for r in res]
            same = toks["xla"] == toks["scheduled"]
            distinct = [len(set(t)) for t in toks["xla"]]
            tag = "int8" if quant else "fp"
            out[tag] = {"identical": same, "distinct_per_request": distinct,
                        "launches": counts}
            print(f"scaled-down fp32 llama4 {tag}, weights x4: greedy "
                  f"tokens identical across backends: {same}; distinct "
                  f"tokens a request {distinct}")
            if not same:
                raise AssertionError(f"scaled-down llama4 {tag} tokens "
                                     f"differ between backends")
            if min(distinct) < 4:
                raise AssertionError(f"degenerate greedy output: {distinct}")
        rep["moe_small"] = out

    # -- 15. MLA and deepseek-v2 ------------------------------------------
    #: the first block and 4 of its 60 MoE layers: ~32 GiB of bf16 weights
    MLA_LAYERS = 4
    MLA_CHUNK = 256

    def mla_config():
        return dataclasses.replace(CONFIGS.get("deepseek_v2_236b"),
                                   n_layers=MLA_LAYERS).validate()

    def mla_want(cfg, r, backend, quant):
        """A step's launches, with L MoE layers and the first block: an
        MLA layer runs wq_a, wq_b, wkv_a and wo (and, in a chunk step, the
        wk_b and wv_b decompressions); a MoE layer the router and the
        shared experts' gate, up and down; the first block its MLP's
        three; then the head.  fp scheduled: all through K2, (8L + 8) a
        decode step and (10L + 10) a chunk step.  int8 scheduled: wq_a,
        wkv_a and the router through K2 (3L + 2), the rest through K3
        ((5L + 6) decode, (7L + 8) chunk; the absorbed decode dequantizes
        wk_b / wv_b into its einsums).  None under xla.  K1 never: MLA
        reads its latent pool through the gather path."""
        L = cfg.n_layers
        dec, chk = r["decode_steps"], r["chunk_steps"]
        k2 = k3 = 0
        if backend == "scheduled" and quant:
            k2 = (3 * L + 2) * (dec + chk)
            k3 = (5 * L + 6) * dec + (7 * L + 8) * chk
        elif backend == "scheduled":
            k2 = (8 * L + 8) * dec + (10 * L + 10) * chk
        return {"mpgemm": k2, "quant_matmul": k3, "paged_decode": 0,
                "paged_decode_int8": 0, "ssd_intra": 0}

    def combine_repeats(cfg, params, rows):
        """``moe_apply`` of MoE layer 0 twice on the same (rows, D) input:
        whether the two outputs are bit-equal (the top-k combine's order
        on the card)."""
        from repro_torch.models import moe as MOE
        p = tree_map(lambda _p, a: a[0], params["blocks"][0]["moe"])
        gen = torch.Generator(device=dev).manual_seed(rows)
        x = torch.randn(1, rows, cfg.d_model, generator=gen, device=dev
                        ).to(torch.bfloat16)
        a, _ = MOE.moe_apply(p, x, cfg)
        b, _ = MOE.moe_apply(p, x, cfg)
        return {"rows": rows, "bit_equal": bool(torch.equal(a, b)),
                "max_abs_diff": (a.float() - b.float()).abs().max().item()}

    def p_mla():
        """deepseek-v2 at published widths, the first block and 4 MoE
        layers: 8 requests of 64-512 prompt tokens and 32 new, 8 slots,
        max_len 1024, chunk 256, under both backends, fp and then int8
        (the engine's default policy; the latent pool stays bf16), the
        pool audit after every step; the fp scheduled run repeated (the
        same tokens) and ``moe_apply`` twice on one input (bit-equal); one
        chunk step and one decode step profiled."""
        from repro_torch.models import moe as MOE
        t_phase = time.perf_counter()
        m2_params.clear()
        free_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        free_gib = torch.cuda.mem_get_info(dev)[0] / 2**30
        cfg0 = mla_config()
        t0 = time.perf_counter()
        params = init_layerwise(cfg0, args.seed)
        torch.cuda.synchronize()
        n_full = [0]
        tree_map(lambda _p, d: n_full.__setitem__(
            0, n_full[0] + int(np.prod(d.shape))),
            N.param_defs(CONFIGS.get("deepseek_v2_236b")))
        full_gb = n_full[0] * 2 / 2**30
        m = cfg0.mla
        latent_b = (m.kv_lora_rank + m.qk_rope_head_dim) * 2
        gqa_b = cfg0.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                + m.v_head_dim) * 2
        out = {"layers": MLA_LAYERS, "of_layers": 60, "first_block": True,
               "free_gib_before": free_gib,
               "weights_gib": param_bytes(params) / 2**30,
               "full_model_gib": full_gb,
               "init_s": time.perf_counter() - t0,
               "latent_bytes_per_token_layer": latent_b,
               "gqa_bytes_per_token_layer": gqa_b}
        print(f"[{card}] deepseek-v2-236b at published widths, depth cut "
              f"from 60 MoE layers to {MLA_LAYERS} (and the dense first "
              f"block): weights {out['weights_gib']:.1f} GiB in bf16 "
              f"against {full_gb:.1f} GiB for the whole model, built layer "
              f"by layer on the card in {out['init_s']:.1f} s "
              f"({free_gib:.1f} GiB free before)")
        reqs = requests(np.random.default_rng(args.seed), 8, 64, 513, 32,
                        cfg0.vocab)
        qparams = None
        n_layers = cfg0.n_layers + 1
        for quant in (False, True):
            qcfg = dataclasses.replace(cfg0, quant_serving=quant)
            if quant:
                free_memory()
                qparams = serving_quant_params(qcfg, params)
                out["int8_weights_gib"] = param_bytes(qparams) / 2**30
            tree = qparams if quant else params
            warm = requests(np.random.default_rng(99), 2, 40, 41, 4,
                            cfg0.vocab)
            ContinuousEngine(qcfg, tree, slots=8, max_len=1024,
                             prefill_chunk=MLA_CHUNK, device=dev).run(warm)
            torch.cuda.synchronize()
            runs = [("xla", ""), ("scheduled", "")]
            if not quant:
                runs.append(("scheduled", " repeat"))
            for b, again in runs:
                cfg = dataclasses.replace(qcfg, gemm_backend=b)
                tag = f"{'int8' if quant else 'fp'} {b}{again}"
                with MOE.record_drops() as drops:
                    eng, res, wall, counts = serve(
                        cfg, tree, reqs, 8, 1024, audit=True,
                        prefill_chunk=MLA_CHUNK)
                r = summary(eng, res, wall)
                r["launches"] = counts
                r["tokens"] = [q.tokens.tolist() for q in res]
                st = eng.pool.stats()
                r["quantized_pool"] = st["quantized"]
                pool_shape = eng.caches["first"]["c_kv"].shape
                kv_tok = eng.kv_bytes()["allocated"] / (
                    pool_shape[0] * pool_shape[1] * n_layers)
                r["kv_bytes_per_token_layer"] = kv_tok
                want = mla_want(cfg, r, b, quant)
                got = {k: counts[k] for k in want}
                r["expected_launches"] = want
                decode_drops, chunk_drops = drops_by_step(
                    drops, cfg.n_layers, 8 * cfg.moe.top_k)
                r["decode_drops"], r["chunk_drops"] = decode_drops, \
                    chunk_drops
                out[tag] = r
                print(f"[{card}] deepseek-v2 {MLA_LAYERS}+1 layers, {tag}: "
                      f"{r['ok']}/{r['requests']} ok, {r['new_tokens']} "
                      f"tokens in {r['wall_s']:.2f} s = "
                      f"{r['tok_per_s']:.1f} tok/s, TTFT p50 "
                      f"{r['ttft_p50_ms']:.1f} ms, TPOT p50 "
                      f"{r['tpot_p50_ms']:.2f} ms, {r['decode_steps']} "
                      f"decode + {r['chunk_steps']} chunk steps; launches "
                      f"{got} (expected {want}); dropped (token, expert) "
                      f"slots: decode steps {decode_drops}, each chunk "
                      f"step [dropped, slots, capacity] {chunk_drops}; "
                      f"latent pool {kv_tok:.0f} B a token and layer "
                      f"(bf16; a GQA pool at 128 heads {gqa_b} B); "
                      f"schedule misses {r['schedule_misses']}")
                bad = []
                if r["ok"] != 8 or r["new_tokens"] != 8 * 32:
                    bad.append(f"{r['ok']}/8 ok, {r['new_tokens']} tokens")
                if got != want or not r["decode_steps"] \
                        or not r["chunk_steps"]:
                    bad.append(f"launches {got}, expected {want}")
                if counts["mpgemm_by_route"]["cuda_core"] \
                        or counts["quant_matmul_by_route"]["cuda_core"]:
                    bad.append(f"a bf16 GEMM took the CUDA-core route: "
                               f"{counts}")
                if decode_drops:
                    bad.append(f"a decode step dropped {decode_drops} slots")
                if len(chunk_drops) != r["chunk_steps"]:
                    bad.append(f"{len(chunk_drops)} chunk-step drop "
                               f"records for {r['chunk_steps']} chunk steps")
                if r["quantized_pool"] or kv_tok != latent_b:
                    bad.append(f"pool int8 {r['quantized_pool']}, "
                               f"{kv_tok} B a token and layer")
                if bad:
                    raise AssertionError(f"deepseek {tag}: " + "; ".join(bad))
                del eng
            tag = "int8" if quant else "fp"
            tx, ts = (out[f"{tag} {b}"]["tokens"]
                      for b in ("xla", "scheduled"))
            same = sum(x == y for a, c in zip(tx, ts) for x, y in zip(a, c))
            out[f"{tag} agreement"] = same / sum(len(a) for a in tx)
            print(f"deepseek {tag} greedy agreement xla vs scheduled (bf16, "
                  f"not gated): {same}/{sum(len(a) for a in tx)}")
        rep_same = out["fp scheduled"]["tokens"] \
            == out["fp scheduled repeat"]["tokens"]
        combine = [combine_repeats(cfg0, params, n) for n in (8, 2048)]
        out["repeat_tokens_equal"] = rep_same
        out["combine_repeats"] = combine
        print(f"deepseek fp scheduled run repeated on the same requests: "
              f"tokens equal {rep_same}; top-6 combine of moe_apply twice "
              f"on one input: {combine}")
        if not rep_same or not all(c["bit_equal"] for c in combine):
            raise AssertionError("deepseek: a repeat on the same inputs "
                                 "gave other tokens or another combine")
        # logits of a short prefill, finite, under both backends
        cfgs = {b: dataclasses.replace(cfg0, gemm_backend=b)
                for b in ("xla", "scheduled")}
        lx, ls = prefill_logits(cfgs, params, np.random.default_rng(5),
                                "deepseek")
        if tuple(lx.shape) != (2, cfg0.vocab) or not (
                torch.isfinite(lx).all() and torch.isfinite(ls).all()):
            raise AssertionError("deepseek logits not finite / bad shape")
        # one chunk step (8 x 256 rows) and one decode step profiled
        cfg = dataclasses.replace(cfg0, gemm_backend="scheduled")
        eng = ContinuousEngine(cfg, params, slots=8, max_len=1024,
                               prefill_chunk=MLA_CHUNK, device=dev)
        plen = 5 * MLA_CHUNK // 2
        for r in requests(np.random.default_rng(7), 8, plen, plen + 1, 16,
                          cfg.vocab):
            eng.submit(r)
        chunk = measure(eng, 1)
        eng.step()
        eng.step()
        decode = measure(eng, 5)
        out["step_profile"] = {"chunk": chunk, "decode": decode}
        for kind_, pr in (("chunk", chunk), ("decode", decode)):
            show(f"deepseek-v2 ({MLA_LAYERS}+1 layers) {kind_} step, "
                 f"scheduled", pr)
            print(f"deepseek {kind_} step: top aten ops by device time: "
                  + "; ".join(f"{k} {t:.2f} ms x{c}"
                              for k, t, c in pr["top_ops"]))
        expert_bytes = 3 * cfg.moe.n_experts * cfg.d_model \
            * cfg.moe.d_ff_expert * 2 * cfg.n_layers
        out["decode_expert_read_bound_ms"] = expert_bytes / 3.35e12 * 1e3
        print(f"deepseek decode step: the routed experts' weights "
              f"({expert_bytes / 1e9:.1f} GB) bound it at "
              f"{out['decode_expert_read_bound_ms']:.2f} ms; device time "
              f"{decode['device_ms']:.2f} ms")
        if decode["k1_launches"] or chunk["k1_launches"] \
                or decode["k1_int8_launches"]:
            raise AssertionError(f"deepseek profiled steps launched K1: "
                                 f"{decode['k1_launches']} / "
                                 f"{chunk['k1_launches']}")
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"[{card}] deepseek phase peak memory "
              f"{out['peak_gib']:.1f} GiB")
        del eng, params, qparams
        free_memory()
        out["seconds"] = time.perf_counter() - t_phase
        rep["mla"] = out

    def p_mla_small():
        """Scaled-down deepseek-v2 (MLA, 8 experts top-2, 2 shared, the
        first block; fp32) at ``FAMILY_SCALES`` (the CPU parity tests'
        x4): greedy tokens identical across backends, fp and int8 (every
        projection), on the paged engine (a shared-prefix trace), the
        dense engine and the wave; paged equal to dense; ngram
        speculation and forced copy-on-write forks give the paged
        tokens."""
        base = CONFIGS.get("deepseek_v2_236b").scaled_down()
        emb, rest = FAMILY_SCALES["deepseek_v2_236b"]
        params = N.init(base, args.seed, dev)
        params = {k: tree_map(lambda _p, a, s=(emb if k == "embed"
                                               else rest): a * s, v)
                  for k, v in params.items()}
        rng = np.random.default_rng(args.seed + 1)
        reqs = requests(rng, 4, 4, 60, 16, base.vocab, prefix=40) \
            + requests(rng, 4, 4, 60, 16, base.vocab)
        reqs = [dataclasses.replace(r, rid=i) for i, r in enumerate(
            reqs[0::2] + reqs[1::2])]
        qp = QuantPolicy(min_size=0)
        out = {}

        def toks_of(res, what):
            if not all(r.status == "ok" and len(r.tokens) == 16
                       for r in res):
                raise AssertionError(f"scaled-down deepseek {what}: a "
                                     f"request failed")
            return [r.tokens.tolist() for r in res]
        for quant in (False, True):
            qbase = dataclasses.replace(base, quant_serving=quant)
            tag = "int8" if quant else "fp"
            got, extra = {}, {}
            for b in ("xla", "scheduled"):
                cfg = dataclasses.replace(qbase, gemm_backend=b)
                eng, res, _, _c = serve(cfg, params, reqs, 2, 160,
                                        audit=True, prefill_chunk=32,
                                        quant_policy=qp)
                got[f"paged {b}"] = toks_of(res, f"{tag} paged {b}")
                extra[f"shared_token_hits {b}"] = \
                    eng.pool.stats()["shared_token_hits"]
                eng = ContinuousEngine(cfg, params, slots=2, max_len=160,
                                       paged=False, quant_policy=qp,
                                       device=dev)
                got[f"dense {b}"] = toks_of(eng.run(reqs), f"{tag} dense")
                wave = WaveEngine(cfg, params, slots=2, max_len=160,
                                  device=dev)
                got[f"wave {b}"] = toks_of(wave.run(reqs), f"{tag} wave")
                eng, res, _, _c = serve(cfg, params, reqs, 2, 160,
                                        audit=True, prefill_chunk=32,
                                        quant_policy=qp, spec="ngram",
                                        spec_k=4)
                got[f"ngram {b}"] = toks_of(res, f"{tag} ngram")
                extra[f"spec_drafted {b}"] = eng.spec_drafted
                eng = forced_forks(ContinuousEngine(
                    cfg, params, slots=2, max_len=160, audit=True,
                    prefill_chunk=32, quant_policy=qp, device=dev))
                got[f"forked {b}"] = toks_of(eng.run(reqs), f"{tag} forked")
                extra[f"cow_forks {b}"] = eng.pool.stats()["cow_forks"]
            ref = got["paged xla"]
            same = {k: v == (got["wave xla"] if k.startswith("wave")
                             else ref) for k, v in got.items()}
            distinct = [len(set(t)) for t in ref]
            out[tag] = {"identical": same, "distinct_per_request": distinct,
                        **extra}
            print(f"scaled-down fp32 deepseek-v2 {tag}, weights x{rest:g}: "
                  f"greedy tokens equal to the paged xla run's (the wave's "
                  f"to its xla run's): {same}; {extra}; distinct tokens a "
                  f"request {distinct}")
            if not all(same.values()):
                raise AssertionError(f"scaled-down deepseek {tag}: tokens "
                                     f"differ: {same}")
            if min(distinct) < 4:
                raise AssertionError(f"degenerate greedy output: {distinct}")
            if min(extra.values()) <= 0:
                raise AssertionError(f"deepseek {tag}: no shared prefix, "
                                     f"fork or draft: {extra}")
        rep["mla_small"] = out

    # -- 14. the paper's tables, on a machine without JAX ---------------------
    def p_paper_tables():
        """``repro_torch.launch.paper_tables``: every table's derived
        number equal to the value the CPU parity test holds
        (``tests/_paper_expected.py``), and its CLI."""
        from _paper_expected import DERIVED, ROWS
        from repro_torch.launch import paper_tables as PT
        got = {}
        for name in DERIVED:
            rows, derived = getattr(PT, name)()
            got[name] = derived
            ok = derived == DERIVED[name] and len(rows) == ROWS[name]
            print(f"{name}: {len(rows)} rows, derived {derived} "
                  f"{'ok' if ok else 'MISMATCH ' + str(DERIVED[name])}")
            if not ok:
                raise AssertionError(f"{name}: {derived} != "
                                     f"{DERIVED[name]}")
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.paper_tables", "all"],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        lines = [ln for ln in cli.stdout.splitlines()
                 if not ln.startswith(" ")]
        print("\n".join(lines))
        if cli.returncode or len(lines) != 1 + len(DERIVED):
            raise AssertionError(f"paper_tables CLI rc {cli.returncode}: "
                                 f"{cli.stderr[-500:]}")
        if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                       for m in sys.modules):
            raise AssertionError("the reference package or JAX was imported")
        rep["paper_tables"] = {"derived": got, "cli": lines}

    # -- 16. training: K5-bwd, scaled-down parity, full width ---------------
    #: launch counts of the mamba2-2.7b run of train_path (K5-bwd's row)
    train_launches: dict = {}

    def k5_bwd_inputs(B, nc, Q, H, G, P, N_, seed, strided=False,
                      fall=None, unaligned=False):
        """K5's operands (``ssd_tiles.path_inputs``) and a dy ~ N(0, 1);
        ``strided``: x, B and C views of one wider tensor and dy a
        permuted view; ``unaligned``: x and dy start 4 bytes past a
        16-byte boundary."""
        args_ = SSD_T.path_inputs(Q, seed, dev, B, nc, H, G, P, N_,
                                  strided=strided, fall=fall)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        if strided:
            dy = torch.randn(B, nc, Q, P, H, generator=gen,
                             device=dev).transpose(3, 4)
        else:
            dy = torch.randn(B, nc, Q, H, P, generator=gen, device=dev)
        x = args_[0]
        if unaligned:
            def shift(t):
                buf = torch.empty(t.numel() + 1, device=dev)
                return buf[1:].view(t.shape).copy_(t)
            x, dy = shift(x), shift(dy)
        return (x,) + tuple(args_[1:]) + (dy,)

    #: (label, (B, nc, Q, H, G, P, N), options): mamba2's and zamba2's
    #: training calls (seq 1024: four chunks of 256 a row, batch 4),
    #: G > 1 with a ragged head block, Q = 32, a ragged Q, strided
    #: operands, an unaligned x and dy, and cums falling by 300
    k5_bwd_cases = (
        ("mamba2 train B=4 nc=4 Q=256 H=80 N=128", (4, 4, 256, 80, 1, 64,
                                                   128), {}),
        ("zamba2 train H=112 N=64", (4, 4, 256, 112, 1, 64, 64), {}),
        ("G=2, ragged head block (7 + 6)", (8, 4, 256, 26, 2, 64, 128),
         {}),
        ("Q=32", (8, 1, 32, 80, 1, 64, 128), {}),
        ("ragged Q=100, P=24, N=40", (2, 1, 100, 8, 2, 24, 40), {}),
        ("strided views, permuted dy", (2, 2, 256, 80, 1, 64, 128),
         {"strided": True}),
        ("unaligned x and dy, P=18, N=10", (2, 1, 100, 8, 2, 18, 10),
         {"unaligned": True}),
        ("cums fall by 300", (2, 1, 256, 80, 1, 64, 128), {"fall": 300.0}))
    K5_BWD_NAMES = ("dx", "ddt", "dcums", "db", "dc")

    def p_k5_bwd():
        """K5-bwd against ``ssd_intra_chunked_bwd_ref``: every output within
        2e-4 of that output's max |.|, finite, and a repeat bit-equal;
        then the autograd Function on the card against the CPU's."""
        rows = []
        bad = []
        for n, (label, shape, kw) in enumerate(k5_bwd_cases):
            args_ = k5_bwd_inputs(*shape, seed=300 + n, **kw)
            got = SSD.ssd_intra_chunked_bwd(*args_)
            again = SSD.ssd_intra_chunked_bwd(*args_)
            want = SSD.ssd_intra_chunked_bwd_ref(*args_)
            torch.cuda.synchronize()
            errs, rel = {}, {}
            for name, g, w in zip(K5_BWD_NAMES, got, want):
                e = (g - w).abs().max().item()
                errs[name] = e
                rel[name] = e / max(w.abs().max().item(), 1e-30)
                sm.kerr["ssd_intra_bwd"] = max(sm.kerr["ssd_intra_bwd"], e)
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            plan = SSD.ssd_bwd_plan(*shape[:6])
            ok = finite and same and max(rel.values()) <= 2e-4
            rows.append({"case": label, "shape": list(shape), "kw": kw,
                         "head_block": plan.head_block,
                         "grid_main": plan.grid_main, "max_abs_err": errs,
                         "max_rel_err": rel, "finite": finite,
                         "bit_equal_repeat": same, "ok": ok})
            print(f"K5-bwd {label} {shape}: head block {plan.head_block}, "
                  f"grid {plan.grid_main}; err / max "
                  + ", ".join(f"{k} {v:.1e}" for k, v in rel.items())
                  + f"; finite {finite}, repeat bit-equal {same} "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(label)
            del got, again, want, args_
        # the Function: forward K5 and backward K5-bwd on the card against
        # the plain forward and backward on the CPU, at a small shape
        args_ = k5_bwd_inputs(2, 2, 64, 8, 2, 16, 16, seed=399)
        ins = [t.detach().clone().requires_grad_() for t in args_[:5]]
        cpu = [t.detach().cpu().requires_grad_() for t in args_[:5]]
        reset_launches()
        y = SSD.ssd_intra_chunked(*ins)
        g_dev = torch.autograd.grad(y, ins, args_[5])
        fn_counts = (SSD.launches.count, SSD.bwd_launches.count)
        y_cpu = SSD.ssd_intra_chunked(*cpu)
        g_cpu = torch.autograd.grad(y_cpu, cpu, args_[5].cpu())
        fn_rel = max(((a.cpu() - b).abs().max()
                      / b.abs().max().clamp_min(1e-30)).item()
                     for a, b in zip((y,) + g_dev, (y_cpu,) + g_cpu))
        print(f"SsdIntraChunked on the card vs the CPU: max err / max "
              f"{fn_rel:.1e}; K5 launches {fn_counts[0]}, K5-bwd "
              f"{fn_counts[1]}")
        if fn_counts != (1, 1) or fn_rel > 2e-4:
            bad.append("autograd Function")
        rep["k5_bwd"] = {"cases": rows, "function_rel_err": fn_rel,
                         "function_launches": fn_counts}
        if bad:
            raise AssertionError(f"K5-bwd mismatches: {bad}")

    def k5_bwd_bound_ms(n_seq, Q, H, G, P, N_):
        """K5-bwd's bound: x, dy, dt, cums, B, C read once and dx, d dt,
        d cums, dB, dC written once; the products of the causal pairs
        (dM and dX once a head, the scores, dC and dB once a group) in
        3xTF32 (three TF32 products each, 495 TFLOP/s), as K5's."""
        nbytes = 4 * n_seq * Q * (3 * H * P + 4 * H + 4 * G * N_)
        pairs = Q * (Q + 1) // 2
        flops = 3 * n_seq * pairs * 2 * (2 * H * P + 3 * G * N_)
        return bound_ms(nbytes, flops, "tfloat32")

    def k5_bwd_timing(flush):
        """K5-bwd at mamba2's training call beside its plain version and,
        as context, torch.autograd's backward through the plain
        forward."""
        t0 = time.perf_counter()
        shape = k5_bwd_cases[0][1]
        args_ = k5_bwd_inputs(*shape, seed=500)
        kern = time_ms(lambda: SSD.ssd_intra_chunked_bwd(*args_), 20, flush)
        plain = time_ms(lambda: SSD.ssd_intra_chunked_bwd_ref(*args_), 5,
                        flush)
        ins = [t.detach().clone().requires_grad_() for t in args_[:5]]
        y = SSD.ssd_intra_chunked_ref(*ins)
        ctx = time_ms(lambda: torch.autograd.grad(y, ins, args_[5],
                                                  retain_graph=True), 5,
                      flush)
        del y, ins
        B_, nc, Q, H, G, P, N_ = shape
        b_ms, b_by = k5_bwd_bound_ms(B_ * nc, Q, H, G, P, N_)
        plan = SSD.ssd_bwd_plan(B_, nc, Q, H, G, P)
        timing["ssd_intra_bwd"] = {
            "shape": "mamba2 training call (B 4, nc 4, Q 256, H 80, G 1, "
                     "P 64, N 128) fp32",
            "ms": kern, "plain_ms": plain, "library_ms": None,
            "library": "none (no PyTorch call computes this backward)",
            "context_ms": ctx,
            "context": "torch.autograd.grad through ssd_intra_chunked_ref "
                       "(the backward only), fp32, TF32 off",
            "bound_ms": b_ms, "bound_by": b_by,
            "head_block": plan.head_block, "grid_main": plan.grid_main}
        print(f"K5-bwd {shape}: kernel {kern*1e3:.1f} us, plain "
              f"{plain*1e3:.1f} us, autograd through the plain forward "
              f"(context) {ctx*1e3:.1f} us, bound {b_ms*1e3:.1f} us "
              f"({b_by})")
        added("timing", t0, "train")

    TRAIN_SMALL = ("qwen2_0_5b", "mamba2_2_7b", "zamba2_7b", "hubert_xlarge",
                   "deepseek_v2_236b")

    def p_train_small():
        """Scaled-down fp32 (TF32 off): the same CPU-made weights and batch
        on the card and on the CPU, for each of ``TRAIN_SMALL``: the loss
        within 1e-5 relative, every gradient leaf within 1e-4 of its max
        |g|; K5 and K5-bwd once a MAMBA2 layer on the card.  Then the
        restart drill of tests/test_system.py on the card (12 steps, a
        checkpoint every 4, a failure at step 6): the clean run's final
        loss within 1e-5 abs."""
        from repro_torch.data.pipeline import DataConfig, make_batch
        from repro_torch.launch import train as TRAIN
        from repro_torch.optim.adamw import leaves
        from repro_torch.runtime.faults import FailureInjector, RestartPolicy
        out, bad = {}, []
        for arch in TRAIN_SMALL:
            cfg = CONFIGS.get(arch).scaled_down()
            params = N.init(cfg, args.seed, device="cpu")
            batch = make_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=64,
                                               global_batch=2,
                                               seed=args.seed), 0)
            res = {}
            for where in ("cpu", dev):
                p = tree_map(lambda _p, a: a.to(where, copy=True), params)
                ps = leaves(p)
                for t in ps:
                    t.requires_grad_(True)
                reset_launches()
                loss, _m = N.loss_fn(p, cfg, {k: torch.from_numpy(v).to(where)
                                             for k, v in batch.items()})
                gs = torch.autograd.grad(loss, ps, allow_unused=True)
                res[where] = (loss.item(), [
                    (torch.zeros_like(t) if g is None else g).cpu()
                    for t, g in zip(ps, gs)],
                    (SSD.launches.count, SSD.bwd_launches.count))
            (l0, g0, _), (l1, g1, k5) = res["cpu"], res[dev]
            loss_rel = abs(l1 - l0) / abs(l0)
            grad_rel = max(((a - b).abs().max()
                            / b.abs().max().clamp_min(1e-30)).item()
                           for a, b in zip(g1, g0))
            n_ssm = sum(k is BlockKind.MAMBA2 for k in
                        cfg.pattern * cfg.n_groups_scan + cfg.tail)
            ok = loss_rel <= 1e-5 and grad_rel <= 1e-4 \
                and k5 == (n_ssm, n_ssm)
            out[arch] = {"loss_cpu": l0, "loss_card": l1,
                         "loss_rel": loss_rel, "grad_rel_max": grad_rel,
                         "k5_k5bwd_launches": k5, "mamba2_layers": n_ssm,
                         "ok": ok}
            print(f"train scaled-down fp32 {arch}: loss card {l1:.7f} cpu "
                  f"{l0:.7f} (rel {loss_rel:.1e}), worst gradient leaf "
                  f"{grad_rel:.1e} of its max; K5, K5-bwd launches {k5} "
                  f"(expected {n_ssm} each) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(arch)
        cfg = CONFIGS.get("qwen2_0_5b").scaled_down()
        base = dict(steps=12, global_batch=2, seq_len=32, ckpt_every=4,
                    log_every=100, seed=args.seed)
        logs: list[str] = []
        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2:
            clean = TRAIN.train(cfg, TRAIN.TrainConfig(ckpt_dir=d1, **base),
                                log=logs.append, device=dev)
            faulty = TRAIN.train(cfg, TRAIN.TrainConfig(ckpt_dir=d2, **base),
                                 injector=FailureInjector(fail_at_steps=(6,)),
                                 restart_policy=RestartPolicy(backoff_s=0.0),
                                 log=logs.append, device=dev)
        drill = abs(clean["loss"] - faulty["loss"])
        resumed = [ln for ln in logs if ln.startswith("[restore]")]
        print(f"restart drill on the card: clean final loss "
              f"{clean['loss']:.7f}, with a failure at step 6 "
              f"{faulty['loss']:.7f} (|diff| {drill:.1e}); {resumed}")
        out["restart_drill"] = {"clean": clean["loss"],
                                "faulty": faulty["loss"], "abs_diff": drill,
                                "resumed": resumed}
        if drill > 1e-5 or resumed != ["[restore] resumed from step 4"]:
            bad.append("restart drill")
        rep["train_small"] = out
        if bad:
            raise AssertionError(f"train_scaled_down_fp32 failed: {bad}")

    #: (arch, steps, batch, checkpoint and failure): the full-width runs
    TRAIN_PATH = (("qwen2_0_5b", 8, 8, True), ("mamba2_2_7b", 4, 4, False),
                  ("hubert_xlarge", 4, 8, False))
    TRAIN_SEQ = 1024

    def p_train_path():
        """``launch.train.train`` at full width (``N.init`` from --seed,
        bf16, remat, the xla backend, 1024-token rows): qwen2-0.5b 8 steps
        at batch 8 with a checkpoint every 4 and a failure at step 6,
        against a clean run; mamba2-2.7b 4 steps at batch 4; hubert-xlarge
        4 steps at batch 8.  Gates: finite losses, grad_norm > 0, the
        resume at the checkpointed step with its batches byte-equal to the
        clean run's and the clean run's final loss, K5 twice and K5-bwd
        once a MAMBA2 layer and step (remat: the forward and the
        recompute), K1, K2, K3 never.  Reports each model's step wall,
        device time and busy share of one profiled step, tokens/s, 6 N
        tokens / time as a share of the bf16 dense peak, peak memory, and
        the checkpoint's bytes and write time."""
        import hashlib
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.launch import train as TRAIN
        from repro_torch.optim.adamw import leaves
        from repro_torch.runtime.faults import FailureInjector, RestartPolicy
        real_step, real_batch = TRAIN.make_train_step, TRAIN.make_batch
        out, bad = {}, []

        class TimedManager(CheckpointManager):
            """Records each save's host snapshot and its write (the join)."""
            saves: list = []

            def save(self, step, tree, **kw):
                self.wait()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                super().save(step, tree, **kw)
                self.saves.append({"step": step,
                                   "snapshot_s": time.perf_counter() - t0,
                                   "t_end": None, "t0": t0})

            def wait(self):
                busy = self._thread is not None
                super().wait()
                if busy and self.saves and self.saves[-1]["t_end"] is None:
                    s = self.saves[-1]
                    s["t_end"] = time.perf_counter()
                    s["total_s"] = s["t_end"] - s["t0"]
                    d = self._step_dir(s["step"])
                    s["bytes"] = sum(f.stat().st_size
                                     for f in Path(d).rglob("*")
                                     if f.is_file()) if os.path.isdir(d) \
                        else None

        def run(arch, steps, batch, ckpt_dir=None, injector=None,
                profile_step=None):
            """One ``train`` call; per step: wall, batch digest, metrics;
            the launch counts of the whole call."""
            cfg = CONFIGS.get(arch)
            rec = {"steps": [], "batches": {}, "profile": None}

            def timed_step(*a, **k):
                inner = real_step(*a, **k)

                def step(params, opt, b):
                    i = len(rec["steps"])
                    torch.cuda.synchronize()
                    prof = None
                    if i == profile_step:
                        prof = torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA])
                        prof.__enter__()
                    t0 = time.perf_counter()
                    res = inner(params, opt, b)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    if prof is not None:
                        prof.__exit__(None, None, None)
                        dev_ms, n_k = kernel_ms(prof)
                        rec["profile"] = {
                            "wall_ms": wall * 1e3, "device_ms": dev_ms,
                            "kernels": n_k,
                            "busy_share": dev_ms / (wall * 1e3),
                            "top": top_ops(prof, 8)}
                    m = res[2]
                    rec["steps"].append({"wall_s": wall,
                                         "loss": m["loss"].item(),
                                         "grad_norm": m["grad_norm"].item()})
                    return res
                return step

            def digest_batch(cfg_, data, step):
                b = real_batch(cfg_, data, step)
                h = hashlib.sha256()
                for k in sorted(b):
                    h.update(k.encode() + b[k].tobytes())
                rec["batches"].setdefault(step, []).append(h.hexdigest())
                return b
            TRAIN.make_train_step, TRAIN.make_batch = timed_step, digest_batch
            TRAIN.CheckpointManager = TimedManager
            TimedManager.saves = []
            logs: list[str] = []
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t0 = time.perf_counter()
                final = TRAIN.train(
                    cfg, TRAIN.TrainConfig(steps=steps, global_batch=batch,
                                           seq_len=TRAIN_SEQ,
                                           ckpt_dir=ckpt_dir, ckpt_every=4,
                                           log_every=1, seed=args.seed),
                    injector=injector,
                    restart_policy=RestartPolicy(backoff_s=0.0),
                    log=logs.append, device=dev)
                torch.cuda.synchronize()
                rec["wall_s"] = time.perf_counter() - t0
                rec["launches"] = launch_counts()
                rec["launches"]["ssd_intra_bwd"] = SSD.bwd_launches.count
                rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            finally:
                TRAIN.make_train_step, TRAIN.make_batch = real_step, \
                    real_batch
                TRAIN.CheckpointManager = CheckpointManager
            rec["final"] = final
            rec["log"] = logs
            rec["saves"] = [{k: v for k, v in s.items() if k != "t0"}
                            for s in TimedManager.saves]
            rec["cfg"] = cfg
            return rec

        for arch, steps, batch, drill in TRAIN_PATH:
            t_arch = time.perf_counter()
            if drill:
                clean = run(arch, steps, batch, profile_step=steps - 1)
                with tempfile.TemporaryDirectory() as d:
                    free = shutil.disk_usage(d).free / 2**30
                    r = run(arch, steps, batch, ckpt_dir=d,
                            injector=FailureInjector(fail_at_steps=(6,)))
                r["disk_free_gib"] = free
                r["clean_final_loss"] = clean["final"]["loss"]
                resumed = [ln for ln in r["log"]
                           if ln.startswith("[restore]")]
                same_batches = all(
                    r["batches"][s][-1] == clean["batches"][s][0]
                    for s in range(4, steps))
                exact = abs(r["final"]["loss"] - clean["final"]["loss"])
                r.update({"resumed": resumed,
                          "resumed_batches_equal": same_batches,
                          "final_loss_abs_diff": exact,
                          "profile": clean["profile"],
                          "clean_steps": clean["steps"]})
                prof = clean["profile"]
                steps_run = clean["steps"]
            else:
                r = run(arch, steps, batch, profile_step=steps - 1)
                prof = r["profile"]
                steps_run = r["steps"]
            cfg = r.pop("cfg")
            n_params = sum(math.prod(d.shape) for d in leaves(
                tree_map(lambda _p, d: d, N.param_defs(cfg))))
            tokens = batch * TRAIN_SEQ
            walls = [s["wall_s"] for s in steps_run[1:]] or \
                [s["wall_s"] for s in steps_run]
            wall = sorted(walls)[len(walls) // 2]
            n_ssm = sum(k is BlockKind.MAMBA2 for k in
                        cfg.pattern * cfg.n_groups_scan + cfg.tail)
            n_steps = len(r["steps"])
            want = {"ssd_intra": 2 * n_ssm * n_steps,
                    "ssd_intra_bwd": n_ssm * n_steps, "paged_decode": 0,
                    "paged_decode_int8": 0, "mpgemm": 0, "quant_matmul": 0}
            got = {k: r["launches"][k] for k in want}
            losses = [s["loss"] for s in r["steps"]]
            gnorms = [s["grad_norm"] for s in r["steps"]]
            r.update({
                "params": n_params, "tokens_per_step": tokens,
                "step_wall_s_median": wall, "tokens_per_s": tokens / wall,
                "model_flops_share": 6 * n_params * tokens / wall / 989e12,
                "launches_expected": want, "arch_s":
                    time.perf_counter() - t_arch})
            r.pop("batches")
            out[arch] = r
            if n_ssm:
                train_launches.update(r["launches"])
            ck = r["saves"][0] if r["saves"] else {}
            print(f"[{card}] train {arch}: {n_steps} steps at batch {batch} "
                  f"x {TRAIN_SEQ}; losses {[round(v, 4) for v in losses]}, "
                  f"grad norms {[round(v, 3) for v in gnorms]}; step wall "
                  f"{wall*1e3:.0f} ms (median), {tokens / wall:.0f} tokens/s, "
                  f"6 N tokens / time {100 * r['model_flops_share']:.1f}% of "
                  f"989 TFLOP/s; profiled step device "
                  f"{prof['device_ms']:.0f} ms of {prof['wall_ms']:.0f} ms "
                  f"(busy {100 * prof['busy_share']:.0f}%, "
                  f"{prof['kernels']} kernels); peak {r['peak_gib']:.1f} "
                  f"GiB; launches {got} (expected {want})"
                  + (f"; checkpoint {ck.get('bytes', 0) / 2**30:.2f} GiB, "
                     f"snapshot {ck['snapshot_s']:.2f} s, written in "
                     f"{ck.get('total_s', float('nan')):.2f} s" if ck else ""))
            fails = []
            if not all(math.isfinite(v) for v in losses) \
                    or min(gnorms) <= 0 or not all(
                        math.isfinite(v) for v in gnorms):
                fails.append("loss or grad norm")
            if got != want:
                fails.append(f"launches {got}")
            if drill:
                print(f"  resume: {r['resumed']}; resumed batches equal to "
                      f"the clean run's {r['resumed_batches_equal']}; final "
                      f"loss {r['final']['loss']:.6f} vs clean "
                      f"{r['clean_final_loss']:.6f} (|diff| "
                      f"{r['final_loss_abs_diff']:.1e}); disk free "
                      f"{r['disk_free_gib']:.0f} GiB")
                if r["resumed"] != ["[restore] resumed from step 4"] \
                        or not r["resumed_batches_equal"] \
                        or r["final_loss_abs_diff"] > 1e-5:
                    fails.append("resume")
            if fails:
                bad.append(f"{arch}: {fails}")
            torch.cuda.empty_cache()
        rep["train_path"] = out
        if bad:
            raise AssertionError(f"train_path failed: {bad}")

    phases = (("device", p_device), ("build", p_build),
              ("k1_vs_plain", p_k1), ("k1_int8_vs_plain", p_k1_int8),
              ("k2_vs_plain", p_k2), ("k3_vs_plain", p_k3),
              ("k4_vs_plain", p_k4), ("k5_vs_plain", p_k5),
              ("k6_vs_plain", p_k6),
              ("main_path", p_main), ("quant_main_path", p_quant_main),
              ("mamba2_path", p_mamba),
              ("scaled_down_fp32", p_small),
              ("quant_scaled_down_fp32", p_quant_small),
              ("mamba2_scaled_down_fp32", p_mamba_small),
              ("limb_path", p_limb_path), ("spill_path", p_spill_path),
              ("sampled_path", p_sampled), ("policy_path", p_policy),
              ("spec_path", p_spec), ("families_path", p_families))
    family_phases = tuple((f"{a}_scaled_down_fp32", family_small(a))
                          for a in FAMILIES)
    dense_phases = (("dense_path", p_dense), ("patches_path", p_patches),
                    ("dense_scaled_down_fp32", p_dense_small))
    resilience_phases = (("resilience_path", p_resilience),
                         ("restart_path", p_restart),
                         ("resilience_scaled_down_fp32", p_resilience_small),
                         ("serve_cli_path", p_serve_cli))
    profile_phases = (("profile_path", p_profile_path),
                      ("profile_scaled_down_fp32", p_profile_small))
    moe_phases = (("ssm_quant_path", p_ssm_quant),
                  ("ssm_quant_scaled_down_fp32", p_ssm_quant_small),
                  ("moe_path", p_moe),
                  ("moe_scaled_down_fp32", p_moe_small),
                  ("paper_tables", p_paper_tables))
    mla_phases = (("mla_path", p_mla),
                  ("mla_scaled_down_fp32", p_mla_small))
    train_phases = (("k5_bwd_vs_plain", p_k5_bwd),
                    ("train_scaled_down_fp32", p_train_small),
                    ("train_path", p_train_path))
    phases += family_phases + dense_phases + resilience_phases + \
        profile_phases + moe_phases + mla_phases + train_phases + (
            ("timing", p_timing), ("step_profile", p_profile))
    only = set(args.phases.split(",")) if args.phases else None
    for name, fn in phases:
        if name != "device" and "build" in sm.failures:
            break
        if only is None or name in only or name in ("device", "build"):
            sm.phase(name, fn)
    if only is not None:
        sm.failures.append("not every phase ran (--phases)")
    # each slice's phases, and its cases inside the earlier phases, beside
    # all the rest of this run: the families since qwen1.5, then the dense
    # path (dense_path, patches_path, dense_scaled_down_fp32)
    slices = {"families": {"families_path"} | {n for n, _ in family_phases},
              "dense": {n for n, _ in dense_phases},
              "resilience": {n for n, _ in resilience_phases},
              "profile": {n for n, _ in profile_phases},
              "moe": {n for n, _ in moe_phases},
              "mla": {n for n, _ in mla_phases},
              "train": {n for n, _ in train_phases}}
    secs = {n: v["seconds"] for n, v in rep["phases"].items()}
    rep["time_split"] = {}
    for sl, names in slices.items():
        t_phases = sum(v for n, v in secs.items() if n in names)
        t_cases = sum(added_s[sl].values())
        t_new = t_phases + t_cases
        t_old = sum(secs.values()) - t_new
        rep["time_split"][sl] = {"phases_s": t_phases,
                                 "cases_s": added_s[sl], "total_s": t_new,
                                 "other_s": t_old,
                                 "added_share": t_new / max(t_old, 1e-9)}
        ran = ", ".join(f"{n} {secs[n]:.1f}" for n in sorted(names)
                        if n in secs)
        cases = ", ".join(f"{n} {v:.1f}" for n, v in added_s[sl].items())
        print(f"time split, {sl}: its phases ({ran}) {t_phases:.1f} s, its "
              f"cases in earlier phases {t_cases:.1f} s ({cases}); "
              f"everything else {t_old:.1f} s "
              f"(+{100 * t_new / max(t_old, 1e-9):.1f}%)")

    # launches: each kernel's count in the scheduled run of its main path
    # -- the fp run for K1 and K2, the int8 run for K1-int8 and K3, the
    # mamba2 run for K5 (each backend's counts are in the report) -- K4's
    # in limb_path and K6's in spill_path
    kernels = []
    fp_run = main_launches.get("scheduled", {})
    int8_run = quant_launches.get("scheduled", {})
    for name, src, repl, counts in (
            ("paged_decode", K1_SOURCE, K1_REPLACES, fp_run),
            ("paged_decode_int8", K1_SOURCE, K1I_REPLACES, int8_run),
            ("mpgemm", K2_SOURCE, K2_REPLACES, fp_run),
            ("quant_matmul", K3_SOURCE, K3_REPLACES, int8_run),
            ("limb_gemm", K4_SOURCE, K4_REPLACES, limb_launches),
            ("ssd_intra", K5_SOURCE, K5_REPLACES,
             mamba_launches.get("scheduled", {})),
            ("mpgemm_spill", K2_SOURCE, K6_REPLACES, spill_launches),
            ("ssd_intra_bwd", K5B_SOURCE, K5B_REPLACES, train_launches)):
        t = timing.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": counts.get(name, 0),
                        "max_abs_err": sm.kerr[name],
                        "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
                        "bound_ms": t.get("bound_ms"),
                        "bound_by": t.get("bound_by"),
                        "library_ms": t.get("library_ms")})
    rep["timing"] = timing
    rep["kernels"] = kernels
    rep["failures"] = sm.failures
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rep, indent=1, default=str) + "\n")
    print(card)
    print(json.dumps({"kernels": kernels}))
    if sm.failures:
        print(f"chip_smoke: FAILED phases {sm.failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
