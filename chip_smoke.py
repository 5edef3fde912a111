#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py [--n 1000000] [--bootstrap-replicates 100]
                          [--out results.json] [--phases a,b,...]

``--phases`` runs only the phases whose names equal or start with one of
its comma-separated entries (``--phases lm_serve:arctic-480b``,
``--phases kernels:flash,lm_serve:deepseek``); a phase that takes
another's output (``lm_serve:granite-3-2b`` the model of
``backbone:granite-3-2b``, ``kernels:dr-forms`` ``dr:fit``'s residuals)
is skipped unless that one is selected too.  With no option every phase
runs, as the contract's run does.  The record lists the phases that ran.

Phases (each failure makes the script exit non-zero):

  1. the card (name and power limit, as nvidia-smi reports them), the
     torch/CUDA versions, and the build of every kernel from source (one
     thread per source, each running its nvcc, all started together);
  2. every kernel against its plain PyTorch version at the main path's
     shapes: error of each against an fp64 computation, kernel and plain
     times (CUDA events, L2 flushed between runs; a seg_gram kernel's
     launches replayed from a CUDA graph, so that the wrapper's Python
     does not count as the card's time), one library call
     (``torch.matmul``) timed as a yardstick, and the least time the
     card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s
     fp32; a symmetric Gram counts its q(q+1)/2 distinct entries);
  3. the kernel's bitwise invariants on the card, and the large tile's
     symmetric Grams bitwise equal to their transposes;
  4. a small fit on the card against the same fit on the CPU;
  5. the main path at full width — ``paper_demo_data`` then ``DML.fit``
     plus the delete-fold jackknife — on the "parallel", "parallel_loo"
     and row_block=0 paths, each with the launch counters set to 0 just
     before and read just after, the fallback counters held at 0, and
     theta = [1, 0.5] recovered within 5 se (the larger of the jackknife
     and the HC0 sandwich se);
  6. flash attention against its plain version at the backbone's shape
     (q (256, 256, 32, 64) in the model's (B, S, H, D) layout, k/v with
     8 KV heads, causal) in bf16 (the tensor-core template, the
     backbones') and fp32 (the CUDA-core template), and at two small
     shapes (fp32; softcap): error against fp64 (bf16: at most 1.1 x
     plain's), bf16's share of o bitwise equal to plain's (>= 0.99: p
     rounded to one bf16 would move a third of it), kernel / plain / SDPA
     times and the bound (bytes over 3.35 TB/s, or the two products'
     FLOP under the causal half over the 989 TFLOP/s bf16 tensor-core
     peak, 67 TFLOP/s for fp32, the larger); one record per template;
  7. the LM-backbone main path — granite-3-2b at full width and depth,
     port init from the seed, 8,192 event sequences of 256 events,
     ``backbone_features(batch_size=256)`` -> standardize -> ``DML.fit``
     + jackknife on the "parallel" engine (row_block 4096, "pallas") —
     with the launch counters set to 0 just before and read just after
     (flash 40 x 8192/256; seg_gram design 1, gram_and_vec 16,
     residual 1, residual_meat 1; fallbacks 0), finite theta/cov, and
     the first 512 users' features through the kernel against the same
     run through the plain attention;
  8. the seg_gram kernel's design and gram_and_vec forms on the
     backbone path's own features (q = 2049, k = 5);
  9. the scan kernels against their plain chunked versions and an fp64
     naive oracle (first 32 batch rows): GLA in bonus and post modes at
     rwkv6-3b's batch (256 x 40 heads x 256 x 64, bf16 r/k/v as
     strided (B, T, H, D) views, fp32 w and u, all random), an fp32 case
     and T = 200 (the chunk halved to 8); SSD at zamba2-1.2b's batch
     (256 users x 64 heads x 256 x 64, fp32, strided v and a) and
     T = 200; the main-path shapes must run the tiled form, and it must
     equal the generic form byte for byte there; kernel / generic /
     plain times and the bound (bytes over 3.35 TB/s, or the
     causal-triangle FLOP over 67 TFLOP/s fp32, the larger);
 10. the same backbone path as 7 for rwkv6-3b (32 layers, d 2560, GLA
     1,024 launches) and zamba2-1.2b (38 mamba layers + the shared
     attention block 7 times: SSD 1,216, flash 224), every scan launch
     on the tiled form (``LAUNCHES`` by form), each model freed
     before the next, the features gate through the plain scans (gated
     end to end for granite and rwkv6: see FEAT_GATED), and on all three
     a per-block gate — every block applied to the kernel run's own
     hidden states through the kernels and through the plain versions;
     and seg_gram's heads forms at rwkv6's q = 2561.

 11. ``kernels:inference-forms``: the bootstrap chunk's seg_gram forms at
     ``paper_demo_data(n=100_000, p=500)`` and R = 25 replicates of pairs
     draws — fold_weighted (R·k = 125, q = 502), residual_direct and the
     batched residual_meat — against their plain versions and fp64, with
     kernel / plain / library times and the bound;
 12. ``main:bootstrap``: ``DML.fit`` + ``ate_interval()`` +
     ``cate_interval(X[:5])`` with the default inference (pairs
     bootstrap, executor "vmap") at that scale, B = 100 (EconML's
     default; ``--bootstrap-replicates 200`` runs the config default) in
     chunks of 25, launches counted around it (per chunk: fold_weighted
     1 + 2·16, residual_direct 1, residual_meat 1; the point fit's 19),
     no fallback, theta within 5 se of [1, 0.5], bootstrap se within
     0.6–1.6 of the HC0 se, and the batched solves' share of the phase;
 13. ``main:bootstrap-agreement``: at n = 20,000 × 50, four replicates
     on given folds and weights on the card against the CPU (1e-4),
     serial against batched executors on the card (bitwise), and eight
     multiplier replicates card against CPU (1e-4);
 14. ``iv:orthoiv``: ``make_iv_data(n, 500)`` and OrthoIV with the
     jackknife (launches design 1, gram_and_vec 32, iv 1, iv_meat 1,
     iv_segmented 1), the LATE within 5 se of the truth; then
     ``kernels:iv-forms`` on its residuals (iv, iv_segmented S = 5,
     iv_meat); and ``iv:bootstrap`` at n = 100,000 with B = 16 (the fit's
     launches plus fold_weighted 65, iv 1 and iv_meat 1 per chunk).

 15. ``kernels:pair-forms``: the segment walk (``segment_outer``'s pair
     form, and every S > 1 form) at the sweep's and the store's shapes —
     MM terms t1 (2^20 × 5 by 2^20 × 501, S = 64) and t2 (1 × 501,
     S = 320), fold_gram's design (q = 502, S = 320), the final stage
     (2 × 2, S = 64), the store's ng (2^18 × 503) and vg (2^18 × 1006),
     seeded with a first day's Grams, S = 320 — against plain and fp64,
     with the time of init's symmetry check beside, kernel / plain /
     library (one ``torch.bmm`` over the rows sorted by segment and
     zero-padded) times and the bound; ``invariants:pair`` (bitwise:
     repeat, appended seg = -1 and zero rows, an empty segment, two
     seeded ingests against one pass) on each pair kernel: the large
     tile at the store's width, the thin kernel at the MM terms' 1 and
     5 x 501, the small kernel at the final stage's 2 x 2;
 16. ``sweep:segmented``: ``sweep(SweepSpec(64, (("dml", SWEEP),)),
     mode="segmented")`` at ``paper_demo_data(2^20, 500)`` with uniform
     segment ids (the reference sweep cell's E, n and p; "pallas",
     row_block 65536), launches counted (design_segmented 2, pair
     2·32 + 2) and walk plans made (4: each of the two id tensors once
     per kernel that walks it), every segment's ATE within 5 se of 1,
     the seconds, peak
     memory and the MM solves' share; a small sweep card vs CPU (1e-4);
 17. ``store:ingest``: five daily ingests of 2^18 rows of
     ``make_causal_data(5·2^18, 500, continuous t)`` into a 64-segment
     store (k = 5, cate_features 2: ng (320, 503, 503), vg (320, 1006,
     1006)), snapshots at days 3 and 5 in a temporary directory under
     ``build/``, the refresh, launches (pair 10), every ATE within 5 se
     of the truth, a one-shot ingest bitwise the incremental one, the
     day-3 snapshot bitwise a store of days 1-3; a small store card vs
     CPU (1e-4) and aligned "chunked" partitions bitwise on the card.

 18. ``dr:fit``: ``DRLearner`` on the tables' data and configuration
     (k = 5, basis [1, x0], "pallas"), launches counted (fold_weighted
     2 + 2·16 for the two arms and the propensity, design 1 for the
     pseudo-outcome regression), the ATE within 5 se of the truth, a
     small fit (n = 4096, p = 16) card vs CPU (1e-4); then
     ``kernels:dr-forms`` (fold_weighted at k = 5 and the q = 3 design
     against plain, fp64 and ``torch.matmul``);
 19. ``dr:bootstrap``: the same at n = 100,000 with its pairs bootstrap,
     B = 32 (cut from 200 for time) in chunks of 25: seconds per
     replicate, fold_weighted's share, the bootstrap se of the ATE within
     0.6–1.6 of the analytic se, launches, serial ≡ batched bitwise on 2
     replicates;
 20. ``driv:fit`` on ``iv:orthoiv``'s data: launches, the LATE within 5
     se of the truth and of OrthoIV's, the jackknife refused, a small fit
     card vs CPU (1e-4); ``kernels:driv-forms`` (iv and iv_meat at
     phi = 1 on the same residuals); ``driv:bootstrap`` at n = 100,000,
     B = 16 (launches, serial ≡ batched);
 21. ``serve:effects``: the store's 64-cohort panels — day 5 from the
     refresh (equal to its snapshot's), day 3 through
     ``panel_from_checkpoint`` — serving 2^19 requests (cut from 2^20
     for time) through
     ``EffectServer`` waves of (8, 64): requests per second and the
     server's own wave and request p50 / p99, every wave bitwise
     ``score_single`` on a sample of 1,024 requests, padded slots
     flagged, a hot-swap to day 5 and a rollback bitwise day 3's scores;
 22. ``trace``: the sweep and the store's ingests again with a
     ``Tracer``, bitwise the untraced runs, the span names and rollup
     printed and a Chrome trace written to
     ``build/chip_smoke_trace.json``.

 23. the task runtime, the refutation suite, the sweep's cells mode and
     jobs (every phase before and after reports 0 retry and 0 downgrade
     events of the runtime; ``runtime:downgrade`` exactly one of each):
     ``crossfit:executors`` — ``DML.fit`` at the tables cell on the
     "parallel" engine, the "sequential" one (the fold axis through the
     serial executor: one-fold batches, within 1e-4) and a traced
     ``TaskRuntime("vmap")`` (bitwise "parallel"), times and spans;
     ``refute:tables`` — ``run_all`` at the tables cell, 3 refits a
     refuter, traced: each report with its seconds (its ``dag.task``
     span), every refuter passing, the base ATE within 5 se of 1; then
     ``kernels:refute-forms`` (fold_weighted at random_common_cause's
     q = 503 with k = 5, and at R·k = 15 over 1M rows); ``runtime:budget``
     — the DML bootstrap at n = 100,000, B = 32: the memory model probed
     on the card, the budget set to its peak at 10 replicates, the
     budgeted run traced as a call node of the runtime's DAG: base,
     slope, the chunk it picks (< B), each chunk's predicted and
     measured peak (<= 1.10 x the budget), replicates bitwise an
     explicit ``runtime_chunk`` run's; ``runtime:downgrade`` — the same
     bootstrap on an executor defined here whose first map call fails:
     one downgrade to serial, bitwise; ``refute:iv`` —
     ``placebo_instrument`` and ``weak_instrument`` on OrthoIV's fit at
     ``make_iv_data(1_000_000, 500)``; ``quickstart`` —
     ``examples/torch_quickstart.py``'s main; ``examples:iv``,
     ``examples:store``, ``examples:sweep`` — the main of
     ``examples/torch_{iv,store,sweep}_demo.py`` at the reference demos'
     sizes (IV 8,000 x 10 with B = 200; 5 days x 4,096 rows x 10, 8
     segments; 16,384 x 10, 16 segments, B = 32), each with the launch
     counters set to 0 just before and read just after, the seg_gram
     launches by form equal to ``EXAMPLE_LAUNCHES`` (the route of the
     CPU run, counted before the first card run), fallbacks 0, every
     launch made through ``seg_gram.ops.seg_reduce``, whose first call of
     each (form, output shape, rows) is held against its plain version
     in fp64 within ``EXAMPLE_KERNEL_TOL``: the
     OrthoIV LATE within 5 se of the truth and both intervals finite
     around it; the store bitwise a from-scratch refit on every day; the
     cells panel bitwise the serial loop, every valid segment's ATE
     finite; ``trace:runtime`` — the
     budgeted run traced ≡ untraced bitwise, its Chrome trace
     (``build/chip_smoke_runtime_trace.json``) strict JSON with
     ``runtime.chunk`` and ``dag.task`` spans and audit rows;
     ``sweep:cells`` — ``sweep(mode="cells")`` at 32 segments (cut
     from the sweep cell's 64 for time) x 500 at 2^18 rows (cut from
     2^20 for time), the dml and
     drlearner columns under a budget that chunks them (the dml cells'
     memory model probed on the card, at its peak for 8 cells): chunk,
     peak and seconds per column, every segment's ATE within 5 se of 1,
     the largest |cells - segmented| ATE in se (no gate), a small cells
     sweep card vs CPU (1e-4), ``with_ci`` (16 segments x 2^14 rows —
     cut from 2^16 for time —, B = 8, cut from 16) bitwise at two chunk
     sizes,
     ``serial_loop`` bitwise cells
     (8 segments); then ``kernels:cells-forms`` (fold_weighted at the
     chunk the budget picked); ``jobs`` — ``JobManager.submit`` of a
     two-column cells spec (16 segments x 2^16 rows): the subscribed
     events, the panel bitwise a direct sweep's.

 24. the metalearners, the mlp nuisance and tuning (slice 11; no phase
     catches its own failure, the fallback counters stay 0):
     ``meta:fit`` — ``s_learner``, ``t_learner``, ``x_learner`` at the
     tables cell ("pallas", row_block 4096), fold_weighted launches by
     (weight rows, q) around each (S 1 at q = 1003; T 2 at q = 502; X
     20 at q = 502 and 16 at q = 501), each ATE within 0.02 of 1, a small
     fit of each card vs CPU (1e-4); then ``kernels:meta-forms``
     (fold_weighted at one weight row, q = 1003, 502 and 501);
     ``tune:penalty`` — ``tuned_nuisances`` at the tables cell (4 λ × 5
     folds a grid: one ``map_product``, design 1 and gram_and_vec 16 at
     20 weight rows), DML on the winners within 5 se of [1, 0.5], a
     small grid's scores card vs CPU (1e-4) and its winners equal; then
     ``kernels:tune-forms`` (design and gram_and_vec at R = 20);
     ``meta:bootstrap`` — each learner's ``ate_interval`` at n = 100,000,
     B = 32 (cut from 200 for time) in chunks of 8: launches by shape,
     the bootstrap se finite, the truth within 5 se, serial ≡ batched
     bitwise on 2 replicates; then ``kernels:meta-boot-forms``
     (fold_weighted at the chunk's 8 weight rows, q = 502, 501 and 1003;
     each record counts the launches of its own shape); ``tune:halving`` —
     ``successive_halving("reg")`` at n = 100,000 × 500 (cut from 1M for
     time), 8 learning rates, the reference's defaults (3 folds,
     hidden (64,), base 25 steps, eta 2, 3 rungs): survivors 4, 2, 1,
     and a small input's survivor sets on the card equal the CPU's;
     ``mlp:dml`` — ``DML.fit`` with mlp outcome and treatment nuisances
     (hidden (256, 256), 200 steps) at n = 100,000 × 500 (cut for time)
     on the "parallel" engine: theta finite, its distance from [1, 0.5]
     reported (these defaults overfit the noise columns, in the
     reference too), the same fit on the "sequential" engine with
     bitwise the same out-of-fold predictions, and a small mlp DML
     (3000 × 200, hidden (32, 32)) card vs CPU (1e-3).

 25. LM serving (slice 12), ``lm_serve:<arch>`` right after each
     ``backbone:<arch>``, on the model that phase built (full width and
     depth): ``launch/serve.py``'s ``BatchServer`` serves a wave of 8
     greedy requests (prompts of 96–128 tokens drawn from the seed,
     left-padded to 128, 32 new tokens each, a cache of 256 positions),
     then a wave of eight 128-token prompts, and its first request
     alone.  Gates: each wave's prefill launches exactly the model's
     kernels once per block (granite flash 40; rwkv6 GLA 32; zamba2 SSD
     38 and flash 7; scans on the tiled form) and its decode steps none,
     no fallback; block by block on the serving run's own hidden states
     (``_serve_block_errors``: each block's residual halves), the
     prefill through the kernels against the plain versions (output and
     every cache leaf, the scans' fp32 final states too), each decode
     step against the half's train form at that position, and one row
     alone against its row in the batch; end to end (gated for
     granite and rwkv6, printed for zamba2), the prefill's last-token
     logits and cache leaves against the plain versions, teacher-forced
     decode logits (the wave's own tokens) against ``train_hidden`` +
     ``_logits`` over the whole sequence, and the wave's row against
     the request alone up to the first token where they part.  Printed
     with the card's name and power limit: prefill ms, decode ms a step,
     tokens/s of the wave, the solo request's latency, the time to cast
     the weights once, peak device memory.  The served launches enter
     the flash and scan records' ``launches_by_path`` as
     ``lm_serve:<arch>``.

 26. the data mesh (slice 13), after the tables phases: ``mesh:ranks``
     spawns 4 ranks on cuda:0 (``launch/dist_smoke.spawn_ranks``; a gloo
     world, rank 0 alone in an nccl group — one card takes no second
     nccl rank — the kernels built here first), which run
     ``mesh:reduce`` — weighted_gram (q 502) and fold_gram (S 5) at 1M ×
     500, "pallas", 131,072 rows a block, one seg_gram launch a block on
     its rank: bitwise across 1 (nccl), 2 and 4 (gloo, the accumulators
     staged through host memory) ranks, within 1e-5·max + 1e-6 of one
     kernel pass, psum within 1e-5 of ordered —; ``mesh:dml`` — the
     tables cell's fit + jackknife at that block size on 2 ranks bitwise
     the 1-rank fit, within 1e-4 of the fit with no mesh, theta within 5
     se —; ``mesh:ladder`` — a DML bootstrap at 100k × 500, B = 32 in
     chunks of 8 under ``TaskRuntime(data_mesh=)`` on 2 ranks (one block
     each), once healthy and once with one injected lost shard: one
     retry and one downgrade, replicates bitwise —; ``mesh:shard_map`` —
     the same 32 replicates split over 4 ranks, bitwise the vmap
     executor's.  Each prints its seconds, backend, ranks, seg_gram
     launches per rank and the accumulator bytes that crossed the group
     (beside the rows' bytes); the launches enter the seg_gram records'
     ``launches_by_path`` as ``mesh:<phase>``;
 27. the mesh's consumers and the paper's cells as steps (slice 14), on
     the same ranks: ``mesh:sweep`` — a cells sweep (dml and drlearner
     columns) of 16 segments × 2^17 rows × 500, 65,536 rows a block, on
     2 ranks bitwise the 1-rank (nccl) panel, within 1e-4 of the panel
     with no mesh, every dml ATE within 5 se —; ``mesh:shard_map-sweep``
     — a dml column's cells split over 4 ranks, bitwise the vmap
     column —; ``mesh:resume`` — a lost shard with no retry budget fails
     its column alone, its neighbour bitwise the healthy mesh run (the
     job below), and a re-run restores the neighbour and recomputes that
     column bitwise; ``elastic_sweep`` twice, the second restoring —;
     ``mesh:jobs`` — a threaded ``JobManager.submit(data_mesh=)`` of
     that spec, its events and its panel bitwise the re-run's —; ``mesh:store`` — 64 cohorts,
     2 days of 2^18 rows: 2 ranks bitwise 1, one-shot bitwise two
     ingests, within 1e-5·max + 1e-6 of the store with no mesh —;
     ``cell:dml`` / ``cell:iv`` — ``launch/dml_cell``'s steps at 2^20 ×
     500 with no mesh bitwise ``DML`` / ``OrthoIV``'s fit on the same
     folds, on 2 ranks within 1e-4 of it, theta within 5 se; then, in
     this process, ``cell:sweep`` — ``launch/sweep_cell``'s segmented
     step at 2^20 × 500 × 64 (every segment within 5 se) and its cells
     step at 2^16 × 8 (32,768 rows a block) bitwise ``serial_loop``.
     Every rank of every mesh phase must launch seg_gram.

 28. the other decoder-only families (slice 15), ``lm_serve:<arch>`` after
     the backbones, each on a model built for it (``family_model``) at
     its published widths in fp32 parameters: phi4-mini-3.8b (partial
     NeoX RoPE) and chatglm3-6b (interleaved RoPE on half the head) at
     full depth, yi-34b cut to 8 of 60 layers, arctic-480b to 1 of 35
     (all 128 experts), deepseek-v3-671b to 2 of 61 (one dense layer,
     one MoE layer with all 256 experts, MLA), the cut stacks' weights
     rescaled to the full depth's init std; the cuts are printed and
     recorded (``reduced``) before the serving run.  Each serves
     ``phase_lm_serve``'s waves with its gates; the prefill's flash
     launches must all run at the model's head dims (deepseek-v3: q.k
     192, v 128); the MoE blocks print their dropped picks (prefill,
     train form; decode must drop none), the share of tokens whose
     expert set differs between the kernel and plain runs (at most
     MOE_FLIP_MAX) and the block's error on the other tokens (at most
     MOE_BLOCK_TOL), and the train and solo gates of a MoE half skip
     the tokens whose routing parted or whose picks dropped.
     ``kernels:flash`` also holds the (192, 128) kernel against plain
     and fp64 at deepseek-v3's prefill wave (8 x 128 tokens, 128 heads),
     bf16 and fp32, with SDPA's time where it takes Ev != E.

 29. the families with extras (slice 16), ``lm_serve:whisper-tiny`` and
     ``lm_serve:pixtral-12b`` after them, whole at their published widths
     and depths in fp32 parameters and bf16 compute: whisper's waves
     take 1500 frames a request (0.1 · normal from the seed), its
     encoder's 4 layers run the flash kernel bidirectionally at Sq = Sk =
     1500 and its decoder's 4 causally, its cross-attention dense over
     the encoder's K/V; pixtral's take LM_PATCHES patch embeddings a
     request over the front of the left-padded prompt.  The per-block
     gates walk whisper's encoder halves (attention, MLP: ``plain`` and
     ``solo``) and its decoder halves (self, cross, MLP: all three
     gates); each prefill's flash launches are counted by form
     (bidirectional, causal).  ``kernels:flash`` also holds the kernel
     against plain and fp64 at whisper's encoder form (8 x 1500 frames,
     6/6 heads x 64, bf16, bidirectional), with SDPA's time.

 30. LM training (slice 17), after the families: ``kernels:flash-train``
     holds the flash route under autograd in bf16 at granite-3-2b's
     causal 8 x 1024 (32/8 heads x 64), deepseek-v3's MLA (q.k 192, v
     128) at 2 x 1024 x 128 heads and whisper-tiny's bidirectional 8 x
     1500 frames: o with the LSE bitwise o without, the LSE within 1e-3
     of the plain fp32 logsumexp, (dq, dk, dv) through
     ``ops.flash_attention`` (the kernel's forward, the plain blocked
     backward) within 1e-2·max of autograd through the plain version in
     fp32; it times the forward with the LSE, the plain backward, and
     SDPA's forward and forward + backward (the ``flash_attention[lse]``
     record, its ``backward`` the plain backward's, not a kernel).
     ``lm_train:granite-3-2b`` trains the whole model (40 layers, d
     2048, vocab 49155) through ``launch/train.make_train_step``: batch 8
     x 1024 in 2 microbatches, remat "nothing", fp32 master weights and
     AdamW moments, one warm step and 8 timed on a ``ShardedFeed`` on
     the card; gates: finite losses and grad norms, the last loss below
     the first, 160 flash launches a step all with the LSE, and the
     first batch's loss and grad norm through the flash route within
     1e-2 / 5e-2 of ``attention_impl="chunked"``'s from the same init.
     ``lm_train:whisper-tiny``
     trains the whole model on 8 x 128 tokens over 1500 frames a row for
     3 timed steps (flash bidirectional in its encoder under autograd;
     finite losses and grad norms, 16 launches a step with the LSE).
     Printed with the card's name and power limit: ms a step, tokens/s,
     peak GiB, flash launches a step.

 31. the scans under autograd (slice 18), after ``kernels:flash-train``:
     ``kernels:scan-train`` runs ``ssm_scan.ops``'s Functions (the
     kernel's forward, the plain fp32 backward ``gla_bwd_chunks`` /
     ``ssd_bwd_chunks``) at one microbatch of 4 x 1024: rwkv6-3b's GLA
     bonus (40 heads x 64, bf16 r/k/v, fp32 w and u, chunk 16) and
     zamba2-1.2b's SSD (64 heads, N = P = 64, fp32, chunk 32), in the
     models' (B, T, H, D) views.  Gates: the kernel's o and state
     within SCAN_TOL of the plain chunked scan (with the fp64 naive
     oracle printed), one launch under grad, o and
     the state bitwise the no-grad launch's; each gradient before the
     cast within 1e-4·max of autograd through the plain chunked scan in
     fp32 on the card, and the Function's bf16 gradients one bf16 step
     (2^-7 of the element) more; times (CUDA events) of the kernel's
     forward, the plain backward (its bound twice the forward's
     products, at 67 TFLOP/s fp32) and plain autograd forward + backward
     (the
     ``gla[bonus]@train`` / ``ssd@train`` records, ``backward`` the
     plain backward's, not a kernel).  ``lm_train:rwkv6-3b`` (32 layers,
     d 2560, vocab 65536) and ``lm_train:zamba2-1.2b`` (38 mamba layers
     and the shared attention block after each 6, d 2048) train whole
     as granite does (8 x 1024 in 2 microbatches, remat "nothing",
     fp32 masters and moments, a ``ShardedFeed`` on the card), one warm
     step and 12 timed (rwkv6: its init's u gradient carries the grad
     norm for about two steps) or 5 (zamba2); gates: finite losses and
     grad norms, the last loss below the first, GLA 128 launches a step
     (2 x 32 x 2) and SSD 152 (2 x 38 x 2) with zamba2's shared block's
     14 flash launches with the LSE, every scan launch through its
     Function, the first batch's loss and grad norm through the scan
     kernels within 1e-2 / 5e-2 of autograd through the plain chunked
     scans from the same init, and every gradient leaf of both against
     the plain route in fp32 compute: the kernel route's error (·the
     leaf's max) within 2 x the plain route's + 1e-3 (granite's flash
     and chunked routes too).  Printed with the card's name and power
     limit: ms a
     step, tokens/s, peak GiB, launches a step by kernel.

 32. the production tooling (slice 19): each of granite-3-2b's,
     rwkv6-3b's and zamba2-1.2b's ``lm_train`` phases ends with one more
     step under ``launch/op_cost.count`` (``_counted_step``): its
     counted flops and bytes, launches by kernel (the wrappers'
     ``charge``), the one-card ``Roofline`` (t_compute, t_memory,
     step_time), ``model_flops_for`` at (8, 1024), useful_frac and the
     mfu of the median measured step (at 989 TFLOP/s bf16).  Gates: the
     counted launches equal LAUNCHES' for the step and
     LM_COUNTED_LAUNCHES (flash 160; GLA 128; SSD 152 + flash 14),
     step_time at most the median measured step, useful_frac inside
     LM_USEFUL_BAND (fixed from the config before any measurement).
     ``dryrun:production`` runs ``python -m repro_torch.launch.dryrun``
     on the host's CPU in two background processes started after the
     builds (a fake default group of 512 ranks cannot share this
     process with the mesh phases'): granite-3-2b/train_4k on the
     (16, 16) mesh and deepseek-v3-671b/decode_32k on (2, 16, 16) at
     published widths.  Gates: exit 0 and status ok; rank 0's parameter
     bytes equal those the cell's specs give; the peak at most 80 GiB;
     the collectives by op printed.

 33. the elastic re-mesh and the paper's cell on a device mesh (slice
     20), on a default group of this process alone (NCCL, one rank):
     ``elastic:remesh`` — granite-3-2b at full width, ELASTIC_LAYERS of
     its 40 layers, ``ParallelConfig(fsdp=False)`` with the flash
     kernel, ELASTIC_BATCH x ELASTIC_SEQ tokens: ELASTIC_STEPS steps
     with no mesh, a save, ``elastic_restore(..., rules,
     make_host_mesh())`` and ELASTIC_STEPS more under the mesh (batches
     placed by ``batch_sharding``), against 2 x ELASTIC_STEPS steps
     with no mesh from the same init.  Gates: every restored leaf a
     DTensor placed as ``state_shardings`` says (printed by placement)
     and bitwise the leaf saved, the first ELASTIC_STEPS losses
     bitwise, every later loss within
     ELASTIC_LOSS_TOL of the uninterrupted run's, the flash kernel
     launched in every step, as many times under the mesh as without.
     ``cell:dml-mesh`` — ``make_dml_step`` ("parallel", row_block
     65536, "pallas") at 2^20 x 500 on inputs placed by
     ``dml_cell.row_sharding`` on the host mesh (each moments pass a
     seg_gram launch on the rank's rows, then an all-reduce) against the
     same step with no mesh.  Gates: theta and cov within DML_MESH_TOL ·
     max (bitwise printed), the same seg_gram launches by form,
     fallbacks 0.  ``dryrun:paper-cell`` runs ``python -m
     repro_torch.launch.dryrun --paper-cell --mesh both`` and
     ``dryrun:smoke-2.11`` the rwkv6-3b / zamba2-1.2b ``-smoke`` train
     and prefill cells and arctic-480b-smoke's train cell, in the
     background (started after the mesh ranks, whose gloo work is the
     host's), on the host's torch.
     Gates: exit 0; 4 paper-cell records ok, each rank's argument bytes
     its row shard's (X 2^20 / 256 x 500 x 4 B on the single pod), an
     all-reduce and no other collective; the 5 smoke records ok.

Every seg_gram record also names the kernel that ran (``design``:
small, thin or big) and times its second pass alone (``reduce_ms``)
and, for a segment walk, its plan alone (``plan_ms``; ``ms`` has the
plan cached, as the sweep's repeated walks do).

The backbone phases are named ``backbone:<arch>``, the serving phases
``lm_serve:<arch>``.  The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints
no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, fp32 outside tensor cores
BF16_TC_FLOP_PER_S = 989e12    # H100 SXM data sheet, dense bf16 tensor cores
KERNEL_TOL = 1e-4              # |kernel - plain| / max|plain|
# flash attention: max|kernel - plain| / max|plain|.  fp32: sums in
# another order.  bf16: both round an fp32 value to bf16 -- the kernel's
# from bf16 q.k products summed in fp32 and p carried as bf16 hi + lo
# (~2^-16 relative) -- so they part by one bf16 step (2^-8 relative)
# where a sum straddles a rounding boundary.
FA_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# bf16 (tensor cores, p as bf16 hi + lo ~ p to 2^-17): the least share of
# o bitwise equal to plain's, and the most its error against fp64 may
# exceed plain's; p rounded to one bf16 (~2^-9) moves a large share of o
# (tests/test_torch_cuda.py::test_flash_bf16_tensor_cores_match_plain)
FA_BF16_SAME, FA_BF16_FP64_RATIO = 0.99, 1.1
# backbone features, kernel vs plain attention: max|diff| / max|feature|.
# Each of the 40 layers rounds its attention output to bf16, and a sum
# that straddles a rounding boundary flips one bf16 step (2^-8 of that
# element); the pooled features are themselves rounded to bf16, so one
# step of the largest feature is 3.9e-3.  2e-2 allows ~5 such steps.
FEAT_TOL = 2e-2
# The same gate per block: each block of the path applied to the kernel
# run's own hidden states through the kernels and through the plain
# versions.  Both round the block's output and then the residual sum to
# bf16, so they may part by one bf16 step at each rounding, and one step
# at the top of a binade is 2^-7 of the largest element: 2 x 2^-7.
BLOCK_TOL = 1.6e-2
# Backbones whose end-to-end features gate (FEAT_TOL) is a test of the
# kernels.  zamba2-1.2b's is not: tools/feature_drift.py shows its
# untrained stack amplifying a ~1e-6 per-block difference in fp32
# compute to ~8e-2 of the hidden state over its 45 blocks, so any two
# correct implementations that sum in another order part at its output.
# Its end-to-end error is printed; the per-block gate holds it.
FEAT_GATED = ("granite-3-2b", "rwkv6-3b")
# scan kernels: max|kernel - plain| / max|plain| over o and the state.
# fp32: the same factorised sums in another order.  bf16 o: both round
# the same fp32 value to bf16, one step (2^-8) apart where it straddles
# a rounding boundary (the state stays fp32 in both).
SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
SEG_SRC = "src/repro_torch/kernels/seg_gram/csrc/seg_gram.cu"
SEG_TPU = "src/repro/kernels/seg_gram/kernel.py:57"
RG_TPU = "src/repro/kernels/residual_gram/kernel.py:29"
FA_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FA_TPU = "src/repro/kernels/flash_attention/kernel.py:76"
SCAN_SRC = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
GLA_TPU = "src/repro/kernels/ssm_scan/kernel.py:88"
SSD_TPU = "src/repro/kernels/ssm_scan/kernel.py:169"
BACKBONE_ARCHS = ("granite-3-2b", "rwkv6-3b", "zamba2-1.2b")
BACKBONE_USERS, BACKBONE_SEQ, BACKBONE_BATCH, GATE_USERS = 8192, 256, 256, 512
# the bootstrap phases: Figure 6's middle scale, EconML's default B,
# runtime_chunk replicates per batched call; OrthoIV's bootstrap B
BOOT_N, BOOT_B, BOOT_CHUNK, IV_BOOT_B = 100_000, 100, 25, 16
# the doubly-robust bootstraps' B: the config's 200 cut for time (DR: a
# third of the DML bootstrap's B = 100 replicates' work; DRIV: OrthoIV's)
DR_BOOT_B, DRIV_BOOT_B = 32, 16
# serial and batched replicates are gated bitwise equal on the card
# (tests/test_torch_cuda.py::test_serial_equals_batched_on_card shows it)
SERIAL_BITWISE = True


def log(msg: str) -> None:
    """Print one progress line, flushed."""
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before each run."""

    def __init__(self) -> None:
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")           # 256 MB > 50 MB L2

    def ms(self, fn, reps: int, warm: int = 1) -> float:
        """Mean ms of ``fn`` over ``reps`` runs after ``warm`` runs."""
        for _ in range(warm):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / reps

    def graph_ms(self, fn, reps: int) -> float:
        """Mean ms of ``fn``'s launches replayed from a CUDA graph (captured
        once, after a warm-up on a side stream): the device's time for
        them, without the host's time in the Python around them, which
        exceeds the L2 flush's ~0.1 ms for the small forms."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        try:
            return self.ms(graph.replay, reps)
        finally:
            del graph


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|, in fp64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@dataclasses.dataclass
class Case:
    """One kernel at one main-path shape, with its plain twin."""

    name: str            # counter key / record name
    form: str            # which main-path form it serves
    kernel: object       # () -> Tensor via the kernel's wrapper
    plain: object        # () -> Tensor, plain PyTorch on the card
    exact: object        # () -> Tensor, fp64
    lib_prep: object     # () -> operands of the library call (untimed)
    lib: object          # operands -> Tensor, ONE torch call
    bytes: float
    flops: float
    reps: int
    replaces: str = SEG_TPU
    q: tuple = None      # seg_gram's (qL, qR): the record names its kernel
    walk: tuple = None   # (seg, S, seeded) of a segment walk: its plan


def kernel_cases(X, y, t, folds, k, W=None):
    """The main path's kernel calls at its shapes; ``W`` (B, n) replaces
    the k fold weights of the batched forms (design, gram_and_vec)."""
    from repro_torch.core.crossfit import fold_weights
    from repro_torch.core.final_stage import cate_basis
    from repro_torch.core.moments import design
    from repro_torch.kernels.residual_gram import kernel as rg_kernel
    from repro_torch.kernels.residual_gram import ref as rg_ref
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.kernels.seg_gram import ref

    def sym(q):
        # distinct entries of a symmetric (q, q) Gram
        return q * (q + 1) / 2

    n = X.shape[0]
    W = fold_weights(folds, k) if W is None else W   # (B, n)
    B = W.shape[0]
    seg = folds.to(torch.int32)
    Dr = design(X, intercept=True, append=y)         # ridge design (n, p+2)
    Dl = design(X, intercept=True)                   # logistic design (n, p+1)
    wg = (0.25 * W).contiguous()                     # first Newton step
    v = (W * (0.5 - t)[None]).contiguous()
    my, mt = X[:, 0].contiguous(), torch.sigmoid(X[:, 0])
    phi = cate_basis(X, 2)
    theta = torch.tensor([1.0, 0.5], device=X.device)
    cols = [c[:, None] for c in (y, t, my, mt)]
    qr, ql, ph = Dr.shape[1], Dl.shape[1], phi.shape[1]

    def batched(builder, arrays, w, dtype):
        return torch.stack([
            ref.seg_gram_plain(builder, [a.to(dtype) for a in arrays],
                               w=w[b][:, None].to(dtype))
            for b in range(B)])

    def gv_operand():
        # [Dl·wg | v] built in one (B, n, ql + 1) buffer: the product and a
        # concatenation of it would each hold another copy
        A = torch.empty((B, n, ql + 1), device=X.device)
        torch.mul(Dl[None], wg[:, :, None], out=A[..., :ql])
        A[..., ql] = v
        return A.transpose(1, 2), Dl

    def gv_plain(dtype):
        return torch.stack([
            ref.seg_gram_plain(ref.build_gram_and_vec,
                               [Dl.to(dtype), wg[b][:, None].to(dtype),
                                v[b][:, None].to(dtype)])
            for b in range(B)])

    def seg_plain(dtype):
        return ref.seg_gram_plain(ref.build_design, [Dr.to(dtype)],
                                  seg=folds, n_segments=k)

    def res_plain(dtype):
        return ref.seg_gram_plain(ref.build_residual,
                                  [c.to(dtype) for c in cols]
                                  + [phi.to(dtype)])

    def meat_plain(dtype):
        return ref.seg_gram_plain(ref.build_residual_meat,
                                  [c.to(dtype) for c in cols]
                                  + [phi.to(dtype),
                                     theta[None].to(dtype)])

    def rg_exact():
        G = res_plain(torch.float64)
        return torch.cat([G[:2, :2].reshape(-1), G[:2, 2]])

    col_bytes = 4 * n * 4 + phi.numel() * 4
    f32 = torch.float32
    return [
        Case("design", f"ridge weighted_gram, {B} weight rows batched",
             lambda: kern.seg_gram_cuda("design", Dr, w=W),
             lambda: batched(ref.build_design, [Dr], W, f32),
             lambda: batched(ref.build_design, [Dr], W, torch.float64),
             lambda: ((Dr[None] * W[:, :, None]).transpose(1, 2), Dr),
             lambda ab: torch.matmul(*ab),
             Dr.numel() * 4 + W.numel() * 4 + B * qr * qr * 4,
             2.0 * B * n * sym(qr), 3, q=(qr, qr)),
        Case("design_segmented", "fold_gram S=5 (parallel_loo)",
             lambda: kern.seg_walk_cuda("design", Dr, seg=seg,
                                        n_segments=k),
             lambda: seg_plain(f32),
             lambda: seg_plain(torch.float64),
             lambda: ((Dr[:, None, :] * (folds[:, None] == torch.arange(
                 k, device=X.device)[None])[:, :, None])
                 .reshape(n, k * qr).T, Dr),
             lambda ab: torch.matmul(*ab),
             Dr.numel() * 4 + n * 4 + k * qr * qr * 4,
             2.0 * n * sym(qr), 3, q=(qr, qr), walk=(seg, k, False)),
        Case("gram_and_vec", f"logistic Newton step, {B} weight rows",
             lambda: kern.seg_gram_cuda("gram_and_vec", Dl,
                                        scalars=(wg, v)),
             lambda: gv_plain(f32), lambda: gv_plain(torch.float64),
             gv_operand, lambda ab: torch.matmul(*ab),
             Dl.numel() * 4 + 2 * wg.numel() * 4 + B * (ql + 1) * ql * 4,
             2.0 * B * n * (sym(ql) + ql), 3, q=(ql + 1, ql)),
        Case("residual", "final-stage residual_moments (G, b)",
             lambda: kern.seg_gram_cuda("residual", phi,
                                        scalars=(y, t, my, mt))[0],
             lambda: res_plain(f32), lambda: res_plain(torch.float64),
             lambda: (torch.cat([(t - mt)[:, None] * phi,
                                 (y - my)[:, None]], dim=1),),
             lambda a: a[0].T @ a[0],
             col_bytes + 9 * 4, 2.0 * n * sym(ph + 1), 20,
             q=(ph + 1, ph + 1)),
        Case("residual_meat", "final-stage HC0 meat",
             lambda: kern.seg_gram_cuda("residual_meat", phi,
                                        scalars=(y, t, my, mt),
                                        theta=theta)[0],
             lambda: meat_plain(f32), lambda: meat_plain(torch.float64),
             lambda: (ref.build_residual_meat(*cols, phi, theta[None])[0],),
             lambda a: a[0].T @ a[0],
             col_bytes + 2 * 4 + 4 * 4, 2.0 * n * sym(ph) + 8.0 * n, 20,
             q=(ph, ph)),
        Case("residual_gram", "final stage at row_block=0",
             lambda: torch.cat([g.reshape(-1) for g in
                                rg_kernel.residual_gram_cuda(y, t, my, mt,
                                                             phi)]),
             lambda: torch.cat([g.reshape(-1) for g in
                                rg_ref.residual_gram_ref(y, t, my, mt,
                                                         phi)]),
             rg_exact,
             lambda: ((t - mt)[:, None] * phi,),
             lambda a: a[0].T @ a[0],
             col_bytes + 6 * 4, 2.0 * n * (sym(ph) + ph), 20,
             replaces=RG_TPU, q=(ph + 1, ph + 1)),
    ]


def phase_kernels(X, y, t, folds, k, timer, forms=None, suffix=""):
    """Kernel vs plain vs fp64 at the main path's shapes; timings.
    ``forms`` picks cases by name; ``suffix`` tags their record keys."""
    cases = [c for c in kernel_cases(X, y, t, folds, k)
             if forms is None or c.name in forms]
    return run_cases(cases, timer, suffix)


def run_cases(cases, timer, suffix=""):
    """Each case's kernel against its plain version and fp64; kernel,
    plain and library times; one record per case."""
    records = {}
    for c in cases:
        G64 = c.exact()
        Gk = c.kernel()
        Gp = c.plain()
        torch.cuda.synchronize()
        err_k, err_p, kp = rel(Gk, G64), rel(Gp, G64), rel(Gk, Gp)
        max_abs = float((Gk.double() - Gp.double()).abs().max())
        del G64
        # seg_gram: the kernel's launches replayed from a CUDA graph (the
        # device's time), its eager time, Python included, beside; the
        # library call is one op, whose host time the L2 flush hides (and
        # a captured cuBLAS call would keep a workspace per capture stream)
        ms = (timer.graph_ms if c.q is not None else timer.ms)(c.kernel,
                                                                c.reps)
        plain_ms = timer.ms(c.plain, c.reps)
        ops = c.lib_prep()
        lib_ms = timer.ms(lambda: c.lib(ops), c.reps)
        del ops
        split = _seg_split(c, timer) if c.q is not None else {}
        torch.cuda.empty_cache()
        t_bytes = c.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = c.flops / FP32_FLOP_PER_S * 1e3
        ok = kp <= KERNEL_TOL and bool(torch.isfinite(Gk).all())
        log(f"kernel {c.name:17s} [{c.form}] shape={tuple(Gk.shape)} "
            f"err/max|G| kernel={err_k:.3e} plain={err_p:.3e} "
            f"kernel-vs-plain={kp:.3e} (tol {KERNEL_TOL:g}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} "
            f"bound_ms={max(t_bytes, t_ops):.4f} "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
            + "".join(f"{k}={v:.4f} " if isinstance(v, float) else f"{k}={v} "
                      for k, v in split.items())
            + ("OK" if ok else "FAIL"))
        if not ok:
            raise AssertionError(f"kernel {c.name} disagrees with its plain "
                                 f"version: {kp:.3e} > {KERNEL_TOL:g}")
        records[c.name + suffix] = {
            "name": (f"seg_gram[{c.name}]" if c.name != "residual_gram"
                     else "residual_gram") + suffix,
            "route": "cuda", "source": SEG_SRC, "replaces": c.replaces,
            "launches": None, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "err_kernel_vs_fp64": err_k, "err_plain_vs_fp64": err_p,
            **split}
    return records


def _seg_split(c, timer) -> dict:
    """The seg_gram kernel that ran a case (``design``: small, thin or
    big), its second pass alone (``reduce_ms``; 0 launches when seeded)
    replayed from a CUDA graph, and, for a walk, the plan alone
    (``plan_ms``, eager; ``ms`` has it cached); and the call's eager
    time with the host's Python in it (``eager_ms``, how ``ms`` was
    timed before the graphs)."""
    from repro_torch.kernels.seg_gram import kernel as kern

    with kern.stage("reduce"):
        reduce_ms = timer.graph_ms(c.kernel, c.reps)
    plan_ms = None
    if c.walk is not None:
        seg, S, seeded = c.walk
        rs = None if seeded else kern.library().seg_gram_split_rows(*c.q)
        plan_ms = timer.ms(lambda: kern.walk_plan(seg, S, rs), c.reps)
    return {"design": kern.design_of(*c.q), "plan_ms": plan_ms,
            "reduce_ms": reduce_ms, "eager_ms": timer.ms(c.kernel, c.reps)}


def phase_invariants(seed: int) -> None:
    """Bitwise: padded tail, w=0 == zeroed rows, empty segment,
    power-of-two weights, run-to-run repeat."""
    from repro_torch.kernels.seg_gram import kernel as kern

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    n, p, k, pad = 70_001, 300, 5, 40_000    # pad adds whole splits
    dev = "cuda"
    D = torch.randn((n, p), generator=g, device=dev)
    seg = torch.randint(0, k, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((k, n), generator=g, device=dev)
    y, t, my, mt = (torch.randn(n, generator=g, device=dev)
                    for _ in range(4))
    phi = torch.randn((n, 2), generator=g, device=dev)

    def same(a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"invariant broken: {what}")
        log(f"invariant ok: {what}")

    # padded tail: zero data, seg = -1, w = 0 rows appended
    Dp = torch.cat([D, torch.zeros((pad, p), device=dev)])
    segp = torch.cat([seg, torch.full((pad,), -1, dtype=torch.int32,
                                      device=dev)])
    wp = torch.cat([w, torch.zeros((k, pad), device=dev)], dim=1)
    same(kern.seg_walk_cuda("design", D, seg=seg, n_segments=k),
         kern.seg_walk_cuda("design", Dp, seg=segp, n_segments=k),
         "padded tail (design, S=5)")
    same(kern.seg_gram_cuda("design", D, w=w),
         kern.seg_gram_cuda("design", Dp, w=wp.contiguous()),
         "padded tail (design, k=5 batch)")
    # w = 0 masks a row exactly like zeroing its data
    mask = (torch.arange(n, device=dev) % 3 != 0).float()
    same(kern.seg_gram_cuda("residual", phi, scalars=(y, t, my, mt),
                            w=mask),
         kern.seg_gram_cuda("residual", phi * mask[:, None],
                            scalars=(y * mask, t * mask, my * mask,
                                     mt * mask)),
         "w=0 == zeroed rows (residual)")
    same(kern.seg_gram_cuda("design", D, w=mask),
         kern.seg_gram_cuda("design", D * mask[:, None]),
         "w=0 == zeroed rows (design)")
    # an empty segment is exactly zero
    seg_e = torch.where(seg == 2, torch.ones_like(seg), seg)
    G = kern.seg_walk_cuda("design", D, seg=seg_e, n_segments=k)
    if not bool((G[2] == 0).all()):
        raise AssertionError("invariant broken: empty segment")
    log("invariant ok: empty segment is exactly 0")
    # power-of-two weights scale exactly
    same(2.0 * kern.seg_walk_cuda("design", D, seg=seg, n_segments=k),
         kern.seg_walk_cuda("design", D, seg=seg, n_segments=k,
                            w=torch.full((n,), 2.0, device=dev)),
         "power-of-two weights")
    same(2.0 * kern.seg_gram_cuda("residual_meat", phi,
                                  scalars=(y, t, my, mt),
                                  theta=torch.tensor([1.0, 0.5],
                                                     device=dev)),
         kern.seg_gram_cuda("residual_meat", phi, scalars=(y, t, my, mt),
                            theta=torch.tensor([1.0, 0.5], device=dev),
                            w=torch.full((n,), 2.0, device=dev)),
         "power-of-two weights (residual_meat)")
    # two runs are bitwise equal
    wg, v = w, (w * 0.5).contiguous()
    Gv = kern.seg_gram_cuda("gram_and_vec", D, scalars=(wg, v))
    same(Gv, kern.seg_gram_cuda("gram_and_vec", D, scalars=(wg, v)),
         "two runs bitwise equal (gram_and_vec, k=5 batch)")
    # the large tile computes one triangle and mirrors it: every
    # symmetric Gram equals its transpose bitwise (gram_and_vec: its X
    # block; the appended v row is not symmetric)
    for G, what in (
            (kern.seg_gram_cuda("design", D, w=w), "design, k=5 batch"),
            (kern.seg_walk_cuda("design", D, seg=seg, n_segments=k),
             "design, S=5"),
            (Gv[:, :p], "gram_and_vec's X block"),
            (kern.seg_gram_cuda("residual", D[:, :p - 1].contiguous(),
                                scalars=(y, t, my, mt)), "residual"),
            (kern.seg_gram_cuda("iv", D[:, :p // 2].contiguous(),
                                scalars=(y, t, my), w=w), "iv, k=5 batch")):
        same(G, G.transpose(-1, -2), f"bitwise symmetric ({what})")


def phase_small_agreement(seed: int) -> None:
    """The port's fit on the card against its fit on the CPU (plain
    versions), small input, every engine and path."""
    from repro_torch.config import CausalConfig
    from repro_torch.core.dml import DML
    from repro_torch.data.causal_dgp import paper_demo_data

    d = paper_demo_data(n=4000, p=10, seed=seed, device="cpu")
    for engine, rb, st in [("parallel", 512, "pallas"),
                           ("parallel_loo", 512, "pallas"),
                           ("sequential", 512, "pallas"),
                           ("parallel", 0, "chunked")]:
        cfg = CausalConfig(n_folds=5, cate_features=2, engine=engine,
                           inference="jackknife", row_block=rb,
                           row_block_strategy=st)
        out = {}
        for dev in ("cpu", "cuda"):
            r = DML(cfg, device=dev).fit(d.y, d.t, d.X,
                                         gen=torch.Generator().manual_seed(1))
            out[dev] = (r.theta.cpu(), r.cov.cpu(), r.inference().se.cpu())
        e = max(rel(out["cuda"][i], out["cpu"][i]) for i in range(3))
        log(f"small fit cuda vs cpu [{engine}, row_block={rb}, {st}]: "
            f"max rel diff {e:.3e} (tol 1e-4)")
        if not e <= 1e-4:
            raise AssertionError(f"card and CPU fits disagree: {e:.3e}")


def phase_main(data, cfg, expected):
    """One full-width fit + jackknife, launches counted around it."""
    from repro_torch.core import moments
    from repro_torch.core.dml import DML
    from repro_torch.kernels.seg_gram import kernel as kern

    est = DML(cfg)
    torch.cuda.synchronize()
    kern.LAUNCHES.clear()
    moments.FALLBACKS.clear()
    t0 = time.perf_counter()
    res = est.fit(data.y, data.t, data.X,
                  gen=torch.Generator().manual_seed(0))
    inf = res.inference()
    lo, hi = res.ate_interval()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kern.LAUNCHES)
    fallbacks = {f: c for f, c in moments.FALLBACKS.items() if c}
    theta, se = res.theta.double().cpu(), inf.se.double().cpu()
    target = torch.tensor([1.0, 0.5], dtype=torch.float64)
    # the k=5 jackknife se has 4 degrees of freedom and can land well
    # below the HC0 sandwich se: hold theta to the larger of the two
    z = (theta - target).abs() / torch.maximum(se, res.stderr.double().cpu())
    tag = (f"{cfg.engine}, row_block={cfg.row_block}, "
           f"{cfg.row_block_strategy}")
    log(f"main path [{tag}]: fit+jackknife {secs:.3f} s, "
        f"theta={theta.tolist()} jackknife se={se.tolist()} "
        f"sandwich se={res.stderr.double().cpu().tolist()} "
        f"|theta-[1,0.5]|/max(se)={z.tolist()} ATE CI=[{lo:.5f}, {hi:.5f}] "
        f"launches={counts} "
        f"fallbacks={fallbacks} diag={res.diagnostics.rows()}")
    if not (torch.isfinite(res.theta).all() and torch.isfinite(res.cov).all()
            and tuple(res.theta.shape) == (2,)
            and tuple(res.cov.shape) == (2, 2)):
        raise AssertionError("non-finite or misshapen theta/cov")
    if not bool((z <= 5.0).all()):
        raise AssertionError(f"theta not within 5 se of [1, 0.5]: {z}")
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    return counts, secs


def inference_cases(X, y, t, seed, R, k):
    """The bootstrap chunk's kernel calls at its shapes: R replicates of
    pairs draws times k folds over ``paper_demo_data``'s (n, 500)."""
    from repro_torch.core.crossfit import fold_weights
    from repro_torch.core.final_stage import cate_basis
    from repro_torch.core.moments import design
    from repro_torch.inference.bootstrap import replicate_draws
    from repro_torch.kernels.seg_gram import ops as sops
    from repro_torch.kernels.seg_gram import ref

    def sym(q):
        return q * (q + 1) / 2

    n = X.shape[0]
    folds, w, _ = replicate_draws(seed, torch.arange(R), n, k, "pairs",
                                  device=X.device)
    Wk = (fold_weights(folds, k) * w[:, None, :]).reshape(R * k, n)
    D = design(X, intercept=True, append=y)                  # (n, 502)
    q = D.shape[1]
    phi = cate_basis(X, 2)
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    ry = (y[None] - 0.1 * torch.randn((R, n), generator=g, device="cuda"))
    rt = (t[None] - torch.sigmoid(X[:, 0])[None]
          + 0.01 * torch.randn((R, n), generator=g, device="cuda"))
    zero = torch.zeros_like(ry)
    theta = torch.tensor([1.0, 0.5], device="cuda") \
        + 0.01 * torch.randn((R, 2), generator=g, device="cuda")
    ph = phi.shape[1]

    def fw_plain(dtype):
        Dd = D.to(dtype)
        return torch.stack([ref.seg_gram_plain(
            ref.build_fold_weighted, [Wk[b:b + 1].T.to(dtype), Dd])
            for b in range(R * k)])

    def per_rep(builder, cols, th=None, ww=None, dtype=torch.float32):
        out = []
        for b in range(R):
            arrs = [c[b][:, None].to(dtype) for c in cols] + [phi.to(dtype)]
            if th is not None:
                arrs.append(th[b][None].to(dtype))
            if ww is not None and th is not None:
                arrs.append(ww[b][:, None].to(dtype))
            out.append(ref.seg_gram_plain(
                builder, arrs,
                w=None if ww is None or th is not None
                else ww[b][:, None].to(dtype)))
        return torch.stack(out)

    def rd(dtype=torch.float32):
        return per_rep(ref.build_residual_direct, [ry, rt], ww=w,
                       dtype=dtype)

    def meat(dtype=torch.float32):
        return per_rep(ref.build_residual_meat, [ry, rt, zero, zero],
                       th=theta, ww=w, dtype=dtype)

    def M_direct():
        M = torch.cat([rt[:, :, None] * phi[None], ry[:, :, None]], dim=2)
        return (M * w[:, :, None]).transpose(1, 2), M

    def M_meat():
        z = rt[:, :, None] * phi[None]
        e = w * (ry - (z * theta[:, None, :]).sum(-1))
        m = e[:, :, None] * z
        return m.transpose(1, 2), m

    col_bytes = 3 * R * n * 4 + phi.numel() * 4
    return [
        Case("fold_weighted", f"bootstrap nuisance Grams, R*k={R * k}",
             lambda: sops.fold_weighted_design_gram(D, Wk),
             lambda: fw_plain(torch.float32),
             lambda: fw_plain(torch.float64),
             lambda: ((D[None] * Wk[:, :, None]).transpose(1, 2), D),
             lambda ab: torch.matmul(*ab),
             D.numel() * 4 + Wk.numel() * 4 + R * k * q * q * 4,
             2.0 * R * k * n * sym(q), 3, q=(q, q)),
        Case("residual_direct", f"bootstrap weighted final stage, R={R}",
             lambda: sops.residual_weighted_gram(ry, rt, phi, w)[0],
             rd, lambda: rd(torch.float64), M_direct,
             lambda ab: torch.matmul(*ab),
             col_bytes + R * (ph + 1) ** 2 * 4,
             2.0 * R * n * sym(ph + 1), 20, q=(ph + 1, ph + 1)),
        Case(f"residual_meat@R{R}", f"bootstrap weighted HC0 meat, R={R}",
             lambda: sops.residual_meat(ry, rt, zero, zero, phi, theta,
                                        w=w),
             meat, lambda: meat(torch.float64), M_meat,
             lambda ab: torch.matmul(*ab),
             col_bytes + R * ph * 4 + R * ph * ph * 4,
             2.0 * R * n * sym(ph) + 8.0 * R * n, 20, q=(ph, ph)),
    ]


def iv_cases(ry, rt, rz, phi, folds, theta, k):
    """The OrthoIV fit's and jackknife's kernel calls on its residuals."""
    from repro_torch.kernels.seg_gram import ops as sops
    from repro_torch.kernels.seg_gram import ref

    def sym(q):
        return q * (q + 1) / 2

    n, ph = phi.shape
    q = 2 * ph + 1
    ones = torch.ones_like(ry)
    cols = [c[:, None] for c in (ry, rt, rz)]

    def plain(builder, extra=(), seg=None, S=1, dtype=torch.float32):
        return ref.seg_gram_plain(
            builder, [c.to(dtype) for c in cols] + [phi.to(dtype)]
            + [e.to(dtype) for e in extra], seg=seg, n_segments=S)

    def M_iv():
        M = torch.cat([rz[:, None] * phi, rt[:, None] * phi, ry[:, None]], 1)
        return M.T, M

    def M_seg():
        M = torch.cat([rz[:, None] * phi, rt[:, None] * phi, ry[:, None]], 1)
        oh = (folds[:, None] == torch.arange(k, device=folds.device)[None])
        return (M[:, None, :] * oh[:, :, None]).reshape(n, k * q).T, M

    def M_meat():
        e = ry - ((rt[:, None] * phi) * theta[None]).sum(1)
        m = (e * rz)[:, None] * phi
        return m.T, m

    col_bytes = 3 * n * 4 + phi.numel() * 4
    th = theta[None]
    return [
        Case("iv", "OrthoIV final stage iv_gram", lambda: sops.iv_gram(
                 ry, rt, rz, phi, ones)[0],
             lambda: plain(ref.build_iv),
             lambda: plain(ref.build_iv, dtype=torch.float64), M_iv,
             lambda ab: torch.matmul(*ab), col_bytes + n * 4 + q * q * 4,
             2.0 * n * sym(q), 20, q=(q, q)),
        Case("iv_segmented", f"OrthoIV jackknife fold_iv_gram, S={k}",
             lambda: sops.seg_reduce(ref.build_iv, cols + [phi], seg=folds,
                                     n_segments=k),
             lambda: plain(ref.build_iv, seg=folds, S=k),
             lambda: plain(ref.build_iv, seg=folds, S=k,
                           dtype=torch.float64), M_seg,
             lambda ab: torch.matmul(*ab),
             col_bytes + n * 4 + k * q * q * 4, 2.0 * n * sym(q), 20,
             q=(q, q), walk=(folds, k, False)),
        Case("iv_meat", "OrthoIV HC0 meat", lambda: sops.iv_meat(
                 ry, rt, rz, phi, theta),
             lambda: plain(ref.build_iv_meat, (th,)),
             lambda: plain(ref.build_iv_meat, (th,), dtype=torch.float64),
             M_meat, lambda ab: torch.matmul(*ab),
             col_bytes + ph * 4 + ph * ph * 4,
             2.0 * n * sym(ph) + 8.0 * n, 20, q=(ph, ph)),
    ]


def _solve_ms(timer, M, q, reps=2) -> float:
    """ms of one batched (M, q, q) Gauss-Jordan solve, as the bootstrap's
    weighted fits run it."""
    from repro_torch.inference.numerics import det_solve

    g = torch.Generator(device="cuda").manual_seed(5)
    A = torch.randn((M, q, q), generator=g, device="cuda") / q ** 0.5
    A = A @ A.transpose(1, 2) + torch.eye(q, device="cuda")
    b = torch.randn((M, q), generator=g, device="cuda")
    ms = timer.ms(lambda: det_solve(A, b), reps)
    del A, b
    torch.cuda.empty_cache()
    return ms


def _counters():
    from repro_torch.core import moments
    from repro_torch.kernels.seg_gram import kernel as kern
    return kern.LAUNCHES, moments.FALLBACKS, kern.SHAPES, kern.PLANS


def _read_counters():
    launches, fallbacks, _, _ = _counters()
    return dict(launches), {f: c for f, c in fallbacks.items() if c}


def _reset_counters():
    for c in _counters():
        c.clear()


def phase_bootstrap(data, cfg, timer, forms_ms):
    """DML.fit + the default inference (pairs bootstrap, "vmap", chunks of
    runtime_chunk) on the card: ate_interval and cate_interval, launches
    counted around them."""
    from repro_torch.core.dml import DML

    B, R, k = cfg.n_bootstrap, cfg.runtime_chunk, cfg.n_folds
    chunks = -(-B // R)
    iters = cfg.newton_iters
    est = DML(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    res = est.fit(data.y, data.t, data.X, gen=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    lo, hi = res.ate_interval()
    band = res.cate_interval(data.X[:5])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    inf = res.inference()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    theta = res.theta.double().cpu()
    se_b, se_hc0 = inf.se.double().cpu(), res.stderr.double().cpu()
    z = (theta - torch.tensor([1.0, 0.5], dtype=torch.float64)).abs() \
        / torch.maximum(se_b, se_hc0)
    ratio = se_b / se_hc0
    # the 502/501-wide Gauss-Jordan solves: 1 ridge + 16 Newton per chunk
    solve_ms = _solve_ms(timer, min(R, B) * k, data.X.shape[1] + 1)
    solve_share = chunks * (1 + iters) * solve_ms / 1e3 / (secs - t_fit)
    kernel_s = forms_ms.get("fold_weighted", 0.0) * counts.get(
        "fold_weighted", 0) / 1e3
    expected = {"design": 1, "gram_and_vec": iters, "residual": 1,
                "residual_meat": 1 + chunks, "fold_weighted":
                chunks * (1 + 2 * iters), "residual_direct": chunks}
    log(f"bootstrap path: B={B} (EconML's BootstrapInference default is "
        f"100, the config's 200), chunks of {R}, executor "
        f"{inf.executor}, n={data.n} p={data.p}: fit {t_fit:.3f} s, "
        f"bootstrap + intervals {secs - t_fit:.3f} s ({(secs - t_fit) / B:.4f}"
        f" s per replicate), peak device memory {peak:.2f} GiB; "
        f"theta={theta.tolist()} bootstrap se={se_b.tolist()} HC0 se="
        f"{se_hc0.tolist()} se ratio={ratio.tolist()} |theta-[1,0.5]|/max(se)"
        f"={z.tolist()} ATE CI=[{lo:.5f}, {hi:.5f}] CATE bands lo="
        f"{band[0].cpu().tolist()} hi={band[1].cpu().tolist()}; one "
        f"({min(R, B) * k}, {data.X.shape[1] + 1}) solve {solve_ms:.2f} ms, "
        f"solves ~{100 * solve_share:.1f} % of the bootstrap; fold_weighted "
        f"kernel ~{kernel_s:.2f} s; launches={counts} fallbacks={fallbacks}")
    if not (torch.isfinite(inf.replicates).all() and lo < hi
            and bool(torch.isfinite(band[0]).all())):
        raise AssertionError("non-finite replicates or an empty interval")
    if not bool((z <= 5.0).all()):
        raise AssertionError(f"theta not within 5 se of [1, 0.5]: {z}")
    if not bool(((ratio >= 0.6) & (ratio <= 1.6)).all()):
        raise AssertionError(f"bootstrap se / HC0 se outside [0.6, 1.6]: "
                             f"{ratio}")
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    return counts, secs


def phase_bootstrap_agreement(seed: int) -> None:
    """Replicates on the card against the CPU on given folds and weights;
    serial against batched on the card; the multiplier scheme."""
    from repro_torch.config import CausalConfig
    from repro_torch.core.dml import DML
    from repro_torch.core.final_stage import cate_basis
    from repro_torch.core.nuisance import make_nuisance
    from repro_torch.data.causal_dgp import paper_demo_data
    from repro_torch.inference.bootstrap import (dml_theta_once,
                                                 replicate_draws)

    d = paper_demo_data(n=20_000, p=50, seed=seed, device="cpu")
    cfg = CausalConfig(n_folds=5, cate_features=2, row_block=4096,
                       row_block_strategy="pallas", n_bootstrap=4,
                       runtime_chunk=4)
    folds, w, _ = replicate_draws(seed, torch.arange(4), d.n, 5, "pairs")
    out = {}
    for dev in ("cpu", "cuda"):
        ny = make_nuisance("ridge", "reg", cfg)
        nt = make_nuisance("logistic", "clf", cfg)
        X, y, t = (a.to(dev) for a in (d.X, d.y, d.t))
        r = dml_theta_once(ny, nt, 5, X, y, t, cate_basis(X, 2),
                           folds.to(dev), w.to(dev), row_block=4096,
                           strategy="pallas")
        out[dev] = torch.cat([r["theta"], r["se"]], dim=1).cpu()
    e = rel(out["cuda"], out["cpu"])
    log(f"bootstrap agreement: 4 replicates on given folds and weights, "
        f"theta and se card vs CPU max rel diff {e:.3e} (tol 1e-4)")
    if not e <= 1e-4:
        raise AssertionError(f"card and CPU replicates disagree: {e:.3e}")

    res = DML(cfg).fit(d.y, d.t, d.X)
    batched = res.inference(executor="vmap")
    serial = res.inference(executor="serial")
    diff = float((serial.replicates - batched.replicates).abs().max())
    log(f"bootstrap serial vs batched on the card (4 replicates): max |diff| "
        f"{diff:.3e}, bitwise equal {torch.equal(serial.replicates, batched.replicates)}"
        f" (gated: {SERIAL_BITWISE})")
    if SERIAL_BITWISE and not torch.equal(serial.replicates,
                                          batched.replicates):
        raise AssertionError(f"serial and batched replicates differ: {diff}")

    mcfg = dataclasses.replace(cfg, inference="multiplier", n_bootstrap=8)
    mult = {dev: DML(mcfg, device=dev).fit(d.y, d.t, d.X).inference()
            for dev in ("cpu", "cuda")}
    card = mult["cuda"]
    e = rel(card.replicates.cpu(), mult["cpu"].replicates)
    log(f"multiplier bootstrap, 8 replicates: card vs CPU max rel diff "
        f"{e:.3e} (tol 1e-4), se={card.se.cpu().tolist()}")
    if not e <= 1e-4:
        raise AssertionError(f"multiplier replicates disagree: {e:.3e}")


def phase_orthoiv(data, cfg, expected):
    """OrthoIV.fit + its inference on the card, launches counted around
    them; the LATE within 5 se of the data's truth.  Returns the launch
    counts and the fit's residuals for the kernel checks."""
    from repro_torch.core.iv import OrthoIV

    est = OrthoIV(cfg)
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    res = est.fit(data.y, data.t, data.z, data.X,
                  gen=torch.Generator().manual_seed(0))
    inf = res.inference()
    lo, hi = res.late_interval()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    se = max(float(inf.se[0]), float(res.stderr[0]))
    z = abs(res.late - data.true_late) / se
    t, y = data.t, data.y
    naive = float((y * t).sum() / t.sum() - (y * (1 - t)).sum()
                  / (1 - t).sum())
    log(f"OrthoIV [{cfg.inference}, B={cfg.n_bootstrap if cfg.inference != 'jackknife' else '-'}]"
        f" n={data.n} p={data.p}: fit+inference {secs:.3f} s, "
        f"LATE={res.late:.5f} (true {data.true_late}) {cfg.inference} se="
        f"{float(inf.se[0]):.5f} HC0 se={float(res.stderr[0]):.5f} "
        f"|LATE-true|/max(se)={z:.3f} CI=[{lo:.5f}, {hi:.5f}] naive "
        f"diff-in-means={naive:.5f} first-stage F="
        f"{res.diagnostics.first_stage_f:.1f} launches={counts} "
        f"fallbacks={fallbacks}")
    if not (torch.isfinite(res.theta).all() and torch.isfinite(res.cov).all()
            and torch.isfinite(inf.replicates).all()):
        raise AssertionError("non-finite theta, cov or replicates")
    if not z <= 5.0:
        raise AssertionError(f"LATE not within 5 se of the truth: {z:.3f}")
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    cf = res.crossfit
    resid = (data.y - cf.oof_y, data.t - cf.oof_t, data.z - cf.oof_z,
             res.fit_ctx.phi, cf.folds, res.theta)
    return counts, secs, resid


# -- slice 5: the segment walk, the sweep and the store ----------------------

SWEEP_N, SWEEP_P, SWEEP_E = 2 ** 20, 500, 64       # src/repro/launch/sweep_cell.py
STORE_DAY, STORE_DAYS = 2 ** 18, 5
# (record key, form) of the pair forms: the LAUNCHES/SHAPES key, S and
# the output width the main paths give each
# (record key) -> (LAUNCHES key, S, qL values) of the launches on the
# main paths that the record's shape stands for; fold_gram's design runs
# at q = 502 ([X|1|y], the ridge y) and 501 ([X|1], the logistic H0)
PAIR_FORMS = {
    "pair:t1": ("pair", SWEEP_E, (5,)),
    "pair:t2": ("pair", SWEEP_E * 5, (1,)),
    "design_segmented@S320": ("design_segmented", SWEEP_E * 5,
                              (SWEEP_P + 2, SWEEP_P + 1)),
    "pair:final": ("pair", SWEEP_E, (2,)),
    "pair:ng": ("pair", SWEEP_E * 5, (SWEEP_P + 3,)),
    "pair:vg": ("pair", SWEEP_E * 5, (2 * (SWEEP_P + 3),)),
}


def _padded_segments(M, seg, S):
    """(S, longest segment, q): each segment's rows in arrival order,
    zero-padded — the library call's operand."""
    ok = (seg >= 0) & (seg < S)
    idx = torch.nonzero(ok).squeeze(1)
    s = seg[idx].long()
    order = torch.argsort(s, stable=True)
    idx, s = idx[order], s[order]
    counts = torch.bincount(s, minlength=S)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(s.shape[0], device=s.device) - starts[s]
    out = torch.zeros((S, int(counts.max()), M.shape[1]), dtype=M.dtype,
                      device=M.device)
    out[s, rank] = M[idx]
    return out


def pair_cases(seed: int, timer):
    """The segment walk at the sweep's and the store's shapes: (a) MM term
    t1, (b) t2, (c) fold_gram's design at S = E·k, (d) the per-segment
    final stage, (e) the store's ng and (f) vg, both seeded; and the
    time of init's symmetry check, which a store's first ingest and its
    first after a restore pay."""
    from repro_torch.core.moments import design
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.kernels.seg_gram import ref

    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    dev, E, k = "cuda", SWEEP_E, 5

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def ids(n, S):
        return torch.randint(0, S, (n,), generator=g, device=dev)

    n, p = SWEEP_N, SWEEP_P
    X = rnd(n, p)
    Xa = design(X, intercept=True)                        # (n, 501)
    D = design(X, intercept=True, append=rnd(n))          # (n, 502)
    del X
    sids, comb = ids(n, E), ids(n, E * k)
    r, rr, m = rnd(n, k), rnd(n, 1), rnd(n, 2)
    nd = STORE_DAY
    dn = torch.cat([rnd(nd, p), torch.ones((nd, 1), device=dev),
                    rnd(nd, 2)], dim=1)                  # (nd, 503)
    phi = torch.cat([torch.ones((nd, 1), device=dev), dn[:, :1]], dim=1)
    v = (phi[:, :, None] * dn[:, None, :]).reshape(nd, -1)  # (nd, 1006)
    cs = ids(nd, E * k)
    # the standing accumulators: a first day's Grams from the walk, as the
    # store's are after its first ingest (known symmetric: no check)
    ng0 = kern.seg_walk_cuda("pair", dn, Y=dn, seg=cs, n_segments=E * k)
    vg0 = kern.seg_walk_cuda("pair", v, Y=v, seg=cs, n_segments=E * k)
    for name, M, G in (("ng", dn, ng0), ("vg", v, vg0)):
        G = G.clone()                  # not the walk's own: checked
        check_ms = timer.ms(lambda: kern._same_rows(M, M, G), 3)
        log(f"store {name}'s init symmetry check {tuple(G.shape)} (a first "
            f"ingest, and the first after a restore): ms={check_ms:.4f}")
        del G

    def sym(q):
        return q * (q + 1) / 2

    def case(name, form, U, V, seg, S, init=None, builder="pair", reps=3):
        same = V is None
        Vv = U if same else V

        def kernel():
            if builder == "design":
                return kern.seg_walk_cuda("design", U, seg=seg, n_segments=S)
            return kern.seg_walk_cuda("pair", U, Y=Vv, seg=seg, n_segments=S,
                                      init=init)

        def plain(dtype=torch.float32):
            G = ref.seg_gram_plain(ref.build_pair, [U.to(dtype), Vv.to(dtype)],
                                   seg=seg, n_segments=S)
            return G if init is None else init.to(dtype) + G

        def lib_prep():
            Lp = _padded_segments(U, seg, S)
            Rp = Lp if same else _padded_segments(Vv, seg, S)
            return Lp.transpose(1, 2), Rp

        def lib(ab):
            if init is None:
                return torch.bmm(*ab)
            return torch.baddbmm(init, *ab)

        qU, qV = U.shape[1], Vv.shape[1]
        nbytes = (U.numel() + (0 if same else Vv.numel())) * 4 \
            + seg.numel() * seg.element_size() + S * qU * qV * 4 \
            * (2 if init is not None else 1)
        flops = 2.0 * U.shape[0] * (sym(qU) if same else qU * qV)
        return Case(name, form, kernel, plain,
                    lambda: plain(torch.float64), lib_prep, lib, nbytes,
                    flops, reps, q=(qU, qV), walk=(seg, S, init is not None))

    return [
        case("pair:t1", f"sweep MM term t1, S={E}", r, Xa, sids, E, reps=10),
        case("pair:t2", f"sweep MM term t2, S={E * k}", rr, Xa, comb, E * k,
             reps=10),
        case("design_segmented@S320", f"sweep fold_gram, S={E * k}", D, None,
             comb, E * k, builder="design"),
        case("pair:final", f"sweep final stage, S={E}", m, None, sids, E,
             reps=10),
        case("pair:ng", f"store ng, S={E * k}, init", dn, None, cs, E * k,
             init=ng0),
        case("pair:vg", f"store vg, S={E * k}, init", v, None, cs, E * k,
             init=vg0, reps=2),
    ]


def phase_pair_invariants(seed: int) -> None:
    """Bitwise on the card, for each pair kernel: the store's width (the
    large tile), the sweep's thin MM terms (1 and 5 x 501) and its small
    final stage (2 x 2) — a second run, seg = -1 rows and zero rows
    appended, an empty segment, two seeded ingests against one pass; a
    symmetric pair bitwise symmetric; the seeded walk against the split
    one."""
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.kernels.seg_gram import ops as sops

    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    dev, n, pad, h = "cuda", 200_000, 30_000, 77_777

    def same(a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"invariant broken: {what}")
        log(f"invariant ok: {what}")

    for qU, qV, S in ((SWEEP_P + 3, None, SWEEP_E * 5), (1, SWEEP_P + 1,
                                                         SWEEP_E * 5),
                      (5, SWEEP_P + 1, SWEEP_E), (2, None, SWEEP_E)):
        U = torch.randn((n, qU), generator=g, device=dev)
        V = U if qV is None else torch.randn((n, qV), generator=g,
                                             device=dev)
        qv = V.shape[1]
        tag = f"pair {qU} x {qv} ({kern.design_of(qU, qv)}), S={S}"
        seg = torch.randint(0, S, (n,), generator=g, device=dev)
        seg = torch.where(seg == 7, torch.full_like(seg, 8), seg)  # 7 empty

        G = sops.segment_outer(U, V, seg, S)
        same(G, sops.segment_outer(U, V, seg, S), f"{tag}: a second run "
             "repeats")
        if qV is None:
            same(G, G.transpose(-1, -2), f"{tag}: U with itself is bitwise "
                 "symmetric")
        if not bool((G[7] == 0).all()):
            raise AssertionError(f"invariant broken: {tag}: empty segment")
        log(f"invariant ok: {tag}: an empty segment is exactly 0")
        Up = torch.cat([U, torch.randn((pad, qU), generator=g, device=dev)])
        Vp = Up if qV is None else torch.cat(
            [V, torch.randn((pad, qv), generator=g, device=dev)])
        segp = torch.cat([seg, torch.full((pad,), -1, device=dev)])
        same(G, sops.segment_outer(Up, Vp, segp, S), f"{tag}: seg = -1 rows")
        Uz = torch.cat([U, torch.zeros((pad, qU), device=dev)])
        Vz = Uz if qV is None else torch.cat(
            [V, torch.zeros((pad, qv), device=dev)])
        segz = torch.cat([seg, torch.randint(0, S, (pad,), generator=g,
                                             device=dev)])
        same(G, sops.segment_outer(Uz, Vz, segz, S), f"{tag}: appended zero "
             "rows")
        zero = torch.zeros((S, qU, qv), device=dev)
        one = sops.segment_outer(U, V, seg, S, init=zero)
        Vh, Vt = (U[:h], U[h:]) if qV is None else (V[:h], V[h:])
        first = sops.segment_outer(U[:h], Vh, seg[:h], S, init=zero)
        same(one, sops.segment_outer(U[h:], Vt, seg[h:], S, init=first),
             f"{tag}: two seeded ingests == one pass")
        if qV is None:
            same(one, one.transpose(-1, -2), f"{tag}: seeded, bitwise "
                 "symmetric")
        e = rel(one, G)
        log(f"{tag}: seeded walk vs split walk rel diff {e:.3e} (tol "
            f"{KERNEL_TOL:g})")
        if not e <= KERNEL_TOL:
            raise AssertionError(f"seeded and split walks disagree: {e:.3e}")
        del U, V, Up, Vp, Uz, Vz, G, one, first
        torch.cuda.empty_cache()


def _sweep_inputs(seed: int):
    """The sweep phases' data, segment ids and spec (seeded draws on the
    card, so a rerun sees the same rows)."""
    from repro_torch.configs.sweep_synthetic import SWEEP
    from repro_torch.data.causal_dgp import paper_demo_data
    from repro_torch.sweep import SweepSpec

    data = paper_demo_data(n=SWEEP_N, p=SWEEP_P, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    sids = torch.randint(0, SWEEP_E, (SWEEP_N,), generator=g, device="cuda")
    cfg = dataclasses.replace(SWEEP, row_block=65536,
                              row_block_strategy="pallas")
    return data, sids, SweepSpec(SWEEP_E, (("dml", cfg),))


def phase_sweep(seed: int, timer):
    """sweep(mode="segmented") at the reference sweep cell's scale,
    launches counted around it; every segment's ATE within 5 se of 1;
    a small sweep on the card against the CPU."""
    from repro_torch.data.causal_dgp import paper_demo_data
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.sweep import SweepSpec, sweep

    data, sids, spec = _sweep_inputs(seed)
    cfg = spec.columns[0][1]
    iters = 2 * cfg.newton_iters
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    kern.clear_plan_cache()
    t0 = time.perf_counter()
    panel = sweep(spec, X=data.X, y=data.y, t=data.t, segment_ids=sids,
                  seed=seed, mode="segmented")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    shapes, plans = dict(_counters()[2]), dict(_counters()[3])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    col = panel.columns[0]
    if col.failed:
        raise AssertionError(f"the sweep column failed: {col.error}")
    del data
    torch.cuda.empty_cache()
    solve_ms = _solve_ms(timer, SWEEP_E * 5, SWEEP_P + 1)
    share = iters * solve_ms / 1e3 / secs
    ate, se = col.ates.double().cpu(), col.ses[:, 0].double().cpu()
    z = (ate - 1.0).abs() / se
    expected = {"design_segmented": 2, "pair": 2 * iters + 2}
    # one walk plan per (id tensor, rows per unit): sids for the MM term
    # t1 (thin) and the final stage (small), comb for t2 (thin) and
    # fold_gram's two designs (the large tile)
    rows = kern.library().seg_gram_split_rows
    want_plans = {(SWEEP_E, rows(5, SWEEP_P + 1)): 1,
                  (SWEEP_E, rows(2, 2)): 1,
                  (SWEEP_E * 5, rows(1, SWEEP_P + 1)): 1,
                  (SWEEP_E * 5, rows(SWEEP_P + 2, SWEEP_P + 2)): 1}
    log(f"sweep path: n={SWEEP_N} p={SWEEP_P} E={SWEEP_E} k=5, {iters} MM "
        f"steps: {secs:.3f} s, peak device memory {peak:.2f} GiB; one "
        f"({SWEEP_E * 5}, {SWEEP_P + 1}) solve {solve_ms:.2f} ms, the MM "
        f"steps' solves ~{100 * share:.1f} % of the sweep; ATE range "
        f"[{float(ate.min()):.5f}, {float(ate.max()):.5f}] se range "
        f"[{float(se.min()):.5f}, {float(se.max()):.5f}] max |ate-1|/se "
        f"{float(z.max()):.3f}; rows/segment {int(panel.counts.min())}-"
        f"{int(panel.counts.max())}; launches={counts} fallbacks={fallbacks}"
        f" by shape={ {f'{a}@S{b}:{c}x{d}': v for (a, b, c, d), v in shapes.items()} }"
        f"; walk plans made (S, rows per unit)={plans} for "
        f"{sum(counts.values())} launches")
    if not bool(torch.isfinite(col.thetas).all()):
        raise AssertionError("non-finite sweep thetas")
    if not bool((z <= 5.0).all()):
        raise AssertionError(f"a segment's ATE is not within 5 se of 1: "
                             f"{z.max():.3f}")
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if plans != want_plans:
        raise AssertionError(f"walk plans {plans}, expected {want_plans}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")

    small = paper_demo_data(n=20_000, p=20, seed=seed, device="cpu")
    ssid = torch.randint(0, 8, (20_000,), generator=torch.Generator()
                         .manual_seed(seed + 6))
    scfg = dataclasses.replace(cfg, row_block=4096)
    out = [sweep(SweepSpec(8, (("dml", scfg),)), X=small.X, y=small.y,
                 t=small.t, segment_ids=ssid, seed=seed, mode="segmented",
                 device=dev).columns[0] for dev in ("cpu", "cuda")]
    e = max(rel(out[1].thetas.cpu(), out[0].thetas),
            rel(out[1].ses.cpu(), out[0].ses))
    log(f"sweep agreement (n=20000, p=20, E=8): card vs CPU max rel diff "
        f"{e:.3e} (tol 1e-4)")
    if not e <= 1e-4:
        raise AssertionError(f"card and CPU sweeps disagree: {e:.3e}")
    return shapes, secs, col


def _store_cfg(**kw):
    from repro_torch.config import CausalConfig

    base = dict(n_folds=5, inference="none", nuisance_t="ridge",
                discrete_treatment=False, cate_features=2, row_block=65536,
                row_block_strategy="pallas")
    base.update(kw)
    return CausalConfig(**base)


def _state_equal(a, b) -> bool:
    fa, fb = a.state_dict(), b.state_dict()
    return all(torch.equal(fa["seg_counts"], fb["seg_counts"]) and all(
        torch.equal(fa[c][key], fb[c][key]) for key in ("ng", "vg", "counts"))
        for c in fa if c != "seg_counts")


def _panel_equal(a, b) -> bool:
    return all(torch.equal(x.thetas, y.thetas) and torch.equal(x.ses, y.ses)
               for x, y in zip(a.columns, b.columns))


def _store_spec():
    from repro_torch.sweep import SweepSpec

    return SweepSpec(SWEEP_E, (("dml", _store_cfg()),))


def _store_days(seed: int):
    """The store phases' five days of rows: ``rows(lo, hi)`` and the
    data (make_causal_data on the card, seeded, so a rerun draws the
    same rows)."""
    from repro_torch.data.causal_dgp import make_causal_data

    n = STORE_DAY * STORE_DAYS
    d = make_causal_data(n=n, p=SWEEP_P, seed=seed, discrete_treatment=False)
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    sids = torch.randint(0, SWEEP_E, (n,), generator=g, device="cuda")

    def rows(lo, hi):
        return dict(X=d.X[lo:hi], y=d.y[lo:hi], t=d.t[lo:hi],
                    segment_ids=sids[lo:hi])

    return d, rows


def phase_store(seed: int, ckpt_dir: str):
    """A daily refresh of 64 cohorts: five ingests of 2^18 rows with
    snapshots at days 3 and 5 (in ``ckpt_dir``), the refresh, a one-shot
    ingest against the incremental one, rollback to day 3; a small store
    card vs CPU, and aligned partitions on "chunked" on the card.
    Returns the launches by shape, the ingest seconds and the day-5
    panel."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.store import MomentStore
    from repro_torch.sweep import SweepSpec

    n = STORE_DAY * STORE_DAYS
    d, rows = _store_days(seed)
    spec = _store_spec()
    mgr = CheckpointManager(ckpt_dir, keep_latest=4)
    store = MomentStore(spec, SWEEP_P, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    day_s = []
    for day in range(STORE_DAYS):
        t0 = time.perf_counter()
        store.ingest(**rows(day * STORE_DAY, (day + 1) * STORE_DAY))
        torch.cuda.synchronize()
        day_s.append(time.perf_counter() - t0)
        if day + 1 in (3, 5):
            store.save(mgr)
    t0 = time.perf_counter()
    panel = store.refresh()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    shapes = dict(_counters()[2])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    col = panel.columns[0]
    ate, se = col.ates.double().cpu(), col.ses[:, 0].double().cpu()
    z = (ate - d.true_ate).abs() / se
    log(f"store path: {STORE_DAYS} daily ingests of {STORE_DAY} rows, "
        f"p={SWEEP_P}, E={SWEEP_E}, k=5, cate_features=2 (ng "
        f"{tuple(store.state_dict()['col0']['ng'].shape)}, vg "
        f"{tuple(store.state_dict()['col0']['vg'].shape)}): ingest s per "
        f"day {[round(x, 4) for x in day_s]}, refresh {refresh_s:.3f} s, "
        f"peak device memory {peak:.2f} GiB; ATE range "
        f"[{float(ate.min()):.5f}, {float(ate.max()):.5f}] max "
        f"|ate-true|/se {float(z.max()):.3f}; launches={counts} "
        f"fallbacks={fallbacks}")
    if counts != {"pair": 2 * STORE_DAYS}:
        raise AssertionError(f"launches {counts}, expected "
                             f"{ {'pair': 2 * STORE_DAYS} }")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    if not (bool(torch.isfinite(col.thetas).all())
            and bool((z <= 5.0).all())):
        raise AssertionError(f"a segment's ATE is not within 5 se of "
                             f"the truth: {z.max():.3f}")

    once = MomentStore(spec, SWEEP_P, seed=seed)
    t0 = time.perf_counter()
    once.ingest(**rows(0, n))
    torch.cuda.synchronize()
    once_s = time.perf_counter() - t0
    bitwise = _state_equal(once, store) and _panel_equal(
        once.refresh(), panel)
    log(f"store one-shot ingest of {n} rows {once_s:.3f} s; "
        f"incremental == one-shot bitwise (accumulators and panel): "
        f"{bitwise}")
    if not bitwise:
        raise AssertionError("incremental and one-shot ingests differ")
    del once
    three = MomentStore(spec, SWEEP_P, seed=seed)
    three.ingest(**rows(0, 3 * STORE_DAY))
    back = MomentStore(spec, SWEEP_P, seed=seed).restore(mgr, step=3)
    ok = _state_equal(back, three) and _panel_equal(back.refresh(),
                                                    three.refresh())
    log(f"store snapshots {sorted(s for s, _ in mgr._steps())}; "
        f"restore of day 3 == a store of days 1-3 bitwise: {ok}")
    if not ok:
        raise AssertionError("the day-3 snapshot does not restore")
    del three, back, store, d, rows
    torch.cuda.empty_cache()

    # small store: card vs CPU; chunked aligned partitions on the card
    from repro_torch.data.causal_dgp import make_causal_data as mcd

    sd = mcd(n=5 * 4096, p=10, seed=seed, discrete_treatment=False,
             device="cpu")
    ss = torch.randint(0, 8, (5 * 4096,), generator=torch.Generator()
                       .manual_seed(seed + 10))

    def small(dev, strategy, cuts):
        cfg = _store_cfg(n_folds=3, row_block=1024,
                         row_block_strategy=strategy)
        st = MomentStore(SweepSpec(8, (("dml", cfg),)), 10, seed=seed,
                         device=dev)
        b = [0, *cuts, 5 * 4096]
        for lo, hi in zip(b[:-1], b[1:]):
            st.ingest(X=sd.X[lo:hi], y=sd.y[lo:hi], t=sd.t[lo:hi],
                      segment_ids=ss[lo:hi])
        return st

    days = tuple(4096 * i for i in range(1, 5))
    pc, pg = (small(dev, "pallas", days).refresh() for dev in ("cpu", "cuda"))
    e = max(rel(pg.columns[0].thetas.cpu(), pc.columns[0].thetas),
            rel(pg.columns[0].ses.cpu(), pc.columns[0].ses))
    ch_inc, ch_one = small("cuda", "chunked", days), small("cuda", "chunked",
                                                           ())
    aligned = _state_equal(ch_inc, ch_one) and _panel_equal(
        ch_inc.refresh(), ch_one.refresh())
    log(f"small store (5 x 4096 rows, p=10, E=8, k=3): card vs CPU max rel "
        f"diff {e:.3e} (tol 1e-4); chunked, aligned daily partitions == "
        f"one-shot bitwise on the card: {aligned}")
    if not e <= 1e-4:
        raise AssertionError(f"card and CPU stores disagree: {e:.3e}")
    if not aligned:
        raise AssertionError("aligned chunked partitions are not bitwise")
    return shapes, sum(day_s), panel


# -- slice 9: the doubly-robust estimators, serving and tracing --------------

def _fit_counts(iters: int, driv: bool) -> dict:
    """The seg_gram launches of one DRLearner / DRIV fit on the card
    ("parallel" engine, "pallas"): DR's arms and propensity are
    fold_weighted (k folds in one launch), its pseudo-outcome regression
    one design launch; DRIV's y / t / z and compliance nuisances go
    through the engine's design and gram_and_vec forms, its preliminary
    OrthoIV is iv + iv_meat at phi = 1."""
    if driv:
        return {"design": 3, "gram_and_vec": 2 * iters, "iv": 1,
                "iv_meat": 1}
    return {"fold_weighted": 2 + 2 * iters, "design": 1}


def _merge(*dicts) -> dict:
    out = collections.Counter()
    for d in dicts:
        out.update(d)
    return dict(out)


def dr_cases(X, y, t, folds, phi, psi, k):
    """DRLearner's new kernel calls at the fit's shapes: the arm-masked
    fold_weighted Gram (k folds, q = p + 2) and the pseudo-outcome
    regression's design Gram over [phi | psi] (q = 3)."""
    from repro_torch.core.crossfit import fold_weights
    from repro_torch.core.moments import design
    from repro_torch.kernels.seg_gram import ops as sops
    from repro_torch.kernels.seg_gram import ref

    def sym(q):
        return q * (q + 1) / 2

    n = X.shape[0]
    Wk = (fold_weights(folds, k) * t[None]).contiguous()     # arm T = 1
    D = design(X, intercept=True, append=y)                  # (n, p + 2)
    q = D.shape[1]
    Dp = design(phi, append=psi)                             # (n, 3)
    qp = Dp.shape[1]
    ones = torch.ones(n, device=X.device)

    def fw_plain(dtype):
        Dd = D.to(dtype)
        return torch.stack([ref.seg_gram_plain(
            ref.build_fold_weighted, [Wk[b:b + 1].T.to(dtype), Dd])
            for b in range(k)])

    def pd_plain(dtype):
        return ref.seg_gram_plain(ref.build_design, [Dp.to(dtype)],
                                  w=ones[:, None].to(dtype))

    return [
        Case("fold_weighted@k5", f"DR arm / propensity Grams, k={k}",
             lambda: sops.fold_weighted_design_gram(D, Wk),
             lambda: fw_plain(torch.float32),
             lambda: fw_plain(torch.float64),
             lambda: ((D[None] * Wk[:, :, None]).transpose(1, 2), D),
             lambda ab: torch.matmul(*ab),
             D.numel() * 4 + Wk.numel() * 4 + k * q * q * 4,
             2.0 * k * n * sym(q), 3, q=(q, q)),
        Case("design@q3", "pseudo-outcome regression [phi | psi]",
             lambda: sops.design_gram(Dp, w=ones),
             lambda: pd_plain(torch.float32),
             lambda: pd_plain(torch.float64),
             lambda: ((Dp * ones[:, None]).T, Dp),
             lambda ab: torch.matmul(*ab),
             Dp.numel() * 4 + n * 4 + qp * qp * 4, 2.0 * n * sym(qp), 20,
             q=(qp, qp)),
    ]


def phase_dr_fit(data, cfg, seed: int):
    """DRLearner.fit on the card at the tables' configuration, launches
    counted around it; the ATE within 5 se of the truth; a small fit on
    the card against the CPU.  Returns the launches and the fit's state
    for the kernel checks."""
    from repro_torch.core.drlearner import DRLearner
    from repro_torch.data.causal_dgp import paper_demo_data

    est = DRLearner(cfg)
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    res = est.fit(data.y, data.t, data.X,
                  gen=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    expected = _fit_counts(cfg.newton_iters, False)
    z = abs(res.ate - data.true_ate) / res.stderr
    log(f"DRLearner n={data.n} p={data.p} k={cfg.n_folds}: fit {secs:.3f} s, "
        f"ATE={res.ate:.5f} (true {data.true_ate:.5f}) se={res.stderr:.5f} "
        f"|ATE-true|/se={z:.3f} theta={res.theta.cpu().tolist()} "
        f"launches={counts} fallbacks={fallbacks}")
    if not (bool(torch.isfinite(res.theta).all())
            and bool(torch.isfinite(res.pseudo).all())):
        raise AssertionError("non-finite theta or pseudo-outcomes")
    if not z <= 5.0:
        raise AssertionError(f"ATE not within 5 se of the truth: {z:.3f}")
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")

    small = paper_demo_data(n=4096, p=16, seed=seed, device="cpu")
    scfg = dataclasses.replace(cfg, row_block=1024)
    out = {}
    for dev in ("cpu", "cuda"):
        r = DRLearner(scfg, device=dev).fit(
            small.y, small.t, small.X, gen=torch.Generator().manual_seed(1))
        out[dev] = torch.cat([r.theta.cpu(), torch.tensor([r.ate, r.stderr]),
                              r.pseudo.cpu()])
    e = rel(out["cuda"], out["cpu"])
    log(f"DRLearner small fit (n=4096, p=16) card vs CPU max rel diff "
        f"{e:.3e} (tol 1e-4)")
    if not e <= 1e-4:
        raise AssertionError(f"card and CPU DR fits disagree: {e:.3e}")
    return counts, secs, (res.fit_ctx.phi, res.pseudo)


def phase_dr_bootstrap(data, cfg, forms_ms):
    """DRLearner.fit + its pairs bootstrap ("vmap", chunks of
    runtime_chunk) on the card, launches counted around them; the
    bootstrap se of the ATE within 0.6-1.6 of the analytic se; serial
    and batched replicates bitwise equal."""
    from repro_torch.core.drlearner import DRLearner
    from repro_torch.inference.bootstrap import derive_seed, dr_bootstrap

    B, R, k, it = cfg.n_bootstrap, cfg.runtime_chunk, cfg.n_folds, \
        cfg.newton_iters
    chunks = -(-B // R)
    est = DRLearner(cfg)
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    res = est.fit(data.y, data.t, data.X, gen=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    inf = res.inference()
    lo, hi = res.ate_interval()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    boot_s = secs - t_fit
    se_b = float(torch.std(inf.ate_replicates, correction=1))
    ratio = se_b / res.stderr
    fw = counts.get("fold_weighted", 0) - (2 + 2 * it)
    # the record times a chunk of R replicates: a chunk of r launches
    # r/R of its work (the last chunk's is short)
    share = (forms_ms.get("fold_weighted", 0.0) * (2 + 2 * it) * B / R
             / 1e3 / boot_s)
    expected = _merge(_fit_counts(it, False), {
        "fold_weighted": chunks * (2 + 2 * it),
        "residual_direct": chunks, "residual_meat": chunks})
    log(f"DR bootstrap: B={B} (cut from the config's 200 for time), chunks "
        f"of {R}, n={data.n} p={data.p}: fit {t_fit:.3f} s, bootstrap + "
        f"interval {boot_s:.3f} s ({boot_s / B:.4f} s per replicate); "
        f"ATE={res.ate:.5f} bootstrap se={se_b:.5f} analytic se="
        f"{res.stderr:.5f} ratio={ratio:.3f} CI=[{lo:.5f}, {hi:.5f}]; "
        f"fold_weighted ~{100 * share:.1f} % of the bootstrap ({fw} "
        f"launches, the R={R} record's ms scaled by each chunk's "
        f"replicates); launches={counts} fallbacks={fallbacks}")
    if not (bool(torch.isfinite(inf.replicates).all()) and lo < hi):
        raise AssertionError("non-finite replicates or an empty interval")
    if not 0.6 <= ratio <= 1.6:
        raise AssertionError(f"bootstrap se / analytic se {ratio:.3f}")
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    ctx = res.fit_ctx
    kw = dict(n_folds=k, X=ctx.X, y=ctx.y, t=ctx.t, phi=ctx.phi,
              seed=derive_seed(ctx.seed, 0x0b00), n_replicates=2,
              clip=ctx.clip, row_block=cfg.row_block,
              strategy=cfg.row_block_strategy)
    serial = dr_bootstrap(ctx.outcome, ctx.propensity, executor="serial",
                          **kw)
    batched = dr_bootstrap(ctx.outcome, ctx.propensity, executor="vmap",
                           **kw)
    same = (torch.equal(serial.replicates, batched.replicates)
            and torch.equal(serial.ate_replicates, batched.ate_replicates))
    log(f"DR bootstrap serial vs batched on the card (2 replicates): "
        f"bitwise equal {same}; equal to the run's first two: "
        f"{torch.equal(batched.replicates, inf.replicates[:2])}")
    if not same:
        raise AssertionError("serial and batched DR replicates differ")
    return counts, secs, chunks


def phase_driv_fit(data, cfg, ortho_late: float, seed: int):
    """DRIV.fit on the card, launches counted around it; its LATE within
    5 se of the DGP's and of OrthoIV's on the same data; a small fit on
    the card against the CPU; the jackknife refused.  Returns the
    launches and the residuals for the kernel checks."""
    from repro_torch.core.iv import DRIV
    from repro_torch.data.causal_dgp import make_iv_data

    est = DRIV(cfg)
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    res = est.fit(data.y, data.t, data.z, data.X,
                  gen=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    expected = _fit_counts(cfg.newton_iters, True)
    z_true = abs(res.late - data.true_late) / res.stderr
    z_ortho = abs(res.late - ortho_late) / res.stderr
    log(f"DRIV n={data.n} p={data.p}: fit {secs:.3f} s, LATE={res.late:.5f} "
        f"(true {data.true_late}, OrthoIV {ortho_late:.5f}) se="
        f"{res.stderr:.5f} theta_pre={res.theta_pre:.5f} theta="
        f"{res.theta.cpu().tolist()} |LATE-true|/se={z_true:.3f} "
        f"|LATE-OrthoIV|/se={z_ortho:.3f} first-stage F="
        f"{res.diagnostics.first_stage_f:.1f} launches={counts} "
        f"fallbacks={fallbacks}")
    if not (bool(torch.isfinite(res.theta).all())
            and bool(torch.isfinite(res.pseudo).all())):
        raise AssertionError("non-finite theta or pseudo-outcomes")
    if not (z_true <= 5.0 and z_ortho <= 5.0):
        raise AssertionError(f"LATE off: {z_true:.3f} / {z_ortho:.3f} se")
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    try:
        res.inference(method="jackknife")
    except ValueError as err:
        log(f"DRIV jackknife refused: {err}")
    else:
        raise AssertionError("DRIV ran a jackknife")

    small = make_iv_data(4096, 16, seed=seed, device="cpu")
    scfg = dataclasses.replace(cfg, row_block=1024)
    out = {}
    for dev in ("cpu", "cuda"):
        r = DRIV(scfg, device=dev).fit(small.y, small.t, small.z, small.X,
                                       gen=torch.Generator().manual_seed(1))
        out[dev] = torch.cat([r.theta.cpu(), torch.tensor(
            [r.late, r.stderr, r.theta_pre]), r.pseudo.cpu()])
    e = rel(out["cuda"], out["cpu"])
    log(f"DRIV small fit (n=4096, p=16) card vs CPU max rel diff {e:.3e} "
        f"(tol 1e-4)")
    if not e <= 1e-4:
        raise AssertionError(f"card and CPU DRIV fits disagree: {e:.3e}")
    return counts, secs, res


def phase_driv_bootstrap(data, cfg):
    """DRIV.fit + its pairs bootstrap on the card, launches counted
    around them; finite draws; serial and batched replicates bitwise
    equal."""
    from repro_torch.core.iv import DRIV
    from repro_torch.inference.bootstrap import derive_seed, driv_bootstrap

    B, R, it = cfg.n_bootstrap, cfg.runtime_chunk, cfg.newton_iters
    chunks = -(-B // R)
    est = DRIV(cfg)
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    res = est.fit(data.y, data.t, data.z, data.X,
                  gen=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    inf = res.inference()
    lo, hi = res.late_interval()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    boot_s = secs - t_fit
    se_b = float(torch.std(inf.ate_replicates, correction=1))
    expected = _merge(_fit_counts(it, True), {
        "fold_weighted": chunks * (1 + 4 * it) + B, "iv": chunks,
        "residual_direct": chunks, "residual_meat": chunks})
    log(f"DRIV bootstrap: B={B}, chunks of {R}, n={data.n} p={data.p}: fit "
        f"{t_fit:.3f} s, bootstrap + interval {boot_s:.3f} s "
        f"({boot_s / B:.4f} s per replicate); LATE={res.late:.5f} bootstrap "
        f"se={se_b:.5f} analytic se={res.stderr:.5f} ratio="
        f"{se_b / res.stderr:.3f} CI=[{lo:.5f}, {hi:.5f}]; "
        f"launches={counts} fallbacks={fallbacks}")
    if not (bool(torch.isfinite(inf.replicates).all())
            and bool(torch.isfinite(inf.ate_replicates).all()) and lo < hi):
        raise AssertionError("non-finite replicates or an empty interval")
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    ctx = res.fit_ctx
    kw = dict(n_folds=cfg.n_folds, XW=ctx.XW, y=ctx.y, t=ctx.t, z=ctx.z,
              phi=ctx.phi, seed=derive_seed(ctx.seed, 0x1b00),
              n_replicates=2, cov_clip=cfg.iv_cov_clip,
              row_block=cfg.row_block, strategy=cfg.row_block_strategy)
    nuis = (ctx.nuis_y, ctx.nuis_t, ctx.nuis_z, ctx.compliance)
    serial = driv_bootstrap(*nuis, executor="serial", **kw)
    batched = driv_bootstrap(*nuis, executor="vmap", **kw)
    same = (torch.equal(serial.replicates, batched.replicates)
            and torch.equal(serial.ate_replicates, batched.ate_replicates))
    log(f"DRIV bootstrap serial vs batched on the card (2 replicates): "
        f"bitwise equal {same}")
    if not same:
        raise AssertionError("serial and batched DRIV replicates differ")
    return counts, secs, chunks


# 2^19 requests (cut from 2^20 for time)
SERVE_REQUESTS, SERVE_WAVES, SERVE_SAMPLE = 2 ** 19, (8, 64), 1024


def phase_serve(seed: int, ckpt_dir: str, day5_panel):
    """The store's 64-cohort panels served: a ServingPanel from the day-5
    refresh and one from the day-3 snapshot (panel_from_checkpoint);
    SERVE_REQUESTS through EffectServer waves of the reference's ladder;
    every wave bitwise ``score_single`` on a sample of 1,024 requests,
    padded slots flagged; a hot-swap to day 5 and a rollback, bitwise
    day 3's scores again.  Returns requests per second and the server's
    wave / request latency percentiles."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.serve_effects import (EffectServer, ServingPanel,
                                           panel_from_checkpoint,
                                           score_batch, score_single)

    mgr = CheckpointManager(ckpt_dir, keep_latest=4)
    spec = _store_spec()
    t0 = time.perf_counter()
    p3 = panel_from_checkpoint(mgr, spec, SWEEP_P, seed=seed, step=3)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    p5 = ServingPanel.from_effect_panel(day5_panel, n_features=SWEEP_P,
                                        version=5)
    p5c = panel_from_checkpoint(mgr, spec, SWEEP_P, seed=seed, step=5)
    if not (torch.equal(p5c.thetas, p5.thetas)
            and torch.equal(p5c.ses, p5.ses)):
        raise AssertionError("the day-5 snapshot's panel is not the "
                             "refreshed day-5 panel")
    g = torch.Generator(device="cuda").manual_seed(seed + 21)
    X = torch.randn((SERVE_REQUESTS, SWEEP_P), generator=g,
                    device="cuda").cpu().numpy()
    sids = torch.randint(0, SWEEP_E, (SERVE_REQUESTS,), generator=g,
                         device="cuda").cpu().numpy()
    sample = np.sort(np.random.default_rng(seed).choice(
        SERVE_REQUESTS, SERVE_SAMPLE, replace=False))
    srv = EffectServer(p3, wave_sizes=SERVE_WAVES, max_queue=1024)
    burst = 1 << 16
    got = {}
    t0 = time.perf_counter()
    for lo in range(0, SERVE_REQUESTS, burst):
        resp = srv.score(X[lo:lo + burst], sids[lo:lo + burst])
        for i in sample[(sample >= lo) & (sample < lo + burst)]:
            got[int(i)] = resp[i - lo]
    secs = time.perf_counter() - t0
    snap = srv.snapshot()
    z = srv._z

    def fields(r):
        return (r.cate, r.lo, r.hi, r.se, r.ok)

    def single(panel, i):
        o = score_single(panel, X[i], int(sids[i]), z)
        return (float(o["cate"]), float(o["lo"]), float(o["hi"]),
                float(o["se"]), bool(o["ok"]))

    bad = [i for i in sample if fields(got[int(i)]) != single(p3, i)]
    # a ragged wave: 37 requests padded to 64 with garbage rows
    Xw = np.full((SERVE_WAVES[-1], SWEEP_P), 1e30, np.float32)
    sw = np.full((SERVE_WAVES[-1],), -1, np.int64)
    Xw[:37], sw[:37] = X[sample[:37]], sids[sample[:37]]
    out = score_batch(p3, Xw, sw, z)
    real = [(float(out["cate"][j]), float(out["se"][j]), bool(out["ok"][j]))
            for j in range(37)]
    padded_ok = (not bool(out["ok"][37:].any())
                 and bool((out["cate"][37:] == 0).all())
                 and all(real[j] == tuple(single(p3, sample[j])[i]
                                          for i in (0, 3, 4))
                         for j in range(37)))
    # hot-swap to day 5 between waves, then roll back
    Xs, ss = X[sample], sids[sample]
    r3 = [fields(r) for r in srv.score(Xs, ss)]
    srv.swap(p5)
    r5 = srv.score(Xs, ss)
    srv.rollback()
    r3b = srv.score(Xs, ss)
    back = (all(fields(a) == b for a, b in zip(r3b, r3))
            and {r.version for r in r3b} == {3})
    moved = sum(fields(a) != b for a, b in zip(r5, r3))
    day5_ok = all(fields(r5[j]) == single(p5, sample[j]) for j in range(64))
    wave = snap["histograms"]["serve.wave_seconds"]
    req = snap["histograms"]["serve.request_seconds"]
    occ = snap["histograms"]["serve.batch_occupancy"]
    rps = SERVE_REQUESTS / secs
    log(f"serving: 64-cohort panels (day 3 from its snapshot in "
        f"{load_s:.3f} s, day 5 from the refresh == its snapshot), "
        f"{SERVE_REQUESTS} requests, waves {SERVE_WAVES}: {secs:.3f} s, "
        f"{rps:.0f} requests/s, {snap['counters']['serve.waves']} waves; "
        f"wave s p50={wave['p50']:.6f} p99={wave['p99']:.6f} mean="
        f"{wave['mean']:.6f}; request s p50={req['p50']:.6f} p99="
        f"{req['p99']:.6f}; occupancy mean {occ['mean']:.3f}; sample of "
        f"{SERVE_SAMPLE}: waves == score_single bitwise {not bad}; padded "
        f"slots flagged {padded_ok}; swap to day 5 moved {moved}/"
        f"{SERVE_SAMPLE} scores, day-5 scores == score_single {day5_ok}; "
        f"rollback bitwise day 3 again {back}")
    if bad:
        raise AssertionError(f"{len(bad)} sampled requests differ from "
                             f"score_single, e.g. {bad[:3]}")
    if not (padded_ok and back and day5_ok and moved > 0):
        raise AssertionError("padded slots, hot-swap or rollback failed")
    return {"requests_per_s": rps, "wave_p50_s": wave["p50"],
            "wave_p99_s": wave["p99"], "request_p50_s": req["p50"],
            "request_p99_s": req["p99"], "seconds": secs}


def phase_trace(seed: int, sweep_col, store_panel):
    """The sweep and the store ingest again with a Tracer: outputs
    bitwise the untraced runs', the span names and rollup printed, a
    Chrome trace written under build/."""
    from repro_torch.obs import Tracer
    from repro_torch.store import MomentStore
    from repro_torch.sweep import sweep

    tracer = Tracer()
    data, sids, spec = _sweep_inputs(seed)
    panel = sweep(spec, X=data.X, y=data.y, t=data.t, segment_ids=sids,
                  seed=seed, mode="segmented", tracer=tracer)
    col = panel.columns[0]
    sweep_same = (not col.failed and torch.equal(col.thetas, sweep_col.thetas)
                  and torch.equal(col.ses, sweep_col.ses))
    del data, sids, panel
    torch.cuda.empty_cache()
    d, rows = _store_days(seed)
    store = MomentStore(_store_spec(), SWEEP_P, seed=seed, tracer=tracer)
    for day in range(STORE_DAYS):
        store.ingest(**rows(day * STORE_DAY, (day + 1) * STORE_DAY))
    store_same = _panel_equal(store.refresh(), store_panel)
    del d, rows, store
    torch.cuda.empty_cache()
    out = Path(__file__).resolve().parent / "build" / "chip_smoke_trace.json"
    out.parent.mkdir(exist_ok=True)
    tracer.write_chrome_trace(str(out))
    roll = {k: {"count": v["count"], "total_s": round(v["total_s"], 6)}
            for k, v in tracer.rollup().items()}
    log(f"trace: spans {tracer.span_names()}; rollup {roll}; counters "
        f"{tracer.metrics.snapshot()['counters']}; Chrome trace {out} "
        f"({out.stat().st_size} bytes); traced == untraced bitwise: sweep "
        f"{sweep_same}, store {store_same}")
    log(tracer.render())
    if not (sweep_same and store_same):
        raise AssertionError("a traced run differs from the untraced one")
    if tracer.span_names().count("store.ingest") != STORE_DAYS:
        raise AssertionError("missing store.ingest spans")



def _fa_plain(q, k, v, causal=True, softcap=0.0, scale=None, chunk=None):
    """The plain version in the model's (B, S, heads, D) layout (``chunk``,
    the card's backward's key block, is ignored)."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    return fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                softcap=softcap, scale=scale).transpose(1, 2)


def phase_flash(seed: int, timer) -> dict:
    """Flash attention vs plain vs fp64 at the backbone's shape, at
    deepseek-v3's MLA prefill (q/k 192, v 128 wide), at whisper-tiny's
    bidirectional encoder over its 1500 frames and at two small shapes
    (fp32, softcap); timings at the backbone's, the MLA and the encoder's
    shapes."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    dev = "cuda"

    def qkv(B, S, H, KV, D, dtype, Dv=None):
        return tuple(torch.randn((B, S, h, d), generator=g, device=dev)
                     .to(dtype) for h, d in ((H, D), (KV, D), (KV, Dv or D)))

    def check(q, k, v, causal, cap, what):
        got = fa_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                             softcap=cap)
        plain = _fa_plain(q, k, v, causal=causal, softcap=cap)
        torch.cuda.synchronize()
        err_k = err_p = 0.0
        for i in range(0, q.shape[0], 32):      # fp64 in slices of 32
            sl = slice(i, i + 32)
            exact = _fa_plain(*(x[sl].double() for x in (q, k, v)),
                              causal=causal, softcap=cap)
            err_k = max(err_k, rel(got[sl], exact))
            err_p = max(err_p, rel(plain[sl], exact))
            del exact
        kp = rel(got, plain)
        max_abs = float((got.double() - plain.double()).abs().max())
        tol = FA_TOL[q.dtype]
        ok = kp <= tol and bool(torch.isfinite(got).all())
        same = float((got == plain).double().mean())
        bf16 = ""
        if q.dtype == torch.bfloat16:
            ok = ok and same >= FA_BF16_SAME \
                and err_k <= FA_BF16_FP64_RATIO * err_p
            bf16 = (f"bitwise plain's {same:.4f} (>= {FA_BF16_SAME}), "
                    f"fp64 err <= {FA_BF16_FP64_RATIO} x plain's ")
        log(f"kernel flash_attention [{what}] q={tuple(q.shape)} "
            f"kv={tuple(k.shape)} err/max|o| kernel={err_k:.3e} "
            f"plain={err_p:.3e} kernel-vs-plain={kp:.3e} (tol {tol:g}) "
            f"{bf16}{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version [{what}]")
        return {"what": what, "q": list(q.shape), "kv": list(k.shape),
                "dtype": str(q.dtype).replace("torch.", ""),
                "causal": causal, "softcap": cap, "max_abs_err": max_abs,
                "err_kernel_vs_fp64": err_k, "err_plain_vs_fp64": err_p,
                "bitwise_plain_share": same}

    B, S, H, KV, D = BACKBONE_BATCH, BACKBONE_SEQ, 32, 8, 64
    extra = [check(*qkv(2, 320, 8, 2, 64, torch.float32), True, 0.0,
                   "fp32, causal, 5 key blocks"),
             check(*qkv(2, 192, 8, 8, 64, torch.bfloat16), True, 30.0,
                   "bf16, causal, softcap 30")]
    records = {}
    # the bf16 template (tensor cores) is the backbones'; the fp32 one
    # (CUDA cores) is timed at the same shape for its own record
    for dtype, key, peak, peak_name in (
            (torch.bfloat16, "flash_attention", BF16_TC_FLOP_PER_S,
             "989 TFLOP/s bf16"),
            (torch.float32, "flash_attention[fp32]", FP32_FLOP_PER_S,
             "67 TFLOP/s fp32")):
        q, k, v = qkv(B, S, H, KV, D, dtype)
        tag = str(dtype).replace("torch.", "")
        path = check(q, k, v, True, 0.0, f"backbone: {tag}, causal, GQA 32/8")
        ms = timer.ms(lambda: fa_kernel.flash_attention_cuda(q, k, v), 10)
        plain_ms = timer.ms(lambda: _fa_plain(q, k, v), 3)
        qh = q.transpose(1, 2).contiguous()
        kh = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
        vh = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
        lib_ms = timer.ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), 10)
        del qh, kh, vh
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                     + q.numel())
        flops = 4.0 * B * H * S * S * D / 2      # QK and PV, causal half
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        log(f"kernel {key} [backbone] ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA) "
            f"bound_ms={max(t_bytes, t_ops):.4f} "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
            f"{nbytes / 1e9:.3f} GB at 3.35 TB/s, {flops / 1e9:.1f} GFLOP "
            f"at {peak_name})")
        records[key] = {
            "name": key, "route": "cuda", "source": FA_SRC,
            "replaces": FA_TPU, "launches": None,
            "max_abs_err": path["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "err_kernel_vs_fp64": path["err_kernel_vs_fp64"],
            "err_plain_vs_fp64": path["err_plain_vs_fp64"],
            "bitwise_plain_share": path["bitwise_plain_share"],
            "shape": path["q"], "dtype": tag}
        del q, k, v
        torch.cuda.empty_cache()
    records["flash_attention"]["other_checks"] = extra
    # MLA's prefill at deepseek-v3's widths: a serving wave of LM_WAVE
    # prompts of LM_PROMPT tokens, 128 heads, q/k 128 + 64, v 128
    B, S, H, D, Dv = LM_WAVE, LM_PROMPT, 128, 192, 128
    for dtype, key, peak, peak_name in (
            (torch.bfloat16, "flash_attention[mla]", BF16_TC_FLOP_PER_S,
             "989 TFLOP/s bf16"),
            (torch.float32, "flash_attention[mla,fp32]", FP32_FLOP_PER_S,
             "67 TFLOP/s fp32")):
        q, k, v = qkv(B, S, H, H, D, dtype, Dv)
        tag = str(dtype).replace("torch.", "")
        path = check(q, k, v, True, 0.0,
                     f"mla prefill: {tag}, causal, q.k {D} / v {Dv}")
        ms = timer.ms(lambda: fa_kernel.flash_attention_cuda(q, k, v), 10)
        plain_ms = timer.ms(lambda: _fa_plain(q, k, v), 3)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        try:            # SDPA with a value head dim of its own, if it takes one
            lib_ms = timer.ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True), 10)
            lib_note = f"library_ms={lib_ms:.4f} (SDPA)"
        except RuntimeError as e:
            lib_ms, lib_note = None, f"SDPA refuses Ev != E ({e})"
        del qh, kh, vh
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                     + B * S * H * Dv)
        flops = 2.0 * B * H * S * S * (D + Dv) / 2   # QK and PV, causal half
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        log(f"kernel {key} [mla prefill] ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"{lib_note} bound_ms={max(t_bytes, t_ops):.4f} "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
            f"{nbytes / 1e9:.4f} GB at 3.35 TB/s, {flops / 1e9:.2f} GFLOP "
            f"at {peak_name})")
        records[key] = {
            "name": key, "route": "cuda", "source": FA_SRC,
            "replaces": FA_TPU, "launches": None,
            "max_abs_err": path["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "err_kernel_vs_fp64": path["err_kernel_vs_fp64"],
            "err_plain_vs_fp64": path["err_plain_vs_fp64"],
            "bitwise_plain_share": path["bitwise_plain_share"],
            "shape": path["q"], "v_shape": list(v.shape), "dtype": tag}
        del q, k, v
        torch.cuda.empty_cache()
    # whisper-tiny's encoder: a serving wave's frames attend to each other
    # bidirectionally, Sq = Sk = max_source_positions (1500, a multiple of
    # no tile: the kernel masks the last blocks' rows and keys), 6/6 x 64
    from repro_torch.configs import get_config
    wcfg = get_config("whisper-tiny")
    B, S, H, D = (LM_WAVE, wcfg.max_source_positions, wcfg.num_heads,
                  wcfg.head_dim)
    q, k, v = qkv(B, S, H, H, D, torch.bfloat16)
    path = check(q, k, v, False, 0.0,
                 f"whisper encoder: bf16, bidirectional, {S} frames")
    ms = timer.ms(lambda: fa_kernel.flash_attention_cuda(q, k, v,
                                                         causal=False), 10)
    plain_ms = timer.ms(lambda: _fa_plain(q, k, v, causal=False), 3)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = timer.ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh),
        10)
    del qh, kh, vh
    nbytes = q.element_size() * 4 * q.numel()      # q, k, v read, o written
    flops = 4.0 * B * H * S * S * D                 # QK and PV, every pair
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TC_FLOP_PER_S * 1e3
    key = "flash_attention[bidir]"
    log(f"kernel {key} [whisper encoder] ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} (SDPA) bound_ms={max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
        f"{nbytes / 1e9:.4f} GB at 3.35 TB/s, {flops / 1e9:.2f} GFLOP at "
        f"989 TFLOP/s bf16)")
    records[key] = {
        "name": key, "route": "cuda", "source": FA_SRC, "replaces": FA_TPU,
        "launches": None, "max_abs_err": path["max_abs_err"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "err_kernel_vs_fp64": path["err_kernel_vs_fp64"],
        "err_plain_vs_fp64": path["err_plain_vs_fp64"],
        "bitwise_plain_share": path["bitwise_plain_share"],
        "shape": path["q"], "dtype": "bfloat16", "causal": False}
    del q, k, v
    torch.cuda.empty_cache()
    return records


def _scan_record(name, tpu, path, ms, plain_ms, generic_ms, nbytes, flops):
    """A kernel record of the scan phase (launches filled in later);
    ``generic_ms`` the generic form's time on the same inputs."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    log(f"kernel {name} [{path['what']}, form {path['form']}] ms={ms:.4f} "
        f"generic_ms={generic_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms=null (no single PyTorch call) "
        f"bound_ms={max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
        f"{nbytes / 1e9:.3f} GB at 3.35 TB/s, {flops / 1e9:.1f} GFLOP at "
        f"67 TFLOP/s fp32)")
    return {"name": name, "route": "cuda", "source": SCAN_SRC, "replaces": tpu,
            "launches": None, "max_abs_err": path["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "form": path["form"],
            "generic_ms": generic_ms,
            "err_kernel_vs_fp64": path["err_kernel_vs_fp64"],
            "err_plain_vs_fp64": path["err_plain_vs_fp64"],
            "shape": path["shape"]}


def _scan_check(kernel_fn, plain_fn, exact_fn, args, tol, what, batch=32):
    """Kernel vs plain (both outputs) and both vs the fp64 naive oracle
    on the first ``batch`` rows; raises beyond ``tol``.  ``form`` in the
    result: the form the kernel call launched (``LAUNCHES`` by form)."""
    from repro_torch.kernels.ssm_scan import kernel as sk

    before = collections.Counter(sk.LAUNCHES)
    got = kernel_fn(*args)
    ran = [k.split(":")[1] for k, n in sk.LAUNCHES.items()
           if ":" in k and n > before[k]]
    plain = plain_fn(*args)
    torch.cuda.synchronize()
    kp = max(rel(g, p) for g, p in zip(got, plain))
    max_abs = max(float((g.double() - p.double()).abs().max())
                  for g, p in zip(got, plain))
    sl = [a[:batch] if a is not None and a.dim() > 2 else a for a in args]
    exact = exact_fn(*sl)
    err_k = max(rel(g[:batch], e) for g, e in zip(got, exact))
    err_p = max(rel(p[:batch], e) for p, e in zip(plain, exact))
    del exact
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    ok = kp <= tol and finite
    log(f"kernel {what}: form {'+'.join(ran)}, o {tuple(got[0].shape)} "
        f"{str(got[0].dtype)[6:]} "
        f"err/max kernel-vs-fp64={err_k:.3e} plain-vs-fp64={err_p:.3e} "
        f"kernel-vs-plain={kp:.3e} (tol {tol:g}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"scan kernel disagrees with its plain version "
                             f"[{what}]: {kp:.3e} > {tol:g}")
    return {"what": what, "shape": list(got[0].shape), "max_abs_err": max_abs,
            "err_kernel_vs_fp64": err_k, "err_plain_vs_fp64": err_p,
            "form": "+".join(ran)}


def _scan_forms(path, tiled_fn, generic_fn, what):
    """The main-path call must have run the tiled form, and the tiled and
    generic forms must agree byte for byte on its inputs."""
    if path["form"] != "tiled":
        raise AssertionError(f"{what}: the main-path shape ran the "
                             f"{path['form'] or 'no'} form, not tiled")
    same = all(torch.equal(a, b) for a, b in zip(tiled_fn(), generic_fn()))
    log(f"kernel {what}: tiled == generic bitwise {same}")
    if not same:
        raise AssertionError(f"{what}: the tiled and generic forms differ")


def phase_scans(seed: int, timer) -> dict:
    """The GLA (bonus and post) and SSD kernels against their plain
    chunked versions and an fp64 naive oracle, at rwkv6's and zamba2's
    main-path shapes in the layouts the models pass (strided (B, T, H, D)
    views), plus an fp32 case and a ragged T that halves the chunk; u, w,
    a and the inputs random (the untrained init's u = 0 would hide the
    bonus term).  Timings at the main-path shapes."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref

    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    dev, bf16, f32 = "cuda", torch.bfloat16, torch.float32
    wmin = float(torch.exp(torch.tensor(-sref.MAX_LOG_DECAY)))

    def gla_in(B, H, T, D, dtype):
        def bthd(lo=None):
            x = (torch.rand((B, T, H, D), generator=g, device=dev) * (1 - lo)
                 + lo if lo is not None
                 else torch.randn((B, T, H, D), generator=g, device=dev))
            return x.transpose(1, 2)
        q, k, v = (bthd().to(dtype) for _ in range(3))
        return (q, k, v, bthd(lo=wmin),
                torch.randn((H, D), generator=g, device=dev))

    def naive64(*a):
        return sref.gla_naive(*(None if x is None else x.double() for x in a))

    out, checks = {}, []            # checks: the smaller GLA cases
    B, H, T, D, C = BACKBONE_BATCH, 40, BACKBONE_SEQ, 64, 16   # rwkv6-3b
    for mode in ("bonus", "post"):
        q, k, v, w, u = gla_in(B, H, T, D, bf16)
        uu = u if mode == "bonus" else None
        args = (q, k, v, w, uu)
        path = _scan_check(lambda *a: sops.gla(*a, chunk=C),
                           lambda *a: sref.gla_chunked_ref(*a, chunk=C),
                           naive64, args, SCAN_TOL[bf16],
                           f"gla {mode}, rwkv6 (B,T,H,D) views, bf16 r/k/v")
        path["what"] = f"{mode}, rwkv6 batch"
        _scan_forms(path, lambda: sk.gla_cuda(*args, chunk=C),
                    lambda: sk.gla_cuda(*args, chunk=C, form="generic"),
                    f"gla {mode}, rwkv6 batch")
        ms = timer.ms(lambda: sk.gla_cuda(*args, chunk=C), 10)
        generic_ms = timer.ms(
            lambda: sk.gla_cuda(*args, chunk=C, form="generic"), 10)
        plain_ms = timer.ms(lambda: sref.gla_chunked_ref(*args, chunk=C), 3)
        flops, nbytes = sk.gla_cost(*args, C)
        out[f"gla[{mode}]"] = _scan_record(f"gla[{mode}]", GLA_TPU, path, ms,
                                           plain_ms, generic_ms, nbytes, flops)
        out[f"gla[{mode}]"]["other_checks"] = checks
        del q, k, v, w, u, args
        torch.cuda.empty_cache()
    # fp32, and a ragged T = 200 (chunk 16 -> 8)
    for (Bx, Hx, Tx, dt, what) in ((4, 8, 256, f32, "gla bonus, fp32"),
                                   (4, 8, 200, bf16, "gla bonus, T=200")):
        args = gla_in(Bx, Hx, Tx, D, dt)
        fit = C
        while Tx % fit:
            fit //= 2
        checks.append(_scan_check(
            lambda *a: sops.gla(*a, chunk=C),
            lambda *a, f=fit: sref.gla_chunked_ref(*a, chunk=f), naive64,
            args, SCAN_TOL[dt], what))

    def ssd_in(B, H, T, N, P):
        q, k = (torch.randn((B, T, N), generator=g, device=dev)
                for _ in range(2))
        v = torch.randn((B, T, H, P), generator=g, device=dev).transpose(1, 2)
        a = (torch.rand((B, T, H), generator=g, device=dev) * (1 - 1e-3)
             + 1e-3).transpose(1, 2)
        return q, k, v, a

    def ssd64(*a):
        return sref.ssd_naive(*(x.double() for x in a))

    B, H, T, N, C = BACKBONE_BATCH, 64, BACKBONE_SEQ, 64, 32     # zamba2
    args = ssd_in(B, H, T, N, N)
    path = _scan_check(lambda *a: sops.ssd(*a, chunk=C),
                       lambda *a: sref.ssd_chunked_ref(*a, chunk=C), ssd64,
                       args, SCAN_TOL[f32],
                       "ssd, zamba2 (B,T,H,P) views, fp32")
    path["what"] = "zamba2 batch"
    _scan_forms(path, lambda: sk.ssd_cuda(*args, chunk=C),
                lambda: sk.ssd_cuda(*args, chunk=C, form="generic"),
                "ssd, zamba2 batch")
    ms = timer.ms(lambda: sk.ssd_cuda(*args, chunk=C), 10)
    generic_ms = timer.ms(lambda: sk.ssd_cuda(*args, chunk=C, form="generic"),
                          10)
    plain_ms = timer.ms(lambda: sref.ssd_chunked_ref(*args, chunk=C), 3)
    flops, nbytes = sk.ssd_cost(*args, C)
    out["ssd"] = _scan_record("ssd", SSD_TPU, path, ms, plain_ms, generic_ms,
                              nbytes, flops)
    del args
    torch.cuda.empty_cache()
    args = ssd_in(4, 8, 200, N, N)                           # chunk 32 -> 8
    out["ssd"]["other_checks"] = [_scan_check(
        lambda *a: sops.ssd(*a, chunk=C),
        lambda *a: sref.ssd_chunked_ref(*a, chunk=8), ssd64, args,
        SCAN_TOL[f32], "ssd, T=200")]
    return out


class _PlainKernels:
    """Route the model's flash attention (unless ``flash`` is False) and
    scans to their plain versions, autograd differentiating them under
    grad (the features gate's and lm_train's reference runs); restores
    the kernels on exit."""

    def __init__(self, flash: bool = True):
        self.flash = flash

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.ssm_scan import ops as sops
        from repro_torch.kernels.ssm_scan import ref as sref
        self.saved = [(sops, "gla", sops.gla), (sops, "ssd", sops.ssd)]
        if self.flash:
            self.saved.append((fa_ops, "flash_attention",
                               fa_ops.flash_attention))
            fa_ops.flash_attention = _fa_plain
        sops.gla = lambda *a, chunk: sref.gla_chunked_ref(*a, chunk=chunk)
        sops.ssd = lambda *a, chunk: sref.ssd_chunked_ref(*a, chunk=chunk)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _standardize(f: torch.Tensor) -> torch.Tensor:
    return (f - f.mean(0)) / (f.std(0, correction=0) + 1e-6)


@torch.no_grad()
def _block_errors(model, tokens) -> dict:
    """max|kernel - plain| / max|plain| of every block's output, each
    block applied to the kernel run's own hidden states, over the users
    in batches of BACKBONE_BATCH."""
    from repro_torch.models.layers import embed_tokens

    errs = {}
    for i in range(0, tokens.shape[0], BACKBONE_BATCH):
        h = embed_tokens(model.embed, model.cfg, tokens[i:i + BACKBONE_BATCH])
        for j, (name, block, p) in enumerate(
                model.decoder_stack.layers(model.stack)):
            with _PlainKernels():
                want = block(p, h)
            h = block(p, h)
            key = f"{j}:{name}"
            errs[key] = max(errs.get(key, 0.0), rel(h, want))
    return errs


def _model_launches(cfg) -> dict:
    """The model's kernel launches in one forward over a batch (a
    features batch, or a serving wave's prefill): flash per dense layer,
    per shared-block use or per encoder and decoder layer (whisper), GLA
    per rwkv6 layer, SSD per mamba layer, each scan on its tiled form."""
    if cfg.family == "ssm":
        return {"gla": cfg.num_layers, "gla:tiled": cfg.num_layers}
    if cfg.family == "hybrid":           # one shared block after each group
        return {"ssd": cfg.num_layers, "ssd:tiled": cfg.num_layers,
                "flash_attention": -(-cfg.num_layers // cfg.shared_attn_every)}
    return {"flash_attention": cfg.num_layers + cfg.encoder_layers}


def _flash_forms(cfg) -> dict:
    """The model's flash launches in one forward by mask: whisper's
    encoder layers bidirectional, every other attention causal."""
    n = _model_launches(cfg).get("flash_attention", 0)
    forms = {"causal": n - cfg.encoder_layers,
             "bidirectional": cfg.encoder_layers}
    return {f: c for f, c in forms.items() if c}


def _backbone_launches(cfg, newton_iters: int) -> dict:
    """Launches one backbone path must count: the model's kernels per
    batch and the DML heads' seg_gram forms."""
    batches = -(-BACKBONE_USERS // BACKBONE_BATCH)
    return {**{k: n * batches for k, n in _model_launches(cfg).items()},
            "design": 1, "gram_and_vec": newton_iters, "residual": 1,
            "residual_meat": 1}


def phase_backbone(seed: int, arch: str):
    """One LM-backbone main path at ``arch``'s full width and depth;
    returns (launch counts, standardized features, y, t, the model —
    which ``lm_serve:<arch>`` serves next)."""
    from repro_torch.config import CausalConfig, ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.core import moments
    from repro_torch.core.dml import DML
    from repro_torch.core.nuisance import backbone_features
    from repro_torch.data.event_dgp import make_event_data
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.seg_gram import kernel as sg_kernel
    from repro_torch.kernels.ssm_scan import kernel as scan_kernel
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, ParallelConfig(use_flash_attention=True), seed=seed)
    data = make_event_data(BACKBONE_USERS, BACKBONE_SEQ, cfg.vocab_size, seed=seed)
    torch.cuda.synchronize()
    log(f"backbone {cfg.name} ({cfg.family}): {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
        f"x {cfg.head_dim}, d_ff {cfg.d_ff}, ssm_state {cfg.ssm_state}, "
        f"chunk {cfg.ssm_chunk}, vocab {cfg.padded_vocab}; "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params "
        f"(fp32), init + data {time.perf_counter() - t0:.2f} s")
    t, y = data.t, data.y
    naive = float((y * t).sum() / t.sum() - (y * (1 - t)).sum()
                  / (1 - t).sum())
    ccfg = CausalConfig(n_folds=5, nuisance_y="ridge", nuisance_t="logistic",
                        engine="parallel", inference="jackknife",
                        row_block=4096, row_block_strategy="pallas")
    est = DML(ccfg)
    torch.cuda.synchronize()
    for counter in (fa_kernel.LAUNCHES, sg_kernel.LAUNCHES,
                    scan_kernel.LAUNCHES, moments.FALLBACKS):
        counter.clear()
    t0 = time.perf_counter()
    feats = backbone_features(model, data.tokens, batch_size=BACKBONE_BATCH)
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = _standardize(feats)
    res = est.fit(y, t, X, gen=torch.Generator().manual_seed(0))
    inf = res.inference()
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = {**dict(fa_kernel.LAUNCHES), **dict(scan_kernel.LAUNCHES),
              **dict(sg_kernel.LAUNCHES)}
    fallbacks = {f: c for f, c in moments.FALLBACKS.items() if c}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # gate 1: the first users' features through the plain versions
    with _PlainKernels():
        plain = backbone_features(model, data.tokens[:GATE_USERS],
                                  batch_size=BACKBONE_BATCH)
    torch.cuda.synchronize()
    feat_err = rel(feats[:GATE_USERS], plain)
    # gate 2: every block on the kernel run's own hidden states
    block_err = _block_errors(model, data.tokens[:GATE_USERS])
    theta = float(res.theta[0])
    se_jk, se_hc0 = float(inf.se[0]), float(res.stderr[0])
    log(f"backbone path {cfg.name}: features {t_feat:.3f} s, fit+jackknife "
        f"{t_fit:.3f} s, peak device memory {peak:.2f} GiB; "
        f"theta={theta:.5f} jackknife se={se_jk:.5f} HC0 se={se_hc0:.5f} "
        f"naive diff-in-means={naive:.5f} (true 2.0) "
        f"|theta-2|/max(se)={abs(theta - 2.0) / max(se_jk, se_hc0):.3f} "
        f"features kernel-vs-plain (first {GATE_USERS} users) "
        f"{feat_err:.3e} ("
        f"{'tol %g' % FEAT_TOL if arch in FEAT_GATED else 'not gated'}), "
        f"worst block {max(block_err, key=block_err.get)} "
        f"{max(block_err.values()):.3e} (tol {BLOCK_TOL:g}) "
        f"launches={counts} fallbacks={fallbacks}")
    expected = _backbone_launches(cfg, ccfg.newton_iters)
    if not (torch.isfinite(res.theta).all() and torch.isfinite(res.cov).all()
            and bool(torch.isfinite(feats).all())):
        raise AssertionError("non-finite features, theta or cov")
    if arch in FEAT_GATED and not feat_err <= FEAT_TOL:
        raise AssertionError(f"features through the kernels and the plain "
                             f"versions differ: {feat_err:.3e}")
    bad = {k: v for k, v in block_err.items() if not v <= BLOCK_TOL}
    if bad:
        raise AssertionError(f"blocks through the kernels and the plain "
                             f"versions differ: {bad}")
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    del plain, feats
    return counts, X, y, t, model


# ---------------------------------------------------------------------------
# LM serving (slice 12): prefill through the kernels, decode through none.
# ---------------------------------------------------------------------------

# lm_serve:<arch>: one wave of LM_WAVE greedy requests whose prompts have
# LM_PROMPT_MIN..LM_PROMPT tokens (drawn from --seed, the first of
# LM_PROMPT so that the wave pads to it), LM_NEW new tokens each, a cache
# of LM_MAX_SEQ positions; then a wave of LM_PROMPT-token prompts, and
# its row LM_SOLO_ROW served alone.
LM_WAVE, LM_PROMPT_MIN, LM_PROMPT, LM_NEW, LM_MAX_SEQ = 8, 96, 128, 32, 256
LM_SOLO_ROW = 0
# pixtral's patch positions at a LM_PROMPT-token prompt: the reference's
# stub splices max(1, min(256, seq_len // 4)) of them at the front
LM_PATCHES = max(1, min(256, LM_PROMPT // 4))
# The serving gates, block by block (all three backbones), on the
# serving run's own hidden states, per residual half of each block
# (``_halves``): the prefill through the kernels against the plain
# versions, each decode step against the half's train form at that
# position, and one row run alone against its row in the batch.  Each
# pair rounds the same fp32 values to bf16 at the half's output and at
# the residual sum, so they may part by one bf16 step at each:
# BLOCK_TOL.  The prefill's fp32 scan states see the same inputs in both
# runs and differ only by the scan's sums in another order: KERNEL_TOL.
# End to end (last-token logits and every cache leaf of the prefill
# against the plain versions; teacher-forced decode logits against the
# train path; the same-length wave's row against the request alone, up
# to the first token where they part), max|a - b| / max|b| is no
# rounding-level quantity: at bf16 the untrained stacks carry one-step
# flips through the layers into the logits of each position (which a
# mean over 256 positions, the features gate, hides).  On the CPU,
# ``tools/serve_drift.py --device cpu`` reads teacher-forced decode
# against train 0.0329 for granite-3-2b cut to 4 of its 40 layers and
# 0.0620 at 12, 0.0253 for rwkv6-3b at 4 of 32 and 0.0488 at 8 (the full
# depth's init std kept): it grows about linearly with depth, to ~0.2
# at full depth.  LM_E2E_TOL is therefore a coarse gate, for
# granite-3-2b and rwkv6-3b (FEAT_GATED), that a cache or position
# fault still fails (it moves the logits by their own size);
# zamba2-1.2b's end-to-end numbers are printed, as its features are.
LM_E2E_TOL = 0.5

# lm_serve:<arch> for the other decoder-only families (slice 15), each
# on a model built for the phase at its published widths, in the
# configs' fp32 parameters.  Depth is cut only where one card's 80 GB or
# the run's time forces it (layers kept here; the rest run whole):
# yi-34b's 60 layers are 138 GB, 8 of them 22 GB (cut for time, as its
# 0.56 B-parameter layers all repeat one block); arctic-480b's one layer
# with all 128 experts is 54.5 GB; deepseek-v3-671b keeps one dense
# (first_k_dense) and one MoE layer with all 256 experts, 56 GB.  In a
# cut model the stacked weights are rescaled to the std the full
# depth's init gives them (the reference's fan-in is the stacked layer
# axis, so 1/sqrt(full layers)), so each layer's gains are the full
# model's.  phi4-mini-3.8b and chatglm3-6b run whole.
LM_FAMILY_ARCHS = ("phi4-mini-3.8b", "chatglm3-6b", "yi-34b", "arctic-480b",
                   "deepseek-v3-671b")
# and the two families with extras (slice 16), whole at their published
# widths and depths: whisper-tiny's 4 + 4 layers over 1500 frames a
# request, pixtral-12b's 40 layers (12.25 B fp32 parameters, 45.6 GiB)
# with LM_PATCHES patch embeddings a request
LM_ENCODER_ARCHS = ("whisper-tiny", "pixtral-12b")
LM_FAMILY_LAYERS = {"yi-34b": 8, "arctic-480b": 1, "deepseek-v3-671b": 2}
# end-to-end gate (LM_E2E_TOL): the dense GQA stacks, as granite's; the
# MoE stacks' end-to-end numbers are printed, not gated — a routing flip
# or a pick dropped in one run and kept in the other moves a token's
# logits by their own size, and the block gates below hold the layers
LM_E2E_GATED = FEAT_GATED + ("phi4-mini-3.8b", "chatglm3-6b", "yi-34b",
                             "pixtral-12b")
# (whisper-tiny is printed, not gated: its untrained encoder's
# bidirectional attention over 1500 frames amplifies one-step bf16
# differences, and ``tools/serve_drift.py --device cpu --arch
# whisper-tiny --layers 4`` reads teacher-forced decode against train
# 0.6228 at its full depth, over LM_E2E_TOL; its halves are gated.)
# MoE blocks: the kernel and plain runs' expert sets may part where a
# one-step difference of the attention output moves a near-tied router
# logit.  With the router logits' spread over E = 128 / 256 experts and
# one bf16 step (2^-8) at a few hundredths of the d_model inputs, a
# token's top-k boundary moves by ~1e-3 of the gap to its neighbour:
# flips should touch well under 1 % of the tokens; MOE_FLIP_MAX = 5 %
# fails a routing or dispatch fault (which moves most tokens) with room.
MOE_FLIP_MAX = 0.05
# The whole MoE block (attention, then the MoE on its output) through
# the kernel and through the plain attention, on the tokens whose
# experts agree: each half parts by up to BLOCK_TOL, and the SwiGLU
# experts carry their input's relative difference about twice (silu(g)
# times u, two linear images of it) before the residual sum rounds
# again, hence 4 x BLOCK_TOL.
MOE_BLOCK_TOL = 4 * BLOCK_TOL
# MLA's attention half, teacher-forced decode (absorbed) against the
# train form (expanded) and a row alone against the batch, in bf16: not
# a rounding-level quantity at deepseek-v3's dense layers.  The
# reference's init takes fan-in from the stacked layer axis, so the
# first_k_dense = 3 dense layers draw std 1/sqrt(3): q and k come out
# ~20x the inputs' scale, the scaled logits in the hundreds, and a
# one-step bf16 difference of q·k (the absorbed form rounds q·wk_b, the
# expanded one c·wk_b; another batch size takes other GEMM tiles) moves
# a near-tied row's softmax off its top key (on an NVIDIA H100 80GB HBM3
# at 700 W: 7.4e-2 and 5.9e-2 against BLOCK_TOL, logits up to 3.7e3,
# 4.7 % of the query rows' top two logits within two bf16 steps; the
# MoE layer's MLA, std 1/sqrt(58), stayed within BLOCK_TOL).  ``_mla_fp32_gates`` therefore holds those two
# gates on the half's fp32-compute twin (same weights, the inputs
# upcast, the fp32 flash template), where a logit moves by ~1e-7 of its
# hundreds: ~1e-4 of a near-tied row's p, MLA_FP32_TOL with room; the
# bf16 numbers are printed, with the share of query rows whose top two
# logits lie within two bf16 steps.
MLA_FP32_TOL = 1e-3


def _lm_counts() -> collections.Counter:
    """Every kernel's launch counters, summed over the wrappers."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.seg_gram import kernel as sg_kernel
    from repro_torch.kernels.ssm_scan import kernel as scan_kernel
    c = collections.Counter()
    for counter in (fa_kernel.LAUNCHES, scan_kernel.LAUNCHES,
                    sg_kernel.LAUNCHES):
        c.update(counter)
    return c


class _ServeRecorder:
    """Wraps a ``BatchServer``'s prefill, decode and sampling: each call's
    kernel launches (the counters' delta), its synchronized ms, the
    logits every token was sampled from, and the prefill's outputs
    (cloned: decode writes the cache in place).  Wrapping changes no
    arithmetic; the server's own loop and sampling run as they are."""

    def __init__(self, server):
        self.server = server
        self.fns = server._prefill, server._decode, server._sample
        server._prefill = self._wrap(self.fns[0], "prefill")
        server._decode = self._wrap(self.fns[1], "decode")
        server._sample = self._sample
        self.start()

    def close(self):
        """Give the server its own calls back.  The wrapped server and
        this recorder refer to each other, and until the cycle is broken
        (or the collector runs) it keeps the model's weights alive; so
        would the server's bound ``_sample`` set on the server itself, so
        the class's method takes its place again."""
        self.server._prefill, self.server._decode = self.fns[:2]
        del self.server._sample
        self.server = self.fns = None

    def start(self):
        self.calls, self.logits, self.prefill_out = [], [], None

    def _wrap(self, fn, kind):
        from repro_torch.inference.executor import tree_map

        def call(*a, **kw):
            torch.cuda.synchronize()
            before = _lm_counts()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.calls.append((kind, ms, dict(_lm_counts() - before)))
            if kind == "prefill":
                self.prefill_out = (out[0].clone(),
                                    tree_map(torch.clone, out[1]))
            return out
        return call

    def _sample(self, logits, temperature):
        self.logits.append(logits[:, -1].clone())
        return self.fns[2](logits, temperature)


def _halves(model, kind: str, p, blocks=None, kv=None) -> list:
    """A block's residual halves, each as (name, train(x), prefill(x) ->
    (y, cache), decode(x, cache, pos) -> (y, cache), route): attention
    (GQA or MLA) then MLP or MoE (dense), time-mix then channel-mix
    (rwkv), the mamba block whole; whisper's encoder layer: its
    bidirectional attention, then its MLP (no decode form); its decoder
    layer: causal self-attention, cross-attention over ``kv`` (the
    layer's encoder K/V of the whole wave, and the solo row's slice
    (rows) of it, which a call on one row reads), then its MLP.  Their
    composition is the block (``_block_gates`` checks it bitwise against
    the port's ``Blocks`` or ``models/encdec.py``).  ``route`` is None
    but for the MoE half: a dict whose "last" holds the routing
    (``moe_apply``'s stats: the picks and whether each was kept) of the
    half's latest call.  ``blocks`` (the model's by default) binds them
    to another config: the fp32 twin of ``_mla_fp32_gates``."""
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.models.layers import mlp_apply

    if kind in ("encoder", "decoder"):
        cfg, norm, par = model.cfg, model.norm, model.parallel
    else:
        blocks = blocks or model.decoder_stack.blocks
        cfg, norm = blocks.cfg, blocks.norm

    def stateless(f):
        return (lambda x: x + f(x), lambda x: (x + f(x), {}),
                lambda x, c, pos: (x + f(x), {}))

    def mixer(train, prefill, decode):
        def pre(x):
            y, c = prefill(x)
            return x + y, c

        def dec(x, c, pos):
            y, c = decode(x, c, pos)
            return x + y, c
        return (lambda x: x + train(x), pre, dec)

    if kind == "encoder":
        return [("attn",) + stateless(lambda x: attn.gqa_train(
                    p["attn"], cfg, norm(p["ln1"], x), par, causal=False))
                + (None,),
                ("mlp",) + stateless(lambda x: mlp_apply(
                    p["mlp"], cfg, norm(p["ln2"], x))) + (None,)]
    if kind == "decoder":
        whole, rows = kv
        kv_of = (lambda x: whole if x.shape[0] == whole["k"].shape[0]
                 else {n: t[rows] for n, t in whole.items()})
        n1 = lambda x: norm(p["ln1"], x)              # noqa: E731
        return [("self",) + mixer(
                    lambda x: attn.gqa_train(p["self"], cfg, n1(x), par,
                                             causal=True),
                    lambda x: attn.gqa_prefill(p["self"], cfg, n1(x), par),
                    lambda x, c, pos: attn.gqa_decode(p["self"], cfg, n1(x),
                                                      c, pos)) + (None,),
                ("cross",) + stateless(lambda x: attn.cross_attn(
                    p["cross"], cfg, norm(p["ln2"], x), kv_of(x))) + (None,),
                ("mlp",) + stateless(lambda x: mlp_apply(
                    p["mlp"], cfg, norm(p["ln3"], x))) + (None,)]
    if kind == "dense":
        n1 = lambda x: norm(p["ln1"], x)              # noqa: E731
        halves = [("attn",) + mixer(
            lambda x: blocks.attn_train(p["attn"], n1(x)),
            lambda x: blocks.attn_prefill(p["attn"], n1(x)),
            lambda x, c, pos: blocks.attn_decode(p["attn"], n1(x), c, pos))
            + (None,)]
        if "moe" not in p:
            return halves + [("mlp",) + stateless(
                lambda x: blocks.ffn(p, x)[0]) + (None,)]
        route = {}

        def moe_y(x):                 # blocks.ffn's call, with its stats
            st = {}
            y, _ = moe_mod.moe_apply(p["moe"], cfg, norm(p["ln2"], x), st)
            route["last"] = st
            return y
        return halves + [("moe",) + stateless(moe_y) + (route,)]
    if kind == "rwkv":
        n1 = lambda x: norm(p["ln1"], x)              # noqa: E731
        n2 = lambda x: norm(p["ln2"], x)              # noqa: E731
        ch = cfg.ssm_chunk
        return [("tm",) + mixer(
                    lambda x: rwkv_mod.time_mix_train(p["tm"], cfg, n1(x),
                                                      chunk=ch),
                    lambda x: rwkv_mod.time_mix_prefill(p["tm"], cfg, n1(x),
                                                        chunk=ch),
                    lambda x, c, pos: rwkv_mod.time_mix_decode(
                        p["tm"], cfg, n1(x), c)) + (None,),
                ("cm",) + mixer(
                    lambda x: rwkv_mod.channel_mix_train(p["cm"], cfg,
                                                         n2(x)),
                    lambda x: rwkv_mod.channel_mix_prefill(p["cm"], cfg,
                                                           n2(x)),
                    lambda x, c, pos: rwkv_mod.channel_mix_decode(
                        p["cm"], cfg, n2(x), c)) + (None,)]
    return [("mamba", lambda x: blocks.mamba_train(p, x),
             lambda x: blocks.mamba_prefill(p, x),
             lambda x, c, pos: blocks.mamba_decode(p, x, c, pos), None)]


def _experts_of(route) -> torch.Tensor:
    """Each token's expert set (its picks sorted): (B, S, k)."""
    return route["idx"].sort(-1).values


def _agree(a, b) -> torch.Tensor:
    """(B, S): where two routings pick the same expert set."""
    return (_experts_of(a) == _experts_of(b)).all(-1)


def _rel_on(a, b, keep) -> float:
    """``rel`` over the tokens ``keep`` (B, S) marks; 0 if none."""
    return rel(a[keep], b[keep]) if bool(keep.any()) else 0.0


@torch.no_grad()
def _mla_fp32_gates(model, p, pre_in, dec_in, prompt: int, row: int
                    ) -> dict:
    """An MLA attention half's ``train`` and ``solo`` gates on its
    fp32-compute twin: the same weights and the bf16 inputs upcast,
    prefill over ``pre_in``, then decode at each later position; also
    the share of the prefill's query rows whose top two scaled logits
    lie within two bf16 steps of each other (``near-tie share``) and
    the largest |logit|, from the bf16 model's own q and k."""
    from repro_torch.inference.executor import tree_map
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import Blocks

    cfg = model.cfg
    twin = Blocks(dataclasses.replace(cfg, compute_dtype=torch.float32),
                  model.decoder_stack.blocks.parallel)
    _, train, prefill, decode, _ = _halves(model, "dense", p, twin)[0]
    T = prompt + len(dec_in)
    x0, xs = pre_in.float(), [h.float() for h in dec_in]
    r = slice(row, row + 1)
    out, cache = prefill(x0)
    out_r, cache_r = prefill(x0[r])
    res = {"solo prefill": rel(out_r, out[r])}
    for leaf, c in cache.items():
        res[f"solo prefill {leaf}"] = rel(cache_r[leaf], c[r])
    cache = {n: torch.cat([c, c.new_zeros((c.shape[0], T - prompt)
                                          + c.shape[2:])], 1)
             for n, c in cache.items()}
    outs, step = [], 0.0
    for t, h in zip(range(prompt, T), xs):
        alone = tree_map(lambda a: a[r].clone(), cache)
        o, cache = decode(h, cache, t)
        o_r, alone = decode(h[r], alone, t)
        step = max(step, rel(o_r, o[r]))
        outs.append(o)
    res["solo decode"] = step
    want = train(torch.cat([x0] + xs, 1))[:, prompt:]
    res["train decode"] = rel(torch.cat(outs, 1), want)
    # the bf16 model's scaled logits over the prompt
    h = model.decoder_stack.blocks.norm(p["ln1"], pre_in)
    B, S, _ = h.shape
    pos = torch.arange(S, device=h.device).expand(B, S)
    q_nope, q_rope = attn._mla_q(p["attn"], cfg, h, pos)
    c_kv, k_rope = attn._mla_latent(p["attn"], cfg, h, pos)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv,
                          p["attn"]["wk_b"].to(cfg.compute_dtype))
    lg = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
          + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
          ) * attn._scale(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    lg = lg.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                   device=h.device).triu(1), float("-inf"))
    top = lg[:, :, 1:].topk(2, dim=-1).values        # rows with 2+ keys
    near = (top[..., 0] - top[..., 1]) <= 2 * 2 ** -8 * top[..., 0].abs()
    return {"gates": res, "near-tie share": float(near.double().mean()),
            "max |logit|": float(top[..., 0].abs().max())}


@torch.no_grad()
def _serve_block_errors(model, tokens, prompt: int, row: int,
                        extras=None) -> dict:
    """The serving gates block by block on the serving run's own hidden
    states — each block's residual halves (``_halves``) in prefill form
    over ``tokens[:, :prompt]``, then in decode form for each later
    position, each half's outputs the next half's inputs:

      * ``plain``: the prefill through the kernels against the plain
        versions, output and every cache leaf;
      * ``train``: the decode outputs against the half's train form over
        the same inputs, at every decoded position;
      * ``solo``: row ``row`` alone (its prefill, then each decode step
        on its own copy of the row's cache) against its row in the
        batch, output and cache leaves.

    Halves, not blocks: the decode form of a half may round one of its
    values where the train form does not (rwkv6's time-mix readout is
    fp32 out of the step and bf16 out of the scan, as in the reference),
    and within one block the next half's gains would carry that step
    past the rounding level the gate holds.  Each block's composed
    prefill and decode outputs are checked bitwise against the port's
    ``Blocks`` forms (whisper's: ``models/encdec.py``'s layer forms).

    whisper (``extras["frames"]``) walks its encoder layers first, over
    the frames with their positions: ``plain`` and ``solo`` on the
    prefill form (the encoder has no decode form, so no ``train``);
    then its decoder layers over the tokens, each cross-attention half
    over the layer's K/V of the walk's own encoder output.  pixtral's
    ``extras["patch_embeds"]`` take the first positions of the tokens'
    embeddings, as in the model.

    A MoE half is compared only on the tokens whose expert sets agree
    between the two runs (a one-step difference of a router input can
    flip a near-tied pick), and ``train`` also only where the train
    form (one dispatch group of the whole sequence) dropped none of the
    token's picks; decode (one token a group) drops none.  Its
    ``moe`` entry: the prefill's dropped picks, the train form's, the
    decode steps' (must be 0), the tokens left out of ``train`` and
    ``solo``, and the kernel-vs-plain check of the whole block — the
    MoE half applied to the attention half's plain output as well:
    the share of tokens whose expert set differs from the kernel run's
    (``flip share``) and the block's output on the other tokens
    (``block``).  An MLA attention half's ``train`` and ``solo`` gates
    move to ``mla fp32`` (``_mla_fp32_gates``; its bf16 numbers under
    ``mla bf16``, with the near-tie share).  Returns {gate: {"<j>:<block>
    <half>": {what: max|a - b| / max|b|}}}."""
    from repro_torch.models import encdec
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.params import layer_slice

    cfg, extras = model.cfg, extras or {}
    T = tokens.shape[1]
    errs = {"plain": {}, "train": {}, "solo": {}, "moe": {}, "mla fp32": {},
            "mla bf16": {}}
    j = 0
    if cfg.is_encdec:
        ct, fr = cfg.compute_dtype, extras["frames"]
        h = fr.to(ct) + model.encoder["pos"][:fr.shape[1]].to(ct)
        for i in range(cfg.encoder_layers):
            h, _ = _block_gates(model, errs, f"{j}:encoder {i}", "encoder",
                                layer_slice(model.encoder["layers"], i), h,
                                [], h.shape[1], row)
            j += 1
        cross = encdec.encoder_cross_kv(
            model.decoder, cfg, model.norm(model.encoder["ln_f"], h))
        blocks = [(f"decoder {i}", "decoder", layer_slice(model.decoder, i),
                   {n: c[i] for n, c in cross.items()})
                  for i in range(cfg.num_layers)]
        x = embed_tokens(model.embed, cfg, tokens)
    else:
        blocks = [(name, kind, p, None) for name, kind, _, p in
                  model.decoder_stack.serve_layers(model.stack)]
        x = model._embed_in(tokens, None, extras.get("patch_embeds"))
    pre_in, dec_in = x[:, :prompt], [x[:, t:t + 1] for t in range(prompt, T)]
    for name, kind, p, kv in blocks:
        pre_in, dec_in = _block_gates(model, errs, f"{j}:{name}", kind, p,
                                      pre_in, dec_in, prompt, row, kv)
        j += 1
    return errs


def _block_gates(model, errs: dict, label: str, kind: str, p, pre_in,
                 dec_in: list, prompt: int, row: int, kv=None):
    """``_serve_block_errors``'s gates of one block (its ``kind`` and
    weights ``p``, its cross K/V ``kv`` for a whisper decoder layer) on
    the prefill input ``pre_in`` and the decode inputs ``dec_in`` (none
    for an encoder layer), written into ``errs`` under ``label``.
    Returns the block's (prefill output, decode outputs)."""
    from repro_torch.convert import _flatten
    from repro_torch.inference.executor import tree_map
    from repro_torch.models import encdec

    T = prompt + len(dec_in)
    r = slice(row, row + 1)
    mla = model.cfg.attention == "mla"
    block_in, block_dec = pre_in, dec_in
    caches, plain_out = {}, None
    grows = kind in ("dense", "decoder")        # a KV cache, not a state
    for half, train, prefill, decode, route in _halves(
            model, kind, p, kv=None if kv is None else (kv, r)):
        key = f"{label} {half}"
        out, cache = prefill(pre_in)
        rk = route["last"] if route is not None else None
        with _PlainKernels():
            out_p, cache_p = prefill(pre_in)
        out_r, cache_r = prefill(pre_in[r])
        flat, flat_p, flat_r = (_flatten(c) for c in
                                (cache, cache_p, cache_r))
        plain = {"out": rel(out, out_p)}
        if route is None:
            solo = {"prefill": rel(out_r, out[r])}
        else:
            keep_r = _agree(route["last"], {"idx": rk["idx"][r]})
            solo = {"prefill": _rel_on(out_r, out[r], keep_r)}
            moe = {"prefill drops": int((~rk["kept"]).sum()),
                   "solo left out": int((~keep_r).sum())}
        for leaf, c in flat.items():
            plain[leaf] = rel(c, flat_p[leaf])
            solo[f"prefill {leaf}"] = rel(flat_r[leaf], c[r])
        caches[half] = tree_map(torch.clone, cache)
        if grows and cache:               # room for the decoded tokens
            cache = {n: torch.cat([c, c.new_zeros(
                (c.shape[0], T - prompt) + c.shape[2:])], 1)
                for n, c in cache.items()}
        outs, step, step_leaves = [], 0.0, 0.0
        dec_routes, dec_drops = [], 0
        for t, h in zip(range(prompt, T), dec_in):
            alone = tree_map(lambda a: a[r].clone(), cache)
            o, cache = decode(h, cache, t)
            if route is not None:
                rd = route["last"]
                dec_routes.append(rd)
                dec_drops += int((~rd["kept"]).sum())
            o_r, alone = decode(h[r], alone, t)
            if route is None:
                step = max(step, rel(o_r, o[r]))
            else:
                keep = _agree(route["last"], {"idx": rd["idx"][r]})
                moe["solo left out"] += int((~keep).sum())
                step = max(step, _rel_on(o_r, o[r], keep))
            fa, fc = _flatten(alone), _flatten(cache)
            step_leaves = max([step_leaves] + [rel(fa[k], fc[k][r])
                                               for k in fa])
            outs.append(o)
        if dec_in:                        # an encoder layer has none
            solo["decode"], solo["decode leaves"] = step, step_leaves
            want = train(torch.cat([pre_in] + dec_in, 1))[:, prompt:]
            got = torch.cat(outs, 1)
        if route is None:
            if dec_in:
                errs["train"][key] = {"decode": rel(got, want)}
        else:
            rt = route["last"]
            dec = {"idx": torch.cat([d["idx"] for d in dec_routes], 1)}
            tr = {"idx": rt["idx"][:, prompt:]}
            keep = _agree(dec, tr) & rt["kept"][:, prompt:].all(-1)
            errs["train"][key] = {"decode": _rel_on(got, want, keep)}
            moe.update({"train drops": int((~rt["kept"]).sum()),
                        "decode drops": dec_drops,
                        "train left out": int((~keep).sum())})
            # the whole block, kernel against plain: this half on the
            # attention half's plain output too
            out_pp, _ = prefill(plain_out)
            agree = _agree(rk, route["last"])
            moe["flip share"] = 1.0 - float(agree.double().mean())
            moe["block"] = _rel_on(out, out_pp, agree)
            errs["moe"][key] = moe
        errs["plain"][key], errs["solo"][key] = plain, solo
        if mla and half == "attn":
            tw = _mla_fp32_gates(model, p, pre_in, dec_in, prompt, row)
            errs["mla fp32"][key] = tw["gates"]
            errs["mla bf16"][key] = {
                **{f"solo {k}": v for k, v in
                   errs["solo"].pop(key).items()},
                **{f"train {k}": v for k, v in
                   errs["train"].pop(key).items()},
                "near-tie share": tw["near-tie share"],
                "max |logit|": tw["max |logit|"]}
        pre_in, dec_in, plain_out = out, outs, out_p
    # the halves compose to the port's block, bit for bit
    cfg, par = model.cfg, model.parallel
    if kind == "encoder":
        out_b, dec_b = encdec.encoder_layer(p, cfg, block_in, par), None
    else:
        state = {"dense": lambda: caches["attn"],
                 "decoder": lambda: caches["self"],
                 "rwkv": lambda: {"tm": caches["tm"], "cm": caches["cm"]},
                 "mamba": lambda: caches["mamba"]}[kind]()
        if grows:                             # as the walk grew it
            state = {n: torch.cat([c, c.new_zeros(
                (c.shape[0], T - prompt) + c.shape[2:])], 1)
                for n, c in state.items()}
        if kind == "decoder":
            out_b, _ = encdec.decoder_layer_prefill(p, cfg, block_in, kv,
                                                    par)
            dec_b, _ = encdec.decoder_layer_decode(p, cfg, block_dec[0],
                                                   state, kv, prompt)
        else:
            blocks = model.decoder_stack.blocks
            out_b, _ = getattr(blocks, kind + "_prefill")(p, block_in)
            dec_b, _ = getattr(blocks, kind + "_decode")(p, block_dec[0],
                                                         state, prompt)
    if not (torch.equal(out_b, pre_in)
            and (dec_b is None or torch.equal(dec_b, dec_in[0]))):
        raise AssertionError(f"{label}: the halves do not compose to the "
                             f"port's block")
    return pre_in, dec_in


def _serve_block_failures(errs: dict) -> dict:
    """Block errors over their tolerance: KERNEL_TOL for the prefill's
    fp32 scan states against the plain scans, BLOCK_TOL otherwise; a
    MoE block's flip share MOE_FLIP_MAX, its block error on the agreeing
    tokens MOE_BLOCK_TOL, and no dropped pick in decode; an MLA attention
    half's fp32-twin gates MLA_FP32_TOL."""
    bad = {}
    for gate, per_block in errs.items():
        if gate == "mla bf16":                  # printed, not gated
            continue
        for block, e in per_block.items():
            for what, v in e.items():
                if gate == "mla fp32":
                    tol = MLA_FP32_TOL
                elif gate == "moe":
                    tol = {"flip share": MOE_FLIP_MAX, "block": MOE_BLOCK_TOL,
                           "decode drops": 0}.get(what)
                    if tol is None:
                        continue
                else:
                    tol = (KERNEL_TOL if gate == "plain"
                           and what in ("s", "ssm") else BLOCK_TOL)
                if not v <= tol:
                    bad[f"{gate} {block} {what}"] = v
    return bad


def _cast_ms(model) -> float:
    """ms to cast every weight a decode step reads (the stack's or the
    decoder's, and the unembedding table) to the compute dtype once, as
    each step does."""
    ct = model.cfg.compute_dtype
    table = (model.embed["embedding"] if model.cfg.tie_embeddings
             else model.embed["unembed"])
    ws = [w for n, w in model.named_parameters()
          if n.startswith(("stack.", "decoder."))]
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    s.record()
    for w in ws + [table]:
        w.to(ct)
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def _attn_dims(cfg):
    """(q.k, v) head dims of the model's flash launches."""
    if cfg.attention == "mla":
        return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
    return (cfg.head_dim, cfg.head_dim)


def _lm_extras(cfg, seed: int, dev) -> dict:
    """A wave's extras, 0.1 · normal from ``seed`` in the compute dtype,
    as the reference's tests draw them: whisper's frames (LM_WAVE,
    max_source_positions, d_model), pixtral's patch embeddings (LM_WAVE,
    LM_PATCHES, d_model); none for the other families."""
    shape = ((LM_WAVE, cfg.max_source_positions, cfg.d_model)
             if cfg.is_encdec else (LM_WAVE, LM_PATCHES, cfg.d_model)
             if cfg.family == "vlm" else None)
    if shape is None:
        return {}
    g = torch.Generator(device=dev).manual_seed(seed)
    x = 0.1 * torch.randn(shape, generator=g, device=dev)
    return {"frames" if cfg.is_encdec else "patch_embeds":
            x.to(cfg.compute_dtype)}


def phase_lm_serve(seed: int, model, reduced=None):
    """``lm_serve:<arch>``: ``launch/serve.py``'s ``BatchServer`` over the
    model ``backbone:<arch>`` built (full width and depth) or
    ``phase_lm_family`` built (``reduced`` says how it was cut), with the
    four gates: the prefill through the kernels against the plain
    versions, teacher-forced decode against the train path, the wave
    against a request alone, and the launch counts (each wave's prefill
    launches exactly ``_model_launches``, all at the model's head dims
    and in the model's forms (``_flash_forms``), decode steps none, no
    fallback).  whisper's waves take frames and pixtral's patch
    embeddings (``_lm_extras``); a request alone takes its row's.
    Returns (launches of the served calls, metrics)."""
    from repro_torch.convert import _flatten
    from repro_torch.core import moments
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.serve import BatchServer, Request

    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    lens = rng.integers(LM_PROMPT_MIN, LM_PROMPT + 1, LM_WAVE)
    lens[0] = LM_PROMPT
    draw = lambda n: torch.from_numpy(                      # noqa: E731
        rng.integers(0, cfg.vocab_size, int(n))).to(dev)
    ragged = [draw(n) for n in lens]
    same = [draw(LM_PROMPT) for _ in range(LM_WAVE)]
    ex_wave, ex_same = (_lm_extras(cfg, seed + i, dev) for i in (1, 2))
    solo_row = slice(LM_SOLO_ROW, LM_SOLO_ROW + 1)
    expected = _model_launches(cfg)
    moments.FALLBACKS.clear()
    dims_before = collections.Counter(fa_kernel.LAUNCHES_BY_DIMS)
    forms_before = collections.Counter(fa_kernel.LAUNCHES_BY_FORM)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    server = BatchServer(model, max_seq=LM_MAX_SEQ)
    rec = _ServeRecorder(server)
    try:
        served = collections.Counter()
        waves = {}
        for name, prompts, extras in (
                ("wave", ragged, ex_wave), ("same-length", same, ex_same),
                ("solo", [same[LM_SOLO_ROW]],
                 {k: v[solo_row] for k, v in ex_same.items()})):
            rec.start()
            outs = server.serve_wave([Request(q, max_new_tokens=LM_NEW)
                                      for q in prompts], extras=extras)
            for kind, _, c in rec.calls:
                served.update(c)
            # gate 4: the prefill launches the table's counts, decode none
            got = [c for _, _, c in rec.calls]
            if got[0] != expected or any(got[1:]):
                raise AssertionError(f"{name}: prefill launches {got[0]} "
                                     f"(expected {expected}), decode launches "
                                     f"{[c for c in got[1:] if c]}")
            waves[name] = dict(outs=outs, calls=rec.calls, logits=rec.logits,
                               prefill=rec.prefill_out)
    finally:
        rec.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fallbacks = {f: c for f, c in moments.FALLBACKS.items() if c}
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    # every served flash launch ran at the model's head dims
    dims = dict(collections.Counter(fa_kernel.LAUNCHES_BY_DIMS) - dims_before)
    want_dims = ({_attn_dims(cfg): served["flash_attention"]}
                 if served.get("flash_attention") else {})
    if dims != want_dims:
        raise AssertionError(f"flash launches by head dims {dims}, "
                             f"expected {want_dims}")
    # and by mask: each of the three prefills launches the model's forms
    forms = dict(collections.Counter(fa_kernel.LAUNCHES_BY_FORM)
                 - forms_before)
    want_forms = {f: 3 * n for f, n in _flash_forms(cfg).items()}
    if forms != want_forms:
        raise AssertionError(f"flash launches by form {forms}, expected "
                             f"{want_forms}")

    # gate 1, end to end: the wave's prefill against the plain versions.
    # Logits are compared over the real vocabulary: the padded slots hold
    # -1e30 on both sides and would set max|b|.
    V = cfg.vocab_size
    w = waves["wave"]
    toks = torch.stack([torch.nn.functional.pad(q, (LM_PROMPT - len(q), 0))
                        for q in ragged])
    with _PlainKernels():
        plain_l, plain_c = model.prefill(toks, **ex_wave)
    got_l, got_c = w["prefill"]
    flat, flat_p = _flatten(got_c), _flatten(plain_c)
    e2e = {"prefill logits": rel(got_l[..., :V], plain_l[..., :V]),
           "prefill cache": max(rel(flat[k], flat_p[k]) for k in flat)}
    del plain_c, got_c, flat, flat_p
    # gate 2, end to end: decode logits at each generated position against
    # the train path over the whole sequence (teacher-forced: the wave's
    # own tokens fed back in)
    gen_toks = torch.tensor([c.tokens for c in w["outs"]], device=dev)
    full = torch.cat([toks, gen_toks], 1)
    with torch.no_grad():
        h = model._hidden(full, **ex_wave)
        train_l = model._logits(h[:, LM_PROMPT - 1:LM_PROMPT - 1 + LM_NEW])
    e2e["decode vs train"] = max(rel(lg[..., :V], train_l[:, s, :V])
                                 for s, lg in enumerate(w["logits"]))
    del h, train_l
    # gate 3, end to end: the same-length wave's row against it alone
    ws, solo = waves["same-length"], waves["solo"]
    a, b = ws["outs"][LM_SOLO_ROW].tokens, solo["outs"][0].tokens
    part = next((i for i, (u, v) in enumerate(zip(a, b)) if u != v), None)
    upto = len(a) if part is None else part + 1
    e2e["solo logits"] = max(rel(solo["logits"][s][0, :V],
                                 ws["logits"][s][LM_SOLO_ROW, :V])
                             for s in range(upto))
    margin = None
    if part is not None:
        lw = ws["logits"][part][LM_SOLO_ROW, :V].double()
        margin = float((lw[a[part]] - lw[b[part]]) / lw.abs().max())
    # gates 1-3 block by block, on the first wave's own tokens
    block = _serve_block_errors(model, full, LM_PROMPT, LM_SOLO_ROW,
                                ex_wave)
    worst = {g: max(((k, max(e.values())) for k, e in per.items()),
                    key=lambda kv: kv[1])
             for g, per in block.items()
             if per and g not in ("moe", "mla bf16")}
    moe = None
    if block["moe"]:
        per = block["moe"].values()
        moe = {what: (max if what in ("flip share", "block") else sum)(
                   e[what] for e in per)
               for what in next(iter(per))}

    prefill_ms = [ms for kind, ms, _ in ws["calls"] if kind == "prefill"][0]
    decode_ms = [ms for kind, ms, _ in ws["calls"] if kind == "decode"]
    lat = ws["outs"][0].latency_s
    metrics = {
        "card": card_line(), "prompt": LM_PROMPT, "wave": LM_WAVE,
        "new_tokens": LM_NEW, "prefill_ms": prefill_ms,
        "decode_ms_per_step": float(np.mean(decode_ms)),
        "wave_s": lat, "tokens_per_s": LM_WAVE * LM_NEW / lat,
        "first_wave_s": w["outs"][0].latency_s,
        "solo_latency_s": solo["outs"][0].latency_s,
        "solo_prefill_ms": [ms for k, ms, _ in solo["calls"]
                            if k == "prefill"][0],
        "solo_decode_ms_per_step": float(np.mean(
            [ms for k, ms, _ in solo["calls"] if k == "decode"])),
        "weight_cast_ms": _cast_ms(model), "peak_gib": peak,
        "e2e": e2e, "solo_parts_at": part, "solo_margin": margin,
        "worst_block": {g: list(kv) for g, kv in worst.items()},
        "launches_per_prefill": expected,
        "flash_launches_by_dims": {f"{a}x{b}": n for (a, b), n in
                                   dims.items()},
        "flash_launches_by_form": forms,
        "extras": {k: list(v.shape) for k, v in ex_wave.items()},
        "moe": moe, "moe_blocks": block["moe"] or None,
        "mla_bf16": block["mla bf16"] or None,
        "layers": cfg.num_layers, "reduced": reduced}
    solo_note = ("equal" if part is None else
                 f"part at step {part} (margin {margin:.3e})")
    log(f"lm_serve {cfg.name} ({metrics['card']}): prefill {LM_WAVE} x "
        f"{LM_PROMPT} {prefill_ms:.3f} ms, decode "
        f"{metrics['decode_ms_per_step']:.3f} ms a step ({LM_WAVE} tokens), "
        f"wave of {LM_WAVE} x {LM_NEW} new tokens {lat:.3f} s = "
        f"{metrics['tokens_per_s']:.1f} tokens/s (first wave "
        f"{metrics['first_wave_s']:.3f} s), solo request "
        f"{metrics['solo_latency_s']:.3f} s (prefill "
        f"{metrics['solo_prefill_ms']:.3f} ms, decode "
        f"{metrics['solo_decode_ms_per_step']:.3f} ms a step), weights "
        f"cast once {metrics['weight_cast_ms']:.3f} ms, peak device memory "
        f"{peak:.2f} GiB; launches per prefill {expected} (served: by head "
        f"dims {dims}, by form {forms}), per decode step none; extras "
        f"{metrics['extras'] or 'none'}; end to end {e2e} "
        f"({'tol %g' % LM_E2E_TOL if cfg.name in LM_E2E_GATED else 'not gated'})"
        f"; solo tokens {solo_note}; worst blocks {worst} (tol "
        f"{BLOCK_TOL:g}, fp32 states {KERNEL_TOL:g})"
        + ("" if moe is None else
           f"; MoE (all layers): dropped picks {moe['prefill drops']} in "
           f"the wave's block prefill, {moe['train drops']} in the train "
           f"form, {moe['decode drops']} in decode; tokens left out of the "
           f"train gate {moe['train left out']}, of the solo gate "
           f"{moe['solo left out']}; kernel-vs-plain expert-set flip share "
           f"{moe['flip share']:.4f} (max {MOE_FLIP_MAX:g}), block error on "
           f"agreeing tokens {moe['block']:.3e} (tol {MOE_BLOCK_TOL:g})")
        + ("" if not block["mla bf16"] else
           f"; MLA attention halves in bf16 (train and solo not gated: "
           f"their fp32 twin is, tol {MLA_FP32_TOL:g}) {block['mla bf16']}"))
    finite = all(bool(torch.isfinite(lg.float()).all())
                 for wv in waves.values() for lg in wv["logits"])
    if not finite:
        raise AssertionError("non-finite logits")
    bad = _serve_block_failures(block)
    if bad:
        raise AssertionError(f"serving blocks over tolerance: {bad}")
    if cfg.name in LM_E2E_GATED:
        over = {k: v for k, v in e2e.items() if not v <= LM_E2E_TOL}
        if over:
            raise AssertionError(f"end to end over {LM_E2E_TOL}: {over}")
    return dict(served), metrics


def family_model(seed: int, arch: str):
    """``arch`` at its published widths in its config's dtypes, with the
    layers LM_FAMILY_LAYERS keeps (one dense layer of deepseek-v3's
    first_k_dense kept beside its MoE layer), port init from ``seed`` on
    the card, the stacked "scaled" weights of a cut stack rescaled to
    the full depth's std.  Returns (model, reduced): the cuts, each as
    [kept, published]."""
    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import map_schema

    full = get_config(arch)
    L = LM_FAMILY_LAYERS.get(arch, full.num_layers)
    cfg = dataclasses.replace(
        full, num_layers=L, first_k_dense=min(full.first_k_dense, L - 1))
    # layers of each stack: kept, published
    stacks = {"stack.layers": (L, full.num_layers),
              "stack.dense_layers": (cfg.first_k_dense, full.first_k_dense),
              "stack.moe_layers": (L - cfg.first_k_dense,
                                   full.num_layers - full.first_k_dense)}
    model = Model(cfg, ParallelConfig(use_flash_attention=True), seed=seed)
    params = dict(model.named_parameters())
    scaled = []
    map_schema(lambda path, d: scaled.append(path) if d.init == "scaled"
               else None, Model.schema_of(cfg))
    with torch.no_grad():
        for path in scaled:
            for prefix, (kept, pub) in stacks.items():
                if path.startswith(prefix + ".") and kept != pub:
                    params[path].mul_((kept / pub) ** 0.5)
    reduced = {}
    if L != full.num_layers:
        reduced["num_layers"] = [L, full.num_layers]
        if full.first_k_dense:
            reduced["first_k_dense"] = [cfg.first_k_dense,
                                        full.first_k_dense]
        reduced["init"] = ("stacked weights rescaled by sqrt(kept / "
                           "published layers) to the full depth's std")
    return model, reduced


def phase_lm_family(seed: int, arch: str):
    """``lm_serve:<arch>`` for a family with no backbone phase: the model
    of ``family_model``, then ``phase_lm_serve`` over it (features are
    checked there, on the wave's prompts, through the per-block gates).
    Returns what ``phase_lm_serve`` returns; the model is freed."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, reduced = family_model(seed, arch)
    torch.cuda.synchronize()
    cfg = model.cfg
    n = sum(p.numel() for p in model.parameters())
    log(f"lm_serve {arch}: {cfg.num_layers} layers ({cfg.family}, "
        f"{cfg.attention}{', first_k_dense %d' % cfg.first_k_dense if cfg.first_k_dense else ''}), "
        f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
        f"x {cfg.head_dim}, flash head dims {_attn_dims(cfg)}, d_ff "
        f"{cfg.d_ff}, experts {cfg.num_experts} top-{cfg.experts_per_token}"
        f", encoder layers {cfg.encoder_layers} over "
        f"{cfg.max_source_positions if cfg.is_encdec else 0} frames"
        f", vocab {cfg.padded_vocab}; {n / 1e9:.3f} B params "
        f"({str(cfg.param_dtype).replace('torch.', '')}, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB), init "
        f"{time.perf_counter() - t0:.2f} s; reduced {reduced or 'none'}")
    try:
        return phase_lm_serve(seed, model, reduced)
    finally:
        del model
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The task runtime, the refutation suite, the sweep's cells mode and jobs.
# ---------------------------------------------------------------------------

# runtime:budget: the bootstrap cell's B, and the chunk at which the
# budget is set to the memory model's peak (it does not divide B)
RT_BOOT_B, RT_BUDGET_AT = 32, 10
# a chunk's measured peak may exceed the budget by at most this factor
RT_PEAK_SLACK = 1.10
REFUTE_REPS = 3                      # the reference's default refits
# sweep:cells — 32 segments (cut from the sweep cell's 64 for time) x
# 500 covariates at 2^18 rows (cut from 2^20 for time), under a budget of
# the dml cells' memory model (probed on the card) at CELLS_AT cells,
# which chunks them
CELLS_N, CELLS_E, CELLS_AT = 2 ** 18, 32, 8
# with_ci at 2^14 rows (cut from 2^16 for time), B = 8 (cut from 16)
CI_E, CI_N, CI_B, CI_CHUNKS = 16, 2 ** 14, 8, (64, 96)
LOOP_E, LOOP_N = 8, 2 ** 16
JOB_E, JOB_N = 16, 2 ** 16


class _launch_log:
    """Every seg_gram launch made inside the block, counted by
    (form, B, n, S, qL, qR) through the wrapper's launch observers."""

    def __enter__(self):
        from repro_torch.kernels.seg_gram import kernel as kern
        self.counts = collections.Counter()
        self._kern = kern
        kern.LAUNCH_OBSERVERS.append(self._add)
        return self.counts

    def _add(self, key, B, n, S, qL, qR, _nbytes):
        self.counts[(key, B, n, S, qL, qR)] += 1

    def __exit__(self, *exc):
        self._kern.LAUNCH_OBSERVERS.remove(self._add)
        return False


def _no_fallbacks() -> None:
    fallbacks = _read_counters()[1]
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")


def _fw_count(counts, B, n, q=None) -> int:
    """fold_weighted launches of B weight rows over n rows (at width q)."""
    return sum(c for (key, b, nn, _s, ql, _qr), c in counts.items()
               if key == "fold_weighted" and b == B and nn == n
               and (q is None or ql == q))


def fold_weighted_case(name, form, D, Wk, reps=3):
    """A fold_weighted Case: the B weighted Grams of D (n, q) under the
    weight rows Wk (B, n), against plain, fp64 and one torch.matmul."""
    from repro_torch.kernels.seg_gram import ops as sops
    from repro_torch.kernels.seg_gram import ref

    B, n = Wk.shape
    q = D.shape[1]

    def plain(dtype):
        Dd = D.to(dtype)
        return torch.stack([ref.seg_gram_plain(
            ref.build_fold_weighted, [Wk[b:b + 1].T.to(dtype), Dd])
            for b in range(B)])

    return Case(name, form, lambda: sops.fold_weighted_design_gram(D, Wk),
                lambda: plain(torch.float32), lambda: plain(torch.float64),
                lambda: ((D[None] * Wk[:, :, None]).transpose(1, 2), D),
                lambda ab: torch.matmul(*ab),
                D.numel() * 4 + Wk.numel() * 4 + B * q * q * 4,
                2.0 * B * n * q * (q + 1) / 2, reps, q=(q, q))


def _boot_parts(data, cfg):
    """DML.fit on the card; its bootstrap's fit context and keywords."""
    from repro_torch.core.dml import DML
    from repro_torch.inference.bootstrap import derive_seed

    res = DML(cfg).fit(data.y, data.t, data.X,
                       gen=torch.Generator().manual_seed(0))
    c = res.fit_ctx
    kw = dict(n_folds=cfg.n_folds, XW=c.XW, y=c.y, t=c.t, phi=c.phi,
              seed=derive_seed(c.seed, 0x0B00), n_replicates=RT_BOOT_B,
              scheme="pairs", row_block=cfg.row_block,
              strategy=cfg.row_block_strategy)
    return c, kw


def phase_runtime_budget(data, cfg):
    """The memory model probed on the card for the DML bootstrap's
    replicate function, then the bootstrap under a budget of the model's
    peak at RT_BUDGET_AT replicates, traced, run as a call node of the
    runtime's DAG: the chunk it picks, each chunk's predicted and measured
    peak (audit rows), replicates bitwise an explicit-chunk run's."""
    from repro_torch.inference.bootstrap import (dml_bootstrap,
                                                 make_dml_replicate_fn)
    from repro_torch.obs import Tracer
    from repro_torch.runtime import TaskRuntime

    c, kw = _boot_parts(data, cfg)
    B = RT_BOOT_B
    fn = make_dml_replicate_fn(c.nuis_y, c.nuis_t, cfg.n_folds,
                               seed=kw["seed"], scheme="pairs",
                               row_block=cfg.row_block,
                               strategy=cfg.row_block_strategy)
    t0 = time.perf_counter()
    _, model = TaskRuntime("vmap", memory_budget=1 << 50).plan_chunk(
        fn, torch.arange(B), (c.XW, c.y, c.t, c.phi), B)
    t_probe = time.perf_counter() - t0
    if model is None or not model.slope > 0:
        raise AssertionError(f"the probed model's slope is not positive: "
                             f"{model}")
    budget = int(model.peak(RT_BUDGET_AT))
    tracer = Tracer()
    rt = TaskRuntime("vmap", memory_budget=budget, tracer=tracer)
    _reset_counters()
    t0 = time.perf_counter()
    fut = rt.call(lambda: dml_bootstrap(c.nuis_y, c.nuis_t, executor=rt,
                                        **kw), label="dml_bootstrap")
    traced = rt.gather(fut)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    rows = tracer.audit.as_dicts()
    chunk = int(tracer.metrics.snapshot()["gauges"][
        "runtime.chunk_size[dml_bootstrap]"])
    # untraced, at the chunk the budget picked
    explicit = dml_bootstrap(c.nuis_y, c.nuis_t, executor="vmap",
                             chunk=chunk, **kw)
    peaks = [r["probed_peak_bytes"] for r in rows]
    same = (torch.equal(traced.replicates, explicit.replicates)
            and torch.equal(traced.replicate_se, explicit.replicate_se))
    log(f"runtime:budget: n={data.n} p={data.p} B={B}; the model probed on "
        f"the card in {t_probe:.3f} s (chunks 1, 1, 8; outputs dropped; "
        f"readings {model.probes}): base={model.base:.0f} B "
        f"slope={model.slope:.0f} B/replicate; "
        f"budget = peak({RT_BUDGET_AT}) = {budget} B ({budget / 2 ** 30:.3f}"
        f" GiB); the budgeted run picked chunk {chunk} in {secs:.3f} s; "
        f"chunks (size, predicted, measured peak bytes, ms): "
        + ", ".join(f"({r['chunk_size']}, {r['predicted_peak_bytes']:.0f}, "
                    f"{r['probed_peak_bytes']:.0f}, "
                    f"{1e3 * r['measured_s']:.1f})" for r in rows)
        + f"; max measured/budget {max(peaks) / budget:.4f} (gate "
        f"{RT_PEAK_SLACK}); bitwise the runtime_chunk={chunk} run: {same}; "
        f"launches={counts} fallbacks={fallbacks}")
    log(tracer.audit.table())
    if not 1 <= chunk < B:
        raise AssertionError(f"the budget picked chunk {chunk}, not < {B}")
    if max(peaks) > RT_PEAK_SLACK * budget:
        raise AssertionError(f"a chunk peaked at {max(peaks):.0f} B > "
                             f"{RT_PEAK_SLACK} x budget {budget}")
    if not same:
        raise AssertionError("budgeted replicates differ from the explicit "
                             "chunk's")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    return c, kw, chunk, explicit, (tracer, traced, explicit)


def phase_runtime_downgrade(c, kw, chunk, healthy):
    """The same bootstrap on an executor whose first map call fails (a
    lost worker): one downgrade to serial, replicates bitwise the healthy
    run's."""
    from repro_torch.inference.bootstrap import dml_bootstrap
    from repro_torch.inference.executor import BatchedExecutor
    from repro_torch.runtime import TaskRuntime

    class LostWorker(BatchedExecutor):
        """The vmap backend, losing its worker on its first map call."""

        calls = 0

        def map(self, fn, xs, *args):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("worker lost (injected by chip_smoke)")
            return super().map(fn, xs, *args)

    rt = TaskRuntime(LostWorker(), chunk=chunk)
    _reset_counters()
    t0 = time.perf_counter()
    out = dml_bootstrap(c.nuis_y, c.nuis_t, executor=rt, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ev = [(e.action, e.chunk_index, e.backend) for e in rt.events]
    downs = [e for e in rt.events if e.action == "downgrade"]
    same = torch.equal(out.replicates, healthy.replicates)
    log(f"runtime:downgrade: chunk {chunk}, the first map call lost: "
        f"{secs:.3f} s; events {ev}; bitwise the healthy run: {same}")
    if len(downs) != 1 or downs[0].backend != "serial":
        raise AssertionError(f"expected one downgrade to serial, got {ev}")
    if not same:
        raise AssertionError("the downgraded replicates differ")
    _no_fallbacks()


def phase_crossfit_executors(data, base):
    """DML.fit at the tables cell on the "parallel" engine, the
    "sequential" engine (the fold axis through the serial executor) and a
    traced TaskRuntime("vmap"): times, spans, theta bitwise parallel's
    through the runtime; sequential's one-fold batches sum in another
    order (their matmuls have one column instead of k), gated at 1e-4."""
    from repro_torch.core.dml import DML
    from repro_torch.obs import Tracer
    from repro_torch.runtime import TaskRuntime

    cfg = dataclasses.replace(base, inference="none")
    tracer = Tracer()
    out = {}
    for name, eng in (("parallel", "parallel"), ("sequential", "sequential"),
                      ("runtime", TaskRuntime("vmap", tracer=tracer))):
        _reset_counters()
        t0 = time.perf_counter()
        r = DML(dataclasses.replace(cfg, engine=eng)).fit(
            data.y, data.t, data.X, gen=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        out[name] = (r.theta, time.perf_counter() - t0, _read_counters())
    spans = [(s.name, round(1e3 * s.duration_s, 2)) for s in tracer.spans
             if not s.instant]
    th = out["parallel"][0]
    bitwise = {k: torch.equal(v[0], th) for k, v in out.items()}
    e_seq = rel(out["sequential"][0], th)
    log(f"crossfit:executors n={data.n} p={data.p}: " + "; ".join(
        f"{k} fit {v[1]:.3f} s theta={v[0].cpu().tolist()} launches="
        f"{v[2][0]}" for k, v in out.items())
        + f"; bitwise parallel's: {bitwise}; sequential vs parallel max rel "
        f"diff {e_seq:.3e}; traced spans (ms) {spans}")
    if not bitwise["runtime"]:
        raise AssertionError("the runtime-mapped fit differs from parallel")
    if not e_seq <= 1e-4:
        raise AssertionError(f"sequential differs from parallel: {e_seq:.3e}")
    if any(v[2][1] for v in out.values()):
        raise AssertionError("fallback counters rose")


def phase_refute_tables(data, base):
    """run_all at the tables cell (k = 5, basis [1, x0], 3 refits a
    refuter) traced: each report, its seconds from its dag.task span;
    every refuter passes; the base ATE within 5 se of 1.  Returns the
    launch log for the refuters' kernel records."""
    from repro_torch.core.dml import DML
    from repro_torch.core.refutation import run_all
    from repro_torch.obs import Tracer

    cfg = dataclasses.replace(base, inference="none")
    r0 = DML(cfg).fit(data.y, data.t, data.X,
                      gen=torch.Generator().manual_seed(0))
    z = abs(r0.ate - 1.0) / float(r0.stderr[0])
    tracer = Tracer()
    _reset_counters()
    with _launch_log() as launches:
        t0 = time.perf_counter()
        reports = run_all(cfg, data.y, data.t, data.X, seed=0,
                          tracer=tracer)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    dag = {s.attrs["label"]: s.duration_s for s in tracer.spans
           if s.name == "dag.task"}
    for rep in reports:
        log(f"  {rep.row()} refuted={list(rep.refuted_ates)} "
            f"({dag[rep.name]:.3f} s)")
    log(f"refute:tables n={data.n} p={data.p} k={cfg.n_folds}: base ATE "
        f"{r0.ate:.5f} se {float(r0.stderr[0]):.5f} |ATE-1|/se {z:.3f}; "
        f"run_all (fit + 3 x {REFUTE_REPS} refits) {secs:.3f} s; "
        f"launches={counts} by (form, B, n, S, qL, qR)="
        f"{ {str(k): v for k, v in launches.items()} } fallbacks={fallbacks}")
    if not all(rep.passed for rep in reports):
        raise AssertionError("a refuter failed")
    if not z <= 5.0:
        raise AssertionError(f"base ATE not within 5 se of 1: {z:.3f}")
    # fold_weighted per refit: ridge 1 + logistic 2 x newton_iters; the
    # placebo and subset refits at R·k = 15 (two maps), the common-cause
    # refits at k = 5, 1 + newton_iters of them on the q = p + 3 design
    n, k, it = data.n, cfg.n_folds, cfg.newton_iters
    got = (_fw_count(launches, REFUTE_REPS * k, n),
           _fw_count(launches, k, n, q=data.p + 3))
    want = (2 * (1 + 2 * it), REFUTE_REPS * (1 + it))
    if got != want:
        raise AssertionError(f"fold_weighted launches (R·k=15, q=503) {got},"
                             f" expected {want}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    return launches, secs, {rep.name: dag[rep.name] for rep in reports}


def refute_cases(data, k, seed):
    """The refuters' seg_gram call sites at the tables cell: the
    nuisance design with random_common_cause's noise column (q = 503,
    k weight rows) and the placebo / subset refits' fold_weighted Gram
    of R·k = 15 weight rows (q = 502), one map of 3 refits."""
    from repro_torch.core.crossfit import fold_weights
    from repro_torch.core.moments import design
    from repro_torch.core.refutation import refute_draws

    n = data.X.shape[0]
    d = refute_draws("noise", seed, torch.arange(REFUTE_REPS), n, k,
                     device="cuda")
    D = design(torch.cat([data.X, d["draw"][0][:, None]], dim=1),
               intercept=True, append=data.y)
    cases = [fold_weighted_case("fold_weighted@q503",
                                "random_common_cause's nuisance design, k=5",
                                D, fold_weights(d["folds"][0], k))]
    del D
    D = design(data.X, intercept=True, append=data.y)
    Wk = fold_weights(d["folds"], k).reshape(REFUTE_REPS * k, n)
    cases.append(fold_weighted_case(
        f"fold_weighted@R{REFUTE_REPS * k}",
        f"a refuter's {REFUTE_REPS} refits, R*k={REFUTE_REPS * k}", D, Wk))
    return cases


def phase_refute_iv(ivdata, cfg):
    """placebo_instrument and weak_instrument on OrthoIV's fit at
    make_iv_data(n, 500): both pass."""
    from repro_torch.core.iv import OrthoIV
    from repro_torch.core.refutation import (placebo_instrument,
                                             weak_instrument)

    est = OrthoIV(dataclasses.replace(cfg, inference="none"))
    _reset_counters()
    res = est.fit(ivdata.y, ivdata.t, ivdata.z, ivdata.X,
                  gen=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    weak = weak_instrument(res)
    rep = placebo_instrument(est, ivdata.y, ivdata.t, ivdata.z, ivdata.X,
                             original_ate=res.late, n_reps=REFUTE_REPS,
                             seed=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  {weak.row()}")
    log(f"  {rep.row()} refuted={list(rep.refuted_ates)}")
    log(f"refute:iv n={ivdata.n} p={ivdata.p}: LATE {res.late:.5f}; weak "
        f"screen + {REFUTE_REPS} placebo-instrument refits {secs:.3f} s")
    if not (weak.passed and rep.passed):
        raise AssertionError("an instrument refuter failed")
    _no_fallbacks()
    return secs


def _load_example(name: str):
    """The module of ``examples/<name>.py``."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_quickstart():
    """examples/torch_quickstart.py's main on the card: the fit, its
    jackknife CI and the refutation suite; theta0 within 5 se of the
    ATE, every refuter passes."""
    mod = _load_example("torch_quickstart")
    _reset_counters()
    res, reports, true_ate, secs = mod.main([])
    z = abs(res.ate - 1.0) / float(res.stderr[0])
    log(f"quickstart: {secs:.3f} s; theta={res.theta.cpu().tolist()} "
        f"|theta0-1|/se={z:.3f}; true ATE {true_ate:.5f}; refuters "
        f"{[(r.name, r.passed) for r in reports]}")
    if not (z <= 5.0 and all(r.passed for r in reports)):
        raise AssertionError("the quickstart's fit or a refuter failed")
    _no_fallbacks()
    return secs


# seg_gram launches by form of each demo's main([]) on the card: the
# route its CPU run takes (every Gram through seg_gram.ops.seg_reduce or
# residual_gram.ops.residual_gram, each call counted by the key its CUDA
# wrapper counts it by), written down before the first card run
EXAMPLE_LAUNCHES = {
    "iv": {"design": 5, "gram_and_vec": 80, "fold_weighted": 65, "iv": 3,
           "iv_meat": 3, "iv_segmented": 1, "residual": 1,
           "residual_meat": 1},
    "store": {"pair": 20},
    "sweep": {"fold_weighted": 1617, "residual_direct": 50,
              "residual_meat": 50, "design_segmented": 2, "pair": 66},
}


# the demos' own kernel calls against their plain version:
# max|kernel - fp64 plain| / max|fp64 plain| on the first call of each
# (form, output shape, rows)
EXAMPLE_KERNEL_TOL = 1e-5


@contextlib.contextmanager
def _held_to_plain(checked: dict, calls: collections.Counter,
                   spent: list):
    """``seg_gram.ops.seg_reduce`` wrapped for the card run of a demo:
    every call counted in ``calls`` by its ``launch_key``, and the first
    call of each (form, output shape, rows) held against
    ``seg_reduce_plain`` in fp64 on the same inputs, moved to the CPU
    (its error into ``checked``; over EXAMPLE_KERNEL_TOL, or not finite,
    raises).  The checks' seconds, after a sync, go to ``spent``."""
    from repro_torch.kernels.seg_gram import ops as sops

    seg_reduce = sops.seg_reduce

    def cpu64(x):
        return None if x is None else x.detach().cpu().double()

    def held(builder, arrays, *, seg=None, w=None, n_segments=1, init=None,
             row_block=0):
        out = seg_reduce(builder, arrays, seg=seg, w=w,
                         n_segments=n_segments, init=init,
                         row_block=row_block)
        key = sops.launch_key(builder, arrays, w=w, n_segments=n_segments,
                              init=init)
        calls[key] += 1
        sig = (key, tuple(out.shape), int(arrays[0].shape[-2]))
        if sig in checked:
            return out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        G64 = sops.seg_reduce_plain(
            builder, [cpu64(a) for a in arrays],
            seg=None if seg is None else seg.cpu(), w=cpu64(w),
            n_segments=n_segments, init=cpu64(init))
        Gk = out.detach().cpu()
        if tuple(G64.shape) != tuple(Gk.shape):
            raise AssertionError(f"{key}: kernel shape {tuple(Gk.shape)}, "
                                 f"plain {tuple(G64.shape)}")
        err = rel(Gk, G64)
        checked[sig] = err
        spent.append(time.perf_counter() - t0)
        if not (err <= EXAMPLE_KERNEL_TOL and bool(torch.isfinite(Gk).all())):
            raise AssertionError(
                f"seg_gram {key} {tuple(Gk.shape)} over {sig[2]} rows "
                f"disagrees with its plain version: {err:.3e} > "
                f"{EXAMPLE_KERNEL_TOL:g}")
        return out

    sops.seg_reduce = held
    try:
        yield
    finally:
        sops.seg_reduce = seg_reduce


def phase_example(name: str):
    """examples/torch_<name>_demo.py's main on the card at its default
    (the reference demo's) size, launches counted around it: the demo's
    gates, launches by form = EXAMPLE_LAUNCHES[name], fallbacks 0, and
    the demo's own seg_gram calls held to their plain version
    (``_held_to_plain``), which every launch went through.  Returns
    (seconds, launches by form, kernel-vs-plain errors by call form);
    the seconds leave out the checks'."""
    mod = _load_example(f"torch_{name}_demo")
    checked, calls, spent = {}, collections.Counter(), []
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    with _held_to_plain(checked, calls, spent):
        out = mod.main([])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0 - sum(spent)
    counts = {k: c for k, c in _read_counters()[0].items() if c}
    if name == "iv":
        late, se = out["late"], out["se"]
        z = abs(late - out["true_late"]) / se
        ivs = (out["bootstrap_ci"], out["jackknife_ci"])
        log(f"examples:iv: LATE {late:.5f} se {se:.5f} true "
            f"{out['true_late']:.5f} ({z:.3f} se); bootstrap "
            f"{ivs[0]}, jackknife {ivs[1]}; naive DML {out['naive_ate']:.5f};"
            f" DRIV {out['driv_late']:.5f} ± {out['driv_se']:.5f}")
        if not (z <= 5.0 and all(bool(np.isfinite([lo, hi]).all())
                                 and lo <= late <= hi for lo, hi in ivs)):
            raise AssertionError("the IV demo's LATE or an interval failed")
    elif name == "store":
        log(f"examples:store: bitwise {out['bitwise']}; ingest + refresh "
            f"{[round(x, 4) for x in out['ingest_refresh_s']]} s, refit "
            f"{[round(x, 4) for x in out['full_refit_s']]} s; version "
            f"{out['version']}, snapshot {out['latest']}")
        if not (len(out["bitwise"]) == 5 and all(out["bitwise"])):
            raise AssertionError("the store's days are not bitwise a refit")
    else:
        panel, seg = out["panel"], out["segmented"]
        valid = []
        for p in (panel, seg):
            ok = p.ok()
            valid.append(int(ok.sum()))
            for c, col in enumerate(p.columns):
                if not bool(torch.isfinite(col.ates[ok[:, c]]).all()):
                    raise AssertionError("a valid segment's ATE is not "
                                         "finite")
        log(f"examples:sweep: panel == loop {out['bitwise']}; valid cells "
            f"{valid[0]} (panel), {valid[1]} (segmented); panel "
            f"{out['panel_s']:.3f} s, loop {out['loop_s']:.3f} s, "
            f"segmented {out['segmented_s']:.3f} s")
        if not out["bitwise"]:
            raise AssertionError("the sweep panel is not bitwise the loop")
    errs = {}
    for (key, shape, n), err in checked.items():
        errs.setdefault(key, []).append((shape, n, err))
    log(f"examples:{name}: {secs:.3f} s (+ {sum(spent):.3f} s of checks); "
        f"launches {counts}; {len(checked)} calls held to fp64 plain (tol "
        f"{EXAMPLE_KERNEL_TOL:g}), worst by form "
        f"{ {k: max(e for *_, e in v) for k, v in errs.items()} }")
    for key, v in errs.items():
        log(f"  {key}: " + ", ".join(f"{shape}@{n}:{e:.3e}"
                                     for shape, n, e in v))
    if counts != EXAMPLE_LAUNCHES[name]:
        raise AssertionError(f"launches {counts}, expected "
                             f"{EXAMPLE_LAUNCHES[name]}")
    if dict(calls) != counts:
        raise AssertionError(f"launches {counts}, but seg_reduce calls "
                             f"{dict(calls)}: a launch missed the check")
    _no_fallbacks()
    return secs, counts, {k: max(e for *_, e in v) for k, v in errs.items()}


def _cells_inputs(seed: int, n: int, e: int):
    from repro_torch.data.causal_dgp import paper_demo_data
    data = paper_demo_data(n=n, p=SWEEP_P, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    sids = torch.randint(0, e, (n,), generator=g, device="cuda")
    return data, sids


def _cells_cfg(**kw):
    from repro_torch.configs.sweep_synthetic import SWEEP
    return dataclasses.replace(SWEEP, **{
        "row_block": 65536, "row_block_strategy": "pallas",
        "sweep_chunk": 0, **kw})


def phase_sweep_cells(seed: int):
    """sweep(mode="cells") at CELLS_E segments x 500 at 2^18 rows: the dml and drlearner columns under a budget that chunks them,
    traced (chunk, peak and seconds per column); every segment's ATE
    within 5 se of 1; the largest |cells - segmented| ATE in se (no
    gate); a small cells sweep card vs CPU (1e-4); with_ci bitwise at two
    chunk sizes; serial_loop bitwise cells."""
    from repro_torch.data.causal_dgp import paper_demo_data
    from repro_torch.obs import Tracer
    from repro_torch.sweep import SweepSpec, serial_loop, sweep

    from repro_torch.core.registry import get_spec
    from repro_torch.runtime import TaskRuntime
    from repro_torch.sweep import engine

    data, sids = _cells_inputs(seed, CELLS_N, CELLS_E)
    cfg0 = _cells_cfg()
    cell = engine._make_masked_cell(get_spec("dml").weighted_fit(cfg0), 5)
    d = engine._column_data({"X": data.X, "y": data.y, "t": data.t,
                             "sids": sids}, cfg0)
    t0 = time.perf_counter()
    _, model = TaskRuntime("vmap", memory_budget=1 << 50).plan_chunk(
        cell, engine._cells(seed, 0, CELLS_E), (d,), CELLS_E)
    t_probe = time.perf_counter() - t0
    budget = int(model.peak(CELLS_AT))
    del cell, d
    cfg = _cells_cfg(runtime_memory_budget=budget)
    spec = SweepSpec(CELLS_E, (("dml", cfg), ("drlearner", cfg)))
    tracer = Tracer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _launch_log() as launches:
        t0 = time.perf_counter()
        panel = sweep(spec, X=data.X, y=data.y, t=data.t, segment_ids=sids,
                      seed=seed, tracer=tracer)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gauges = tracer.metrics.snapshot()["gauges"]
    col_s = {s.name: s.duration_s for s in tracer.spans
             if s.name.startswith("sweep.column")}
    rows = tracer.audit.as_dicts()
    chunks, lines = {}, []
    for i, col in enumerate(panel.columns):
        if col.failed:
            raise AssertionError(f"cells column {i} failed: {col.error}")
        label = f"sweep:{col.estimator}"
        chunks[col.estimator] = int(gauges[f"runtime.chunk_size[{label}]"])
        mpeak = max(r["probed_peak_bytes"] for r in rows
                    if r["label"] == label)
        ate, se = col.ates.double().cpu(), col.ses[:, 0].double().cpu()
        zmax = float(((ate - 1.0).abs() / se).max())
        lines.append(f"{col.estimator}: chunk {chunks[col.estimator]} "
                     f"({col.events}), peak {mpeak / 2 ** 30:.3f} GiB "
                     f"(budget {budget / 2 ** 30:.3f}), "
                     f"{col_s[f'sweep.column[{i}]']:.3f} s, max |ate-1|/se "
                     f"{zmax:.3f}")
        if not zmax <= 5.0:
            raise AssertionError(f"{col.estimator}: a segment's ATE is not "
                                 f"within 5 se of 1: {zmax:.3f}")
        if not chunks[col.estimator] < CELLS_E:
            raise AssertionError(f"{col.estimator} was not chunked")
    seg = sweep(SweepSpec(CELLS_E, (("dml", cfg),)), X=data.X, y=data.y,
                t=data.t, segment_ids=sids, seed=seed,
                mode="segmented").columns[0]
    dcs = float(((panel.columns[0].ates - seg.ates).abs()
                 / seg.ses[:, 0]).max())
    log(f"sweep:cells n={CELLS_N} p={SWEEP_P} E={CELLS_E} k=5: the dml "
        f"cells' model probed in {t_probe:.3f} s (readings {model.probes}):"
        f" base {model.base:.0f} B, slope {model.slope:.0f} B a cell, budget"
        f" peak({CELLS_AT}) = {budget} B; the sweep {secs:.3f} s, peak "
        f"device memory {peak:.2f} GiB; " + "; ".join(lines)
        + f"; max |cells - segmented| ATE {dcs:.3f} se (no gate); "
        f"launches={counts} fallbacks={fallbacks}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    fw = {"chunk": chunks["dml"],
          "launches": _fw_count(launches, chunks["dml"] * 5, CELLS_N)}
    if not fw["launches"]:
        raise AssertionError("no fold_weighted launch at the cells' chunk")
    del panel, seg
    torch.cuda.empty_cache()

    small = paper_demo_data(n=4096, p=16, seed=seed, device="cpu")
    ssid = torch.randint(0, 4, (4096,),
                         generator=torch.Generator().manual_seed(seed + 6))
    scfg = _cells_cfg(row_block=1024)
    out = [sweep(SweepSpec(4, (("dml", scfg),)), X=small.X, y=small.y,
                 t=small.t, segment_ids=ssid, seed=seed,
                 device=dev).columns[0] for dev in ("cpu", "cuda")]
    e = max(rel(out[1].thetas.cpu(), out[0].thetas),
            rel(out[1].ses.cpu(), out[0].ses))
    log(f"cells agreement (n=4096, p=16, E=4): card vs CPU max rel diff "
        f"{e:.3e} (tol 1e-4)")
    if not e <= 1e-4:
        raise AssertionError(f"card and CPU cells disagree: {e:.3e}")

    n, e16 = CI_N, CI_E
    X, y, t, s16 = (data.X[:n], data.y[:n], data.t[:n], sids[:n] % e16)
    ci = []
    for c in CI_CHUNKS:
        t0 = time.perf_counter()
        col = sweep(SweepSpec(e16, (("dml", _cells_cfg(n_bootstrap=CI_B,
                                                       sweep_chunk=c)),)),
                    X=X, y=y, t=t, segment_ids=s16, seed=seed,
                    with_ci=True).columns[0]
        torch.cuda.synchronize()
        ci.append((col, time.perf_counter() - t0))
    a, b = ci[0][0], ci[1][0]
    ci_same = (not a.failed and torch.equal(a.replicates, b.replicates)
               and torch.equal(a.ci_lo, b.ci_lo)
               and torch.equal(a.ci_hi, b.ci_hi))
    n8, e8 = LOOP_N, LOOP_E
    lcfg = _cells_cfg()
    lkw = dict(X=data.X[:n8], y=data.y[:n8], t=data.t[:n8],
               segment_ids=sids[:n8] % e8, seed=seed)
    cells = sweep(SweepSpec(e8, (("dml", lcfg),)), **lkw).columns[0]
    t0 = time.perf_counter()
    loop = serial_loop("dml", lcfg, n_segments=e8, **lkw)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    loop_same = (torch.equal(loop["theta"], cells.thetas)
                 and torch.equal(loop["se"], cells.ses))
    log(f"with_ci E={e16} n={n} B={CI_B}: chunks {CI_CHUNKS} of the "
        f"{e16 * CI_B} (cell, replicate) pairs in {ci[0][1]:.3f} / "
        f"{ci[1][1]:.3f} s, events {a.events} / {b.events}, bitwise: "
        f"{ci_same}; CI of segment 0 [{float(a.ci_lo[0]):.5f}, "
        f"{float(a.ci_hi[0]):.5f}]; serial_loop E={e8} n={n8} "
        f"{t_loop:.3f} s, bitwise cells: {loop_same}")
    if not ci_same:
        raise AssertionError("with_ci replicates differ across chunkings")
    if not loop_same:
        raise AssertionError("serial_loop differs from cells")
    del data, sids
    torch.cuda.empty_cache()
    return fw, secs, budget


def cells_cases(seed: int, chunk: int):
    """fold_weighted at the cells-mode batch: the first ``chunk`` cells'
    fold weights times their segment masks (chunk·k weight rows) over the
    sweep:cells rows."""
    from repro_torch.core.crossfit import fold_weights
    from repro_torch.core.moments import design
    from repro_torch.sweep.engine import cell_folds, column_keys

    data, sids = _cells_inputs(seed, CELLS_N, CELLS_E)
    keys = column_keys(seed, 0, CELLS_E)[:chunk].tolist()
    folds = torch.stack([cell_folds(key, CELLS_N, 5, "cuda") for key in keys])
    mask = (sids[None, :] == torch.arange(chunk, device="cuda")[:, None]
            ).float()
    Wk = (fold_weights(folds, 5) * mask[:, None, :]).reshape(chunk * 5,
                                                             CELLS_N)
    D = design(data.X, intercept=True, append=data.y)
    return [fold_weighted_case("fold_weighted@cells",
                               f"sweep cells, {chunk} cells x k=5", D, Wk)]


def phase_jobs(seed: int):
    """JobManager.submit of a two-column cells spec on the card: the
    events (submitted, a column per column, done) read by subscribing,
    the panel bitwise a direct sweep's."""
    from repro_torch.runtime import JobManager
    from repro_torch.sweep import SweepSpec, sweep

    data, sids = _cells_inputs(seed + 1, JOB_N, JOB_E)
    cfg = _cells_cfg()
    spec = SweepSpec(JOB_E, (("dml", cfg), ("drlearner", cfg)))
    kw = dict(X=data.X, y=data.y, t=data.t, segment_ids=sids, seed=seed)
    _reset_counters()
    t0 = time.perf_counter()
    job = JobManager().submit(spec, **kw)
    events = [(e.action, e.label) for e in job.subscribe()]
    panel = job.result(timeout=600)
    secs = time.perf_counter() - t0
    direct = sweep(spec, **kw)
    same = all(not a.failed and torch.equal(a.thetas, b.thetas)
               and torch.equal(a.ates, b.ates) and torch.equal(a.ses, b.ses)
               for a, b in zip(panel.columns, direct.columns))
    log(f"jobs: E={JOB_E} n={JOB_N}: job {secs:.3f} s; events {events}; "
        f"status {job.status()}; panel bitwise a direct sweep: {same}")
    if [a for a, _ in events] != ["submitted", "column", "column", "done"]:
        raise AssertionError(f"job events {events}")
    if not same:
        raise AssertionError("the job's panel differs from a direct sweep")
    _no_fallbacks()


def phase_runtime_trace(rt_trace):
    """The runtime:budget run: traced bitwise untraced (the same chunks
    without a tracer); its Chrome trace strict JSON with runtime.chunk
    and dag.task spans, audit rows."""
    tracer, traced, untraced = rt_trace
    same = (torch.equal(traced.replicates, untraced.replicates)
            and torch.equal(traced.replicate_se, untraced.replicate_se))
    out = Path(__file__).resolve().parent / "build" / \
        "chip_smoke_runtime_trace.json"
    out.parent.mkdir(exist_ok=True)
    tracer.write_chrome_trace(str(out))

    def refuse(token):
        raise ValueError(f"non-strict JSON token {token}")

    events = json.loads(out.read_text(), parse_constant=refuse)["traceEvents"]
    names = collections.Counter(e["name"] for e in events)
    log(f"runtime trace: {out} ({out.stat().st_size} bytes, strict JSON) "
        f"span counts {dict(names)}; audit rows {len(tracer.audit)}; "
        f"counters {tracer.metrics.snapshot()['counters']}; traced == "
        f"untraced bitwise: {same}")
    if not same:
        raise AssertionError("the traced budgeted run differs")
    if not (names["runtime.chunk"] and names["dag.task"]
            and len(tracer.audit)):
        raise AssertionError("runtime.chunk / dag.task spans or audit rows "
                             "missing")


# --- slice 11: the metalearners, the mlp nuisance and tuning ---------------

# meta:fit's row_block (any R > 0 routes "pallas" to the kernel); the meta
# bootstrap at the bootstrap cell's rows, B = 32 (cut from the config's 200
# for time) in chunks of 8
META_RB, META_BOOT_B, META_CHUNK = 4096, 32, 8
# |ATE - truth| bound of meta:fit at 1M rows: a well-specified linear
# learner's ATE se here is ~0.002-0.003, so 0.02 is ~7-10 of them
META_ATE_TOL = 0.02
# tune:halving: 8 learning rates under the reference's defaults (3 folds,
# hidden (64,), base 25 steps, eta 2, 3 rungs)
HALVING_LRS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1)
# a small mlp DML, card against CPU from the same folds and inits:
# max|card - cpu| / max|cpu| of theta after 200 AdamW steps of each
# nuisance (each device's matmuls sum in their own order, ~1e-7 relative
# a step, and Adam's normalisation can turn a small gradient entry's
# difference into a full-size step's)
MLP_TOL = 1e-3
META_FNS = ("s_learner", "t_learner", "x_learner")
TUNE_LAMS = (1e-4, 1e-3, 1e-2, 1e-1)      # tuned_nuisances' grid


def _fw_shapes(launches, n):
    """fold_weighted launches over n rows by (weight rows, q)."""
    out = collections.Counter()
    for (key, b, nn, _s, ql, _qr), c in launches.items():
        if key == "fold_weighted" and nn == n:
            out[(b, ql)] += c
    return dict(out)


def _meta_fit_counts(name, p, iters, R=1):
    """One metalearner fit's fold_weighted launches by (weight rows, q),
    its stages at R weight rows (a singleton fold axis): S one Gram of
    [X | t | X·t | 1 | y]; T one per arm; X its two arms' outcome fits,
    the propensity's gradient Gram over [X | 1 | 1] and Hessian over
    [X | 1] per Newton step, and the two stage-2 fits, whose targets
    differ per replicate, one replicate at a time."""
    q = p + 2
    if name == "s_learner":
        return {(R, 2 * p + 3): 1}
    if name == "t_learner":
        return {(R, q): 2}
    out = collections.Counter({(R, q): 2 + iters, (R, q - 1): iters})
    out[(1, q)] += 2 * R
    return dict(out)


def _meta_fn(name):
    from repro_torch.core import metalearners as meta
    return getattr(meta, name)


def phase_meta_fit(data, cfg, seed):
    """s_learner, t_learner and x_learner on the card at the tables cell
    ("pallas"), fold_weighted launches counted by shape around each;
    each ATE within META_ATE_TOL of the truth; a small fit of each on
    the card against the CPU (1e-4).  Returns seconds and launches."""
    from repro_torch.data.causal_dgp import paper_demo_data

    secs, logs = {}, collections.Counter()
    for name in META_FNS:
        torch.cuda.synchronize()
        _reset_counters()
        with _launch_log() as launches:
            t0 = time.perf_counter()
            res = _meta_fn(name)(data.y, data.t, data.X, cfg=cfg)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        counts, fallbacks = _read_counters()
        got = _fw_shapes(launches, data.n)
        want = _meta_fit_counts(name, data.p, cfg.newton_iters)
        err = abs(res.ate - data.true_ate)
        log(f"{name} n={data.n} p={data.p}: {secs[name]:.3f} s, ATE="
            f"{res.ate:.5f} (true {data.true_ate:.5f}, |err| {err:.5f}, tol "
            f"{META_ATE_TOL}) fold_weighted by (rows, q)={got} launches="
            f"{counts} fallbacks={fallbacks}")
        logs.update(launches)
        if not bool(torch.isfinite(res.cate).all()):
            raise AssertionError(f"{name}: non-finite CATE")
        if not err <= META_ATE_TOL:
            raise AssertionError(f"{name}: ATE {res.ate:.5f} not within "
                                 f"{META_ATE_TOL} of the truth")
        if got != want or set(counts) != {"fold_weighted"}:
            raise AssertionError(f"{name}: launches {got} / {counts}, "
                                 f"expected {want}")
        if fallbacks:
            raise AssertionError(f"fallback counters rose: {fallbacks}")
        del res
        torch.cuda.empty_cache()
    small = paper_demo_data(n=4096, p=16, seed=seed, device="cpu")
    scfg = dataclasses.replace(cfg, row_block=1024)
    for name in META_FNS:
        out = {}
        for dev in ("cpu", "cuda"):
            r = _meta_fn(name)(small.y, small.t, small.X, cfg=scfg,
                               device=dev)
            out[dev] = torch.cat([torch.tensor([r.ate]), r.cate.cpu()])
        e = rel(out["cuda"], out["cpu"])
        log(f"{name} small fit (n=4096, p=16) card vs CPU max rel diff "
            f"{e:.3e} (tol 1e-4)")
        if not e <= 1e-4:
            raise AssertionError(f"{name}: card and CPU disagree: {e:.3e}")
    return secs, logs


def meta_cases(data):
    """The metalearners' fold_weighted shapes at the tables cell: the
    S-learner's one Gram of [X | t | X·t | 1 | y] (q = 1003), an arm
    fit's one weight row (q = 502) and the X-learner's propensity
    Hessian over [X | 1] (q = 501, its first Newton step's weights)."""
    from repro_torch.core.moments import design

    tt = data.t[:, None]
    D = design(torch.cat([data.X, tt, data.X * tt], dim=1), intercept=True,
               append=data.y)
    ones = torch.ones((1, data.n), device="cuda")
    cases = [fold_weighted_case("fold_weighted@q1003",
                                "S-learner, 1 weight row", D, ones)]
    del D
    D = design(data.X, intercept=True, append=data.y)
    cases.append(fold_weighted_case("fold_weighted@k1",
                                    "T/X arm fit, 1 weight row", D,
                                    data.t[None].contiguous()))
    del D
    D = design(data.X, intercept=True)
    cases.append(fold_weighted_case("fold_weighted@k1q501",
                                    "X propensity Hessian, 1 weight row", D,
                                    torch.full((1, data.n), 0.25,
                                               device="cuda")))
    return cases


def phase_tune_penalty(data, cfg, seed):
    """tuned_nuisances on the card at the tables cell (4 λ × 5 folds, reg
    and clf), each grid one map_product; then DML on the winners, theta
    within 5 se of [1, 0.5]; the grids' scores and winners on a small
    input on the card against the CPU.  Returns seconds and launches."""
    from repro_torch.core import tuning
    from repro_torch.core.dml import DML
    from repro_torch.data.causal_dgp import paper_demo_data
    from repro_torch.runtime import TaskRuntime

    calls, real = [], TaskRuntime.map_product

    def counted(self, fn, *a, **kw):
        calls.append(kw.get("label"))
        return real(self, fn, *a, **kw)

    TaskRuntime.map_product = counted
    try:
        torch.cuda.synchronize()
        _reset_counters()
        with _launch_log() as launches:
            t0 = time.perf_counter()
            ny, nt = tuning.tuned_nuisances(
                cfg, data.X, data.y, data.t,
                gen=torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            t_tune = time.perf_counter() - t0
    finally:
        TaskRuntime.map_product = real
    counts, fallbacks = _read_counters()
    grid = dict(counts)
    k, it = cfg.n_folds, cfg.newton_iters
    rows = len(TUNE_LAMS) * k
    want = {"design": 1, "gram_and_vec": it}
    t0 = time.perf_counter()
    res = DML(cfg, nuisance_y=ny, nuisance_t=nt).fit(
        data.y, data.t, data.X, gen=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t_dml = time.perf_counter() - t0
    theta, se = res.theta.double().cpu(), res.stderr.double().cpu()
    z = (theta - torch.tensor([1.0, 0.5], dtype=torch.float64)).abs() / se
    log(f"tune:penalty n={data.n} p={data.p}: tuned_nuisances ({rows} "
        f"(λ, fold) cells a grid) {t_tune:.3f} s, map_product calls {calls};"
        f" winners λ_y={ny.hyper['lam']} λ_t={nt.hyper['lam']}; DML on "
        f"them {t_dml:.3f} s theta={theta.tolist()} HC0 se={se.tolist()} "
        f"|theta-[1,0.5]|/se={z.tolist()}; grid launches={grid} by (form,"
        f" B, n, S, qL, qR)={ {str(k_): v for k_, v in launches.items()} } "
        f"fallbacks={fallbacks}")
    if calls != ["tune_penalty"] * 2:
        raise AssertionError(f"map_product calls {calls}, expected one a "
                             "grid")
    if grid != want or set(b for (_k, b, *_r) in launches) != {rows}:
        raise AssertionError(f"grid launches {grid} / {dict(launches)}, "
                             f"expected {want} at {rows} weight rows")
    if not bool((z <= 5.0).all()):
        raise AssertionError(f"theta not within 5 se of [1, 0.5]: {z}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    small = paper_demo_data(n=4096, p=16, seed=seed, device="cpu")
    scfg = dataclasses.replace(cfg, row_block=1024)
    for task, target in (("reg", small.y), ("clf", small.t)):
        out = {}
        for dev in ("cpu", "cuda"):
            out[dev] = tuning.tune_penalty(
                task, TUNE_LAMS, small.X, target, n_folds=k,
                gen=torch.Generator().manual_seed(1), newton_iters=it,
                row_block=scfg.row_block, strategy=scfg.row_block_strategy,
                device=dev)
        e = rel(out["cuda"].scores.cpu(), out["cpu"].scores)
        log(f"tune_penalty[{task}] small (n=4096, p=16) card vs CPU: scores"
            f" max rel diff {e:.3e} (tol 1e-4), winners "
            f"{out['cuda'].best_value} / {out['cpu'].best_value}")
        if not (e <= 1e-4
                and out["cuda"].best_index == out["cpu"].best_index):
            raise AssertionError(f"tune_penalty[{task}]: card and CPU "
                                 "disagree")
    return {"tune": t_tune, "dml": t_dml}, launches


def tune_cases(X, y, t, folds, k, W):
    """design and gram_and_vec at the penalty grid's weight rows ``W``
    (their library operands, (20, n, 503) and (20, n, 502), are 37.5 GiB
    each at n = 1M)."""
    return [c for c in kernel_cases(X, y, t, folds, k, W)
            if c.name in ("design", "gram_and_vec")]


def tune_grid_weights(n, k=5):
    """The penalty grid's weight rows: the y grid's fold complements (its
    folds drawn as ``tuned_nuisances`` draws them), one per (λ, fold)."""
    from repro_torch.core.crossfit import fold_ids, fold_weights

    folds = fold_ids(torch.Generator().manual_seed(0), n, k, device="cuda")
    W = fold_weights(folds, k).repeat(len(TUNE_LAMS), 1)
    return folds, W.contiguous()


def phase_meta_bootstrap(data, cfg):
    """Each learner's ate_interval at the bootstrap cell (pairs, "vmap",
    B = META_BOOT_B in chunks of META_CHUNK), fold_weighted launches by
    shape around it; the bootstrap se finite and the truth within 5 se;
    serial ≡ batched bitwise on a chunk of 2 replicates, equal to the
    run's first two.  Returns seconds and launches."""
    from repro_torch.core.metalearners import meta_bootstrap
    from repro_torch.inference.bootstrap import derive_seed

    B, R, it = cfg.n_bootstrap, cfg.runtime_chunk, cfg.newton_iters
    secs, logs = {}, collections.Counter()
    for name in META_FNS:
        torch.cuda.synchronize()
        _reset_counters()
        with _launch_log() as launches:
            t0 = time.perf_counter()
            res = _meta_fn(name)(data.y, data.t, data.X, cfg=cfg)
            lo, hi = res.ate_interval()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        counts, fallbacks = _read_counters()
        inf = res.inference()
        se = float(inf.se[0])
        z = abs(res.ate - data.true_ate) / se
        got = _fw_shapes(launches, data.n)
        want = collections.Counter(_meta_fit_counts(name, data.p, it))
        for r in [R] * (B // R) + ([B % R] if B % R else []):
            want.update(_meta_fit_counts(name, data.p, it, r))
        ctx = res.fit_ctx
        kw = dict(y=ctx["y"], t=ctx["t"], X=ctx["X"], n_replicates=2,
                  seed=derive_seed(ctx["seed"], 0x0b00))
        ser = meta_bootstrap(ctx["core"], executor="serial", **kw)
        vec = meta_bootstrap(ctx["core"], executor="vmap", **kw)
        same = torch.equal(ser.ate_replicates, vec.ate_replicates)
        first = torch.equal(vec.ate_replicates, inf.ate_replicates[:2])
        log(f"{name} bootstrap n={data.n} p={data.p} B={B} (cut from the "
            f"config's 200 for time), chunks of {R}: fit + interval "
            f"{secs[name]:.3f} s ({secs[name] / B:.4f} s a replicate); "
            f"ATE={res.ate:.5f} bootstrap se={se:.5f} |ATE-true|/se={z:.3f}"
            f" CI=[{lo:.5f}, {hi:.5f}]; serial vs batched (2 replicates) "
            f"bitwise {same}, the run's first two {first}; fold_weighted by"
            f" (rows, q)={got} launches={counts} fallbacks={fallbacks}")
        logs.update(launches)
        if not (bool(torch.isfinite(inf.ate_replicates).all()) and lo < hi
                and np.isfinite(se) and se > 0):
            raise AssertionError(f"{name}: non-finite draws or se")
        if not z <= 5.0:
            raise AssertionError(f"{name}: truth not within 5 se: {z:.3f}")
        if not (same and first):
            raise AssertionError(f"{name}: serial and batched differ")
        if got != dict(want) or set(counts) != {"fold_weighted"}:
            raise AssertionError(f"{name}: launches {got} / {counts}, "
                                 f"expected {dict(want)}")
        if fallbacks:
            raise AssertionError(f"fallback counters rose: {fallbacks}")
    return secs, logs


def meta_boot_cases(data, seed):
    """fold_weighted at the meta bootstrap's chunk, META_CHUNK replicates'
    pairs weights, one fold each: an arm fit (q = 502), the X-learner's
    propensity Hessian (q = 501) and the S-learner's Gram (q = 1003)."""
    from repro_torch.core.moments import design
    from repro_torch.inference.bootstrap import replicate_weights

    w, _ = replicate_weights(seed, torch.arange(META_CHUNK), data.n, "pairs",
                             device="cuda")
    R = f"R{META_CHUNK}"
    D = design(data.X, intercept=True, append=data.y)
    cases = [fold_weighted_case(f"fold_weighted@{R}",
                                f"meta bootstrap chunk, {META_CHUNK} rows x "
                                "1 fold", D, (w * data.t[None]).contiguous())]
    del D
    D = design(data.X, intercept=True)
    cases.append(fold_weighted_case(f"fold_weighted@{R}q501",
                                    "meta bootstrap chunk, X propensity "
                                    "Hessian", D, (0.25 * w).contiguous()))
    del D
    tt = data.t[:, None]
    D = design(torch.cat([data.X, tt, data.X * tt], dim=1), intercept=True,
               append=data.y)
    cases.append(fold_weighted_case(f"fold_weighted@{R}q1003",
                                    "meta bootstrap chunk, S-learner", D,
                                    w.contiguous()))
    return cases


def phase_tune_halving(data, seed):
    """successive_halving("reg") on the card at the bootstrap cell: 8
    learning rates, the reference's defaults; the history's survivor sets
    (4, 2, 1); on a small input the card's history against the CPU's
    (the same survivors).  Returns seconds."""
    from repro_torch.core import tuning
    from repro_torch.data.causal_dgp import paper_demo_data

    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    res = tuning.successive_halving("reg", HALVING_LRS, data.X, data.y,
                                    gen=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    for h in res.history:
        log(f"  rung {h['rung']} ({h['steps']} steps): lrs {h['lrs']} "
            f"scores {h['scores']} kept {h['kept']}")
    log(f"tune:halving n={data.n} p={data.p}: {secs:.3f} s, best lr "
        f"{res.best_lr}; launches={counts} fallbacks={fallbacks}")
    sizes = [len(h["kept"]) for h in res.history]
    if sizes != [4, 2, 1] or res.best_lr not in torch.tensor(
            HALVING_LRS).tolist():
        raise AssertionError(f"survivor sets {sizes}, best {res.best_lr}")
    if not all(np.isfinite(h["scores"]).all() for h in res.history):
        raise AssertionError("non-finite halving scores")
    if counts or fallbacks:
        raise AssertionError(f"launches {counts} / fallbacks {fallbacks}")
    small = paper_demo_data(n=2048, p=16, seed=seed, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = tuning.successive_halving(
            "reg", HALVING_LRS, small.X, small.y, base_steps=10,
            hidden=(16,), gen=torch.Generator().manual_seed(1), device=dev)
    kept = {dev: [h["kept"] for h in r.history] for dev, r in out.items()}
    e = max(rel(torch.tensor(a["scores"]), torch.tensor(b["scores"]))
            for a, b in zip(out["cuda"].history, out["cpu"].history))
    log(f"tune:halving small (n=2048, p=16) survivors card {kept['cuda']} "
        f"CPU {kept['cpu']}; scores max rel diff {e:.3e}")
    if kept["cuda"] != kept["cpu"]:
        raise AssertionError("card and CPU survivor sets differ")
    return secs


def phase_mlp_dml(data, cfg, seed):
    """DML.fit with mlp outcome and treatment nuisances (hidden (256,
    256), 200 AdamW steps, the reference's defaults) on the "parallel"
    engine at the bootstrap cell: theta finite, the final stage's
    launches, theta's distance from [1, 0.5] in HC0 se reported (no gate:
    at these defaults the nuisances overfit the 499 noise columns, in
    the reference as in the port — tests/test_torch_mlp.py); the same
    fit on the "sequential" engine (one fold model at a time) gives
    bitwise the same out-of-fold predictions; then a small mlp DML on
    the card against the CPU from the same folds and inits (MLP_TOL).
    Returns seconds."""
    from repro_torch.core.dml import DML

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    res = DML(cfg).fit(data.y, data.t, data.X,
                       gen=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    theta, se = res.theta.double().cpu(), res.stderr.double().cpu()
    z = (theta - torch.tensor([1.0, 0.5], dtype=torch.float64)).abs() / se
    d = res.diagnostics
    log(f"mlp:dml n={data.n} p={data.p} hidden {cfg.mlp_hidden} "
        f"{cfg.mlp_steps} steps k={cfg.n_folds}: fit {secs:.3f} s, peak "
        f"{peak:.2f} GiB; theta={theta.tolist()} HC0 se={se.tolist()} "
        f"|theta-[1,0.5]|/se={z.tolist()} (reported, not gated); "
        f"R²(y)={d.nuisance_r2_y:.4f} propensity in [{d.min_propensity:.3e},"
        f" {d.max_propensity:.6f}]; launches={counts} fallbacks={fallbacks}")
    if not bool(torch.isfinite(res.theta).all()):
        raise AssertionError("non-finite theta")
    if counts != {"residual": 1, "residual_meat": 1} or fallbacks:
        raise AssertionError(f"launches {counts} / fallbacks {fallbacks}")
    t0 = time.perf_counter()
    seq = DML(dataclasses.replace(cfg, engine="sequential")).fit(
        data.y, data.t, data.X, gen=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    same = {key: torch.equal(getattr(seq.crossfit, key),
                             getattr(res.crossfit, key))
            for key in ("oof_y", "oof_t")}
    log(f"mlp:dml sequential engine (one fold model at a time) "
        f"{time.perf_counter() - t0:.3f} s: out-of-fold predictions bitwise"
        f" the parallel engine's {same}, theta {seq.theta.tolist()}")
    if not all(same.values()):
        raise AssertionError(f"parallel and sequential mlp fits differ: "
                             f"{same}")
    del seq
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((3000, 200), generator=g)
    t = torch.bernoulli(torch.sigmoid(X[:, 0]), generator=g)
    y = (1 + 0.5 * X[:, 0]) * t + X[:, 0] + torch.randn(3000, generator=g)
    scfg = dataclasses.replace(cfg, n_folds=3, mlp_hidden=(32, 32),
                               row_block=1024)
    thetas = {}
    for dev in ("cpu", "cuda"):
        thetas[dev] = DML(scfg, device=dev).fit(
            y, t, X, gen=torch.Generator().manual_seed(1)).theta.cpu()
    e = rel(thetas["cuda"], thetas["cpu"])
    log(f"mlp DML small (n=3000, p=200, hidden (32, 32), 200 steps, k=3) "
        f"theta card {thetas['cuda'].tolist()} CPU {thetas['cpu'].tolist()}"
        f" max rel diff {e:.3e} (tol {MLP_TOL:g})")
    if not e <= MLP_TOL:
        raise AssertionError(f"card and CPU mlp DML disagree: {e:.3e}")
    return secs


# -- the data mesh (slice 13): ranks of one process group on cuda:0 ----------

MESH_RANKS = 4                 # groups of 1 (nccl), 2 and 4 (gloo) ranks
MESH_RB = 131_072              # rows a block under the mesh: 8 blocks of 1M
MESH_BOOT_B, MESH_CHUNK = 32, 16
MESH_BOOT_RB = 50_000          # the bootstrap's 100k rows: 1 block a rank
MESH_FIT_TOL = 1e-4            # 2-rank fit vs the fit with no mesh
MESH_KERNEL_TOL = 1e-5         # block-wise Grams vs one pass: x·max + 1e-6
MESH_PSUM_TOL = 1e-5           # psum vs ordered, max|d| / max
MESH_TIMEOUT = 600


def _no_op() -> None:
    pass


def _sha(ts) -> str:
    """SHA-256 over the bytes of a list of tensors."""
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _mesh_run(fn):
    """(fn(), this rank's record): seconds, seg_gram launches, accumulator
    bytes into collectives, bytes staged through the host."""
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.runtime import distributed as rd

    sync = torch.cuda.synchronize if torch.cuda.is_available() else _no_op
    sync()
    launches = collections.Counter(kern.LAUNCHES)
    shapes = collections.Counter(kern.SHAPES)
    nbytes, staged = rd.TRAFFIC["bytes"], rd.TRAFFIC["staged_bytes"]
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, {"seconds": time.perf_counter() - t0,
                 "launches": dict(collections.Counter(kern.LAUNCHES)
                                  - launches),
                 "shapes": dict(collections.Counter(kern.SHAPES) - shapes),
                 "bytes": rd.TRAFFIC["bytes"] - nbytes,
                 "staged": rd.TRAFFIC["staged_bytes"] - staged}


def _within(got, want, x, y=0.0) -> float:
    """max|got - want| / (x·max|want| + y): <= 1 passes."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / (x * want.abs().max() + y).clamp_min(1e-300))


def _mesh_rank(rank: int, z: dict, cfg, boot_cfg) -> dict:
    """One rank of the mesh phases (spawned by ``phase_mesh_ranks``):
    ``mesh:reduce`` on all ranks, ``mesh:dml`` and ``mesh:ladder`` on
    ranks 0-1, ``mesh:shard_map`` on all four.  ``z``: the sizes (n, p,
    k, seed, rb, boot_n, boot_b, chunk), the device and rank 0's
    one-rank backend.  Returns what the parent checks."""
    import torch.distributed as dist

    from repro_torch.core import moments
    from repro_torch.core.crossfit import fold_ids
    from repro_torch.core.dml import DML
    from repro_torch.core.registry import tree_arrays
    from repro_torch.data.causal_dgp import paper_demo_data
    from repro_torch.inference.bootstrap import derive_seed, dml_bootstrap
    from repro_torch.inference.executor import ShardMapExecutor
    from repro_torch.runtime import (TaskRuntime, inject_shard_failure,
                                     make_data_mesh, use_data_mesh)

    n, p, k, seed = z["n"], z["p"], z["k"], z["seed"]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if z["device"] == "cuda" else torch.device("cpu"))
    g1 = dist.new_group([0], backend=z["one_rank_backend"])
    g2 = dist.new_group([0, 1], backend="gloo")
    mesh = {4: make_data_mesh(device=dev, backend="gloo")}
    if rank < 2:
        mesh[2] = make_data_mesh(group=g2, device=dev, backend="gloo")
    if rank == 0:
        mesh[1] = make_data_mesh(group=g1, device=dev,
                                 backend=z["one_rank_backend"])
    out = {"rank": rank, "card": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
           "meshes": {s: (m.label, m.backend) for s, m in mesh.items()}}

    # mesh:reduce — weighted_gram and fold_gram at 1M x 500, "pallas"
    data = paper_demo_data(n=n, p=p, seed=seed, device=dev)
    folds = fold_ids(torch.Generator().manual_seed(seed), n, k, device=dev)
    kw = dict(row_block=z["rb"], strategy="pallas")
    grams = {
        "weighted_gram": lambda: moments.weighted_gram(
            data.X, data.propensity, intercept=True, append=data.y, **kw)[0],
        "fold_gram": lambda: moments.fold_gram(
            data.X, folds, k, intercept=True, append=data.y, **kw)[0]}
    dist.barrier()
    red, kept = {}, {}
    for s, dm in [(4, mesh[4]),
                  ("4:psum", dataclasses.replace(mesh[4], reduction="psum")),
                  (2, mesh.get(2)), (1, mesh.get(1))]:
        if dm is None:
            continue
        for form, fn in grams.items():
            with use_data_mesh(dm):
                G, rec = _mesh_run(fn)
            rec["sha"] = _sha([G])
            red[(s, form)] = rec
            if rank == 0:
                kept[(s, form)] = G
            del G
    if rank == 0:
        for form, fn in grams.items():
            single = fn()
            red[("errors", form)] = {
                "kernel": _within(kept[(2, form)], single, MESH_KERNEL_TOL,
                                  1e-6),
                "psum": rel(kept[("4:psum", form)], kept[(4, form)])}
            del single
    out["reduce"] = red
    del kept, folds
    free = torch.cuda.empty_cache if dev.type == "cuda" else _no_op
    free()

    # mesh:dml — the tables cell's fit + jackknife on 2 ranks, 1 rank, none
    dist.barrier()
    if rank < 2:
        def fit():
            res = DML(cfg, device=dev).fit(
                data.y, data.t, data.X, gen=torch.Generator().manual_seed(0))
            inf = res.inference()
            return res, [*tree_arrays(res), inf.se, inf.replicates]

        with use_data_mesh(mesh[2]):
            (res2, leaves), rec = _mesh_run(fit)
        rec["sha"] = _sha(leaves)
        theta, se = res2.theta.double().cpu(), leaves[-2].double().cpu()
        target = torch.tensor([1.0, 0.5], dtype=torch.float64)
        rec["z"] = ((theta - target).abs() / torch.maximum(
            se, res2.stderr.double().cpu())).tolist()
        rec["theta"] = theta.tolist()
        if rank == 0:
            with use_data_mesh(mesh[1]):
                (_, ones), rec1 = _mesh_run(fit)
            rec1["sha"] = _sha(ones)
            (res0, plain), rec0 = _mesh_run(fit)
            rec["vs_no_mesh"] = max(rel(a, b) for a, b in zip(leaves, plain))
            rec["theta_no_mesh"] = res0.theta.tolist()
            out["dml_1"], out["dml_none"] = rec1, rec0
            del ones, plain, res0
        out["dml"] = rec
        del res2, leaves
    del data
    free()

    # mesh:ladder — one lost shard in a B = 32 bootstrap at 100k
    bdata = paper_demo_data(n=z["boot_n"], p=p, seed=seed, device=dev)
    res = DML(boot_cfg, device=dev).fit(bdata.y, bdata.t, bdata.X,
                                        gen=torch.Generator().manual_seed(0))
    c = res.fit_ctx
    bkw = dict(n_folds=boot_cfg.n_folds, XW=c.XW, y=c.y, t=c.t, phi=c.phi,
               seed=derive_seed(c.seed, 0x0B00), n_replicates=z["boot_b"],
               scheme="pairs", row_block=boot_cfg.row_block,
               strategy=boot_cfg.row_block_strategy)
    dist.barrier()
    if rank < 2:
        runs = {}
        for name, lose in (("healthy", 0), ("struck", 1)):
            rt = TaskRuntime("vmap", chunk=z["chunk"], data_mesh=mesh[2])
            inject_shard_failure(lose)
            try:
                b, rec = _mesh_run(lambda: dml_bootstrap(
                    c.nuis_y, c.nuis_t, executor=rt, **bkw))
            finally:
                inject_shard_failure(0)
            rec["sha"] = _sha([b.replicates])
            rec["events"] = [(e.action, e.chunk_index, e.backend)
                             for e in rt.events]
            runs[name] = rec
        out["ladder"] = runs

    # mesh:shard_map — the same bootstrap's replicates over 4 ranks
    dist.barrier()
    sm, rec = _mesh_run(lambda: dml_bootstrap(
        c.nuis_y, c.nuis_t, executor=ShardMapExecutor(mesh[4]), **bkw))
    rec["sha"] = _sha([sm.replicates])
    if rank == 0:
        vm, rec_v = _mesh_run(lambda: dml_bootstrap(
            c.nuis_y, c.nuis_t, executor="vmap", **bkw))
        rec["vmap_sha"], rec["vmap_seconds"] = (_sha([vm.replicates]),
                                                rec_v["seconds"])
    out["shard_map"] = rec
    del bdata, res, c, bkw, sm
    free()
    out.update(_mesh_rank_consumers(rank, z, mesh, dev, cfg))
    dist.barrier()
    return out


def phase_mesh_ranks(args, base):
    """Spawn MESH_RANKS ranks on cuda:0 (gloo world, an nccl group of rank
    0 alone) and run ``_mesh_rank`` on each; the kernels are built."""
    from repro_torch.launch.dist_smoke import spawn_ranks

    cfg = dataclasses.replace(base, row_block=MESH_RB)
    boot_cfg = dataclasses.replace(base, inference="none",
                                   row_block=MESH_BOOT_RB)
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="mesh_ckpt_", dir=build_dir)
    sizes = dict(n=args.n, p=500, k=5, seed=args.seed, rb=MESH_RB,
                 boot_n=BOOT_N, boot_b=MESH_BOOT_B, chunk=MESH_CHUNK,
                 device="cuda", one_rank_backend="nccl", ckpt=ckpt,
                 **MESH_CONSUMER_SIZES)
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(_mesh_rank, MESH_RANKS, sizes, cfg, boot_cfg,
                            backend="gloo", device="cuda",
                            timeout=MESH_TIMEOUT)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"mesh: {MESH_RANKS} ranks on {ranks[0]['card']} (gloo world; "
        f"meshes {ranks[0]['meshes']}) in {time.perf_counter() - t0:.1f} s "
        "with their start")
    return ranks


def _per_rank(ranks, get) -> list:
    return [get(r) for r in ranks if get(r) is not None]


def phase_mesh_reduce(ranks, rows_bytes):
    """``mesh:reduce``: weighted_gram (q 502) and fold_gram (S 5) at
    MESH_RB, every block a seg_gram launch on cuda:0: bitwise across 1
    (nccl), 2 and 4 (gloo) ranks and on every rank, within
    MESH_KERNEL_TOL of one kernel pass, psum within MESH_PSUM_TOL."""
    fails = []
    launches = collections.Counter()
    for form in ("weighted_gram", "fold_gram"):
        shas = {}
        for s in (1, 2, 4, "4:psum"):
            recs = _per_rank(ranks, lambda r: r["reduce"].get((s, form)))
            if s != "4:psum":
                shas[s] = {rec["sha"] for rec in recs}
            for rec in recs:
                launches.update(rec["launches"])
            log(f"mesh:reduce {form} on {s} rank(s) "
                f"[{'nccl' if s == 1 else 'gloo'}]: "
                f"{max(rec['seconds'] for rec in recs):.3f} s; seg_gram "
                f"launches per rank {[rec['launches'] for rec in recs]}; "
                f"bytes across the group {recs[0]['bytes']:,} "
                f"(rows {rows_bytes:,}); staged per rank "
                f"{[rec['staged'] for rec in recs]}")
            if any(sum(rec["launches"].values()) == 0 for rec in recs):
                fails.append(f"{form}@{s}: a rank launched no kernel")
        err = ranks[0]["reduce"][("errors", form)]
        log(f"mesh:reduce {form}: bitwise across 1/2/4 ranks "
            f"{len(set.union(*shas.values())) == 1}; vs one kernel pass "
            f"{err['kernel']:.3e} of tol; psum vs ordered {err['psum']:.3e}")
        if len(set.union(*shas.values())) != 1:
            fails.append(f"{form}: not bitwise across ranks {shas}")
        if not err["kernel"] <= 1.0:
            fails.append(f"{form}: {err['kernel']:.3e} of the kernel tol")
        if not err["psum"] <= MESH_PSUM_TOL:
            fails.append(f"{form}: psum {err['psum']:.3e}")
    if fails:
        raise AssertionError("; ".join(fails))
    return dict(launches)



def phase_mesh_dml(ranks):
    """``mesh:dml``: the tables cell's DML fit + jackknife (row_block
    MESH_RB, "pallas") on 2 gloo ranks bitwise the 1-rank (nccl) fit,
    within MESH_FIT_TOL of the fit with no mesh, theta within 5 se."""
    r0, r1 = ranks[0], ranks[1]
    d0, d1 = r0["dml"], r1["dml"]
    for name, rec in (("2 ranks [gloo]", d0), ("1 rank [nccl]", r0["dml_1"]),
                      ("no mesh", r0["dml_none"])):
        log(f"mesh:dml {name}: {rec['seconds']:.3f} s, seg_gram launches "
            f"{rec['launches']}, bytes across the group {rec['bytes']:,}")
    log(f"mesh:dml 2-rank launches per rank {[d0['launches'], d1['launches']]}"
        f"; theta {d0['theta']} (no mesh {d0['theta_no_mesh']}); "
        f"|theta-[1,0.5]|/se {d0['z']}; "
        f"vs no mesh {d0['vs_no_mesh']:.3e} (tol {MESH_FIT_TOL:g}); bitwise "
        f"2 ranks = 1 rank {d0['sha'] == r0['dml_1']['sha']}, rank 0 = rank "
        f"1 {d0['sha'] == d1['sha']}")
    fails = []
    if not d0["sha"] == d1["sha"] == r0["dml_1"]["sha"]:
        fails.append("the 2-rank fit is not bitwise the 1-rank fit")
    if not d0["vs_no_mesh"] <= MESH_FIT_TOL:
        fails.append(f"{d0['vs_no_mesh']:.3e} from the no-mesh fit")
    if not max(d0["z"]) <= 5.0:
        fails.append(f"theta not within 5 se: {d0['z']}")
    if not all(sum(d["launches"].values()) for d in (d0, d1)):
        fails.append("a rank launched no kernel")
    if fails:
        raise AssertionError("; ".join(fails))
    return {key: d0["launches"].get(key, 0) + d1["launches"].get(key, 0)
            for key in set(d0["launches"]) | set(d1["launches"])}


def phase_mesh_ladder(ranks):
    """``mesh:ladder``: B = MESH_BOOT_B at 100k in chunks of MESH_CHUNK on
    2 gloo ranks; one injected lost shard: one retry and one downgrade (the
    first chunk, on each rank alone), replicates bitwise the healthy
    run's."""
    fails, launches = [], collections.Counter()
    for r in ranks[:2]:
        h, s = r["ladder"]["healthy"], r["ladder"]["struck"]
        launches.update(h["launches"])
        launches.update(s["launches"])
        log(f"mesh:ladder rank {r['rank']} [gloo, 2 ranks]: healthy "
            f"{h['seconds']:.3f} s, struck {s['seconds']:.3f} s; seg_gram "
            f"launches {h['launches']} / {s['launches']}; bytes across the "
            f"group {h['bytes']:,} / {s['bytes']:,}; events {s['events']}")
        acts = [(e[0], e[1]) for e in s["events"] if e[0] != "chunk"]
        if acts != [("retry", 0), ("downgrade", 0)]:
            fails.append(f"rank {r['rank']}: events {s['events']}")
        if [e for e in h["events"] if e[0] != "chunk"]:
            fails.append(f"rank {r['rank']}: healthy events {h['events']}")
        if s["sha"] != h["sha"] or h["sha"] != ranks[0]["ladder"]["healthy"][
                "sha"]:
            fails.append(f"rank {r['rank']}: replicates not bitwise")
        if not sum(h["launches"].values()):
            fails.append(f"rank {r['rank']}: no kernel launched")
    log(f"mesh:ladder: bitwise the healthy run {not fails}")
    if fails:
        raise AssertionError("; ".join(fails))
    return dict(launches)


def phase_mesh_shard_map(ranks):
    """``mesh:shard_map``: the same bootstrap's B = MESH_BOOT_B replicates
    split over 4 gloo ranks (8 each), bitwise the vmap executor's run on
    rank 0."""
    recs = [r["shard_map"] for r in ranks]
    launches = collections.Counter()
    for rec in recs:
        launches.update(rec["launches"])
    same = len({rec["sha"] for rec in recs}) == 1 and \
        recs[0]["sha"] == recs[0]["vmap_sha"]
    log(f"mesh:shard_map [gloo, 4 ranks]: {max(x['seconds'] for x in recs):.3f}"
        f" s (vmap alone {recs[0]['vmap_seconds']:.3f} s); seg_gram launches "
        f"per rank {[x['launches'] for x in recs]}; bytes across the group "
        f"{recs[0]['bytes']:,}; bitwise vmap {same}")
    if not same:
        raise AssertionError("shard_map replicates differ from vmap's")
    if not all(sum(x["launches"].values()) for x in recs):
        raise AssertionError("a rank launched no kernel")
    return dict(launches)


# -- slice 14: the mesh's consumers and the paper's cells as steps ----------

# mesh:sweep — 16 segments (cut from the sweep cell's 64 for time) of
# 2^17 rows (cut from 2^20 for time) x 500, one chunk of 16 cells, two
# blocks of 65,536 rows;
# mesh:shard_map-sweep / resume / jobs at 2^16 rows x 8 segments, two
# blocks; mesh:store — 64 cohorts, 2 days (cut from 5 for time) of 2^18
# rows, two blocks a day; cell:dml / cell:iv at the reference cell's
# 2^20 x 500, eight blocks under the mesh
MESH_CONSUMER_SIZES = dict(
    sweep=(2 ** 17, 16, 65_536), small=(2 ** 16, 8, 32_768),
    store=(2 ** 18, 2, 131_072, 64), cell=(2 ** 20, 131_072))
CELL_SWEEP_SMALL = (2 ** 16, 8, 32_768)     # rows, segments, rows a block
# cells-mode launches under the record of their form's nearest shape
_CELLS_KEYS = {"fold_weighted": "fold_weighted@cells",
               "residual_meat": f"residual_meat@R{BOOT_CHUNK}"}


def _mesh_cells_data(seed: int, n: int, p: int, e: int, dev):
    """``paper_demo_data`` rows and segment ids, drawn on ``dev`` (on the
    card the draws of ``_cells_inputs``)."""
    from repro_torch.data.causal_dgp import paper_demo_data

    data = paper_demo_data(n=n, p=p, seed=seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    return data, torch.randint(0, e, (n,), generator=g, device=dev)


def _panel_rec(panel) -> dict:
    """A panel's SHA-256, its columns on the host, errors and events."""
    cols = panel.columns
    return {"sha": _sha([x for c in cols if not c.failed
                         for x in (c.thetas, c.ates, c.ses)]),
            "cols": [None if c.failed else
                     (c.thetas.cpu(), c.ates.cpu(), c.ses.cpu())
                     for c in cols],
            "sha_cols": [None if c.failed else
                         _sha([c.thetas, c.ates, c.ses]) for c in cols],
            "errors": [c.error for c in cols],
            "events": [tuple(c.events) for c in cols]}


def _mesh_rank_consumers(rank: int, z: dict, mesh: dict, dev, cfg) -> dict:
    """Slice 14's phases on one rank of ``_mesh_rank``'s group:
    ``mesh:sweep`` (2 ranks; rank 2 the panel with no mesh; rank 0 the
    1-rank nccl panel), ``mesh:shard_map-sweep`` (4 ranks),
    ``mesh:resume`` and ``mesh:jobs`` (2 ranks), ``mesh:store`` (2 ranks;
    rank 0 the 1-rank and no-mesh stores), ``cell:dml`` and ``cell:iv``
    (2 ranks; rank 0 the steps with no mesh and the estimators)."""
    import os

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.crossfit import fold_ids
    from repro_torch.core.dml import DML
    from repro_torch.core.iv import OrthoIV
    from repro_torch.data.causal_dgp import (make_causal_data, make_iv_data,
                                             paper_demo_data)
    from repro_torch.launch.dml_cell import make_dml_step, make_iv_step
    from repro_torch.launch.elastic import elastic_sweep
    from repro_torch.runtime import (JobManager, inject_shard_failure,
                                     use_data_mesh)
    from repro_torch.store import MomentStore
    from repro_torch.sweep import SweepSpec, sweep

    p, seed = z["p"], z["seed"]
    free = torch.cuda.empty_cache if dev.type == "cuda" else _no_op
    out = {}

    # mesh:sweep — cells mode, a dml and a drlearner column
    n, e, rb = z["sweep"]
    data, sids = _mesh_cells_data(seed, n, p, e, dev)
    scfg = _cells_cfg(row_block=rb, sweep_chunk=e)
    spec = SweepSpec(e, (("dml", scfg), ("drlearner", scfg)))
    kw = dict(X=data.X, y=data.y, t=data.t, segment_ids=sids, seed=seed)
    dist.barrier()
    rec = {}
    if rank < 2:
        panel, rec["mesh2"] = _mesh_run(lambda: sweep(spec,
                                                      data_mesh=mesh[2], **kw))
        rec["mesh2"].update(_panel_rec(panel))
        if rank == 0:
            panel, rec["mesh1"] = _mesh_run(lambda: sweep(
                spec, data_mesh=mesh[1], **kw))
            rec["mesh1"].update(_panel_rec(panel))
    elif rank == 2:
        panel, rec["none"] = _mesh_run(lambda: sweep(spec, device=dev, **kw))
        rec["none"].update(_panel_rec(panel))
    out["sweep"] = rec
    del data, sids, kw, spec
    free()

    # mesh:shard_map-sweep — a dml column's cells over 4 ranks
    n, e, rb = z["small"]
    data, sids = _mesh_cells_data(seed + 1, n, p, e, dev)
    kw = dict(X=data.X, y=data.y, t=data.t, segment_ids=sids, seed=seed)
    vcfg = _cells_cfg(row_block=rb)
    dist.barrier()
    panel, rec = _mesh_run(lambda: sweep(SweepSpec(e, (("dml", dataclasses
        .replace(vcfg, inference_executor="shard_map")),)),
        data_mesh=mesh[4], **kw))
    rec.update(_panel_rec(panel))
    if rank == 0:
        panel, rec_v = _mesh_run(lambda: sweep(SweepSpec(e, (("dml", vcfg),)),
                                               device=dev, **kw))
        rec["vmap_sha"], rec["vmap_seconds"] = (_panel_rec(panel)["sha"],
                                                rec_v["seconds"])
    out["shard_map_sweep"] = rec

    # mesh:resume and mesh:jobs — 2 ranks, one checkpoint directory
    rspec = SweepSpec(e, (("dml", dataclasses.replace(
        vcfg, runtime_max_retries=0)), ("drlearner", vcfg)))
    dist.barrier()
    if rank < 2:
        runs = {}
        path = os.path.join(z["ckpt"], "resume")
        inject_shard_failure(1)
        try:
            panel, runs["struck"] = _mesh_run(lambda: sweep(
                rspec, data_mesh=mesh[2], checkpoint=CheckpointManager(path),
                **kw))
        finally:
            inject_shard_failure(0)
        runs["struck"].update(_panel_rec(panel))
        panel, runs["again"] = _mesh_run(lambda: sweep(
            rspec, data_mesh=mesh[2], checkpoint=CheckpointManager(path),
            **kw))
        runs["again"].update(_panel_rec(panel))
        espec = SweepSpec(e, (("dml", vcfg),))
        epath = os.path.join(z["ckpt"], "elastic")
        for name in ("elastic1", "elastic2"):
            panel, runs[name] = _mesh_run(lambda: elastic_sweep(
                espec, directory=epath, data_mesh=mesh[2], **kw))
            runs[name].update(_panel_rec(panel))
        out["resume"] = runs

        # the healthy run of the same spec, as a threaded job
        def job():
            j = JobManager().submit(rspec, data_mesh=mesh[2], **kw)
            events = [(ev.action, ev.label) for ev in j.subscribe()]
            return j.result(timeout=MESH_TIMEOUT), events, j.status()

        (panel, events, status), rec = _mesh_run(job)
        rec.update(_panel_rec(panel))
        rec["job_events"], rec["status"] = events, status["status"]
        out["jobs"] = rec
    del data, sids, kw, rspec
    free()

    # mesh:store — 64 cohorts, aligned daily ingests
    day, days, rb, e = z["store"]
    d = make_causal_data(n=day * days, p=p, seed=seed,
                         discrete_treatment=False, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    ssid = torch.randint(0, e, (day * days,), generator=g, device=dev)
    sspec = SweepSpec(e, (("dml", _store_cfg(row_block=rb)),))

    def store(dm, cuts):
        st = MomentStore(sspec, p, seed=seed, data_mesh=dm, device=dev)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            st.ingest(X=d.X[lo:hi], y=d.y[lo:hi], t=d.t[lo:hi],
                      segment_ids=ssid[lo:hi])
        return st

    def leaves(st):
        c = st.state_dict()["col0"]
        return [c["ng"], c["vg"], c["counts"]]

    daily = [i * day for i in range(days + 1)]
    dist.barrier()
    if rank < 2:
        runs = {}
        st2, runs["mesh2"] = _mesh_run(lambda: store(mesh[2], daily))
        runs["mesh2"]["sha"] = _sha(leaves(st2))
        if rank == 0:
            st, runs["mesh1"] = _mesh_run(lambda: store(mesh[1], daily))
            runs["mesh1"]["sha"] = _sha(leaves(st))
            del st
            st, runs["once"] = _mesh_run(lambda: store(mesh[1],
                                                       [0, day * days]))
            runs["once"]["sha"] = _sha(leaves(st))
            del st
            free()
            st, runs["none"] = _mesh_run(lambda: store(None, daily))
            runs["vs_no_mesh"] = max(
                _within(a, b, MESH_KERNEL_TOL, 1e-6)
                for a, b in zip(leaves(st2), leaves(st)))
            del st
            col = st2.refresh().columns[0]
            runs["finite"] = bool(torch.isfinite(col.thetas).all()
                                  and torch.isfinite(col.ses).all())
            runs["ate"] = (float(col.ates.min()), float(col.ates.max()))
        out["store"] = runs
        del st2
    del d, ssid
    free()

    # cell:dml and cell:iv — the paper's steps at 2^20 x 500
    n, rb = z["cell"]
    ccfg = dataclasses.replace(cfg, row_block=rb, inference="none")
    k = ccfg.n_folds
    folds = fold_ids(torch.Generator().manual_seed(0), n, k, device=dev)
    for name in ("dml", "iv"):
        if name == "dml":
            dd = paper_demo_data(n=n, p=p, seed=seed, device=dev)
            args = (dd.X, dd.y, dd.t, folds)
            step = make_dml_step(ccfg, ccfg.engine, device=dev)
            truth = [1.0, 0.5]

            def fit():
                return DML(ccfg, device=dev).fit(
                    dd.y, dd.t, dd.X, gen=torch.Generator().manual_seed(0))
        else:
            dd = make_iv_data(n=n, p=p, seed=seed, device=dev)
            args = (dd.X, dd.y, dd.t, dd.z, folds)
            step = make_iv_step(ccfg, ccfg.engine, device=dev)
            truth = [dd.true_late]

            def fit():
                return OrthoIV(ccfg, device=dev).fit(
                    dd.y, dd.t, dd.z, dd.X,
                    gen=torch.Generator().manual_seed(0))
        dist.barrier()
        if rank < 2:
            with use_data_mesh(mesh[2]):
                (th2, cov2), rec = _mesh_run(lambda: step(*args))
            rec["sha"] = _sha([th2, cov2])
            se = torch.sqrt(torch.diagonal(cov2)).double().cpu()
            th = th2.double().cpu()
            rec["theta"] = th.tolist()
            rec["z"] = [abs(float(th[i]) - v) / float(se[i])
                        for i, v in enumerate(truth)]
            if rank == 0:
                (th0, cov0), rec["none"] = _mesh_run(lambda: step(*args))
                res, rec["fit"] = _mesh_run(fit)
                rec["bitwise_fit"] = bool(torch.equal(th0, res.theta)
                                          and torch.equal(cov0, res.cov))
                rec["vs_no_mesh"] = max(rel(th2, th0), rel(cov2, cov0))
                del res
            out[f"cell_{name}"] = rec
        del dd, args, step
        free()
    return out


def _sum_launches(recs, rename=None) -> dict:
    """Launches of ``recs`` summed over ranks, under record keys."""
    c = collections.Counter()
    for rec in recs:
        for key, n in rec["launches"].items():
            c[(rename or {}).get(key, key)] += n
    return dict(c)


def _launch_gate(fails, what, recs) -> None:
    for i, rec in enumerate(recs):
        if not sum(rec["launches"].values()):
            fails.append(f"{what}: rank {i} launched no kernel")


def phase_mesh_sweep(ranks):
    """``mesh:sweep``: the cells panel on 2 gloo ranks bitwise the 1-rank
    (nccl) panel, within MESH_FIT_TOL of the panel with no mesh, every
    dml segment's ATE within 5 se of 1; each rank launched seg_gram."""
    two = [r["sweep"]["mesh2"] for r in ranks[:2]]
    one, none = ranks[0]["sweep"]["mesh1"], ranks[2]["sweep"]["none"]
    fails = []
    for rec in (*two, one, none):
        fails += [f"column failed: {err}" for err in rec["errors"] if err]
    if fails:
        raise AssertionError("; ".join(fails))
    vs = max(rel(a, b) for ca, cb in zip(two[0]["cols"], none["cols"])
             for a, b in zip(ca, cb))
    ate, se = two[0]["cols"][0][1].double(), two[0]["cols"][0][2][:, 0]
    zmax = float(((ate - 1.0).abs() / se.double()).max())
    for name, rec in (("2 ranks [gloo] rank 0", two[0]),
                      ("2 ranks [gloo] rank 1", two[1]),
                      ("1 rank [nccl]", one), ("no mesh", none)):
        log(f"mesh:sweep {name}: {rec['seconds']:.3f} s; seg_gram launches "
            f"{rec['launches']}; bytes across the group {rec['bytes']:,}, "
            f"staged {rec['staged']:,}")
    same = two[0]["sha"] == two[1]["sha"] == one["sha"]
    log(f"mesh:sweep: 2 ranks bitwise 1 rank {same}; vs no mesh {vs:.3e} "
        f"(tol {MESH_FIT_TOL:g}); dml max |ate-1|/se {zmax:.3f}")
    if not same:
        fails.append("the 2-rank panel is not bitwise the 1-rank panel")
    if not vs <= MESH_FIT_TOL:
        fails.append(f"{vs:.3e} from the panel with no mesh")
    if not zmax <= 5.0:
        fails.append(f"a dml segment's ATE is {zmax:.3f} se from 1")
    _launch_gate(fails, "mesh:sweep", two)
    if fails:
        raise AssertionError("; ".join(fails))
    return _sum_launches(two, _CELLS_KEYS)


def phase_mesh_shard_map_sweep(ranks):
    """``mesh:shard_map-sweep``: a dml column on ``ShardMapExecutor`` over
    4 ranks, bitwise the vmap column with no mesh."""
    recs = [r["shard_map_sweep"] for r in ranks]
    same = (len({rec["sha"] for rec in recs}) == 1
            and recs[0]["sha"] == recs[0]["vmap_sha"]
            and not any(err for rec in recs for err in rec["errors"]))
    log(f"mesh:shard_map-sweep [gloo, 4 ranks]: "
        f"{max(rec['seconds'] for rec in recs):.3f} s (vmap alone "
        f"{recs[0]['vmap_seconds']:.3f} s); seg_gram launches per rank "
        f"{[rec['launches'] for rec in recs]}; bytes across the group "
        f"{recs[0]['bytes']:,}; bitwise vmap {same}")
    fails = [] if same else ["the shard_map column differs from vmap's"]
    _launch_gate(fails, "mesh:shard_map-sweep", recs)
    if fails:
        raise AssertionError("; ".join(fails))
    return _sum_launches(recs, _CELLS_KEYS)


def phase_mesh_resume(ranks):
    """``mesh:resume`` on 2 ranks: the struck column (no retry budget)
    fails, its neighbour bitwise the healthy run's (``mesh:jobs``' job of
    the same spec); the re-run restores only the neighbour and
    recomputes the struck column bitwise; ``elastic_sweep``'s second
    call restores."""
    fails, recs = [], []
    for r in ranks[:2]:
        runs, h = r["resume"], r["jobs"]
        s, a = runs["struck"], runs["again"]
        e1, e2 = runs["elastic1"], runs["elastic2"]
        recs += [s, a, e1]
        log(f"mesh:resume rank {r['rank']} [gloo, 2 ranks]: struck "
            f"{s['seconds']:.3f} s, re-run {a['seconds']:.3f} s, elastic "
            f"{e1['seconds']:.3f} / {e2['seconds']:.3f} s; events struck "
            f"{s['events']}, re-run {a['events']}, elastic {e2['events']}; "
            f"seg_gram launches struck {s['launches']}, re-run "
            f"{a['launches']}")
        if h["errors"] != [None, None]:
            fails.append(f"rank {r['rank']}: healthy run failed {h['errors']}")
        if not (s["errors"][0] and "injected shard failure" in s["errors"][0]
                and s["errors"][1] is None):
            fails.append(f"rank {r['rank']}: struck errors {s['errors']}")
        if s["sha_cols"][1] != h["sha_cols"][1]:
            fails.append(f"rank {r['rank']}: the neighbour is not bitwise")
        if "restored" in a["events"][0] or "restored" not in a["events"][1]:
            fails.append(f"rank {r['rank']}: re-run events {a['events']}")
        if a["sha_cols"] != h["sha_cols"]:
            fails.append(f"rank {r['rank']}: the re-run is not bitwise")
        if "restored" not in e2["events"][0] or e2["sha"] != e1["sha"] or \
                e1["sha_cols"][0] != h["sha_cols"][0]:
            fails.append(f"rank {r['rank']}: elastic {e1['events']} / "
                         f"{e2['events']}")
        if not (sum(a["launches"].values()) and sum(s["launches"].values())):
            fails.append(f"rank {r['rank']}: a run launched no kernel")
    if ranks[0]["resume"]["again"]["sha"] != ranks[1]["resume"]["again"][
            "sha"]:
        fails.append("the ranks' re-runs differ")
    log(f"mesh:resume: one column lost, restored and recomputed bitwise "
        f"{not fails}")
    if fails:
        raise AssertionError("; ".join(fails))
    return _sum_launches(recs, _CELLS_KEYS)


def phase_mesh_jobs(ranks):
    """``mesh:jobs``: a threaded job of the resume spec on 2 ranks; its
    events (submitted, a column per column, done) and its panel bitwise
    the direct sweep of that spec under the same mesh (``mesh:resume``'s
    re-run)."""
    fails, recs = [], [r["jobs"] for r in ranks[:2]]
    for r, rec in zip(ranks, recs):
        acts = [a for a, _ in rec["job_events"]]
        same = rec["sha"] == r["resume"]["again"]["sha"]
        log(f"mesh:jobs rank {r['rank']} [gloo, 2 ranks]: "
            f"{rec['seconds']:.3f} s; events {rec['job_events']}; status "
            f"{rec['status']}; bitwise the direct sweep {same}; seg_gram "
            f"launches {rec['launches']}")
        if acts != ["submitted", "column", "column", "done"]:
            fails.append(f"rank {r['rank']}: job events {acts}")
        if not same:
            fails.append(f"rank {r['rank']}: the job's panel differs")
    _launch_gate(fails, "mesh:jobs", recs)
    if fails:
        raise AssertionError("; ".join(fails))
    return _sum_launches(recs, _CELLS_KEYS)


def phase_mesh_store(ranks):
    """``mesh:store``: 2 gloo ranks bitwise the 1-rank (nccl) store,
    one-shot bitwise the daily ingests, within MESH_KERNEL_TOL of the
    store with no mesh, the refreshed panel finite."""
    two = [r["store"]["mesh2"] for r in ranks[:2]]
    r0 = ranks[0]["store"]
    for name, rec in (("2 ranks [gloo] rank 0", two[0]),
                      ("2 ranks [gloo] rank 1", two[1]),
                      ("1 rank [nccl]", r0["mesh1"]),
                      ("1 rank one-shot", r0["once"]), ("no mesh", r0["none"])):
        log(f"mesh:store {name}: {rec['seconds']:.3f} s; seg_gram launches "
            f"{rec['launches']}; bytes across the group {rec['bytes']:,}, "
            f"staged {rec['staged']:,}")
    same = two[0]["sha"] == two[1]["sha"] == r0["mesh1"]["sha"]
    once = r0["once"]["sha"] == r0["mesh1"]["sha"]
    log(f"mesh:store: 2 ranks bitwise 1 rank {same}; one-shot bitwise two "
        f"ingests {once}; vs no mesh {r0['vs_no_mesh']:.3e} of tol; "
        f"refreshed ATE range {r0['ate']}, finite {r0['finite']}")
    fails = []
    if not same:
        fails.append("the 2-rank store is not bitwise the 1-rank store")
    if not once:
        fails.append("one-shot differs from the daily ingests")
    if not r0["vs_no_mesh"] <= 1.0:
        fails.append(f"{r0['vs_no_mesh']:.3e} of the tol from no mesh")
    if not r0["finite"]:
        fails.append("the refreshed panel is not finite")
    _launch_gate(fails, "mesh:store", two)
    if fails:
        raise AssertionError("; ".join(fails))
    c = collections.Counter()
    for rec in two:
        for (key, S, ql, _qr), n in rec["shapes"].items():
            c["pair:ng" if ql == SWEEP_P + 3 else
              "pair:vg" if ql == 2 * (SWEEP_P + 3) else key] += n
    return dict(c)


def phase_cell(ranks, name):
    """``cell:dml`` / ``cell:iv``: the step with no mesh bitwise the
    estimator's fit on the same folds; on 2 ranks within MESH_FIT_TOL of
    it, bitwise across the ranks, theta within 5 se."""
    recs = [r[f"cell_{name}"] for r in ranks[:2]]
    r0 = recs[0]
    log(f"cell:{name} at 2^20 x 500: 2 ranks [gloo] {r0['seconds']:.3f} s "
        f"(launches per rank {[rec['launches'] for rec in recs]}, bytes "
        f"across the group {r0['bytes']:,}); no mesh "
        f"{r0['none']['seconds']:.3f} s (launches {r0['none']['launches']}); "
        f"the estimator's fit {r0['fit']['seconds']:.3f} s; theta "
        f"{r0['theta']}, |theta - truth|/se {r0['z']}; no mesh bitwise the "
        f"fit {r0['bitwise_fit']}; 2 ranks vs no mesh {r0['vs_no_mesh']:.3e}"
        f" (tol {MESH_FIT_TOL:g})")
    fails = []
    if not r0["bitwise_fit"]:
        fails.append("the step is not bitwise the estimator's fit")
    if recs[0]["sha"] != recs[1]["sha"]:
        fails.append("the ranks' results differ")
    if not r0["vs_no_mesh"] <= MESH_FIT_TOL:
        fails.append(f"{r0['vs_no_mesh']:.3e} from no mesh")
    if not max(r0["z"]) <= 5.0:
        fails.append(f"theta not within 5 se: {r0['z']}")
    _launch_gate(fails, f"cell:{name}", recs)
    if fails:
        raise AssertionError("; ".join(fails))
    return _sum_launches(recs + [r0["none"]])


def phase_cell_sweep(seed: int):
    """``cell:sweep``: ``make_sweep_step("segmented")`` at the sweep cell's
    2^20 x 500 x 64 (every segment's ATE within 5 se of 1), and
    ``make_sweep_step("cells")`` at 2^16 x 8 bitwise ``serial_loop``.
    Returns the launches and the pair launches by shape."""
    from repro_torch.launch.sweep_cell import make_sweep_step
    from repro_torch.sweep import serial_loop

    data, sids, spec = _sweep_inputs(seed)
    cfg = spec.columns[0][1]
    _reset_counters()
    t0 = time.perf_counter()
    theta, se = make_sweep_step(cfg, SWEEP_E, "segmented")(
        data.X, data.y, data.t, sids)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    shapes = dict(_counters()[2])
    z = ((theta[:, 0].double() - 1.0).abs() / se[:, 0].double()).max()
    del data, sids
    torch.cuda.empty_cache()
    n, e, rb = CELL_SWEEP_SMALL
    data, sids = _mesh_cells_data(seed, n, SWEEP_P, e, "cuda")
    ccfg = _cells_cfg(row_block=rb)
    t0 = time.perf_counter()
    ct, cse = make_sweep_step(ccfg, e, "cells")(data.X, data.y, data.t, sids)
    torch.cuda.synchronize()
    cells_s = time.perf_counter() - t0
    cells_counts = dict(collections.Counter(_read_counters()[0])
                        - collections.Counter(counts))
    loop = serial_loop("dml", ccfg, X=data.X, y=data.y, t=data.t,
                       segment_ids=sids, n_segments=e, seed=0, col_index=0)
    same = torch.equal(ct, loop["theta"]) and torch.equal(cse, loop["se"])
    log(f"cell:sweep segmented n={SWEEP_N} p={SWEEP_P} E={SWEEP_E}: "
        f"{seg_s:.3f} s, max |ate-1|/se {float(z):.3f}, launches {counts}; "
        f"cells n={n} E={e}: {cells_s:.3f} s, launches {cells_counts}, "
        f"bitwise serial_loop {same}; fallbacks {fallbacks}")
    if not (bool(torch.isfinite(theta).all()) and float(z) <= 5.0):
        raise AssertionError(f"a segment's ATE is {float(z):.3f} se from 1")
    if not same:
        raise AssertionError("the cells step differs from serial_loop")
    if not (counts and cells_counts.get("fold_weighted")):
        raise AssertionError("a step launched no seg_gram kernel")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    cells = {_CELLS_KEYS.get(k, k): c for k, c in cells_counts.items()}
    return counts, cells, shapes


# ---------------------------------------------------------------------------
# LM training (slice 17): the flash kernel under autograd, granite-3-2b
# and whisper-tiny trained on the card.
# ---------------------------------------------------------------------------

# (dq, dk, dv) of the flash route (the kernel's bf16 forward with its LSE,
# the plain fp32 blocked backward, results rounded to bf16) against
# autograd through the plain version in fp32: max|diff| / max|ref|.  The
# bf16 rounding of the gradients and of o (in delta = rowsum(o·do))
# gives ~3e-3 (tests/test_torch_train.py's CPU rehearsal of the backward
# on bf16 inputs); 1e-2 allows three such steps.
FA_BWD_TOL = 1e-2
FA_LSE_TOL = 1e-3            # |lse - plain fp32 logsumexp|, absolute
# the train-form shapes: (name, B, S, H, KV, Dqk, Dv, causal)
FA_TRAIN_SHAPES = (
    ("granite-3-2b", 8, 1024, 32, 8, 64, 64, True),
    ("deepseek-v3-671b mla", 2, 1024, 128, 128, 192, 128, True),
    ("whisper-tiny encoder", 8, 1500, 6, 6, 64, 64, False))
# lm_train: granite-3-2b's batch and microbatches, timed steps after one
# warm step; flash vs chunked from one init on one batch: loss and grad
# norm within these (bf16 compute: the two round at other places)
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO, LM_TRAIN_STEPS = 8, 1024, 2, 8
LM_TRAIN_LOSS_TOL, LM_TRAIN_GNORM_TOL = 1e-2, 5e-2
LM_TRAIN_LR = 1e-3
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 8, 128, 3
# rwkv6-3b and zamba2-1.2b: granite's batch and microbatches, whole, the
# scans under their Functions; kernel vs plain scan route from one init
# on the first batch within LM_TRAIN_LOSS_TOL / LM_TRAIN_GNORM_TOL,
# every leaf as below.  rwkv6-3b takes more steps: at its init every
# head's o at t = 0 is 0 (u = 0, no history), so its group norm sits at
# var = 0 and the u leaf's gradient, through 1/sqrt(norm_eps), carries
# nearly the whole grad norm (the reference's too); clipping then
# starves every other leaf until u has moved, about two steps
SCAN_TRAIN_STEPS, RWKV_TRAIN_STEPS = 5, 12
# every gradient leaf, against the plain route in fp32 compute from the
# same init (max|g - g32| / max|g32|): the kernel route's within
# LM_TRAIN_LEAF_RATIO x the bf16 plain route's + LM_TRAIN_LEAF_FLOOR (two
# bf16 routes of an untrained stack part by O(1)·max on some leaves:
# PERF.md §6)
LM_TRAIN_LEAF_RATIO, LM_TRAIN_LEAF_FLOOR = 2.0, 1e-3
# (batch, seq, microbatches, timed steps) of each lm_train phase
LM_TRAIN_FORMS = {
    "granite-3-2b": (LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO,
                     LM_TRAIN_STEPS),
    "whisper-tiny": (WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, 1,
                     WHISPER_TRAIN_STEPS),
    "rwkv6-3b": (LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO,
                 RWKV_TRAIN_STEPS),
    "zamba2-1.2b": (LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO,
                    SCAN_TRAIN_STEPS)}
LM_TRAIN_ARCHS = tuple(LM_TRAIN_FORMS)
# Untrained losses these few steps at LM_TRAIN_LR do not move (printed,
# not gated): whisper-tiny's sits at ~ln V
LM_TRAIN_FLAT = ("whisper-tiny",)
# One more step of each trained backbone under ``launch/op_cost.count``:
# its kernel launches (the wrappers' ``charge``) must equal LAUNCHES' own
# count for the step and these; useful_frac = 6·N·tokens / counted flops
# must fall in the band fixed from the config before any measurement
# (PERF.md §6): the shared block of zamba2 is applied 7 times
# but counted once in N, rwkv6's embeddings count in N with no product,
# and remat "nothing" recomputes each layer's forward
LM_COUNTED_LAUNCHES = {"granite-3-2b": {"flash_attention": 160},
                       "rwkv6-3b": {"gla": 128},
                       "zamba2-1.2b": {"ssd": 152, "flash_attention": 14}}
LM_USEFUL_BAND = {"granite-3-2b": (0.55, 0.85), "rwkv6-3b": (0.55, 0.90),
                  "zamba2-1.2b": (0.35, 0.80)}
# the production cells the dry run traces on the card's host: a train
# cell on the single pod, the expert-parallel decode on the multi-pod
DRYRUN_CELLS = (("granite-3-2b", "train_4k", "single"),
                ("deepseek-v3-671b", "decode_32k", "multi"))
DRYRUN_HBM_GIB = 80.0            # an H100's memory
# the paper's cell on both production meshes, and the -smoke cells whose
# DTensor ops differ on the card host's torch (2.11) from this repo's
# tests' (2.13): the token shift's and the causal conv's padding, the
# scans' cumsum under autograd, the MoE train cell
DRYRUN_SMOKE_CELLS = (("rwkv6-3b-smoke", "train_4k"),
                      ("rwkv6-3b-smoke", "prefill_32k"),
                      ("zamba2-1.2b-smoke", "train_4k"),
                      ("zamba2-1.2b-smoke", "prefill_32k"),
                      ("arctic-480b-smoke", "train_4k"))
# elastic:remesh — granite-3-2b at full width and ELASTIC_LAYERS layers,
# ELASTIC_STEPS steps before the save and after the restore; every
# restored leaf bitwise the state saved (one rank, a lossless format);
# the restored run's losses against the uninterrupted run's, relative
# (one card, one rank: the mesh's local products are the same products,
# so only a reordered sum can move a loss; bf16 compute).  The bound is
# a few times the 7.35e-5 measured while the vocab-parallel CE and
# embedding took their sharded forms on one rank
ELASTIC_ARCH, ELASTIC_LAYERS = "granite-3-2b", 2
ELASTIC_BATCH, ELASTIC_SEQ, ELASTIC_STEPS = 8, 256, 3
ELASTIC_LOSS_TOL = 5e-4
# cell:dml-mesh — theta and cov of the step on the one-rank host mesh
# against the step with no mesh: |a - b| <= DML_MESH_TOL · max|b|
DML_MESH_TOL = 1e-5


def _counted_step(arch, cfg, step_fn, state, batch, median_s: float):
    """One train step under ``op_cost.count``: its roofline on one card
    against the median measured step.  Gates: the counted kernel
    launches equal LAUNCHES' for the step and LM_COUNTED_LAUNCHES; the
    bound at most the measured step; useful_frac inside LM_USEFUL_BAND."""
    from repro_torch.config import ShapeConfig
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.launch import op_cost
    from repro_torch.launch.roofline import (PEAK_FLOPS, Roofline,
                                             model_flops_for)

    def launched():
        return {"flash_attention": fa_kernel.LAUNCHES["flash_attention"],
                "gla": sk.LAUNCHES["gla"], "ssd": sk.LAUNCHES["ssd"]}

    before = launched()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with op_cost.count() as tot:
        state.params, state.opt, met = step_fn(state.params, state.opt,
                                               batch)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    delta = {k: n - before[k] for k, n in launched().items()
             if n - before[k]}
    counted = dict(sorted(tot.launches.items()))
    B, S = batch["tokens"].shape
    rl = Roofline(flops=tot.flops, hbm_bytes=tot.bytes,
                  wire_bytes=tot.wire_bytes, chips=1,
                  model_flops=model_flops_for(
                      cfg, ShapeConfig("lm_train", "train", S, B)))
    mfu = rl.model_flops / (median_s * PEAK_FLOPS)
    lo, hi = LM_USEFUL_BAND[arch]
    ok = (counted == delta == LM_COUNTED_LAUNCHES[arch]
          and rl.step_time <= median_s
          and lo <= rl.useful_flops_frac <= hi
          and bool(np.isfinite(float(met["loss"]))))
    log(f"lm_train {arch} counted step [{card_line()}] ({count_s:.1f} s "
        f"under the counter): {tot.flops / 1e12:.3f} TFLOP, "
        f"{tot.bytes / 1e9:.2f} GB, kernel launches {counted} (LAUNCHES "
        f"{delta}, expected {LM_COUNTED_LAUNCHES[arch]}; kernel TFLOP "
        + str({k: round(v / 1e12, 4) for k, v in tot.kernel_flops.items()})
        + f"); roofline t_compute {rl.t_compute * 1e3:.1f} ms t_memory "
        f"{rl.t_memory * 1e3:.1f} ms step_time {rl.step_time * 1e3:.1f} ms "
        f"({rl.bottleneck}) vs the median measured step "
        f"{median_s * 1e3:.1f} ms; model_flops {rl.model_flops / 1e12:.3f} "
        f"TFLOP, useful_frac {rl.useful_flops_frac:.3f} (band {lo}-{hi}), "
        f"mfu {mfu:.4f} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"lm_train {arch}: counted step")
    return {"flops": tot.flops, "bytes": tot.bytes,
            "launches": counted, "launches_step": delta,
            "kernel_flops": tot.kernel_flops,
            "kernel_bytes": tot.kernel_bytes, **rl.row(),
            "model_flops": rl.model_flops, "median_step_ms": median_s * 1e3,
            "mfu": mfu, "useful_band": [lo, hi], "counted_s": count_s,
            "top_ops": tot.top(8)}


def start_dryrun(root: Path, out_dir: Path, cells=DRYRUN_CELLS,
                 paper: bool = False) -> list:
    """Launch ``python -m repro_torch.launch.dryrun`` once per entry of
    ``cells`` ((arch, shape, mesh)), and with ``paper`` once with
    ``--paper-cell --mesh both``, in the background on the host's CPU (a
    fake default group of 256 / 512 ranks cannot share this process with
    the mesh phases' real one); ``phase_dryrun`` / ``phase_dryrun_paper``
    / ``phase_dryrun_smoke`` collect them."""
    import atexit
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    procs = []

    def start(key, path, args):
        path.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
               "--json", str(path)]
        procs.append((key, path, time.perf_counter(),
                      subprocess.Popen(cmd, cwd=root, env=env,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))

    for arch, shape, mesh in cells:
        start((arch, shape, mesh), out_dir / f"{arch}_{shape}_{mesh}.jsonl",
              ["--arch", arch, "--shape", shape, "--mesh", mesh])
    if paper:
        start(("paper-cell", "", "both"), out_dir / "paper_cell.jsonl",
              ["--paper-cell", "--mesh", "both"])
    # none outlives the script, whatever ends it
    atexit.register(lambda: [p.kill() for *_, p in procs
                             if p.poll() is None])
    return procs


def _spec_param_bytes(arch: str, shape: str, multi_pod: bool) -> int:
    """Bytes of rank 0's parameter shards from the cell's specs alone:
    each dim split over its spec's mesh axes as ``torch.chunk`` splits
    it (the first chunk, ceil(n / g))."""
    from repro_torch.launch.cells import make_cell
    from repro_torch.models.params import map_schema
    sizes = {"pod": 2, "data": 16, "model": 16}
    cell = make_cell(arch, shape, multi_pod=multi_pod)
    model = cell.model()
    specs = model.param_specs(cell.rules)
    total = []

    def leaf(path, d):
        spec = specs
        for k in path.split("."):
            spec = spec[k]
        n = 1
        for dim, entry in zip(d.shape, tuple(spec) + (None,) * len(d.shape)):
            for ax in (entry if isinstance(entry, tuple) else
                       (() if entry is None else (entry,))):
                dim = -(-dim // sizes[ax])
            n *= dim
        dt = d.dtype or cell.cfg.param_dtype
        total.append(n * torch.empty((), dtype=dt).element_size())

    map_schema(leaf, model.schema())
    return sum(total)


def _collect(proc, path, timeout: float = 900):
    """(exit code, output, records) of a ``start_dryrun`` process."""
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        text, _ = proc.communicate()
    recs = ([json.loads(x) for x in path.read_text().splitlines()]
            if path.exists() else [])
    return proc.returncode, text, recs


def phase_dryrun(procs) -> dict:
    """The production dry runs started by ``start_dryrun``: each exits 0
    with status ok, rank 0's parameter bytes equal those its specs give
    (``_spec_param_bytes``), its peak within an H100's 80 GiB; prints
    each cell's collectives by op."""
    out, fails = {}, []
    for (arch, shape, mesh), path, t0, proc in procs:
        _, text, recs = _collect(proc, path)
        rec = recs[-1] if recs else {}
        want = _spec_param_bytes(arch, shape, mesh == "multi")
        mem = rec.get("memory", {})
        peak = mem.get("peak_bytes", float("inf")) / 2 ** 30
        ok = (proc.returncode == 0 and rec.get("status") == "ok"
              and mem.get("param_bytes") == want and peak <= DRYRUN_HBM_GIB)
        log(f"dryrun {arch}/{shape} on {rec.get('mesh', mesh)}: exit "
            f"{proc.returncode}, status {rec.get('status')}, traced in "
            f"{rec.get('lower_s')} s ({time.perf_counter() - t0:.1f} s since "
            f"its start); params {mem.get('param_bytes')} B a rank (specs "
            f"give {want}); peak {peak:.2f} GiB (limit {DRYRUN_HBM_GIB:g}); "
            f"{rec.get('flops_per_chip', 0) / 1e12:.2f} TFLOP, "
            f"{rec.get('hbm_bytes_per_chip', 0) / 1e9:.1f} GB, wire bytes by "
            f"op {rec.get('collective_by_op')}; bound "
            f"{rec.get('step_time', 0) * 1e3:.1f} ms "
            f"({rec.get('bottleneck')}) {'OK' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"{arch}/{shape}: {rec.get('error')}")
            log(text[-3000:])
        out[f"{arch}/{shape}/{mesh}"] = {
            k: rec.get(k) for k in
            ("status", "flops_per_chip", "hbm_bytes_per_chip",
             "wire_bytes_per_chip", "collective_by_op", "collective_count",
             "step_time", "bottleneck", "useful_frac", "mfu_bound", "memory",
             "lower_s")}
    if fails:
        raise AssertionError(f"dryrun: {fails}")
    return out




def phase_dryrun_paper(procs) -> dict:
    """``dryrun:paper-cell``: the paper's 2^20 x 500 DML fit traced on
    both production meshes and both engines.  Gates: exit 0; 4 records
    ok; each rank's argument bytes its row shard's (X, y, t fp32 and the
    fold ids int64 of 2^20 / chips rows); an all-reduce and no other
    collective (no rank reads another's rows)."""
    from repro_torch.launch.dml_cell import N_COVARIATES, N_ROWS
    (_, path, t0, proc), = procs
    rc, text, recs = _collect(proc, path)
    out, fails = {}, []
    for rec in recs:
        rows = N_ROWS // rec.get("chips", 1)
        want = rows * (N_COVARIATES * 4 + 4 + 4 + 8)
        mem = rec.get("memory", {})
        coll = rec.get("collective_by_op") or {}
        ok = (rec.get("status") == "ok" and mem.get("argument_bytes") == want
              and set(coll) == {"all-reduce"})
        log(f"dryrun {rec.get('arch')}/{rec.get('shape')} on "
            f"{rec.get('mesh')}: status {rec.get('status')}, args "
            f"{mem.get('argument_bytes')} B a rank (the row shard: {want}), "
            f"peak {mem.get('peak_bytes', 0) / 2 ** 20:.1f} MiB, "
            f"{rec.get('flops_per_chip', 0) / 1e9:.2f} GFLOP, "
            f"{rec.get('hbm_bytes_per_chip', 0) / 1e9:.3f} GB, wire by op "
            f"{coll} ({rec.get('collective_count')} collectives); bound "
            f"{rec.get('step_time', 0) * 1e3:.3f} ms "
            f"({rec.get('bottleneck')}), useful_frac "
            f"{rec.get('useful_frac', 0):.3f}, traced in {rec.get('lower_s')}"
            f" s {'OK' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"{rec.get('arch')}/{rec.get('mesh')}: "
                         f"{rec.get('error')}")
        out[f"{rec.get('arch')}/{rec.get('mesh')}"] = {
            k: rec.get(k) for k in
            ("status", "flops_per_chip", "hbm_bytes_per_chip",
             "wire_bytes_per_chip", "collective_by_op", "collective_count",
             "model_flops", "step_time", "bottleneck", "useful_frac",
             "mfu_bound", "memory", "lower_s")}
    log(f"dryrun --paper-cell: exit {rc}, {len(recs)} records "
        f"({time.perf_counter() - t0:.1f} s since its start)")
    if rc != 0 or len(recs) != 4 or fails:
        log(text[-3000:])
        raise AssertionError(f"dryrun:paper-cell: exit {rc}, {len(recs)} "
                             f"records, {fails}")
    return out


def phase_dryrun_smoke(procs) -> dict:
    """``dryrun:smoke-2.11``: DRYRUN_SMOKE_CELLS on the host's torch.
    Gates: each exits 0 with status ok."""
    out, fails = {}, []
    for (arch, shape, mesh), path, t0, proc in procs:
        rc, text, recs = _collect(proc, path)
        rec = recs[-1] if recs else {}
        ok = rc == 0 and rec.get("status") == "ok"
        log(f"dryrun {arch}/{shape} on {rec.get('mesh', mesh)} [torch "
            f"{torch.__version__}]: exit {rc}, status {rec.get('status')}, "
            f"peak {rec.get('memory', {}).get('peak_bytes', 0) / 2 ** 20:.1f}"
            f" MiB, wire by op {rec.get('collective_by_op')}, traced in "
            f"{rec.get('lower_s')} s {'OK' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"{arch}/{shape}: {rec.get('error')}")
            log(text[-3000:])
        out[f"{arch}/{shape}"] = rec.get("status")
    if fails:
        raise AssertionError(f"dryrun:smoke-2.11: {fails}")
    return out


@contextlib.contextmanager
def _host_mesh_group():
    """A default process group of this process alone (NCCL on the card)
    and its host mesh (1, 1); the group is destroyed on leaving."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


def phase_elastic_remesh(seed: int, mesh) -> dict:
    """``elastic:remesh`` (docstring item 33): a train state saved with
    no mesh, restored onto the host mesh by ``elastic_restore`` and
    trained on there, against the uninterrupted run."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ShardedFeed, batch_sharding
    from repro_torch.distributed.sharding import (default_rules,
                                                  dtensor_ops, mesh_context)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.elastic import elastic_restore, state_shardings
    from repro_torch.launch.train import (TrainState, init_state,
                                          make_train_step)
    from repro_torch.models.model import Model
    from repro_torch.models.params import flatten

    cfg = dataclasses.replace(get_config(ELASTIC_ARCH),
                              num_layers=ELASTIC_LAYERS)
    pc = ParallelConfig(fsdp=False, use_flash_attention=True)
    rules = default_rules(fsdp=False)
    n = ELASTIC_STEPS
    tcfg = TrainConfig(learning_rate=LM_TRAIN_LR, warmup_steps=1,
                       total_steps=2 * n)

    def batch(s):
        return _train_batch(cfg, seed, s, ELASTIC_BATCH, ELASTIC_SEQ)

    def steps(model, state, feed, k, losses, flash):
        step = make_train_step(model, tcfg)
        for _ in range(k):
            f0 = fa_kernel.LAUNCHES["flash_attention"]
            state.params, state.opt, met = step(state.params, state.opt,
                                                next(feed))
            losses.append(float(met["loss"]))
            flash.append(fa_kernel.LAUNCHES["flash_attention"] - f0)

    t0 = time.perf_counter()
    model = Model(cfg, pc, rules, seed=seed)
    ref, ref_flash = [], []
    feed = ShardedFeed(batch)
    steps(model, init_state(model), feed, 2 * n, ref, ref_flash)
    feed.close()
    del model
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0

    ckpt = tempfile.mkdtemp(prefix="elastic_", dir=Path(__file__).resolve()
                            .parent / "build")
    try:
        t0 = time.perf_counter()
        model = Model(cfg, pc, rules, seed=seed)
        state = init_state(model)
        got, flash = [], []
        feed = ShardedFeed(batch)
        steps(model, state, feed, n, got, flash)
        feed.close()
        mgr = CheckpointManager(ckpt)
        saved = flatten({"params": state.params, "opt": state.opt})
        mgr.save(n, {"params": state.params, "opt": state.opt})
        del state
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, meta = elastic_restore(mgr, model, rules, mesh)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    want = flatten(state_shardings(model, rules, mesh))
    leaves = flatten(restored)
    placed = collections.Counter(
        str(tuple(x.placements)) if isinstance(x, DTensor) else "plain"
        for x in leaves.values())
    wrong = [k for k, x in leaves.items() if not isinstance(x, DTensor)
             or tuple(x.placements) != tuple(want[k].placements)]
    # the state as saved, leaf by leaf (before the steps update it)
    changed = sorted(set(saved) ^ set(leaves)) + [
        k for k in saved if k in leaves and not torch.equal(
            leaves[k].full_tensor() if isinstance(leaves[k], DTensor)
            else leaves[k], saved[k])]
    del saved
    t0 = time.perf_counter()
    with mesh_context(mesh), dtensor_ops():
        state = TrainState(restored["params"], restored["opt"], n)
        feed = ShardedFeed(batch, sharding=batch_sharding(mesh),
                           start_step=n)
        steps(model, state, feed, n, got, flash)
        feed.close()
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    rel = [abs(a - b) / abs(b) for a, b in zip(got[n:], ref[n:])]
    log(f"elastic:remesh {ELASTIC_ARCH} ({ELASTIC_LAYERS} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab_size}) [{card_line()}]: "
        f"{2 * n} steps with no mesh {t_ref:.1f} s; {n} steps + save "
        f"{t_save:.1f} s, elastic_restore onto the {tuple(mesh.shape)} host "
        f"mesh [nccl] {t_restore:.1f} s (step {meta['step']}), {n} steps on "
        f"the mesh {t_mesh:.1f} s; restored leaves by placement "
        f"{dict(placed)}, {len(wrong)} not as state_shardings, "
        f"{len(leaves) - len(changed)} of {len(leaves)} bitwise the state "
        f"saved; losses "
        f"{got} vs uninterrupted {ref} (rel after the restore "
        f"{[f'{r:.2e}' for r in rel]}, tol {ELASTIC_LOSS_TOL:g}); flash "
        f"launches a step {flash} (uninterrupted {ref_flash})")
    fails = []
    if wrong:
        fails.append(f"leaves not placed as state_shardings: {wrong[:4]}")
    if changed:
        fails.append(f"restored leaves not the state saved: {changed[:4]}")
    if got[:n] != ref[:n]:
        fails.append("the steps before the save are not bitwise the "
                     "uninterrupted run's")
    if not all(r <= ELASTIC_LOSS_TOL for r in rel):
        fails.append(f"losses after the restore off by {rel}")
    if not (all(f > 0 for f in flash) and flash == ref_flash):
        fails.append(f"flash launches {flash} vs {ref_flash}")
    if fails:
        raise AssertionError("; ".join(fails))
    return {"losses": got, "uninterrupted": ref, "rel": rel,
            "flash_per_step": flash, "placements": dict(placed),
            "seconds": {"uninterrupted": t_ref, "save": t_save,
                        "restore": t_restore, "mesh_steps": t_mesh}}


def phase_cell_dml_mesh(seed: int, cfg, mesh) -> dict:
    """``cell:dml-mesh`` (docstring item 33): the DML step on inputs
    placed by ``row_sharding`` on the host mesh against the step with no
    mesh, at 2^20 x 500."""
    from repro_torch.core.crossfit import fold_ids
    from repro_torch.data.causal_dgp import paper_demo_data
    from repro_torch.distributed.sharding import (distribute, dtensor_ops,
                                                  mesh_context)
    from repro_torch.launch.dml_cell import (N_COVARIATES, N_ROWS,
                                             make_dml_step, row_sharding)

    data = paper_demo_data(n=N_ROWS, p=N_COVARIATES, seed=seed)
    folds = fold_ids(torch.Generator(device="cuda").manual_seed(seed),
                     N_ROWS, cfg.n_folds, device="cuda")
    inputs = {"X": data.X, "y": data.y, "t": data.t, "folds": folds}
    names = ("X", "y", "t", "folds")
    step = make_dml_step(cfg)
    _reset_counters()
    t0 = time.perf_counter()
    theta0, cov0 = step(*[inputs[k] for k in names])
    torch.cuda.synchronize()
    none_s = time.perf_counter() - t0
    none_counts, _ = _read_counters()
    sh = row_sharding(mesh)
    placed = [distribute(inputs[k], sh[k]) for k in names]
    _reset_counters()
    t0 = time.perf_counter()
    with mesh_context(mesh), dtensor_ops():
        theta1, cov1 = step(*placed)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    counts, fallbacks = _read_counters()
    d_theta = float((theta1 - theta0).abs().max() / theta0.abs().max())
    d_cov = float((cov1 - cov0).abs().max() / cov0.abs().max())
    bitwise = torch.equal(theta1, theta0) and torch.equal(cov1, cov0)
    se = torch.sqrt(torch.diagonal(cov1))
    log(f"cell:dml-mesh at {N_ROWS} x {N_COVARIATES} ({cfg.engine}, "
        f"row_block {cfg.row_block}, {cfg.row_block_strategy}): on the "
        f"{tuple(mesh.shape)} host mesh [nccl] {mesh_s:.3f} s, launches "
        f"{counts}; no mesh {none_s:.3f} s, launches {none_counts}; theta "
        f"{theta1.tolist()} (se {se.tolist()}); vs no mesh theta "
        f"{d_theta:.3e}, cov {d_cov:.3e} of max (tol {DML_MESH_TOL:g}), "
        f"bitwise {bitwise}; fallbacks {fallbacks}")
    fails = []
    if not (d_theta <= DML_MESH_TOL and d_cov <= DML_MESH_TOL):
        fails.append(f"theta {d_theta:.3e}, cov {d_cov:.3e} from no mesh")
    if not counts or counts != none_counts:
        fails.append(f"seg_gram launches {counts} vs {none_counts}")
    if fallbacks:
        fails.append(f"fallbacks {fallbacks}")
    if fails:
        raise AssertionError("; ".join(fails))
    return {"seconds": mesh_s, "none_seconds": none_s, "launches": counts,
            "theta_rel": d_theta, "cov_rel": d_cov, "bitwise": bitwise}


def phase_flash_train(seed: int, timer) -> dict:
    """The flash route under autograd at LM training's shapes (bf16):
    granite-3-2b's causal 8 x 1024 (32/8 heads x 64), deepseek-v3's MLA
    (q.k 192, v 128) at 2 x 1024 and whisper-tiny's bidirectional
    encoder over 8 x 1500 frames.  Gates: o with the LSE bitwise o
    without; the LSE within FA_LSE_TOL of the plain fp32 logsumexp;
    (dq, dk, dv) through ``ops.flash_attention`` within FA_BWD_TOL of
    autograd through the plain version in fp32.  Times: the kernel's
    forward with the LSE, the plain blocked backward, the plain
    forward + LSE, and SDPA's forward and forward + backward."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    records, shapes = {}, []
    for name, B, S, H, KV, D, Dv, causal in FA_TRAIN_SHAPES:
        mk = lambda *s: torch.randn(s, generator=g,  # noqa: E731
                                    device="cuda").to(torch.bfloat16)
        q, k, v, do = mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, Dv), \
            mk(B, S, H, Dv)
        o0 = fa_kernel.flash_attention_cuda(q, k, v, causal=causal)
        o, lse = fa_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                return_lse=True)
        plain_o = _fa_plain(q, k, v, causal=causal)
        plain_lse = fa_ref.attention_lse(q.transpose(1, 2),
                                         k.transpose(1, 2), causal=causal)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(o, o0))
        lse_err = float((lse - plain_lse).abs().max())
        o_err = float((o.double() - plain_o.double()).abs().max())
        del o0, plain_o, plain_lse
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fa_ops.flash_attention(*leaves, causal=causal).backward(do)
        refs = [x.float().requires_grad_() for x in (q, k, v)]
        _fa_plain(*refs, causal=causal).backward(do.float())
        torch.cuda.synchronize()
        grad_err = {n: rel(a.grad, r.grad) for n, a, r in
                    zip(("dq", "dk", "dv"), leaves, refs)}
        del leaves, refs
        torch.cuda.empty_cache()
        ok = (bitwise and lse_err <= FA_LSE_TOL
              and max(grad_err.values()) <= FA_BWD_TOL)
        log(f"flash train form [{name}] q={tuple(q.shape)} "
            f"kv={tuple(k.shape)}/{tuple(v.shape)} "
            f"{'causal' if causal else 'bidirectional'}: o with LSE "
            f"bitwise o without {bitwise}; |lse - plain| {lse_err:.3e} "
            f"(tol {FA_LSE_TOL:g}); grads vs plain fp32 autograd "
            + " ".join(f"{n} {e:.3e}" for n, e in grad_err.items())
            + f" (tol {FA_BWD_TOL:g}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash train form disagrees [{name}]")

        fwd_ms = timer.ms(lambda: fa_kernel.flash_attention_cuda(
            q, k, v, causal=causal, return_lse=True), 5)
        plain_fwd_ms = timer.ms(lambda: (
            _fa_plain(q, k, v, causal=causal),
            fa_ref.attention_lse(q.transpose(1, 2), k.transpose(1, 2),
                                 causal=causal)), 2)
        bwd_ms = timer.ms(lambda: fa_ops.flash_attention_bwd_blocks(
            q, k, v, o, lse, do, causal=causal), 2)
        G = H // KV
        qh = q.transpose(1, 2).detach().requires_grad_()
        kh = k.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
            .requires_grad_()
        vh = v.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
            .requires_grad_()
        doh = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal)

        def sdpa_fb():
            torch.autograd.grad(sdpa(), (qh, kh, vh), doh)

        try:
            with torch.no_grad():
                lib_fwd_ms = timer.ms(sdpa, 5)
            lib_fb_ms = timer.ms(sdpa_fb, 5)
        except RuntimeError as e:       # a backend refusing Ev != E
            log(f"SDPA refuses [{name}]: {e}")
            lib_fwd_ms = lib_fb_ms = None
        del qh, kh, vh, doh
        fwd_ops, fwd_bytes = fa_kernel.cost(q, k, v, causal=causal, lse=True)
        bwd_ops, bwd_bytes = fa_kernel.bwd_cost(q, k, v, causal=causal)

        def bound(nbytes, ops):
            tb = nbytes / HBM_BYTES_PER_S * 1e3
            to = ops / BF16_TC_FLOP_PER_S * 1e3
            return max(tb, to), "bytes" if tb >= to else "operations"

        fb, fby = bound(fwd_bytes, fwd_ops)
        bb, bby = bound(bwd_bytes, bwd_ops)
        lib_note = ("SDPA refused" if lib_fwd_ms is None else
                    f"SDPA fwd {lib_fwd_ms:.4f} fwd+bwd {lib_fb_ms:.4f}")
        log(f"flash train form [{name}] kernel fwd+LSE ms={fwd_ms:.4f} "
            f"(bound {fb:.4f}, {fby}) plain fwd+LSE ms={plain_fwd_ms:.4f}; "
            f"plain blocked bwd ms={bwd_ms:.4f} (bound {bb:.4f}, {bby}: "
            f"{bwd_bytes / 1e9:.4f} GB at 3.35 TB/s, {bwd_ops / 1e9:.1f} "
            f"GFLOP at 989 TFLOP/s bf16); {lib_note}")
        rec = {"what": name, "q": list(q.shape), "kv": list(k.shape),
               "v": list(v.shape), "causal": causal, "ms": fwd_ms,
               "plain_ms": plain_fwd_ms, "bound_ms": fb, "bound_by": fby,
               "library_ms": lib_fwd_ms, "max_abs_err": o_err,
               "lse_err": lse_err, "grad_err": grad_err,
               "o_with_lse_bitwise": bitwise,
               "backward": {"route": "plain", "ms": bwd_ms,
                            "bound_ms": bb, "bound_by": bby,
                            "library_ms": lib_fb_ms,
                            "library": "SDPA forward + backward"}}
        shapes.append(rec)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    main = shapes[0]
    records["flash_attention[lse]"] = {
        "name": "flash_attention[lse]", "route": "cuda", "source": FA_SRC,
        "replaces": FA_TPU, "launches": None,
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "shape": main["q"], "dtype": "bfloat16", "lse_err": main["lse_err"],
        "grad_err": main["grad_err"], "backward": main["backward"],
        "other_shapes": shapes[1:]}
    return records


# kernels:scan-train: the scans under autograd at LM training's forms,
# one microbatch of 4 x 1024: rwkv6-3b's GLA bonus (40 heads x 64, bf16
# r/k/v, fp32 w and u, chunk 16) and zamba2-1.2b's SSD (64 heads, N = P
# = 64, fp32, chunk 32).  Gates: o and the state under grad bitwise the
# no-grad launch; the backward's fp32 gradients (``*_bwd_chunks``)
# within SCAN_BWD_TOL·max of autograd through the plain chunked scan in
# fp32 on the card (the same sums in another order); the Function's
# bf16 gradients one bf16 step (2^-7 of the element) more.  The
# forward (o and the final state) is held against the plain chunked
# scan and the fp64 naive oracle at SCAN_TOL, as in ``kernels:scans``.
SCAN_BWD_TOL = 1e-4
SCAN_TRAIN_FORMS = (      # (name, scan, B, H, T, D, chunk, dtype)
    ("rwkv6-3b gla[bonus]", "gla", 4, 40, 1024, 64, 16, torch.bfloat16),
    ("zamba2-1.2b ssd", "ssd", 4, 64, 1024, 64, 32, torch.float32))


def _scan_train_inputs(scan, B, H, T, D, dtype, g):
    """The layouts the models pass: (B, T, H, D) activations viewed as
    (B, H, T, D); w / a in (exp(-MAX_LOG_DECAY), 1]; u random (the
    untrained init's u = 0 would hide the bonus term)."""
    from repro_torch.kernels.ssm_scan import ref as sref

    dev = "cuda"
    lo = float(torch.exp(torch.tensor(-sref.MAX_LOG_DECAY)))

    def bthd(d=D, decay=False):
        x = (torch.rand((B, T, H, d), generator=g, device=dev) * (1 - lo)
             + lo if decay else
             torch.randn((B, T, H, d), generator=g, device=dev))
        return x.transpose(1, 2)
    if scan == "gla":
        q, k, v = (bthd().to(dtype) for _ in range(3))
        return [q, k, v, bthd(decay=True),
                torch.randn((H, D), generator=g, device=dev)]
    q, k = (torch.randn((B, T, D), generator=g, device=dev)
            for _ in range(2))
    a = bthd(d=1, decay=True)[..., 0]
    return [q, k, bthd(), a]


def phase_scan_train(seed: int, timer) -> dict:
    """The scans under autograd (``ssm_scan.ops``'s Functions: the
    kernel's forward, the plain fp32 backward) at SCAN_TRAIN_FORMS.
    Gates: the kernel's o and final state within SCAN_TOL of the plain
    chunked scan (``_scan_check``, with the fp64 naive oracle); o and
    the final state under grad bitwise the no-grad launch, one launch
    under grad; the gradients against autograd through the plain
    chunked scan in fp32 (SCAN_BWD_TOL; bf16 one step more).  Times
    (CUDA events): the kernel's forward, the plain backward
    (``*_bwd_chunks`` from the saved inputs and do), and plain autograd
    forward + backward as a yardstick (no single PyTorch call computes
    either scan).  The backward's bound counts twice the forward's
    products (each product's two operand gradients), over the causal
    triangle as the forward's does."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref

    g = torch.Generator(device="cuda").manual_seed(seed + 29)
    records = {}
    for name, scan, B, H, T, D, C, dtype in SCAN_TRAIN_FORMS:
        xs = _scan_train_inputs(scan, B, H, T, D, dtype, g)
        if scan == "gla":
            fn = lambda *a: sops.gla(*a, chunk=C)  # noqa: E731
            kern = lambda: sk.gla_cuda(*xs, chunk=C)  # noqa: E731
            plain = lambda *a: sref.gla_chunked_ref(*a, chunk=C)  # noqa: E731
            bwd = lambda do: sops.gla_bwd_chunks(  # noqa: E731
                *xs, do, None, C)
            naive64 = sref.gla_naive
        else:
            fn = lambda *a: sops.ssd(*a, chunk=C)  # noqa: E731
            kern = lambda: sk.ssd_cuda(*xs, chunk=C)  # noqa: E731
            plain = lambda *a: sref.ssd_chunked_ref(*a, chunk=C)  # noqa: E731
            bwd = lambda do: sops.ssd_bwd_chunks(  # noqa: E731
                *xs, do, None, C)
            naive64 = sref.ssd_naive
        path = _scan_check(
            lambda *a: kern(), plain,
            lambda *a: naive64(*(x.double() for x in a)), xs,
            SCAN_TOL[dtype], f"{name} train form")
        o0, s0 = kern()
        do = torch.randn(o0.shape, generator=g, device="cuda").to(o0.dtype)
        leaves = [x.detach().requires_grad_() for x in xs]
        n0 = sk.LAUNCHES[scan]
        o, s = fn(*leaves)
        launched = sk.LAUNCHES[scan] - n0
        o.backward(do)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(o.detach(), o0) and
                       torch.equal(s.detach(), s0))
        has_fn = "Scan" in type(o.grad_fn).__name__
        del o, s
        refs = [x.detach().float().requires_grad_() for x in xs]
        plain(*refs)[0].backward(do.float())
        direct = bwd(do)
        torch.cuda.synchronize()
        errs, fn_errs = {}, {}
        ok = bitwise and has_fn and launched == 1
        for gname, leaf, d, r in zip("qkvwu" if scan == "gla" else "qkva",
                                     leaves, direct, refs):
            want = r.grad.double()
            top = float(want.abs().max())
            errs["d" + gname] = float((d.double() - want).abs().max()) / top
            slack = (2.0 ** -7 * want.abs() if leaf.dtype == torch.bfloat16
                     else 0.0)
            excess = float(((leaf.grad.double() - want).abs() - slack)
                           .max()) / top
            fn_errs["d" + gname] = excess
            ok = ok and errs["d" + gname] <= SCAN_BWD_TOL \
                and excess <= SCAN_BWD_TOL and leaf.grad.dtype == leaf.dtype
        del direct, refs, leaves
        log(f"scan train form [{name}] o {tuple(o0.shape)} "
            f"{str(o0.dtype)[6:]}: under grad one launch {launched == 1}, "
            f"o and state bitwise the no-grad launch {bitwise}, grad_fn "
            f"{has_fn}; fp32 grads vs plain fp32 autograd "
            + " ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (tol {SCAN_BWD_TOL:g}); the Function's grads"
            + (" beyond one bf16 step " if dtype == torch.bfloat16 else " ")
            + " ".join(f"{k} {e:.3e}" for k, e in fn_errs.items())
            + f" {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"scan train form disagrees [{name}]")

        fwd_ms = timer.ms(kern, 5)
        bwd_ms = timer.ms(lambda: bwd(do), 3)
        plain_fwd_ms = timer.ms(lambda: plain(*xs), 3)

        def plain_fb():
            rl = [x.detach().float().requires_grad_() for x in xs]
            torch.autograd.grad(plain(*rl)[0], rl, do.float())

        plain_fb_ms = timer.ms(plain_fb, 3)
        fwd_ops, fwd_bytes = (sk.gla_cost if scan == "gla"
                              else sk.ssd_cost)(*xs, C)
        bwd_ops, bwd_bytes = (sk.gla_bwd_cost if scan == "gla"
                              else sk.ssd_bwd_cost)(*xs, C)

        def bound(nbytes, ops):
            tb = nbytes / HBM_BYTES_PER_S * 1e3
            to = ops / FP32_FLOP_PER_S * 1e3
            return max(tb, to), "bytes" if tb >= to else "operations"

        fb, fby = bound(fwd_bytes, fwd_ops)
        bb, bby = bound(bwd_bytes, bwd_ops)
        log(f"scan train form [{name}] [{card_line()}] kernel fwd "
            f"ms={fwd_ms:.4f} (bound {fb:.4f}, {fby}) plain fwd "
            f"ms={plain_fwd_ms:.4f}; plain bwd ms={bwd_ms:.4f} (bound "
            f"{bb:.4f}, {bby}: {bwd_bytes / 1e9:.4f} GB at 3.35 TB/s, "
            f"{bwd_ops / 1e9:.2f} GFLOP at 67 TFLOP/s fp32); plain "
            f"autograd fwd+bwd ms={plain_fb_ms:.4f}")
        key = "gla[bonus]@train" if scan == "gla" else "ssd@train"
        records[key] = {
            "name": key, "route": "cuda", "source": SCAN_SRC,
            "replaces": GLA_TPU if scan == "gla" else SSD_TPU,
            "launches": None, "max_abs_err": path["max_abs_err"],
            "err_kernel_vs_fp64": path["err_kernel_vs_fp64"],
            "err_plain_vs_fp64": path["err_plain_vs_fp64"], "ms": fwd_ms,
            "plain_ms": plain_fwd_ms, "bound_ms": fb, "bound_by": fby,
            "library_ms": None, "what": name, "shape": list(o0.shape),
            "dtype": str(xs[0].dtype)[6:], "chunk": C, "grad_err": errs,
            "fn_grad_excess": fn_errs,
            "backward": {"route": "plain", "ms": bwd_ms, "bound_ms": bb,
                         "bound_by": bby, "library_ms": None,
                         "plain_autograd_fwd_bwd_ms": plain_fb_ms}}
        del xs, o0, s0, do
        torch.cuda.empty_cache()
    return records


class _attention_impl:
    """Run a model through another ``ParallelConfig`` and, if given,
    another compute dtype (the block functions hold the config; the
    weights are untouched)."""

    def __init__(self, model, parallel, compute_dtype=None):
        self.model, self.parallel = model, parallel
        self.compute_dtype = compute_dtype

    def __enter__(self):
        from repro_torch.models.transformer import DecoderStack
        m = self.model
        self.saved = (m.parallel, m.decoder_stack, m.cfg)
        m.parallel = self.parallel
        if self.compute_dtype is not None:
            m.cfg = dataclasses.replace(m.cfg,
                                        compute_dtype=self.compute_dtype)
        if m.decoder_stack is not None:
            m.decoder_stack = DecoderStack(m.cfg, self.parallel)

    def __exit__(self, *exc):
        m = self.model
        m.parallel, m.decoder_stack, m.cfg = self.saved


def _train_batch(cfg, seed: int, step: int, B: int, S: int) -> dict:
    """Batch ``step`` of the seeded token stream (and whisper's frames,
    0.1 · normal from the same generator)."""
    from repro_torch.data.lm_data import lm_batch, step_generator
    gen = step_generator(seed, step)
    b = lm_batch(gen, B, S, cfg.vocab_size)
    if cfg.is_encdec:
        b["frames"] = 0.1 * torch.randn(
            (B, cfg.max_source_positions, cfg.d_model), generator=gen)
    return b


class _count_scan_functions:
    """Count the applications of the scans' autograd Functions (each
    one launch under grad on the card), by scan: the launch gate's
    proof that no scan launched under grad outside them."""

    class _Counting:
        def __init__(self, fn, counts, key):
            self.fn, self.counts, self.key = fn, counts, key

        def apply(self, *a):
            self.counts[self.key] += 1
            return self.fn.apply(*a)

    def __enter__(self):
        from repro_torch.kernels.ssm_scan import ops as sops
        self.sops, self.counts = sops, collections.Counter()
        self.saved = (sops._GLAScan, sops._SSDScan)
        sops._GLAScan = self._Counting(sops._GLAScan, self.counts, "gla")
        sops._SSDScan = self._Counting(sops._SSDScan, self.counts, "ssd")
        return self.counts

    def __exit__(self, *exc):
        self.sops._GLAScan, self.sops._SSDScan = self.saved


def _train_launches(cfg, micro: int) -> dict:
    """Kernel launches of one train step (remat "nothing"): flash with
    its LSE twice a dense or encoder layer a microbatch (the forward and
    remat's recompute), GLA twice an rwkv6 layer, SSD twice a mamba
    layer, and zamba2's shared attention block, applied outside remat,
    once a use."""
    if cfg.family == "ssm":
        return {"gla": 2 * cfg.num_layers * micro}
    if cfg.family == "hybrid":
        uses = -(-cfg.num_layers // cfg.shared_attn_every)
        return {"ssd": 2 * cfg.num_layers * micro,
                "flash_attention[lse]": uses * micro}
    return {"flash_attention[lse]": 2 * (cfg.num_layers + cfg.encoder_layers)
            * micro}


@contextlib.contextmanager
def _fp32_plain(model, parallel):
    """Run ``model`` in fp32 compute with every kernel plain."""
    with _PlainKernels(), _attention_impl(model, parallel, torch.float32):
        yield


def _leaf_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b| of one gradient leaf (0 where both are all
    zero), in the leaves' fp32: ``rel``'s fp64 copies of the largest
    stacked leaf (rwkv6-3b's 734 M elements) would take ~24 GB beside
    the three gradient trees on the card."""
    top = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff / top if top > 0 else (0.0 if diff == 0 else float("inf"))


def phase_lm_train(seed: int, arch: str) -> dict:
    """``launch/train.py``'s step on the card at ``arch``'s full width and
    depth (LM_TRAIN_FORMS: granite-3-2b, rwkv6-3b and zamba2-1.2b batch 8
    x 1024 in 2 microbatches; whisper-tiny 8 x 128 tokens over 1500
    frames), remat "nothing", fp32 masters and moments, the batches from
    a ``ShardedFeed`` on the card: one warm step and the form's timed
    steps.  Gates: every loss and grad norm finite; the kernels launched
    as ``_train_launches`` says, flash only with its LSE, and every scan
    launch through its autograd Function; the last loss below the first
    outside LM_TRAIN_FLAT (whisper's untrained loss does not move in
    these few steps: printed); the loss and pre-clip grad norm of the
    first batch through the kernel route within LM_TRAIN_LOSS_TOL /
    LM_TRAIN_GNORM_TOL of another route from the same init (granite's
    flash against ``attention_impl="chunked"``, the scan archs' scan
    kernels against autograd through the plain chunked scans), and
    every gradient leaf of both against that plain route in fp32
    compute: the kernel route's error within LM_TRAIN_LEAF_RATIO x the
    plain route's + LM_TRAIN_LEAF_FLOOR."""
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ShardedFeed
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.launch.train import (init_state, loss_and_grads,
                                          make_train_step)
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import global_norm

    cfg = get_config(arch)
    B, S, micro, steps = LM_TRAIN_FORMS[arch]
    scans = cfg.family in ("ssm", "hybrid")
    pc = ParallelConfig(use_flash_attention=True, remat_policy="nothing",
                        microbatch=micro)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, pc, seed=seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm_train {arch}: {cfg.num_layers} layers"
        f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
        f", d {cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
        f"params (init {t_init:.1f} s); batch {B} x {S}, microbatch "
        f"{micro}, remat nothing")
    out = {"arch": arch, "params": n_params, "batch": B, "seq": S,
           "microbatch": micro, "steps": steps}

    if arch == "granite-3-2b" or scans:     # routes from one init
        batch = {k: v.cuda() for k, v in
                 _train_batch(cfg, seed, 0, B, S).items()}
        if scans:
            routes = (("fp32 plain", _fp32_plain(model, pc)),
                      ("kernel", contextlib.nullcontext()),
                      ("plain scans", _PlainKernels(flash=False)))
        else:
            chunked = dataclasses.replace(pc, use_flash_attention=False,
                                          attention_impl="chunked")
            routes = (("fp32 chunked",
                       _attention_impl(model, chunked, torch.float32)),
                      ("flash", _attention_impl(model, pc)),
                      ("chunked", _attention_impl(model, chunked)))
        probe, truth, leaf_err = {}, None, {}
        for impl, route in routes:
            t0 = time.perf_counter()
            with route:
                met, grads = loss_and_grads(model, dict(model.state_dict()),
                                            batch)
            gn = float(global_norm(grads))
            if truth is None:       # the fp32 route, kept on the card
                truth = grads
            else:
                leaf_err[impl] = {k: _leaf_rel(g, truth[k])
                                  for k, g in grads.items()}
                if len(leaf_err) == 1:
                    top = sorted(((float(g.norm()), k) for k, g in
                                  grads.items()), reverse=True)[:3]
            del grads
            torch.cuda.synchronize()
            probe[impl] = (float(met["loss"]), gn,
                           time.perf_counter() - t0)
            torch.cuda.empty_cache()
        del truth
        t32 = probe.pop(routes[0][0])
        (na, (la, ga, ta)), (nb, (lb, gb, tb)) = probe.items()
        d_loss, d_gn = abs(la - lb) / abs(lb), abs(ga - gb) / abs(gb)
        ek, ep = leaf_err[na], leaf_err[nb]
        excess = {k: ek[k] / (LM_TRAIN_LEAF_RATIO * ep[k]
                              + LM_TRAIN_LEAF_FLOOR) for k in ek}
        worst = max(excess, key=excess.get)
        ok = (d_loss <= LM_TRAIN_LOSS_TOL and d_gn <= LM_TRAIN_GNORM_TOL
              and excess[worst] <= 1)
        log(f"lm_train {arch}: first batch {na} loss {la:.5f} gnorm "
            f"{ga:.4f} ({ta:.2f} s) vs {nb} loss {lb:.5f} gnorm {gb:.4f} "
            f"({tb:.2f} s): rel {d_loss:.2e} (tol {LM_TRAIN_LOSS_TOL:g}), "
            f"{d_gn:.2e} (tol {LM_TRAIN_GNORM_TOL:g}); against "
            f"{routes[0][0]} (loss {t32[0]:.5f}, gnorm {t32[1]:.4f}, "
            f"{t32[2]:.2f} s) leaf by leaf ·max: {na} worst "
            f"{max(ek.values()):.2e}, {nb} worst {max(ep.values()):.2e}; "
            f"the leaf nearest its bound {worst}: {ek[worst]:.2e} vs "
            f"{ep[worst]:.2e} (bound {LM_TRAIN_LEAF_RATIO:g} x {nb}'s + "
            f"{LM_TRAIN_LEAF_FLOOR:g}) over {len(ek)} leaves; {na}'s "
            f"largest leaf norms "
            + ", ".join(f"{k} {n:.4g}" for n, k in top)
            + f" {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{na} and {nb} routes part")
        out[f"{na.replace(' ', '_')}_vs_{nb.replace(' ', '_')}"] = {
            "loss": [la, lb], "grad_norm": [ga, gb], "seconds": [ta, tb],
            "fp32": list(t32), "leaf_err": {na: ek, nb: ep},
            "largest_leaf_norms": {k: n for n, k in top}}
        del batch

    tcfg = TrainConfig(learning_rate=LM_TRAIN_LR, warmup_steps=1,
                       total_steps=steps + 1)
    state = init_state(model)
    step_fn = make_train_step(model, tcfg)
    feed = ShardedFeed(lambda s: _train_batch(cfg, seed, s, B, S),
                       device="cuda")
    losses, gnorms, times = [], [], []
    try:
        with _count_scan_functions() as fn_counts:
            for i in range(steps + 1):
                batch = next(feed)
                if i == 1:
                    for c in (fa_kernel.LAUNCHES, fa_kernel.LAUNCHES_BY_FORM,
                              sk.LAUNCHES, fn_counts):
                        c.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state.params, state.opt, met = step_fn(state.params,
                                                       state.opt, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(met["loss"]))
                gnorms.append(float(met["grad_norm"]))
    finally:
        feed.close()
    launches = {**{k: n for k, n in fa_kernel.LAUNCHES.items()},
                **{k: n for k, n in sk.LAUNCHES.items()}}
    per_step = {k: n / steps for k, n in sorted(launches.items())}
    forms = dict(fa_kernel.LAUNCHES_BY_FORM)
    fn_counts = dict(fn_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = 1e3 * float(np.mean(times[1:]))
    tok_s = B * S / (ms / 1e3)
    want = {k: n * steps for k, n in _train_launches(cfg, micro).items()}
    log(f"lm_train {arch} [{card_line()}]: {ms:.1f} ms a step "
        f"(warm step {1e3 * times[0]:.1f} ms), {tok_s:.0f} tokens/s, peak "
        f"{peak:.2f} GiB; losses {' '.join(f'{x:.4f}' for x in losses)}; "
        f"grad norms {' '.join(f'{x:.3f}' for x in gnorms)}; launches a "
        f"step {per_step} (flash by form {forms}; scan Functions applied "
        f"{fn_counts})")
    if arch in LM_COUNTED_LAUNCHES:
        batch = {k: v.cuda() for k, v in
                 _train_batch(cfg, seed, steps + 1, B, S).items()}
        out["counted"] = _counted_step(arch, cfg, step_fn, state, batch,
                                       float(np.median(times[1:])))
        del batch
    fails = []
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        fails.append("a loss or grad norm is not finite")
    if arch not in LM_TRAIN_FLAT and not losses[-1] < losses[0]:
        fails.append(f"the last loss {losses[-1]} is not below the first "
                     f"{losses[0]}")
    got = {k: launches.get(k, 0) for k in
           ("flash_attention[lse]", "gla", "ssd")}
    if got != {k: want.get(k, 0) for k in got}:
        fails.append(f"launches {got}, expected {want}")
    if launches.get("flash_attention", 0) != got["flash_attention[lse]"]:
        fails.append(f"flash launched without its LSE: {launches}")
    if fn_counts.get("gla", 0) != got["gla"] or \
            fn_counts.get("ssd", 0) != got["ssd"]:
        fails.append(f"scan launches {got} outside their Functions "
                     f"{fn_counts}")
    if fails:
        raise AssertionError(f"lm_train {arch}: {fails}")
    out.update({"ms_per_step": ms, "warm_step_ms": 1e3 * times[0],
                "tokens_per_s": tok_s, "peak_gib": peak, "losses": losses,
                "grad_norms": gnorms, "launches": got,
                "launches_per_step": per_step,
                "flash_launches_by_form": forms,
                "scan_functions": fn_counts})
    del state, step_fn, model
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    """Run every phase; 0 only if all passed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="rows; the cell's scale is the default")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--bootstrap-replicates", type=int, default=BOOT_B,
                    help="B of main:bootstrap (the config default is 200)")
    ap.add_argument("--out", default="", help="also write the record here")
    ap.add_argument("--phases", default="",
                    help="comma-separated phase names or prefixes to run "
                         "(e.g. lm_serve:deepseek,kernels:flash); all by "
                         "default.  A phase that takes another's output "
                         "runs only if that one is selected too")
    args = ap.parse_args(argv)
    selection = [x.strip() for x in args.phases.split(",") if x.strip()]

    def selected(name: str) -> bool:
        """Whether the selection takes phase ``name`` (all without one)."""
        return not selection or any(name == x or name.startswith(x)
                                    for x in selection)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.config import CausalConfig
        from repro_torch.core.crossfit import fold_ids
        from repro_torch.data.causal_dgp import make_iv_data, paper_demo_data
        from repro_torch.kernels.flash_attention import kernel as fa_kern
        from repro_torch.kernels.seg_gram import kernel as kern
        from repro_torch.kernels.ssm_scan import kernel as scan_kern
        from repro_torch.runtime import scheduler as rt_sched
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 3

    t_start = time.perf_counter()
    failed, ran = [], []
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    mods = (kern, fa_kern, scan_kern)
    builds = [threading.Thread(target=m.library) for m in mods]
    for b in builds:
        b.start()
    for b in builds:
        b.join()
    for m in mods:
        m.library()           # raises here if a build failed
    log(f"built seg_gram.cu, flash_attention.cu and ssm_scan.cu (in "
        f"parallel) in {time.perf_counter() - t0:.1f} s")
    for m in mods:
        log(m.build_log().strip())
    root = Path(__file__).resolve().parent
    dry_dir = root / "build" / "dryrun"
    dryruns = (start_dryrun(root, dry_dir)
               if selected("dryrun:production") else [])

    k, p, row_block = 5, 500, 65536
    data = paper_demo_data(n=args.n, p=p, seed=args.seed)
    records = {}

    def run(name, fn, *a):
        if not selected(name):
            return None
        t = time.perf_counter()
        before = dict(rt_sched.EVENT_COUNTS)
        try:
            out = fn(*a)
            # the task runtime retried or downgraded nothing, outside the
            # phase that injects a lost worker
            ev = {k: rt_sched.EVENT_COUNTS[k] - before.get(k, 0)
                  for k in ("retry", "downgrade")}
            want = ({"retry": 1, "downgrade": 1}
                    if name == "runtime:downgrade" else
                    {"retry": 0, "downgrade": 0})
            if ev != want:
                raise AssertionError(f"runtime events {ev}, expected {want}")
            log(f"phase {name}: ok ({time.perf_counter() - t:.1f} s)")
            ran.append(name)
            return out
        except Exception:                     # report, go on, fail at the end
            traceback.print_exc()
            log(f"phase {name}: FAILED")
            failed.append(name)
            return None

    def blocked(name: str, needs: str) -> None:
        """``name`` cannot run without ``needs``'s output: a failure if
        ``needs`` failed, else (not selected) a skip."""
        if not selected(name):
            return
        if needs in failed:
            failed.append(name)
        else:
            log(f"phase {name}: skipped (it needs {needs}, not selected)")

    folds = fold_ids(torch.Generator().manual_seed(args.seed), args.n, k,
                     device="cuda")
    timer = Timer()
    records = run("kernels", phase_kernels, data.X, data.y, data.t, folds,
                  k, timer) or {}
    torch.cuda.empty_cache()
    run("invariants", phase_invariants, args.seed)
    run("small-agreement", phase_small_agreement, args.seed)

    base = CausalConfig(n_folds=k, nuisance_y="ridge", nuisance_t="logistic",
                        cate_features=2, engine="parallel",
                        inference="jackknife", row_block=row_block,
                        row_block_strategy="pallas")
    iters = base.newton_iters
    paths = [
        ("main:parallel", base,
         {"design": 1, "gram_and_vec": iters, "residual": 1,
          "residual_meat": 1}),
        ("main:parallel_loo", dataclasses.replace(base, engine="parallel_loo"),
         {"design_segmented": 2, "residual": 1, "residual_meat": 1}),
        ("main:row_block=0", dataclasses.replace(base, row_block=0),
         {"residual_gram": 1}),
    ]
    launches = {}
    by_path = {}        # record key -> {path: launches}

    def count(key, path, c):
        if c:
            by_path.setdefault(key, {})[path] = c

    for name, cfg, expected in paths:
        out = run(name, phase_main, data, cfg, expected)
        torch.cuda.empty_cache()
        if out is not None:
            for key, c in out[0].items():
                launches.setdefault(key, c)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"peak device memory {peak:.2f} GiB")

    dr_fit_fw = 2 + 2 * iters        # one DR fit's fold_weighted launches
    dcfg = dataclasses.replace(base, inference="none")
    out = run("dr:fit", phase_dr_fit, data, dcfg, args.seed)
    torch.cuda.empty_cache()
    if out is not None:
        count("fold_weighted@k5", "dr:fit", out[0].get("fold_weighted", 0))
        count("design@q3", "dr:fit", out[0].get("design", 0))
        phi_d, psi_d = out[2]
        records.update(run("kernels:dr-forms", lambda: run_cases(dr_cases(
            data.X, data.y, data.t, folds, phi_d, psi_d, k), timer)) or {})
        del phi_d, psi_d, out
        torch.cuda.empty_cache()
    del folds
    run("crossfit:executors", phase_crossfit_executors, data, base)
    torch.cuda.empty_cache()
    out = run("refute:tables", phase_refute_tables, data, base)
    torch.cuda.empty_cache()
    refute_s = {}
    if out is not None:
        rl, refute_s["run_all"], refute_s["refuters"] = out
        R15 = REFUTE_REPS * k
        count(f"fold_weighted@R{R15}", "refute:tables",
              _fw_count(rl, R15, args.n))
        count("fold_weighted@q503", "refute:tables",
              _fw_count(rl, k, args.n, q=p + 3))
        records.update(run("kernels:refute-forms", lambda: run_cases(
            refute_cases(data, k, args.seed), timer)) or {})
        del rl, out
        torch.cuda.empty_cache()
    slice11_s = {}
    out = run("meta:fit", phase_meta_fit, data,
              dataclasses.replace(base, inference="none", row_block=META_RB),
              args.seed)
    torch.cuda.empty_cache()
    if out is not None:
        slice11_s["meta:fit"], ml = out
        count("fold_weighted@q1003", "meta:fit",
              _fw_count(ml, 1, args.n, q=2 * p + 3))
        count("fold_weighted@k1", "meta:fit",
              _fw_count(ml, 1, args.n, q=p + 2))
        count("fold_weighted@k1q501", "meta:fit",
              _fw_count(ml, 1, args.n, q=p + 1))
        records.update(run("kernels:meta-forms", lambda: run_cases(
            meta_cases(data), timer)) or {})
        del ml, out
        torch.cuda.empty_cache()
    out = run("tune:penalty", phase_tune_penalty, data,
              dataclasses.replace(base, inference="none"), args.seed)
    torch.cuda.empty_cache()
    if out is not None:
        slice11_s["tune:penalty"], tl = out
        R20 = len(TUNE_LAMS) * k
        for form in ("design", "gram_and_vec"):
            count(f"{form}@R{R20}", "tune:penalty",
                  sum(c for (f, b, *_r), c in tl.items()
                      if f == form and b == R20))
        gfolds, gW = tune_grid_weights(args.n, k)
        records.update(run("kernels:tune-forms", lambda: run_cases(
            tune_cases(data.X, data.y, data.t, gfolds, k, gW), timer,
            f"@R{R20}")) or {})
        del tl, out, gfolds, gW
        torch.cuda.empty_cache()
    del data
    torch.cuda.empty_cache()

    mesh_ranks = run("mesh:ranks", phase_mesh_ranks, args, base)
    for name, fn, a in (
            ("mesh:reduce", phase_mesh_reduce, (args.n * p * 4,)),
            ("mesh:dml", phase_mesh_dml, ()),
            ("mesh:ladder", phase_mesh_ladder, ()),
            ("mesh:shard_map", phase_mesh_shard_map, ()),
            ("mesh:sweep", phase_mesh_sweep, ()),
            ("mesh:shard_map-sweep", phase_mesh_shard_map_sweep, ()),
            ("mesh:resume", phase_mesh_resume, ()),
            ("mesh:jobs", phase_mesh_jobs, ()),
            ("mesh:store", phase_mesh_store, ()),
            ("cell:dml", phase_cell, ("dml",)),
            ("cell:iv", phase_cell, ("iv",))):
        if mesh_ranks is None:
            blocked(name, "mesh:ranks")
            continue
        for key, c in (run(name, fn, mesh_ranks, *a) or {}).items():
            count(key, name, c)
    del mesh_ranks
    # the slice-20 dry runs start here, after the CPU-bound mesh ranks
    dry_paper = (start_dryrun(root, dry_dir, cells=(), paper=True)
                 if selected("dryrun:paper-cell") else [])
    dry_smoke = (start_dryrun(root, dry_dir, cells=tuple(
        (a, s, "single") for a, s in DRYRUN_SMOKE_CELLS))
        if selected("dryrun:smoke-2.11") else [])
    out = run("cell:sweep", phase_cell_sweep, args.seed)
    torch.cuda.empty_cache()
    cell_pairs = {}
    if out is not None:
        _, cells_counts, cell_pairs = out
        for key, c in cells_counts.items():
            count(key, "cell:sweep", c)
        del out

    bdata = paper_demo_data(n=BOOT_N, p=p, seed=args.seed)
    forms = run("kernels:inference-forms", lambda: run_cases(
        inference_cases(bdata.X, bdata.y, bdata.t, args.seed, BOOT_CHUNK, k),
        timer)) or {}
    records.update(forms)
    torch.cuda.empty_cache()
    bcfg = dataclasses.replace(base, inference="bootstrap",
                               n_bootstrap=args.bootstrap_replicates,
                               inference_executor="vmap",
                               runtime_chunk=BOOT_CHUNK)
    out = run("main:bootstrap", phase_bootstrap, bdata, bcfg, timer,
              {key: r["ms"] for key, r in forms.items()})
    if out is not None:
        c = out[0]
        count("fold_weighted", "main:bootstrap", c.get("fold_weighted", 0))
        count("residual_direct", "main:bootstrap", c.get("residual_direct", 0))
        # the point fit's meat is the unbatched form; the rest are chunks
        count(f"residual_meat@R{BOOT_CHUNK}", "main:bootstrap",
              c.get("residual_meat", 0) - 1)
    out = run("dr:bootstrap", phase_dr_bootstrap, bdata,
              dataclasses.replace(bcfg, n_bootstrap=DR_BOOT_B),
              {key: r["ms"] for key, r in forms.items()})
    if out is not None:
        c, _, chunks = out
        count("fold_weighted@k5", "dr:bootstrap", dr_fit_fw)
        count("design@q3", "dr:bootstrap", c.get("design", 0))
        count("fold_weighted", "dr:bootstrap",
              c.get("fold_weighted", 0) - dr_fit_fw)
        count("residual_direct", "dr:bootstrap", c.get("residual_direct", 0))
        count(f"residual_meat@R{BOOT_CHUNK}", "dr:bootstrap",
              c.get("residual_meat", 0))
    out = run("runtime:budget", phase_runtime_budget, bdata, bcfg)
    rt_trace = None
    if out is not None:
        c_, kw_, rt_chunk, healthy, rt_trace = out
        run("runtime:downgrade", phase_runtime_downgrade, c_, kw_, rt_chunk,
            healthy)
        del c_, kw_, healthy, out
    else:
        blocked("runtime:downgrade", "runtime:budget")
    mbcfg = dataclasses.replace(base, inference="bootstrap",
                                n_bootstrap=META_BOOT_B,
                                runtime_chunk=META_CHUNK, row_block=META_RB)
    out = run("meta:bootstrap", phase_meta_bootstrap, bdata, mbcfg)
    torch.cuda.empty_cache()
    if out is not None:
        slice11_s["meta:bootstrap"], ml = out
        for q, tag in ((p + 2, ""), (p + 1, "q501"), (2 * p + 3, "q1003")):
            count(f"fold_weighted@R{META_CHUNK}{tag}", "meta:bootstrap",
                  _fw_count(ml, META_CHUNK, BOOT_N, q=q))
        records.update(run("kernels:meta-boot-forms", lambda: run_cases(
            meta_boot_cases(bdata, args.seed), timer)) or {})
        del ml, out
        torch.cuda.empty_cache()
    slice11_s["tune:halving"] = run("tune:halving", phase_tune_halving,
                                    bdata, args.seed)
    torch.cuda.empty_cache()
    slice11_s["mlp:dml"] = run("mlp:dml", phase_mlp_dml, bdata,
                               dataclasses.replace(base, inference="none",
                                                   nuisance_y="mlp",
                                                   nuisance_t="mlp"),
                               args.seed)
    del bdata
    torch.cuda.empty_cache()
    run("main:bootstrap-agreement", phase_bootstrap_agreement, args.seed)
    torch.cuda.empty_cache()

    ivdata = make_iv_data(n=args.n, p=p, seed=args.seed)
    icfg = dataclasses.replace(base, inference="jackknife")
    out = run("iv:orthoiv", phase_orthoiv, ivdata, icfg,
              {"design": 1, "gram_and_vec": 2 * iters, "iv": 1, "iv_meat": 1,
               "iv_segmented": 1})
    if out is not None:
        for key in ("iv", "iv_meat", "iv_segmented"):
            count(key, "iv:orthoiv", out[0].get(key, 0))
        ry, rt, rz, phi, ifolds, itheta = out[2]
        records.update(run("kernels:iv-forms", lambda: run_cases(
            iv_cases(ry, rt, rz, phi, ifolds, itheta, k), timer)) or {})
        # DRIV on the same data: its y / t / z cross-fit draws the same
        # folds (seed 0) as OrthoIV's, so these are its residuals too
        dout = run("driv:fit", phase_driv_fit, ivdata,
                   dataclasses.replace(base, inference="none"),
                   float(itheta[0]), args.seed)
        if dout is not None:
            c = dout[0]
            count("design", "driv:fit", c.get("design", 0) - 1)
            count("design@q3", "driv:fit", 1)
            count("gram_and_vec", "driv:fit", c.get("gram_and_vec", 0))
            count("iv@p1", "driv:fit", c.get("iv", 0))
            count("iv_meat@p1", "driv:fit", c.get("iv_meat", 0))
            ones = torch.ones_like(ry)[:, None]
            th = torch.tensor([dout[2].theta_pre], device="cuda")
            records.update(run("kernels:driv-forms", lambda: run_cases(
                [c_ for c_ in iv_cases(ry, rt, rz, ones, ifolds, th, k)
                 if c_.name in ("iv", "iv_meat")], timer, "@p1")) or {})
            del ones, th, dout
        del ry, rt, rz, phi, ifolds, itheta, out
        torch.cuda.empty_cache()
    refute_s["iv"] = run("refute:iv", phase_refute_iv, ivdata, base)
    torch.cuda.empty_cache()
    del ivdata
    torch.cuda.empty_cache()
    ivb = make_iv_data(n=BOOT_N, p=p, seed=args.seed)
    ibcfg = dataclasses.replace(base, inference="bootstrap",
                                n_bootstrap=IV_BOOT_B,
                                runtime_chunk=BOOT_CHUNK)
    ichunks = -(-IV_BOOT_B // BOOT_CHUNK)
    out = run("iv:bootstrap", phase_orthoiv, ivb, ibcfg,
              {"design": 1, "gram_and_vec": 2 * iters, "iv": 1 + ichunks,
               "iv_meat": 1 + ichunks,
               "fold_weighted": ichunks * (1 + 4 * iters)})
    if out is not None:
        for key in ("iv", "iv_meat", "fold_weighted"):
            count(key, "iv:bootstrap", out[0].get(key, 0))
        del out
    torch.cuda.empty_cache()
    dbcfg = dataclasses.replace(ibcfg, n_bootstrap=DRIV_BOOT_B)
    out = run("driv:bootstrap", phase_driv_bootstrap, ivb, dbcfg)
    if out is not None:
        c, _, chunks = out
        count("design", "driv:bootstrap", c.get("design", 0) - 1)
        count("design@q3", "driv:bootstrap", 1)
        count("gram_and_vec", "driv:bootstrap", c.get("gram_and_vec", 0))
        count("iv@p1", "driv:bootstrap", c.get("iv", 0))
        count("iv_meat@p1", "driv:bootstrap", c.get("iv_meat", 0))
        count("fold_weighted", "driv:bootstrap", chunks * (1 + 4 * iters))
        count("fold_weighted@k5", "driv:bootstrap", DRIV_BOOT_B)
        count("residual_direct", "driv:bootstrap",
              c.get("residual_direct", 0))
        count(f"residual_meat@R{BOOT_CHUNK}", "driv:bootstrap",
              c.get("residual_meat", 0))
        del out
    del ivb
    torch.cuda.empty_cache()
    quick_s = run("quickstart", phase_quickstart)
    torch.cuda.empty_cache()
    examples = {}
    for name in ("iv", "store", "sweep"):
        out = run(f"examples:{name}", phase_example, name)
        torch.cuda.empty_cache()
        if out is not None:
            examples[name] = {"seconds": out[0], "launches": out[1],
                              "max_rel_err_fp64": out[2]}

    records.update(run("kernels:pair-forms", lambda: run_cases(
        pair_cases(args.seed, timer), timer)) or {})
    torch.cuda.empty_cache()
    run("invariants:pair", phase_pair_invariants, args.seed)
    torch.cuda.empty_cache()
    pair_shapes, kept = {}, {}
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="store_ckpt_", dir=build_dir)
    serving = None
    try:
        for name, fn in (("sweep:segmented", lambda: phase_sweep(args.seed,
                                                                timer)),
                         ("store:ingest", lambda: phase_store(args.seed,
                                                              ckpt_dir))):
            out = run(name, fn)
            torch.cuda.empty_cache()
            if out is not None:
                pair_shapes[name], kept[name] = out[0], out[2]
        if "store:ingest" in kept:
            serving = run("serve:effects", phase_serve, args.seed, ckpt_dir,
                          kept["store:ingest"])
        else:
            blocked("serve:effects", "store:ingest")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if len(kept) == 2:
        run("trace", phase_trace, args.seed, kept["sweep:segmented"],
            kept["store:ingest"])
    else:
        blocked("trace", "sweep:segmented" if "store:ingest" in ran
                else "store:ingest")
    del kept
    torch.cuda.empty_cache()
    if rt_trace is not None:
        run("trace:runtime", phase_runtime_trace, rt_trace)
    else:
        blocked("trace:runtime", "runtime:budget")
    del rt_trace
    out = run("sweep:cells", phase_sweep_cells, args.seed)
    torch.cuda.empty_cache()
    cells_s = cells_budget = None
    if out is not None:
        fw, cells_s, cells_budget = out
        count("fold_weighted@cells", "sweep:cells", fw["launches"])
        records.update(run("kernels:cells-forms", lambda: run_cases(
            cells_cases(args.seed, fw["chunk"]), timer)) or {})
        torch.cuda.empty_cache()
    run("jobs", phase_jobs, args.seed)
    torch.cuda.empty_cache()
    pair_shapes["cell:sweep"] = cell_pairs
    for key, (form, S, qls) in PAIR_FORMS.items():
        for path, shapes in pair_shapes.items():
            count(key, path, sum(c for (f, s, ql, _), c in shapes.items()
                                 if f == form and s == S and ql in qls))

    records.update(run("kernels:flash", phase_flash, args.seed, timer) or {})
    torch.cuda.empty_cache()
    records.update(run("kernels:scan", phase_scans, args.seed, timer) or {})
    torch.cuda.empty_cache()
    flash_by_path = {}
    scan_forms = {}     # scan record key -> {form: launches}
    scan_by_path = {}   # scan record key -> {path: launches}
    lm_serve = {}       # arch -> the serving phase's metrics
    for arch in BACKBONE_ARCHS:
        out = run(f"backbone:{arch}", phase_backbone, args.seed, arch)
        torch.cuda.empty_cache()
        if out is None:
            blocked(f"lm_serve:{arch}", f"backbone:{arch}")
            continue
        counts, X, y, t, model = out
        sout = run(f"lm_serve:{arch}", phase_lm_serve, args.seed, model)
        del model, out
        torch.cuda.empty_cache()
        if sout is not None:
            served, lm_serve[arch] = sout
            path = f"lm_serve:{arch}"
            if served.get("flash_attention"):
                flash_by_path[path] = served["flash_attention"]
            for key, scan in (("gla[bonus]", "gla"), ("ssd", "ssd")):
                if served.get(scan):
                    scan_by_path.setdefault(key, {})[path] = served[scan]
                    scan_forms.setdefault(key, collections.Counter()).update(
                        {f: n for f, n in served.items()
                         if f.startswith(scan + ":")})
        for key, scan in (("gla[bonus]", "gla"), ("ssd", "ssd")):
            if counts.get(scan):
                scan_by_path.setdefault(key, {})[f"backbone:{arch}"] = \
                    counts[scan]
        flash_by_path[arch] = counts.get("flash_attention", 0)
        if arch == "granite-3-2b":
            launches["flash_attention"] = flash_by_path[arch]
        launches["gla[bonus]"] = launches.get("gla[bonus]", 0) + counts.get(
            "gla", 0)
        launches["ssd"] = launches.get("ssd", 0) + counts.get("ssd", 0)
        for key, scan in (("gla[bonus]", "gla:"), ("ssd", "ssd:")):
            scan_forms.setdefault(key, collections.Counter()).update(
                {f: n for f, n in counts.items() if f.startswith(scan)})
        q = f"@q{X.shape[1] + 1}"
        if arch != "zamba2-1.2b":        # q = 2049 again: granite's heads
            for key in ("design", "gram_and_vec"):
                launches[key + q] = counts.get(key, 0)
            bfolds = fold_ids(torch.Generator().manual_seed(args.seed),
                              X.shape[0], k, device="cuda")
            records.update(run(f"kernels:backbone-heads{q}", phase_kernels,
                               X, y, t, bfolds, k, timer,
                               ("design", "gram_and_vec"), q) or {})
        del X, y, t
        torch.cuda.empty_cache()

    for arch in LM_FAMILY_ARCHS + LM_ENCODER_ARCHS:
        sout = run(f"lm_serve:{arch}", phase_lm_family, args.seed, arch)
        torch.cuda.empty_cache()
        if sout is not None:
            served, lm_serve[arch] = sout
            path = f"lm_serve:{arch}"
            forms = lm_serve[arch]["flash_launches_by_form"]
            flash_by_path[path] = forms.get("causal", 0)
            if arch == "deepseek-v3-671b":     # the (192, 128) launches
                by_path["flash_attention[mla]"] = {
                    path: served.get("flash_attention", 0)}
            if forms.get("bidirectional"):     # whisper's encoder
                by_path["flash_attention[bidir]"] = {
                    path: forms["bidirectional"]}

    records.update(run("kernels:flash-train", phase_flash_train, args.seed,
                       timer) or {})
    torch.cuda.empty_cache()
    records.update(run("kernels:scan-train", phase_scan_train, args.seed,
                       timer) or {})
    torch.cuda.empty_cache()
    lm_train = {}       # arch -> the training phase's metrics
    for arch in LM_TRAIN_ARCHS:
        out = run(f"lm_train:{arch}", phase_lm_train, args.seed, arch)
        torch.cuda.empty_cache()
        if out is not None:
            lm_train[arch] = out
            for key, kern in (("flash_attention[lse]", "flash_attention[lse]"),
                              ("gla[bonus]@train", "gla"),
                              ("ssd@train", "ssd")):
                if out["launches"][kern]:
                    by_path.setdefault(key, {})[f"lm_train:{arch}"] = \
                        out["launches"][kern]

    mesh_phases = {}
    if selected("elastic:remesh") or selected("cell:dml-mesh"):
        with _host_mesh_group() as host_mesh:
            mesh_phases["elastic:remesh"] = run(
                "elastic:remesh", phase_elastic_remesh, args.seed, host_mesh)
            torch.cuda.empty_cache()
            out = run("cell:dml-mesh", phase_cell_dml_mesh, args.seed,
                      dataclasses.replace(base, inference="none"), host_mesh)
            torch.cuda.empty_cache()
            if out is not None:
                mesh_phases["cell:dml-mesh"] = out
                for key, c in out["launches"].items():
                    count(key, "cell:dml-mesh", c)

    dryrun = run("dryrun:production", phase_dryrun, dryruns) or {}
    if dry_paper:
        dryrun["paper-cell"] = run("dryrun:paper-cell", phase_dryrun_paper,
                                   dry_paper)
    if dry_smoke:
        dryrun["smoke-2.11"] = run("dryrun:smoke-2.11", phase_dryrun_smoke,
                                   dry_smoke)

    for key, rec in records.items():
        rec["launches"] = launches.get(key, 0)
        if key in by_path:
            paths = by_path[key]
            if launches.get(key):       # the main paths' own launches
                paths = {"main": launches[key], **paths}
            rec["launches"] = sum(paths.values())
            rec["launches_by_path"] = paths
    if "flash_attention" in records:
        records["flash_attention"]["launches_by_path"] = flash_by_path
    for key, forms in scan_forms.items():
        if key in records:
            records[key]["launches_by_form"] = dict(forms)
            records[key]["launches_by_path"] = scan_by_path.get(key, {})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    line = {"kernels": list(records.values()), "n": args.n, "p": p,
            "k": k, "row_block": row_block, "users": BACKBONE_USERS,
            "backbones": list(BACKBONE_ARCHS), "bootstrap_n": BOOT_N,
            "bootstrap_replicates": args.bootstrap_replicates,
            "bootstrap_chunk": BOOT_CHUNK, "sweep_n": SWEEP_N,
            "sweep_segments": SWEEP_E, "store_day_rows": STORE_DAY,
            "store_days": STORE_DAYS, "dr_bootstrap_replicates": DR_BOOT_B,
            "driv_bootstrap_replicates": DRIV_BOOT_B,
            "serve_requests": SERVE_REQUESTS,
            "serve_wave_sizes": list(SERVE_WAVES), "serving": serving,
            "runtime_bootstrap_replicates": RT_BOOT_B,
            "refute_reps": REFUTE_REPS, "refute_seconds": refute_s,
            "quickstart_seconds": quick_s, "examples": examples,
            "cells_n": CELLS_N,
            "cells_segments": CELLS_E,
            "cells_at": CELLS_AT, "cells_budget": cells_budget,
            "cells_seconds": cells_s, "meta_bootstrap_replicates":
            META_BOOT_B, "meta_chunk": META_CHUNK,
            "halving_lrs": list(HALVING_LRS), "slice11_seconds": slice11_s,
            "lm_serve": lm_serve, "lm_families": list(LM_FAMILY_ARCHS
                                                      + LM_ENCODER_ARCHS),
            "lm_train": lm_train, "dryrun": dryrun,
            "mesh_phases": mesh_phases,
            "phases": ran, "selection": selection or None,
            "seconds": time.perf_counter() - t_start}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {**line, "card": card, "failed": failed}, indent=1))
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
