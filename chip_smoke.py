#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: require CUDA; print the card's name and power limit. Float32
   matrix products and convolutions run in full float32 (TF32 off), as the
   reference trains and serves.
2. build: compile the CUDA kernels (``mpe_lookup``, ``mpe_qat``,
   ``flash_attention``, ``embedding_bag``, ``segment_sum``, ``adam``,
   ``tiered_cold``, ``kv_cache_write``, ``decode_attention``) from
   the sources in this checkout, one nvcc each, started together; print
   the ptxas reports.
3. kernel vs plain: hold the ``mpe_lookup`` kernel against its plain PyTorch
   version on the card over b ∈ 1..8 × d ∈ {8, 16, 50, 64, 2048} (rtol 1e-6), and
   the ``mpe_qat`` forward and backward against theirs over rows {1, 255,
   257, 4099} × d {8, 16, 32, 33, 50, 64} × widths (0..6) and (0, b), b ∈ 1..8 ×
   softmax and one-hot probabilities, and one width alone (b), b ∈ 1..8,
   at probability 1 (LSQ's and ALPT's lookups): ``out`` and ``drows`` bit-identical,
   ``dprobs``, ``dα``, ``dβ`` at rtol 1e-4 / atol 1e-6 (summed in float64
   in another order); the backward run twice gives the same bits. The three flash
   attention kernels against theirs over BH {1, 3, 37} × S {8, 21, 32, 50,
   64, 65, 128, 256} × hd {4, 16, 50, 64, 128} × causal and not, and on the
   models' (B, S, H, hd) layout at H = 8 over B {1, 3} × S {8, 21, 50, 64,
   65, 128} × hd {4, 16, 50} and at H = 16 (the LM's heads) over B 2 × S
   {65, 100, 127, 384, 1,024} × hd {64, 128}: both routes (S <= 64 staged,
   S > 64 tiled, partial key tiles at S 100 and 127),
   o and lse within rtol = atol = 3e-5, dq, dk, dv within 2e-4 (the
   reference's contracts), the backward run twice bit-identical. The embedding bag's forward kernel
   and backward against theirs over B {1, 4, 16, 1024} × L {1, 3, 7, 20,
   50} × d {4, 8, 16, 32, 50, 64, 128} × int32 and int64 ids × bool and
   float masks, every fourth bag all masked: rtol 1e-5 / atol 1e-6 (the
   reference's contract), both run twice bit-identical. The tiered cache's
   cold fill against its plain version over b ∈ 1..8 × d ∈ {8, 16, 50,
   64} × cold counts {0, 1, 255, 4,096} (a buffer with a junk tail):
   bit-identical, and the rows equal to the monolithic lookup's; then
   several live widths a buffer (DLRM's {0..6} and 16 buckets) × d {16,
   50, 64}, with empty buckets between full ones, totals that end in the
   middle of a tile and one entry alone, bit-identical; bad buffers (a
   negative count, entries of the zero width, more entries than the
   output, more words than the buffer) write nothing; a (0..6)-width table
   behind a store, its lookups equal to the monolithic table's.
4. serve path: the full-width ``dlrm-criteo`` config (dnn, 39 fields,
   34,223,104 features, d=16, MLP 1024-512-256, widths {0..6}) initialised
   from a seed on the card, sampled and exported to the packed table there,
   served by ``build_engine`` with the 512-row ``serve_p99`` and
   262,144-row ``serve_bulk`` cells, each captured once as a CUDA graph
   (with its Figure-5 lookup companion). The kernel is held against its
   plain version on the full-width table at both cell shapes; then, with
   the launch counts set to 0, requests of 1, 300 and 512 rows and one bulk
   request of 300,000 rows are scored, each of which must launch the
   kernel: a replay runs the kernels captured in its graph without calling
   their wrappers, so a cell's launches are its replays times the lookups
   captured in it. The scores must equal the same model run with the plain
   lookup (rtol 1e-4, atol 1e-4).
5. kernels: time the lookup and its plain version at both cell shapes with
   CUDA events, beside the least time the card needs to move the bytes that
   this run's ids need: warm (back-to-back calls on the same ids) and cold
   (each launch timed alone after a write of 256 MB, more than the L2).
6. trace: a separate run under ``torch.profiler`` gives the kernel's device
   time per launch, and for a 300-row and the bulk request the device's
   busy time against the wall time, with the costliest device kernels and
   the bulk request's ``mpe_lookup_kernel`` ms beside the first lookup
   kernel's; each request's graph replays must show ``mpe_lookup_kernel``.
   Then the request lifecycle on phase 4's table and cells: a twin engine
   on the warm cache registers with zero compiles; 64 requests of 1–512
   rows submitted together are coalesced, each within 1e-4 of its lone
   score and of the plain lookup's; an open loop of 300-row requests at
   0.1×–2× the rate one 512-row request sustains (p50/p99, queue /
   assembly / compute, goodput, sheds, occupancy); a run with a deadline
   that sheds; one ``EngineServer`` round trip on localhost; each cell's
   eager step against its replay, paired; ``launch.serve
   --repack-headroom 0.5 --repack-budget 0.8`` at full width, whose swap
   lands mid-stream with zero compiles: the live table must be the plan's
   (rebuilt from the master) leaf for leaf, score equal to the plain
   lookup on it and otherwise than on the table before the swap. The
   path's ``mpe_lookup`` launches (replays × captured lookups) are counted
   part by part, the counts at 0 just before each part (coalesced, open
   loops, server, repack), each held to twice its dispatches (a cell and
   its lookup companion); comparisons and timings fall outside the parts.
   Memory: the graphs' pool read from the allocator's segments, and the
   serving peak as reserved bytes (a replay allocates nothing; the pool
   is reserved, not allocated).
6b. the tiered cache on phase 4's table and prior: ``TieredTableStore``s
   at hot fractions 0, 0.1 and 1.0 (build time, device and host bytes per
   tier, the prior's predicted hit rate), ``tiered_p99`` cells for each
   and ``tiered_bulk`` for 0 and 0.1, each captured as a CUDA graph that
   holds one ``mpe_lookup`` and one ``tiered_cold`` launch. On every cell
   at its capacity the embeddings (the hot lookup, then the cold fill
   over its zeros) equal the plain lookup of the monolithic table bit for
   bit, the cold fill its plain version, the replay its eager step, and
   the scores the monolithic cell's within 1e-4. With the counts at 0,
   requests of 1, 300 and 512 rows (five each) and one of 300,000
   through ``score_tiered``, overlap on and off (bit-identical), each
   dispatch launching both kernels once; p50 and its assembly / compute
   split beside the monolithic cell's p50 on the same ids; the hit and
   miss counts and ``bytes_moved`` equal to a numpy recount of the tier
   bits. At the bulk chunk: the H2D copy, host routing and the kernel
   timed beside its byte bound and its plain version; the 512-row cell's
   fill on its own buffer timed eager and in a CUDA-graph replay. Then
   ``launch.serve
   --hot-frac 0.1 --cache-policy decay --writeback 4 --shift-at 4`` at
   full width (no capture mid-stream, promotions > 0, each plan and
   observation timed); a ``PressureAdapter`` swap through ``refresh`` on
   its engine (no capture, no hot-tier tensor moved, the tiered scores and
   the store's lookups those of the swapped table); the drift sweep of
   ``benchmarks/baselines/BENCH_prefetch.json``'s config (decay >= static
   + 0.25 and > 0.5, beside the reference's 0.5585 and 0.0302).
7. train path: ``repro_torch.launch.train --prefetch`` at full width and the
   ``train_batch`` cell's 65,536 rows — 8 search steps, Eq. 11 sampling,
   8 retrain steps, the packed export, eval on ``eval_set(4)`` — with the
   launch counts set to 0; then the exported table is served by
   ``build_engine`` for a few requests. Every step must launch the
   ``mpe_qat`` forward and backward, the segment sum once a gather (two a
   search step, one a retrain step) and the Adam pass once a parameter
   leaf, every loss be finite and no step be skipped, every request launch
   ``mpe_lookup``, and the served scores equal the plain lookup's (rtol
   1e-4, atol 1e-4). Peak memory as a multiple of the table, beside PR
   15's.
8. one step's own inputs: a search step's gathered rows and probabilities
   (and a retrain step's one-hot ones) at the full shape, the kernels
   against the plain version and against autograd through the
   ``lsq_quantize`` composition (``out`` at rtol 1e-5 / atol 1e-7, ``drows``
   likewise against autograd's own order, reductions at rtol 1e-4 /
   atol 1e-6), and the backward twice.
8b. mesh: the distribution layer (``repro_torch.dist``) on one card. (a)
   ``init_distributed`` from the environment the smoke sets for itself
   (an NCCL group of one rank on a free local port), a ``--mesh 1,1``
   engine with sharded-lookup cells over phase 7's trained table: a few
   ``serve_p99`` and ``serve_bulk`` requests bit-identical to the engine
   without a mesh; two ``Trainer(mesh=...)`` steps at full width whose
   losses equal those without a mesh; the group destroyed. (b) The local
   bodies of the 1×4 and 2×2 row splits at full width, every shard in
   turn, merged by what the all_reduce, all_to_alls and all_gather
   compute: the sharded lookups themselves on a ``dist.shard.LocalMesh``
   (every line of the wrappers but the collectives), the lookup (psum;
   a2a at capacities none, a tight one that spills, and 1) over a 512-row
   and a 262,144-row request and the tiered hot lookup bit-identical to
   the single-device kernels; ``mpe_qat`` on row blocks and flash on
   (batch, head) blocks bit-identical; the bag's partials (rows N(0, 1))
   within the float32 summation bound of each bag, 2·γ_20·Σ|row| — a
   reassociated sum passes, a sum missing one shard's partials does not. (c)
   One rank's 262,144-row psum body beside the single-device lookup
   (one rank's work, no collective), printed on the line before the
   card's. The counts are set to 0 before (a) and read after (b): the
   ``mesh`` path of ``launches_by_path``.
9. ``mpe_qat`` times at ``train_batch`` with CUDA events, beside their plain
   versions and the byte bound; one traced search step (its batch made on
   the host included) for the device's idle share and costliest kernels,
   and its ``mpe_qat``, segment-sum, sort, Adam and library
   dense-embedding-backward ms; then search steps through a pre-built
   ``PrefetchPipeline(ds.batch, depth=k)`` (k: the host's cores less one,
   ``os.cpu_count()`` printed), timed by one measure with synchronous and
   depth-1 steps (8 steps each after the read-ahead fills, in the order
   sync, 1, k, 1, sync): their wall ms, the ms each waited for its batch,
   the ms making a batch took and, traced at depth k, the device's busy
   ms, beside the synchronous step.
   Then one more search step and one retrain
   step, each with its kernels' arguments recorded and checked as in 11
   (``mpe_qat``, the segment sum of the rows over the whole table and of
   the group probabilities, the Adam pass), and the in-place and NaN-step
   checks on each trainer.
10. SASRec serving: the full-width ``sasrec`` config (8,388,608 items,
   d=50, 2 causal blocks, 1 head, S=50) with a random packed table made on
   the card (``Packed.init`` semantics over a Zipf(1.1) frequency prior);
   with the launch counts at 0, ``score_candidates`` at ``serve_p99`` (512
   sequences, 1,000 candidates) and ``retrieval_cand`` (1 sequence,
   1,048,576 candidates), top 100, and an encode at ``serve_bulk`` (262,144
   sequences, also traced, its flash time above 0). Each encode must launch
   the plain flash forward
   twice and the forward with stats never; the scores must equal the same
   model with the plain attention (rtol = atol = 1e-4), and the top-k
   indices too wherever neighbouring scores differ by more than that. The
   lookup alone at the bulk encode's ids (262,144 x 50) and at the
   retrieval candidates (1,048,576), warm and cold, beside its bound. At
   every cell of both tables the path's own lookups (recorded) equal the
   plain version bit for bit.
11. SASRec training: the same config under ``mpe_search``, 8 steps of the
   ``Trainer`` with ``adam(1e-3)`` and λ = 1e-5 at ``train_batch`` (65,536
   sequences), on batches made once before the steps. Each step must launch
   the flash forward with stats and the flash backward twice each and the
   ``mpe_qat`` forward and backward three times each, the segment sum six
   times and the Adam pass once a leaf; every loss finite, no step
   skipped; peak memory as a multiple of the table beside the two-tree
   trainer's. One
   more step with the ``mpe_qat`` backward, segment-sum and Adam wrappers
   recording their arguments: on those, the ``mpe_qat`` kernels against
   their plain versions (as in 8) and timed beside them and the bound; the
   segment sum against its plain version (``F.embedding``'s dense backward
   in float64; elementwise within 2^-22·|want| + c·2^-52·Σ|rows| for a
   segment of c rows: two float64 sums in any order, each rounded once)
   on the rows the ids touch, every other row 0, twice bit-identical,
   timed beside it, the library's float32 dense backward it replaces and
   the bound, and taken apart (the sort and the zeroed gradient timed
   alone, the chunk and combine kernels traced, the scratch bytes); what
   the step's Adam pass left, and one more launch with the flag negated (a
   skipped pass: bit-unchanged), against the plain chain on host copies of
   the state from before the step, bit for bit, by slices of rows; timed
   on the table beside it and ``torch._fused_adamw_``. Every leaf is
   still where it was (updated in place), and a step with a NaN loss leaves
   every bit of the parameters and Adam's state. Then Eq. 11 sampling, the
   packed export, and the trained table served as in 10; one more step
   traced (its flash forward and backward times above 0; the ms of the
   kernels above).
12. flash attention at the paths' shapes: SASRec's (S = hd = 50, causal;
   BH 65,536, 262,144 and 512) and BST's (S = 21, 8 heads of width 4, not
   causal, on (B, S, H, hd): the forward at the bulk apply's 262,144 rows,
   the forward with stats and the backward at a step's 65,536). Each kernel
   held against its plain version on the same inputs (o and lse within
   3e-5, dq, dk, dv within 2e-4, the backward twice bit-identical), then
   timed with CUDA events beside the least time the card needs (bytes over
   3.35 TB/s, or float32 operations over 67 TFLOP/s, whichever is larger),
   their plain versions and ``F.scaled_dot_product_attention`` on
   (B, H, S, hd) views (forward alone and forward plus backward; timed
   only, never on the port's path).
13. BST serving: the full-width ``bst`` config (16,777,216 items + 4
   context fields × 65,536, d=32, one post-LN block of 8 non-causal heads
   of width 4, S=20+1, MLP 1024-512-256) with a random packed table made on
   the card (a Zipf(1.1) prior over the items, uniform context ids); with
   the launch counts at 0, ``BST.apply`` at ``serve_p99`` (512 rows),
   ``serve_bulk`` (262,144, also traced) and ``retrieval_cand`` (one
   history against 1,048,576 candidate targets, then top 100). Each apply
   must launch ``mpe_lookup`` twice and the plain flash forward once; the
   logits must equal the same model's with the plain attention and lookup
   (rtol = atol = 1e-4), the top-100 indices too where the scores are
   distinct by more. ``serve_bulk`` and ``retrieval_cand`` are traced, their
   flash time above 0. The bulk apply's two lookups alone (262,144 x 21
   item ids, 262,144 x 4 context ids), warm and cold, beside their bounds.
   At every cell of both tables the apply's lookups (recorded) equal the
   plain version bit for bit.
14. BST training: the same config under ``mpe_search``, 8 ``Trainer`` steps
   with ``adam(1e-3)`` and λ = 1e-5 at 65,536 rows on batches made once.
   Each step must launch ``mpe_qat`` forward and backward twice each and
   the flash forward with stats and backward once each; every loss
   finite, no step skipped. One more step with the kernels' arguments
   recorded: the flash forward with stats and backward ((65,536, 21, 8, 4),
   non-causal) and the ``mpe_qat`` forward and backward
   (1,376,256 sequence rows and 262,144 context rows, d = 32) against their
   plain versions on the path's own inputs, with the grids' contracts and
   each backward twice bit-identical; one more step recorded and checked
   as in 11 (``mpe_qat``, segment sum, Adam), the in-place and NaN-step
   checks. Then Eq. 11 sampling, the packed export, the trained table
   served as in 13 at ``serve_p99`` and ``retrieval_cand``, one more step
   traced (its flash times above 0).
15. the bag path: ``embeddings.embedding_bag`` sum and mean, forward and
   backward, over the full-width BST search table (17,039,360 × 32) with
   bags of 20 and ragged lengths uniform in 1..20 — the training batch's
   histories (65,536 bags) and Zipf(1.1) ones at ``serve_bulk`` (262,144)
   — with the launch counts at 0: each forward must launch the kernel and
   each backward the segment sum's bag form once; one backward traced must
   run the segment-sum kernels and no library dense embedding backward.
   Then the kernel and the backward against their plain versions (rtol
   1e-5 / atol 1e-6, both twice bit-identical) and timed beside the bound
   (each distinct row once, ids, mask, output; for the backward the dense
   gradient), the plain versions and ``F.embedding_bag`` (timed only,
   never on the port's path): the forward, the backward (also with the
   products written out first, the route the bag form replaces) and the
   forward plus backward through autograd.

16. checks at the reduced DLRM config (8 fields of 1,000 ids, 4,096
   rows): runs prefetched at depth 1 and k give the synchronous run's
   losses bit for bit; ``adam(warmup_cosine(...))``'s pass, which reads
   the schedule's ``lr_t`` on the card, held against its plain version bit
   for bit, a skipped one bit-unchanged; ``Trainer(grad_compression=True)``
   4 finite steps; 6 steps against 3, ``save``, a fresh ``Trainer``,
   ``restore()`` and 3 more: the same losses and parameters.
17. the segment sum's grid at the new shapes: width 1 with a hot segment,
   QR's two-row remainder table at width 16 and 1 (2.5 M ids into two
   segments), against the plain version, twice bit-identical, timed.
18. Table 3 at full DLRM width: the backbone (``plain``) and the five
   baselines (``lsq`` b=6, ``alpt`` b=8, ``qr`` k=2, ``pep``, ``optfs``)
   each through ``launch.train.main --prefetch`` for 4 steps at 65,536
   rows, the counts at 0. Each step must launch ``mpe_qat`` forward and
   backward once (LSQ, ALPT: one width) or never, the segment sum once a
   gather and the Adam pass once a leaf; every loss finite, no step
   skipped, every leaf at its ``data_ptr``, ALPT's table on its grid after
   every step (flags kept on the card, read after the run). One traced
   step each runs the segment sum and no library dense embedding
   backward; LSQ's, ALPT's, QR's and OptFS's next step is recorded and its
   kernels held against their plain versions as in 11. A table of each
   run's storage ratio, step ms and peak memory.
19. Wide & Deep at full width (40 fields × 1,048,576 = 41,943,040 rows,
   d = 32, MLP 1024-512-256): the MPE pipeline through ``launch.train
   --arch wide-deep --prefetch`` (4 search and 4 retrain steps at 65,536
   rows, Eq. 11 sampling, the packed export, eval), each step's kernels
   counted, peak memory as tables; then ``WideDeep.apply`` under the
   ``packed`` compressor at ``serve_p99`` (512) and ``serve_bulk``
   (262,144): one ``mpe_lookup`` an apply, the logits equal to the plain
   lookup's (rtol = atol = 1e-4), the lookups equal to the plain version
   bit for bit, the lookup timed at both cells beside its bound.

20. two-tower retrieval at full width (4 user fields × 8,388,608 + 4 item
   fields × 2,097,152 = 41,943,040 rows, d = 64, towers 1024-512-256 with
   BatchNorm, ``mpe_search``, Zipf(1.1) priors per field): at 2,048 rows
   of a batch the in-batch softmax by blocks of 768 rows against the whole
   (B, B) matrix (the loss at rtol 1e-5, the towers' gradients at rtol
   1e-5); 8 ``Trainer`` steps with ``adam(1e-3)`` and λ = 1e-5 at 65,536
   rows on batches made once (Zipf user and item ids, logQ from the item
   prior), each launching the ``mpe_qat`` forward and backward once a
   tower, the segment sum once a gather (four) and the Adam pass once a
   leaf, every loss finite, no step skipped, the peak under 70 GB (and as
   tables); one step traced; one more step's ``mpe_qat``, segment-sum and
   Adam arguments held against their plain versions as in 11 (the Adam
   pass on the 2,684,354,560-element table leaf too, timed in the traced
   step only); Eq. 11 sampling and the packed export of the whole
   table; then ``retrieval_cand`` through ``Engine.register(
   two_tower_retrieval_cell(..., n_cands=1,048,576, top_k=100))``: one
   lookup a tower in the graph, both equal to the plain version bit for
   bit on a full chunk, the items' one timed; requests of 1,048,576,
   3,000,000 (three chunks) and 1,000 candidates through
   ``engine.retrieve``, each top 100 against the plain lookup's route
   (scores within 1e-4, indices where the scores are distinct), then each
   timed 10 times (p50) with the counts at 0, two lookups a replay; the
   graph pool's bytes.
21. GIN at full width (5 layers, d = 64, learnable ε; λ = 1e-5,
   ``adam(1e-3)``): the molecule cell (128 graphs × 30 nodes / 64 edges,
   atom vocabulary 119, ``mpe_search``) 8 steps, then Eq. 11 sampling and
   the atom table's average width; ``full_graph_sm`` (cora's geometry,
   2,708 nodes / 10,556 edges, 1,433 features: its first scatter is wider
   than a 256-column tile) 4 steps; ``ogb_products`` (2,449,029 nodes /
   61,859,140 edges, 100 features, 47 classes, the graph from
   ``make_sbm_graph``, its host seconds printed) 2 steps. Each step's
   launches are counted and checked (the segment sum for each scatter and
   each gather whose input takes a gradient, the lookup's two gathers on
   the molecule cell, the Adam pass once a leaf); every loss finite, no
   step skipped, every ε moved. The molecule and cora steps' kernel
   arguments are recorded and held against their plain versions as in 11.
   One ``ogb_products`` step traced: the segment-sum kernels ran, and no
   library ``index_add_``, scatter-add, gather or dense embedding backward
   kernel. ``scatter_sum`` at cora's first scatter (10,556 × 1,433), at
   1,048,576 × 1,433 and at ``ogb_products``' shape (61,859,140 × 100):
   bit-identical to its plain version (taken by column tiles), twice
   bit-identical, timed beside the byte bound, the plain version and
   ``index_add_`` (timed only), and taken apart as in 11; the traced
   ``ogb_products`` step's combine pass (``segment_combine_kernel``) apart.

22. the LM's kernels against their plain versions: ``kv_cache_write``
   over B {1, 3, 8} × T {1, 63, 64, 65, 4,096, 8,193} × H {1, 8} × hd {16, 64,
   128} × s {1, T} × int8 (bf16 and float32 values), bf16 and float32
   caches, at mixed lengths (0, T − s, T, between) and one shared length:
   bit-identical, cache and scales, in ``kernels_a_call`` launches (one
   at s · hd ≤ 4,096, two past it into an int8 cache); a layer's keys and
   values in one ``kv_cache_write_kv`` call over T {4,097, 8,193, 32,768}
   × s {1, 3, 64}, lengths that span several pieces of the re-projection
   (and past T − s), growing scales, per-row and shared lengths; one such
   write captured in a CUDA graph and replayed twice, louder the second
   time: bit-identical each time; ``decode_attention`` over the same B,
   T, hd × (Hq, Hkv) {(1, 1), (2, 1), (8, 1), (16, 8)} × s {1, 4} × int8
   (bf16 and float32 queries), bf16 and float32 caches: within 3e-5 with
   float32 queries, else one bf16 ulp plus one bf16 step of each
   probability weighted by |v|. The lookup grid of phase 3 also runs at
   d = 2,048 (the LM's rows: 384 words at 6 bits).
23. flash attention at internlm2-1.8b's prefill shapes (16 heads of 128,
   causal, the tiled route): S = 4,096 against the plain version on every
   head, S = 32,768 on two (b, h) slices; timed beside both bounds (the
   tensor pipe's in split TF32, and the SIMT float32 one of earlier runs),
   the tiled route's time before its redesign (PERF.md), the plain version
   over every head and SDPA's forward.
24. internlm2-1.8b at full width (24 layers, d 2,048, 16 / 8 heads of 128,
   d_ff 8,192, vocab 92,544, bf16), its token table packed on the card
   (``Packed.init`` over ``TokenStream``'s Zipf frequencies). The slotted
   lane: ``lm_decode_slotted_cell`` (8 slots × 32,768, int8 cache) captured
   as a CUDA graph (one lookup, 24 cache writes — a layer's keys and
   values in one launch — and 24 decode attentions), its
   caches the graph's static inputs reset to fresh ones after the capture's
   warm-ups; 24 requests from ``TokenStream`` (prompts of 16–128 tokens,
   16–32 new, a deadline on every third) through ``submit_decode``, every
   8th step held against the plain route on a copy of the caches from
   before it (logits within 0.1 of each row's largest, or twice the gap of
   the plain route's twin — its probabilities kept in float32 — on the same
   step where larger; greedy tokens equal where the plain top-2 margin
   exceeds that); again with the counts at 0
   (the same tokens; launches = replays × captured); the step at full
   context (8 × 32,768) timed and traced beside its bound, and layer 0's
   two kernels timed there beside theirs and their plain versions (the
   write eager and in a CUDA graph, also with values that grow every
   scale), and at the requests' short contexts (each slot a prompt and 16
   tokens);
   ``decode_attention`` also over layer 0's cache dequantized to bf16 (the
   bf16 contract), timed beside SDPA with a boolean key mask and
   ``enable_gqa`` (timed only, never on the port's path).
25. ``LM.prefill`` of 32,768 tokens into an int8 cache (flash over the
   dequantized cache, one lookup, 48 write kernels: a layer's scales, then
   its codes) against the plain route (the long attention chunked by
   4,096), layer 0's cache bit-identical to the plain route's; the lookup
   at those ids and one layer's write into empty caches timed (eager and
   in a graph); 8 ``Engine.decode`` steps
   on ``lm_decode_cell``, the first copying the prefill's caches into the
   cell's, the rest reading the cell's own (the caches returned alias the
   graph's), each held against the plain route. long_500k: the decode cell
   at 1 × 524,288, its cache filled from the seed in place (codes
   ~ N(0, 127/4), scales 1.5 times a 256-token prefill's), one step against
   the plain route, 4 timed, traced and layer 0's kernels timed (the write
   also where every scale grows).
26. deepseek-moe-16b at full width, 2 of its 28 layers: phase 25's prefill
   (4,096 tokens) and 8 decode steps; the MoE combine on the segment-sum
   kernel, once a layer, in the graph too.
27. the LM's training kernels at their new shapes: ``mpe_qat`` forward and
   backward over d {257, 512, 1,000, 2,048, 6,144} (rows wider than 256
   take a block a row) × rows {1, 255, 256, 4,097, 32,768} × the widths
   (0..6) and (6,), as in phase 3; the Adam pass on bf16 leaves (float32
   moments) of 1, 7, 4,099 and 2^26 + 5 elements and a 4,099 × 8 matrix
   with weight decay, a constant rate and a schedule's, the flag true and
   false: bit for bit the plain chain's.
28. internlm2-1.8b's ``train_4k`` at full width and depth (24 layers, bf16
   layers and head, float32 token table), 8 sequences of 4,096 (of the
   cell's 256; memory), ``LM.loss_fn`` with the chunked cross-entropy
   (chunks of 512) and per-layer remat, ``adam(1e-3)``: the first loss
   against the same forward on the plain kernels (within 1e-3) and within
   1.0 of ln V; four ``Trainer`` steps on batches made once, each
   launching the flash forward with statistics 48 times (a layer's forward
   and its recompute), the backward 24, the segment sum once (the token
   table's gather) and the Adam pass once a leaf; every loss finite, no
   step skipped, the reserved peak under 70 GB. One more step's segment-sum
   and Adam arguments held against their plain versions and timed (Adam on
   the largest bf16 leaf and on the float32 table); one more with the
   flash arguments kept: the last layer's recomputed forward bit-identical
   to its first run, the forward with statistics and the backward at
   (8, 4,096, 16, 128) against their plain versions on three (b, h)
   slices, twice bit-identical, timed beside both bounds (tensor pipe and
   SIMT), the tiled route's time before its redesign (PERF.md), the plain
   version over every head and SDPA's forward and forward plus backward; the
   chunked cross-entropy against the whole logit matrix on one sequence;
   every leaf updated in place, every moment float32; one traced step.
29. the vocabulary search: the same model with ``mpe_search`` on its token
   table (``MPEConfig(lam=1e-5, embed_std=0.02)``, ``TokenStream``'s
   frequencies, 723 groups), λ times the regulariser in the loss, four
   steps (``mpe_qat`` forward and backward once each, two gathers); one
   more step's ``mpe_qat`` at (32,768, 2,048), segment-sum and Adam
   arguments held against their plain versions and timed; Eq. 11's average
   bits and the frequent and rare quartiles' bits.
30. deepseek-moe-16b, 2 of its 28 layers at full width, 2 × 4,096 tokens:
   two ``Trainer`` steps with the aux loss, the dispatch's and the
   combine's gathers' backward on the segment-sum kernel; one traced step
   that runs the segment-sum kernels and no library scatter-add.
31. the static contract checker (``repro_torch.analysis``): the tiny
   standard corpus (packed DLRM score cells with their lookup companions,
   tiered cells at hot 0.3, the ``lm-tiny`` decode and ``lm-cb`` slotted
   decode cells) built on the card with the counts at 0 (its
   ``staticcheck`` path), every cell walked op by op with the kernels as
   opaque regions (each region's kernel launched on that path), and the
   same corpus built and walked on the CPU: zero findings on both and in
   the source lint, and the same kernel regions, cell by cell. Then the
   dry run (``launch.dryrun.run_cell``) of ``dlrm-criteo/serve_p99`` and
   ``internlm2-1.8b/decode_32k`` on the 16×16 mesh: one rank's step on
   meta tensors, whose per-device FLOPs, bytes and collective bytes are
   printed — static counts, not card times.
32. the package surface: ``globalize_ids``, ``binary_accuracy``,
   ``apply_updates`` and ``clip_by_global_norm``, imported through the
   port's package names (``repro_torch.embeddings``, ``repro_torch.train``),
   on CUDA tensors at ``dlrm-criteo``'s width (a 262,144-row batch of its 39
   fields; its MLP's leaves, one in bfloat16), each held against the same
   call on the CPU: bit for bit, the clip above its norm and the norm
   within rtol 1e-6 (the sums of squares run in another order).

The line before the last holds the ``{"kernels": [...]}`` record (the
seven ported TPU kernels, the segment sum and the Adam pass, which
replace library calls and no TPU kernel, the tiered cold fill, which
replaces the reference's eager cold path, and the LM's ``kv_cache_write``
and ``decode_attention``; ``launches_by_path`` has the lifecycle's,
``dlrm lifecycle``, the tiered lane's, ``dlrm tiered``, since phases
20–21 ``two-tower train``, ``two-tower serve``, ``gin molecule train``,
``gin cora train`` and ``gin products train``, and since phases 24–26
``lm slotted``, ``lm prefill``, ``lm decode``, ``lm long_500k``, ``moe
prefill`` and ``moe decode``, since phases 28–30 ``lm train``, ``lm
vocab search`` and ``moe train``, since phase 8b ``mesh``, and since
phase 31 ``staticcheck``); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.cache import (DecayAdmissionPolicy,  # noqa: E402
                               StaticTierPolicy, TieredTableStore,
                               tiered_hot_lookup)
from repro_torch.cache.prefetch import PrefetchPipeline  # noqa: E402
from repro_torch.configs.base import SERVE_ROWS, get_arch  # noqa: E402
from repro_torch.configs.gin_tu import GRAPH_CELLS  # noqa: E402
from repro_torch.core import compressors, quantizer  # noqa: E402
from repro_torch.core.quantizer import dequantize_symmetric  # noqa: E402
from repro_torch.core.compressors import Packed, as_mpe_config  # noqa: E402
from repro_torch.core.inference import build_packed_table  # noqa: E402
from repro_torch.core.mpe import MPEConfig, MPESearchEmbedding  # noqa: E402
from repro_torch.core.packing import words_per_row  # noqa: E402
from repro_torch.core.sampling import (average_bits,  # noqa: E402
                                       feature_bits, sample_group_bits)
from repro_torch.data.graphs import (make_molecule_batch,  # noqa: E402
                                     make_sbm_graph)
from repro_torch.data.synthetic import (CTRSpec, DriftingCTR,  # noqa: E402
                                        SyntheticCTR)
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.embeddings import embedding_bag  # noqa: E402
from repro_torch.embeddings.frequency import hot_feature_mask  # noqa: E402
from repro_torch.embeddings.table import total_vocab  # noqa: E402
from repro_torch.kernels.adam import ops as adam_ops  # noqa: E402
from repro_torch.kernels.adam.ref import adam_step_ref_  # noqa: E402
from repro_torch.kernels import COUNTERS, counts  # noqa: E402
from repro_torch.kernels.build import build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, grouped_attention)
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bag_bwd_ref, embedding_bag_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    bwd_ref, flash_attention_ref, fwd_stats_ref)
from repro_torch.kernels.kv_cache_write import ops as kvw_ops  # noqa: E402
from repro_torch.kernels.kv_cache_write.ops import as_lengths  # noqa: E402
from repro_torch.kernels.kv_cache_write.ref import (  # noqa: E402
    kv_cache_write_ref)
from repro_torch.kernels.mpe_lookup import ops as mpe_lookup_ops  # noqa: E402
from repro_torch.kernels.mpe_lookup.ref import packed_lookup_ref  # noqa: E402
from repro_torch.kernels.mpe_qat import ops as qat_ops  # noqa: E402
from repro_torch.kernels.mpe_qat.ref import (  # noqa: E402
    mixed_expectation_bwd_ref, mixed_expectation_fwd_ref)
from repro_torch.kernels.segment_sum import ops as seg_ops  # noqa: E402
from repro_torch.kernels.segment_sum.ref import segment_sum_ref  # noqa: E402
from repro_torch.kernels.tiered_cold import ops as cold_ops  # noqa: E402
from repro_torch.kernels.tiered_cold.ref import cold_fill_ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.serve import (build_engine,  # noqa: E402
                                      build_packed_dlrm)
from repro_torch.launch.server import EngineClient, EngineServer  # noqa: E402
from repro_torch.models.bst import BST, fields  # noqa: E402
from repro_torch.models import two_tower as two_tower_module  # noqa: E402
from repro_torch.models.dlrm import DLRM  # noqa: E402
from repro_torch.models.gnn import GIN  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.lm import transformer as transformer_module  # noqa: E402
from repro_torch.models.sasrec import SASRec  # noqa: E402
from repro_torch.models.two_tower import (TwoTower,  # noqa: E402
                                          in_batch_softmax)
from repro_torch.models.wide_deep import WideDeep  # noqa: E402
from repro_torch.nn import attention as attention_module  # noqa: E402
from repro_torch.nn import moe as moe_module  # noqa: E402
from repro_torch.nn.chunked import (chunked_gqa_attention,  # noqa: E402
                                   chunked_softmax_xent)
from repro_torch.serve.cache import CellCache  # noqa: E402
from repro_torch.serve.cells import (lm_decode_cell,  # noqa: E402
                                     lm_decode_slotted_cell,
                                     two_tower_retrieval_cell)
from repro_torch.serve.clock import TickClock  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.repack import PressureAdapter  # noqa: E402
from repro_torch.serve.stats import LatencyStats, RequestStats  # noqa: E402
from repro_torch.train import optimizer as optimizer_module  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402
from repro_torch.train.optimizer import adam, warmup_cosine  # noqa: E402
from repro_torch.train.tree import leaves, tree_map  # noqa: E402
from repro_torch.zoo import dlrm_builder  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
LOOKUP_RTOL = 1e-6              # the reference's kernel contract
SCORE_TOL = 1e-4                # the reference's serve contract
FWD_TOL = dict(rtol=1e-5, atol=1e-7)   # the reference's Eq. 9 kernel contract
RED_TOL = dict(rtol=1e-4, atol=1e-6)   # its backward contract (sums)
REQUEST_ROWS = [1, 300, 512]
BULK_ROWS = 300_000
SEED = 0
SEARCH_STEPS = RETRAIN_STEPS = 8
LAM = 3e-5                      # the training launcher's default λ
QAT_SOURCE = "src/repro_torch/csrc/mpe_qat.cu"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_TOL = dict(rtol=3e-5, atol=3e-5)  # the reference's forward contract
FLASH_BWD_TOL = dict(rtol=2e-4, atol=2e-4)  # and its backward's
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12       # its dense TF32 tensor-core rate (data sheet)
SASREC_LAM = 1e-5               # the reference's SASRec train cell
TRAIN_ROWS = 65536              # the reference's train_batch cell
SERVE_CANDS = 1000              # its serve_p99 candidate set for SASRec
N_CANDIDATES = 1_048_576        # its retrieval_cand corpus
SASREC_STEPS = 8
SASREC_BATCHES = 2              # made once, reused in turn
BAG_SOURCE = "src/repro_torch/csrc/embedding_bag.cu"
BAG_TOL = dict(rtol=1e-5, atol=1e-6)   # the reference's bag kernel contract
BST_LAM = 1e-5                  # the reference's BST train cell
BST_STEPS = 8
BST_BATCHES = 2                 # made once, reused in turn
BST_PLAIN_CHUNK = 131_072       # rows a plain-kernel yardstick apply takes
ZIPF_A = 1.1
TT_LAM = 1e-5                   # the reference's two-tower train cell
TT_STEPS = 8
TT_BATCHES = 2                  # made once, reused in turn
TT_CHECK_ROWS = 2048            # the blocked loss beside the whole matrix
TT_CHECK_BLOCK = 768            # blocks of rows there: not a divisor
TT_PEAK_LIMIT_GB = 70.0         # a two-tower step's peak must stay under it
TT_REQUESTS = (1_048_576, 3_000_000, 1_000)   # candidates a request
TT_REQUEST_REPS = 10
TT_PLAIN_CHUNK = 262_144        # candidates a plain-route score pass takes
GIN_LAM = 1e-5                  # the reference's GIN train cells
GIN_STEPS = {"molecule": 8, "full_graph_sm": 4, "ogb_products": 2}
GIN_WIDE_ROWS = 1_048_576       # a 1,433-wide scatter at a timeable size
GIN_WIDE_SEGMENTS = 100_000
COLD_SOURCE = "src/repro_torch/csrc/tiered_cold.cu"
COLD_GRID_CAP = 4096             # the grid's largest cold count
TIERED_FRACTIONS = (0.0, 0.1, 1.0)
TIERED_BULK = (0.0, 0.1)         # the fractions that also get tiered_bulk
TIERED_REQUESTS = REQUEST_ROWS * 5
LAUNCH_REQUESTS = 8              # the tiered launcher's closed-loop requests
LAUNCH_POLICY_EVERY = 8          # rounds between plans: two plans in all
DRIFT = {"vocabs": (600, 400, 500), "train_steps": 20, "train_batch": 512,
         "cell_rows": 128, "requests": 48, "qps": 400.0, "batch": 256,
         "shift_at": 12, "shift_frac": 0.4, "hot": 0.2, "halflife": 12.0,
         "every": 1, "max_moves": 256, "writeback": 8}   # BENCH_prefetch.json
REF_STEADY = {"decay": 0.5585, "static": 0.0302}   # its steady hit rates
TOP_K = 100
SEG_SOURCE = "src/repro_torch/csrc/segment_sum.cu"
# the segment sum against its plain version: both sum a segment's c rows in
# float64 (each within (c - 1)·2^-53·Σ|rows| of the exact sum, in any order)
# and round once to float32 (half a float32 step each); so elementwise
# |got - want| <= SEG_RTOL·|want| + c·2^-52·Σ|rows| (``segment_sum_bound``)
SEG_RTOL = 2.0 ** -22
ADAM_SOURCE = "src/repro_torch/csrc/adam.cu"
ADAM_WRITES = {"adam_step_": (0, 2, 3)}    # p, m, v: the pass writes them
ADAM_SLICE = 1 << 26            # elements of a leaf the plain chain takes at a time
# peak device memory at train_batch while the trainer held the old and the
# new trees at once in each step (chip_smoke.py on an H100 80GB HBM3, 700 W)
TWO_TREE_PEAK_GB = {"dlrm": 31.405, "sasrec": 30.720, "bst": 19.840}
# the traced mpe_lookup_kernel ms of the 300,000-row DLRM bulk request with
# the first lookup kernel (one thread an output element; chip_smoke.py on an
# H100 80GB HBM3, 700 W)
PARENT_BULK_LOOKUP_TRACED_MS = 3.831
FLUSH_BYTES = 256 << 20         # written before each cold launch: 5x the L2
# the library's dense embedding backward (aten::embedding_dense_backward)
LIBRARY_SEGMENT_KERNELS = ("sum_and_scatter", "compute_grad_weight",
                           "krn_partial", "compute_num_of_partial_segments",
                           "segment_offsets_kernel")
# paper Table 3's rows other than MPE, at full DLRM width: the gathers a
# step's backward sums (QR: quotient and remainder; OptFS: rows and gates)
# and the library's other scatters: index_add_, scatter_add (and gather),
# index_put_ with accumulate, the dense embedding backward's feature kernel
GIN_LIBRARY_SCATTERS = LIBRARY_SEGMENT_KERNELS + (
    "indexFuncLargeIndex", "indexFuncSmallIndex",
    "_scatter_gather_elementwise_kernel", "index_put_with_sort_kernel",
    "embedding_backward_feature_kernel")
BASELINES = ("plain", "lsq", "alpt", "qr", "pep", "optfs")
BASELINE_GATHERS = {"plain": 1, "lsq": 1, "alpt": 1, "qr": 2, "pep": 1,
                    "optfs": 2}
ONE_WIDTH = ("lsq", "alpt")      # through mpe_qat at one width
RECORDED_BASELINES = ("lsq", "alpt", "qr", "optfs")   # kernels at new shapes
BASELINE_STEPS = 4
WD_STEPS = 4
WD_PLAIN_CHUNK = 65_536          # rows a plain-lookup yardstick apply takes
PREFETCH_MAX_DEPTH = 16
PREFETCH_STEPS = 8
REDUCED_ROWS = 4096
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")
LIFECYCLE_REQUESTS = 64          # concurrent requests, coalesced
SWEEP_REQUESTS = 200             # open-loop requests of 300 rows a load
SWEEP_LOADS = (0.1, 0.25, 0.5, 1.0, 2.0)   # x the rate one 512-row
                                           # request sustains
PAIRED_REPS = 20


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def capture_graph(fn):
    """``fn`` called once on a side stream (so that what it allocates at
    first use is made outside the capture), then captured in a CUDA graph;
    returns the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def graph_ms(fn, iters: int) -> float:
    """Mean device time of a replay of ``fn`` captured by
    ``capture_graph``, replayed back to back: without the host's launches,
    as the serving cells run it."""
    return cuda_ms(capture_graph(fn), iters)


def cold_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` launched alone after a write of
    ``FLUSH_BYTES`` (more than the 50 MB L2), so that it finds the cache
    holding none of its inputs."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    total = 0.0
    for _ in range(reps):
        flush.fill_(1)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def trace(fn, reps: int, attempts: int = 3, expect: str | None = None
          ) -> dict:
    """``fn`` run ``reps`` times under the profiler: per-run wall time, the
    device's busy time (the union of kernel and copy intervals) and device
    time by kernel name, all in ms per run, and each name's launches in
    the window (``launches_by_name``). A profile that recorded no
    device activity at all (the profiler now and then returns none for a
    short window), or none of a kernel whose name holds ``expect`` (which
    the caller has counted launching), is taken again, ``attempts`` times
    in all."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans and (expect is None
                      or any(expect in name for _, _, name in spans)):
            break
        log(f"the profiler recorded no device activity"
            f"{'' if not spans else ' of ' + repr(expect)} (attempt "
            f"{attempt} of {attempts})")
    check(len(spans) > 0, "the profiler recorded no device activity")
    busy_us, by_name, reach = 0.0, {}, float("-inf")
    launches = {}
    for start, end, name in spans:
        busy_us += max(end - max(start, reach), 0.0)
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3 / reps
        launches[name] = launches.get(name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3 / reps,
            "idle_share": 1.0 - busy_us / 1e3 / reps / wall_ms,
            "top": [(name[:60], ms) for name, ms in top],
            "by_name": by_name, "launches_by_name": launches}


def within(got: torch.Tensor, want: torch.Tensor, tol: dict,
           what: str) -> float:
    """Raise unless |got - want| <= atol + rtol·|want| everywhere; returns
    the largest |difference|."""
    ok = bool(((got - want).abs() <= tol["atol"] + tol["rtol"] * want.abs()).all())
    check(ok, f"{what}: outside rtol={tol['rtol']} atol={tol['atol']} (max "
          f"|diff| {max_abs(got, want):.3e})")
    return max_abs(got, want)


def unit_rms(x: torch.Tensor) -> tuple[torch.Tensor, float]:
    """x scaled by a power of two to an RMS in [1, 2), and x's RMS. A
    training step's own cotangents can lie far below the flash backward's
    atol, where a kernel that wrote zeros would pass; the backward is
    linear in do, so it is held to its contract at this scale, do scaled
    alike for the kernel and its plain version."""
    rms = float(x.square().mean(dtype=torch.float64).sqrt())
    return x * 2.0 ** -math.floor(math.log2(rms)), rms


def compare(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
            what: str) -> float:
    """``within``, with a line saying how many elements differ."""
    log(f"{what}: {int((got != want).sum())} of {got.numel()} elements "
        f"differ, max |diff| {max_abs(got, want):.3e}")
    return within(got, want, {"rtol": rtol, "atol": atol}, what)


def lookup_bytes(table, meta, gids: torch.Tensor) -> dict:
    """Bytes the lookup must move for these ids: per id, the id read and its
    float32 row written; per distinct row, its ``width_idx`` entry and, where
    its width is not 0, its ``local_idx`` entry and packed words, each read
    once; α and β read once."""
    d, m = meta["d"], len(meta["bits"])
    wpr = torch.tensor([words_per_row(d, b) if b else 0 for b in meta["bits"]],
                       device=gids.device)
    rows = torch.unique(gids.long())
    row_words = wpr[table["width_idx"][rows].long()]
    kept = int((row_words > 0).sum())
    nbytes = (gids.numel() * (4 + 4 * d) + rows.numel() * 4 + kept * 4
              + 4 * int(row_words.sum()) + 4 * (m + d))
    return {"ids": gids.numel(), "rows": rows.numel(), "kept_rows": kept,
            "bytes": nbytes}


def time_lookup(table, meta, ids: torch.Tensor, what: str,
                plain: bool = False) -> dict:
    """The lookup kernel on ``ids`` warm (back-to-back calls, the same ids,
    so the L2 holds the hot rows) and cold (``cold_ms``), beside the bound
    of ``lookup_bytes`` and, with ``plain``, the plain version."""
    flat = ids.reshape(-1).contiguous()
    iters = 200 if flat.numel() < 100_000 else 20

    def call():
        return mpe_lookup_ops.packed_lookup(table, meta, flat)
    moved = lookup_bytes(table, meta, flat)
    bound = moved["bytes"] / HBM_BYTES_PER_S * 1e3
    row = {**moved, "d": meta["d"], "bound_ms": bound,
           "ms": uncounted(lambda: cuda_ms(call, iters)),
           "cold_ms": uncounted(lambda: cold_ms(call, iters))}
    row["share"], row["cold_share"] = bound / row["ms"], bound / row["cold_ms"]
    if plain:
        row["plain_ms"] = cuda_ms(lambda: packed_lookup_ref(table, meta, flat),
                                  max(iters // 4, 3), warmup=1)
    log(f"mpe_lookup at {what}: {row['ms']:.4f} ms warm ({row['share']:.1%} "
        f"of the bound), {row['cold_ms']:.4f} ms cold ({row['cold_share']:.1%})"
        + (f", plain {row['plain_ms']:.4f} ms" if plain else "")
        + f"; bound {bound:.4f} ms for {moved['bytes']} bytes: {moved['ids']} "
        f"ids, d={meta['d']}, {moved['rows']} distinct rows, "
        f"{moved['kept_rows']} of them not width 0")
    return row


def recorded_lookups(fn) -> list:
    """``fn()`` with the packed lookups of ``core.compressors`` recording
    their (table, meta, ids); its launches are not counted."""
    calls = []

    def record(table, meta, ids):
        calls.append((table, meta, ids))
        return mpe_lookup_ops.packed_lookup(table, meta, ids)
    compressors.packed_lookup = record
    try:
        uncounted(fn)
        torch.cuda.synchronize()
    finally:
        compressors.packed_lookup = mpe_lookup_ops.packed_lookup
    return calls


LOOKUP_CHUNK = 1 << 21           # ids a plain-lookup comparison takes at once


def check_lookup_bits(calls: list, what: str) -> int:
    """Each recorded (table, meta, ids) lookup through the kernel equals its
    plain version bit for bit (in chunks of ids); the launches are a
    comparison's and not counted. Returns the number of ids compared."""
    n = 0
    for table, meta, ids in calls:
        flat = ids.reshape(-1).contiguous()
        for lo in range(0, flat.numel(), LOOKUP_CHUNK):
            part = flat[lo:lo + LOOKUP_CHUNK]
            got = uncounted(lambda p=part: mpe_lookup_ops.packed_lookup(
                table, meta, p))
            check(torch.equal(got, packed_lookup_ref(table, meta, part)),
                  f"{what}: the lookup kernel differs from its plain version")
        n += flat.numel()
    log(f"{what}: the lookup kernel equals its plain version bit for bit on "
        f"{len(calls)} lookups of the path ({n} ids)")
    return n


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s): {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matrix products and convolutions: float32 throughout, "
        "as the reference")
    return smi.splitlines()[0]


def phase_build():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    names = ("mpe_lookup", "mpe_qat", "flash_attention", "embedding_bag",
             "segment_sum", "adam", "tiered_cold", "kv_cache_write",
             "decode_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        outs = {name: f.result() for name, f in futures.items()}
    log(f"built {', '.join(names)} in {time.perf_counter() - t0:.1f} s")
    for name, out in outs.items():
        if not out:
            log(f"{name}: cached library")
        for line in out.splitlines():
            if "ptxas" in line or "spill" in line or "error" in line.lower():
                log(f"{name}: {line.strip()}")


def phase_kernel_grid(dev) -> float:
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for b in range(1, 9):
        for d in (8, 16, 50, 64, 2048):
            n = 1000
            cfg = MPEConfig(bits=(0, b))
            emb = torch.from_numpy(rng.normal(0, 3e-3, (n, d)).astype(np.float32))
            widx = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
            beta = torch.from_numpy(rng.normal(0, 1e-4, d).astype(np.float32))
            alpha = torch.tensor([1.0, 1e-3], dtype=torch.float32)
            table, meta = build_packed_table(emb.to(dev), widx.to(dev),
                                             alpha.to(dev), beta.to(dev), cfg)
            ids = torch.from_numpy(rng.integers(0, n, 4096).astype(np.int32)).to(dev)
            got = mpe_lookup_ops.packed_lookup(table, meta, ids)
            torch.cuda.synchronize()
            want = packed_lookup_ref(table, meta, ids)
            worst = max(worst, compare(got, want, LOOKUP_RTOL, 0.0,
                                       f"grid b={b} d={d}"))
    return worst


def request_gids(spec, buffers, rows: int, step: int, dev) -> torch.Tensor:
    ids = SyntheticCTR(spec._replace(batch_size=rows)).batch(step)["ids"]
    return torch.from_numpy(ids).to(dev) + buffers["offsets"][None, :]


def plain_scores(model, ids: np.ndarray, dev) -> torch.Tensor:
    """The logits of ``model`` = (cfg, params, state, buffers) for ``ids``
    with the plain lookup on the card, on the host."""
    cfg, params, state, buffers = model
    table, meta = params["embedding"], buffers["embedding"]["meta"]
    with torch.inference_mode():
        gids = torch.from_numpy(ids).to(dev) + buffers["offsets"][None, :]
        emb = packed_lookup_ref(table, meta, gids.reshape(-1)).reshape(
            *gids.shape, meta["d"])
        return DLRM.interact(params, state, emb, gids, cfg)[0].cpu()


def reset_lookup_counts(*engines):
    """The lookup's launch counts at 0: its wrapper's, and the replays of
    the engines' cells (a replay runs the kernels captured in its CUDA
    graph without calling their wrappers)."""
    mpe_lookup_ops.packed_lookup.launches = 0
    for engine in engines:
        for reg in engine.registered_cells().values():
            reg.cell.replays = 0


def lookup_launches(*engines) -> int:
    """``mpe_lookup`` launches since ``reset_lookup_counts``: the wrapper's
    count plus, for each cell, its replays times the lookups captured in
    its graph (engines sharing a cache are counted once)."""
    caches = {id(e.cache): e.cache for e in engines}.values()
    return (mpe_lookup_ops.packed_lookup.launches
            + sum(c.launches().get("mpe_lookup", 0) for c in caches))


def dispatches(*engines) -> int:
    """Score-cell dispatches the engines' stats hold: each replays its
    cell and the cell's lookup companion, one lookup each."""
    return sum(s["count"] for e in engines for s in e.summary().values())


def counted(engines, fn):
    """``fn()`` with the lookup's counts at 0 just before it → (its result,
    the ``mpe_lookup`` launches it made on the engines' caches)."""
    reset_lookup_counts(*engines)
    out = fn()
    return out, lookup_launches(*engines)


def phase_main_path(dev):
    cfg = get_arch("dlrm-criteo").make_config(backbone="dnn")
    n = cfg.comp_cfg["n"]
    log(f"dlrm-criteo: {len(cfg.fields)} fields, {n} features, "
        f"d={cfg.d_embed}, MLP {cfg.mlp_hidden}, widths {cfg.comp_cfg['bits']}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, buffers, state, spec = build_packed_dlrm(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    table, meta = params["embedding"], buffers["embedding"]["meta"]
    ratio = Packed.storage_ratio(table, buffers["embedding"], cfg.comp_cfg)
    sub_rows = {k: tuple(v.shape) for k, v in table["subtables"].items()}
    log(f"init + sample + export on the card: {time.perf_counter() - t0:.1f} s; "
        f"storage ratio {ratio:.6f}; subtables {sub_rows}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    torch.cuda.empty_cache()   # what the build left cached goes back
    before = torch.cuda.memory_reserved()
    engine = build_engine(cfg, params, state, buffers, device=dev)
    torch.cuda.synchronize()
    cells_reserved = torch.cuda.memory_reserved() - before
    pool_bytes = engine.cache.pool_bytes()
    copy_bytes = sum(t.numel() * t.element_size()
                     for t in leaves(engine.live_packed_table()))
    log(f"4 cells captured as CUDA graphs in "
        f"{sum(r.cell.compile_s for r in engine.registered_cells().values()):.2f}"
        f" s; their shared pool holds {pool_bytes / 1e9:.3f} GB; the "
        f"engine's copy of the table {copy_bytes / 1e9:.3f} GB; reserved "
        f"bytes grew {cells_reserved / 1e9:.3f} GB")
    check(pool_bytes > 0, "the graphs' pool holds nothing")

    # the kernel against its plain version on the full-width table
    cell_gids = {shape: request_gids(spec, buffers, rows, 5_000, dev)
                 for shape, rows in SERVE_ROWS.items()}
    worst = 0.0
    for shape, gids in cell_gids.items():
        got = mpe_lookup_ops.packed_lookup(table, meta, gids)
        torch.cuda.synchronize()
        want = packed_lookup_ref(table, meta, gids.reshape(-1)).reshape(got.shape)
        worst = max(worst, compare(got, want, LOOKUP_RTOL, 0.0,
                                   f"full-width table, {shape} "
                                   f"({gids.numel()} ids)"))
        del got, want

    # warm both cells once, then drive the main path with the counts at 0
    engine.score(SyntheticCTR(spec._replace(batch_size=8)).batch(1)["ids"])
    engine.score(SyntheticCTR(spec._replace(batch_size=600)).batch(2)["ids"])
    engine.stats = LatencyStats()
    requests = [SyntheticCTR(spec._replace(batch_size=rows)).batch(step)["ids"]
                for step, rows in enumerate(REQUEST_ROWS * 5 + [BULK_ROWS],
                                            start=10_000)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_lookup_counts(engine)
    outputs, request_ms = [], []
    for ids in requests:
        before = lookup_launches(engine)
        t0 = time.perf_counter()
        outputs.append(engine.score(ids, return_logits=True))
        request_ms.append((time.perf_counter() - t0) * 1e3)
        check(lookup_launches(engine) > before,
              f"a {ids.shape[0]}-row request launched no mpe_lookup kernel")
    launches = {"mpe_lookup": lookup_launches(engine)}
    # what the card holds at the peak: the caching allocator's reserved
    # bytes, the graphs' pool among them (a replay allocates nothing)
    serve_peak = torch.cuda.max_memory_reserved()
    serve_peak_allocated = torch.cuda.max_memory_allocated()
    log(f"main path: {len(requests)} requests, kernel launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    check(launches["mpe_lookup"] == 2 * dispatches(engine),
          f"{launches['mpe_lookup']} mpe_lookup launches for "
          f"{dispatches(engine)} dispatches of a cell and its companion")

    # what came out: finite logits of the right shape, equal to the same
    # model run with the plain lookup on the card
    model = (cfg, params, state, buffers)
    for ids, got in zip(requests, outputs):
        check(got.shape == (ids.shape[0],) and np.isfinite(got).all(),
              f"bad scores for a {ids.shape[0]}-row request")
        compare(torch.from_numpy(got), plain_scores(model, ids, dev),
                SCORE_TOL, SCORE_TOL,
                f"scores of a {ids.shape[0]}-row request vs plain lookup")
    summary = engine.stats.summary()
    log("per-cell latency:\n" + engine.stats.format_table())
    p99_req = [ms for ids, ms in zip(requests, request_ms)
               if ids.shape[0] <= SERVE_ROWS["serve_p99"]]
    log(f"request p50 (<=512 rows) {np.percentile(p99_req, 50):.3f} ms; "
        f"bulk request ({BULK_ROWS} rows) {request_ms[-1]:.3f} ms; "
        f"serving peak reserved {serve_peak / 1e9:.3f} GB (allocated "
        f"{serve_peak_allocated / 1e9:.3f} GB)")
    return {"table": table, "meta": meta, "cell_gids": cell_gids,
            "launches": launches, "max_abs_err": worst, "ratio": ratio,
            "cells": summary, "request_p50_ms": float(np.percentile(p99_req, 50)),
            "bulk_request_ms": request_ms[-1], "serve_peak_bytes": serve_peak,
            "serve_peak_allocated_bytes": serve_peak_allocated,
            "engine": engine, "requests": {"300 rows": requests[1],
                                           f"{BULK_ROWS} rows": requests[-1]},
            "model": (cfg, params, state, buffers), "spec": spec,
            "cells_pool_bytes": pool_bytes,
            "cells_reserved_bytes": cells_reserved,
            "table_copy_bytes": copy_bytes}


def phase_kernel_times(main, grid_err: float) -> dict:
    table, meta = main["table"], main["meta"]
    shapes = {}
    for shape, gids in main["cell_gids"].items():
        flat = gids.reshape(-1).contiguous()
        row = time_lookup(table, meta, flat, f"dlrm {shape}", plain=True)
        traced = trace(lambda ids=flat: mpe_lookup_ops.packed_lookup(
            table, meta, ids), 10)
        row["device_ms"] = sum(v for k, v in traced["by_name"].items()
                               if "mpe_lookup_kernel" in k)
        shapes[f"dlrm {shape}"] = row
        log(f"mpe_lookup at dlrm {shape}: {row['device_ms']:.4f} ms on the "
            f"device a call (traced)")
    bulk = shapes["dlrm serve_bulk"]
    return {"name": "mpe_lookup", "route": "cuda",
            "source": "src/repro_torch/csrc/mpe_lookup.cu",
            "replaces": "src/repro/kernels/mpe_lookup/kernel.py:63",
            "launches": main["launches"]["mpe_lookup"],
            "max_abs_err": max(grid_err, main["max_abs_err"]),
            "ms": bulk["ms"], "plain_ms": bulk["plain_ms"],
            "bound_ms": bulk["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shapes": shapes}


def phase_trace(main) -> dict:
    """Where a request's time goes: wall time against device busy time."""
    out = {}
    for what, ids in main["requests"].items():
        reps = 20 if len(ids) <= 512 else 1
        t = trace(lambda x=ids: main["engine"].score(x), reps)
        out[what] = {k: t[k] for k in ("wall_ms", "busy_ms", "idle_share", "top")}
        out[what]["lookup_ms"] = sum(ms for name, ms in t["by_name"].items()
                                     if "mpe_lookup_kernel" in name)
        check(out[what]["lookup_ms"] > 0, f"the traced {what} request's "
              f"graph replays ran no mpe_lookup_kernel")
        log(f"traced {what} request: wall {t['wall_ms']:.3f} ms, device busy "
            f"{t['busy_ms']:.3f} ms (idle share {t['idle_share']:.3f}); "
            f"mpe_lookup_kernel {out[what]['lookup_ms']:.3f} ms"
            + (f" (the first lookup kernel: {PARENT_BULK_LOOKUP_TRACED_MS} ms)"
               if reps == 1 else "") + "; top "
            + "; ".join(f"{n} {ms:.3f} ms" for n, ms in t["top"]))
    return out


def paired_ms(fns: dict, reps: int) -> dict:
    """Host ms of each ``fns[name]()`` up to a synchronize, the calls taken
    in turns (a, b, b, a, ...) so that drift in the host's speed falls on
    both alike: {name: [ms, ...]}."""
    names, out = list(fns), {name: [] for name in fns}
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) * 1e3)
    return out


def p50(values) -> float:
    return float(np.percentile(values, 50))


def open_loop_row(engine, res) -> dict:
    """An open-loop run's end-to-end numbers: latency p50/p99, the queue /
    assembly / compute split, goodput, sheds and occupancy."""
    rs = engine.request_summary().get("score")
    occ = engine.counters()["occupancy"]
    row = {k: res[k] for k in ("offered_qps", "goodput_qps", "completed",
                               "shed", "makespan_s")}
    if rs is not None:
        row.update({f"{part}_{q}": rs[part][f"{q}_ms"]
                    for part in ("latency", "queue", "assembly", "compute")
                    for q in ("p50", "p99")})
    row["occupancy"] = {cell: v["occupancy"] for cell, v in occ.items()}
    row["dispatches"] = {cell: s["count"]
                         for cell, s in engine.summary().items()}
    return row


def phase_lifecycle(main, dev) -> dict:
    """The request lifecycle at full width on phase 4's table and cells:
    coalescing, a twin engine on the warm cache, an open-loop sweep, a
    deadline run, a repack swapped mid-stream, the socket server, and each
    cell's eager step against its CUDA-graph replay."""
    t_phase = time.perf_counter()
    model, spec, engine = main["model"], main["spec"], main["engine"]
    cfg, params, state, buffers = model
    shapes = dict(SERVE_ROWS)
    compiles, hits = engine.compile_count, engine.cache.hits

    def twin_engine() -> Engine:
        """A fresh engine on phase 4's warm cache: its stats start empty."""
        e = Engine(cache=engine.cache)
        e.register_packed_model("dlrm", DLRM, cfg, params, state, buffers,
                                shapes=shapes)
        return e
    twin = twin_engine()
    check(twin.compile_count == compiles and engine.cache.hits == hits + 4,
          "a twin engine on the warm cache compiled a cell")

    # one stream object (its constructor walks all 34 M features' CDFs);
    # a request of n rows is the first n of one of its 512-row batches
    stream = SyntheticCTR(spec._replace(batch_size=512))

    def ids_of(rows: int, step: int) -> np.ndarray:
        return stream.batch(step)["ids"][:int(rows)]

    # each request alone, then the same 64 submitted together: coalesced
    sizes = np.random.default_rng(SEED).integers(1, 513, LIFECYCLE_REQUESTS)
    reqs = [ids_of(n, 30_000 + i) for i, n in enumerate(sizes)]
    lone = [engine.score(r, return_logits=True) for r in reqs]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the path's launches, part by part: each part's run with the counts
    # at 0 just before it, each held to its dispatches (a cell and its
    # lookup companion replay once a dispatch, one lookup each)
    parts = {}

    def coalesce():
        t0 = time.perf_counter()
        tickets = [twin.submit(r) for r in reqs]
        twin.drain()
        return tickets, (time.perf_counter() - t0) * 1e3
    (tickets, coalesced_ms), parts["coalesced"] = counted([engine], coalesce)
    got = [twin.poll(t) for t in tickets]
    n_dispatches = dispatches(twin)
    check(parts["coalesced"] == 2 * n_dispatches,
          f"{parts['coalesced']} mpe_lookup launches for {n_dispatches} "
          f"coalesced dispatches")
    want = plain_scores(model, np.concatenate(reqs), dev)
    bits_equal, worst = 0, 0.0
    for r, g, alone, w in zip(reqs, got, lone,
                              torch.split(want, [len(r) for r in reqs])):
        g = torch.from_numpy(g)
        worst = max(worst, within(g, w, {"rtol": SCORE_TOL, "atol": SCORE_TOL},
                                  f"a coalesced {len(r)}-row request vs "
                                  f"plain lookup"))
        within(g, torch.from_numpy(alone),
               {"rtol": SCORE_TOL, "atol": SCORE_TOL},
               f"a coalesced {len(r)}-row request vs its lone score")
        bits_equal += int(np.array_equal(g.numpy(), alone))
    log(f"lifecycle: {LIFECYCLE_REQUESTS} requests of 1-512 rows "
        f"({int(sizes.sum())} rows) in {n_dispatches} dispatch(es), "
        f"{coalesced_ms:.3f} ms; occupancy {twin.counters()['occupancy']}; "
        f"{bits_equal} equal to their lone scores bit for bit, all within "
        f"{SCORE_TOL}; max |diff| vs plain {worst:.3e}")

    # the rate one 512-row request sustains, and an open-loop sweep
    ids_512 = ids_of(512, 40_000)
    alone = {"512 rows": twin_engine()}
    lone_ms = paired_ms({"r": lambda: alone["512 rows"].score(ids_512)},
                        PAIRED_REPS)["r"]
    rate = 1e3 / p50(lone_ms)
    pool = [ids_of(300, 50_000 + i) for i in range(SWEEP_REQUESTS)]
    sweep, open_engines = {}, []
    deadline_ms = 2 * p50(lone_ms)

    def open_loops():
        for load in SWEEP_LOADS:
            e = twin_engine()
            res = launch_serve.run_open_loop(e, pool.__getitem__,
                                             SWEEP_REQUESTS, load * rate,
                                             seed=SEED)
            check(res["completed"] == SWEEP_REQUESTS and res["shed"] == 0,
                  f"the {load}x open loop lost requests: {res}")
            sweep[f"{load}x"] = open_loop_row(e, res)
            open_engines.append(e)
        e = twin_engine()
        res = launch_serve.run_open_loop(e, pool.__getitem__, SWEEP_REQUESTS,
                                         2 * rate, seed=SEED + 1,
                                         deadline_ms=deadline_ms)
        check(res["shed"] > 0 and res["completed"] + res["shed"]
              == SWEEP_REQUESTS, f"the deadline run shed nothing: {res}")
        sweep["2x, deadline"] = dict(open_loop_row(e, res),
                                     deadline_ms=deadline_ms)
        open_engines.append(e)
    _, parts["open loop"] = counted([engine], open_loops)
    check(parts["open loop"] == 2 * dispatches(*open_engines),
          f"{parts['open loop']} mpe_lookup launches for "
          f"{dispatches(*open_engines)} open-loop dispatches")
    del open_engines
    for name, row in sweep.items():
        log(f"open loop {name} of {rate:.1f} req/s (300 rows each): "
            + json.dumps(row))

    # the socket server, once, on localhost
    ids_300 = ids_of(300, 70_000)
    srv = EngineServer(twin).start()
    before = dispatches(twin)

    def round_trip():
        with EngineClient(srv.host, srv.port) as client:
            return client.score(ids_300)
    try:
        over_wire, parts["server"] = counted([engine], round_trip)
    finally:
        srv.shutdown()
        for t in srv._threads:
            t.join(timeout=30)
    check(parts["server"] == 2 * (dispatches(twin) - before),
          f"{parts['server']} mpe_lookup launches for the server's "
          f"{dispatches(twin) - before} dispatches")
    check(not any(t.is_alive() for t in srv._threads[:2]),
          "the server's threads did not stop")
    check(np.array_equal(over_wire, twin.score(ids_300, return_logits=True)),
          "a request over the socket scored other bits than in process")
    check(twin.compile_count == compiles, "the lifecycle compiled a cell")
    lifecycle_peak = torch.cuda.max_memory_reserved()

    # each cell's eager step against its replay, paired, on the same ids
    bulk_ids = main["requests"][f"{BULK_ROWS} rows"]
    paired = {}
    for shape, rows in shapes.items():
        reg = engine._score[shape]
        x = reg.cell.stage(np.ascontiguousarray(bulk_ids[:rows]))

        def eager(reg=reg, x=x):
            with torch.inference_mode():
                return reg.celldef.step_fn(*reg.bound, *x).cpu()

        def replay(reg=reg, x=x):
            return reg.cell.compiled(*x).cpu()
        check(torch.equal(eager(), replay()),
              f"the {shape} cell's replay differs from its eager step")
        reps = PAIRED_REPS if rows <= 512 else 6
        times = paired_ms({"eager": eager, "replay": replay}, reps)
        paired[shape] = {k: p50(v) for k, v in times.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reg = engine._score["serve_bulk"]
    with torch.inference_mode():
        reg.celldef.step_fn(*reg.bound, *reg.cell.stage(np.ascontiguousarray(
            bulk_ids[:SERVE_ROWS["serve_bulk"]])))
    torch.cuda.synchronize()
    eager_bulk_bytes = torch.cuda.max_memory_allocated() - base
    alone[f"{BULK_ROWS} rows"] = twin_engine()
    paired_ms({"r": lambda: alone[f"{BULK_ROWS} rows"].score(bulk_ids)}, 6)
    # each request alone: p50 of its end to end, queue, assembly (gather,
    # pad, pinned staging) and compute (replays to a synchronize)
    request = {name: {part: e.request_summary()["score"][part]["p50_ms"]
                      for part in ("latency", "queue", "assembly", "compute")}
               for name, e in alone.items()}
    log(f"paired p50, eager step vs graph replay (host ms to a synchronize "
        f"and the output on the host): {json.dumps(paired)}; lifecycle "
        f"request p50 {json.dumps(request)}; "
        f"the graphs' pool holds {main['cells_pool_bytes'] / 1e9:.3f} GB; an "
        f"eager bulk step {eager_bulk_bytes / 1e9:.3f} GB of activations; "
        f"lifecycle peak reserved {lifecycle_peak / 1e9:.3f} GB")

    # a headroom-packed table swapped to 0.8x its bytes mid-stream, through
    # the serving entry point
    argv = ["--arch", "dlrm-criteo", "--requests", "10", "--batch", "300",
            "--repack-headroom", "0.5", "--repack-budget", "0.8",
            "--seed", str(SEED)]
    log(f"repack: python -m repro_torch.launch.serve {' '.join(argv)}")
    r_engine = launch_serve.main(argv)
    # its own cache: its cells' replays are its requests' (the captures'
    # warm-up calls are registration's, not the path's)
    parts["repack"] = r_engine.cache.launches().get("mpe_lookup", 0)
    check(parts["repack"] == 2 * dispatches(r_engine),
          f"{parts['repack']} mpe_lookup launches for the repack run's "
          f"{dispatches(r_engine)} dispatches")
    check(r_engine.swaps_applied == 1 and r_engine.compile_count == 4,
          "the repack swap did not land, or compiled a cell")
    # the launcher's plan again, from the master: the live tensors must be
    # its table leaf for leaf, and the table before the swap another
    master = launch_serve.packed_master(cfg, seed=SEED, device=dev)
    planner, swapper = launch_serve.repack_tools(
        r_engine, master, stream.expected_frequencies())
    gbits = np.asarray(master["group_bits"])
    plan = planner.plan_budget(gbits, int(0.8 * planner.bytes_packed(gbits)))
    new_table, _ = swapper.build(plan.feature_bits_idx)
    old_table, _ = swapper.build(master["feature_bits_idx"])
    del master, planner, swapper
    live = leaves(r_engine.live_packed_table())
    check(all(torch.equal(a, b) for a, b in zip(live, leaves(new_table))),
          "the live table after the swap is not the planned repack")
    check(not all(torch.equal(a, b) for a, b in
                  zip(leaves(old_table), leaves(new_table))),
          "the planned repack is the table it replaced")
    new_model = (cfg, dict(params, embedding=new_table), state, buffers)
    old_model = (cfg, dict(params, embedding=old_table), state, buffers)
    moved = 0
    for rows in (1, 300, 512):
        ids = ids_of(rows, 90_000 + rows)
        got = torch.from_numpy(r_engine.score(ids, return_logits=True))
        compare(got, plain_scores(new_model, ids, dev), SCORE_TOL, SCORE_TOL,
                f"after the swap, a {rows}-row request vs plain lookup on "
                f"the planned table")
        moved += int(not torch.equal(got, plain_scores(old_model, ids, dev)))
    check(moved > 0, "the scores after the swap equal those before it")
    log(f"repack: the live table is the planned one leaf for leaf "
        f"({plan.n_features_moved} features moved, {plan.bytes_before} -> "
        f"{plan.bytes_packed} bytes); {moved} of 3 requests score otherwise "
        f"than on the table before the swap")
    del r_engine, new_model, old_model, new_table, old_table, live
    launches = {"mpe_lookup": sum(parts.values())}
    check(launches["mpe_lookup"] > 0, "the lifecycle launched no mpe_lookup")
    log(f"lifecycle phase: {time.perf_counter() - t_phase:.1f} s, "
        f"mpe_lookup launches {parts} = {launches}")
    return {"launches": launches, "launch_parts": parts, "coalesced": {
                "requests": LIFECYCLE_REQUESTS, "rows": int(sizes.sum()),
                "dispatches": n_dispatches, "ms": coalesced_ms,
                "bit_equal_to_lone": bits_equal, "max_abs_err": worst},
            "rate_512_per_s": rate, "lone_512_p50_ms": p50(lone_ms),
            "sweep": sweep, "paired_cell_p50_ms": paired,
            "request_p50_ms": request,
            "cells_pool_bytes": main["cells_pool_bytes"],
            "cells_reserved_bytes": main["cells_reserved_bytes"],
            "table_copy_bytes": main["table_copy_bytes"],
            "eager_bulk_step_bytes": eager_bulk_bytes,
            "lifecycle_peak_bytes": lifecycle_peak}


def cold_bytes(used_words: int, k: int, d: int) -> int:
    """Bytes the cold fill must move: the staged buffer's used words, read
    once, and the K rows of d float32 outputs, written once."""
    return 4 * used_words + 4 * k * d


def cold_case(rng, b: int, d: int, n_cold: int, dev, extra: int = 0):
    """A (0, b) table of 1,000 features on the card behind a store that
    keeps only the zero-width features hot, ``n_cold`` ids of its cold
    features staged through the store, and the staged buffer copied into
    one ``extra`` words longer whose tail is junk: the kernel reads its
    counts, not its length."""
    emb = torch.from_numpy(rng.normal(0, 3e-3, (1000, d)).astype(np.float32))
    widx = torch.from_numpy(rng.integers(0, 2, 1000).astype(np.int32))
    beta = torch.from_numpy(rng.normal(0, 1e-4, d).astype(np.float32))
    alpha = torch.tensor([1.0, 1e-3], dtype=torch.float32)
    table, meta = build_packed_table(emb.to(dev), widx.to(dev), alpha.to(dev),
                                     beta.to(dev), MPEConfig(bits=(0, b)))
    store = TieredTableStore(table, meta, rng.random(1000), 0.0, device=dev)
    ids = rng.choice(np.nonzero(~store._is_hot_np)[0], n_cold).astype(np.int32)
    fill = store.prefetch_cold(ids)
    buf = torch.from_numpy(rng.integers(-2**31, 2**31 - 1,
                                        fill.buffer.numel() + extra,
                                        dtype=np.int64).astype(np.int32)).to(dev)
    buf[:fill.buffer.numel()] = fill.buffer
    return table, meta, store, ids, buf


def staged_cold(rng, bits, counts, d: int, n_out: int, dev, extra: int = 0):
    """A staged buffer in the kernel's layout holding ``counts`` entries of
    each width of ``bits`` at distinct rows of an (n_out, d) output (rows
    ascending in each bucket, as ``prefetch_cold`` stages them), random
    packed words, then ``extra`` junk words."""
    k = sum(counts)
    rows = rng.permutation(n_out)[:k]
    parts, start = [], 0
    for c in counts:
        parts.append(np.sort(rows[start:start + c]))
        start += c
    n_words = sum(c * words_per_row(d, b) for c, b in zip(counts, bits) if b)
    buf = rng.integers(-2**31, 2**31 - 1, len(bits) + k + n_words + extra,
                       dtype=np.int64).astype(np.int32)
    buf[:len(bits)] = counts
    if k:
        buf[len(bits):len(bits) + k] = np.concatenate(parts)
    return torch.from_numpy(buf).to(dev)


COLD_BUCKET_SETS = ((0, 1, 2, 3, 4, 5, 6), tuple(range(16)))


def cold_bucket_counts(rng, bits, tile: int) -> list:
    """Count patterns over ``bits``: every live width full; empty buckets
    between full ones; a total that ends in the middle of a tile; one entry
    in the last bucket."""
    live = [i for i, b in enumerate(bits) if b]
    full = [0] * len(bits)
    for i in live:
        full[i] = int(rng.integers(1, 300))
    gaps = [c if j % 2 else 0 for j, c in enumerate(full)]
    mid = [0] * len(bits)
    for j, i in enumerate(live):
        mid[i] = tile * (j % 3) + (tile // 2 + 1 if j == len(live) - 1 else 0)
    last = [0] * len(bits)
    last[live[-1]] = 1
    return [full, gaps, mid, last]


def cold_grid_buckets(rng, dev) -> int:
    """Several live widths in one buffer: DLRM's {0..6} and 16 buckets (up
    to 15 bits) × d ∈ {16, 50, 64} × ``cold_bucket_counts``, bit for bit
    against the plain version; a bad buffer (a negative count, entries of
    the zero width, more entries than the output, more words than the
    buffer) writes nothing; a (0..6)-width table behind a store, its
    lookups at counts around a tile equal to the monolithic table's."""
    n = 0
    for bits in COLD_BUCKET_SETS:
        meta_bits = tuple(bits)
        for d in (16, 50, 64):
            tile = 256 // min((d + 3) // 4, 256)
            alpha = torch.from_numpy(rng.uniform(5e-4, 2e-3, len(bits))
                                     .astype(np.float32)).to(dev)
            beta = torch.from_numpy(rng.normal(0, 1e-4, d)
                                    .astype(np.float32)).to(dev)
            meta = {"bits": meta_bits, "d": d}
            for counts in cold_bucket_counts(rng, bits, tile):
                n_out = sum(counts) + 9
                buf = staged_cold(rng, bits, counts, d, n_out, dev, extra=333)
                out = torch.full((n_out, d), 3.0, device=dev)
                want = cold_fill_ref(out.clone(), buf, bits, d, alpha, beta)
                cold_ops.cold_fill(out, buf, meta, alpha, beta)
                torch.cuda.synchronize()
                check(torch.equal(out, want), f"cold grid {len(bits)} "
                      f"buckets d={d} counts {counts}: kernel vs plain")
                n += 1
            live = [i for i, b in enumerate(bits) if b]
            good = [0] * len(bits)
            good[live[-1]] = 40
            bad = [([-1 if i == live[0] else c for i, c in enumerate(good)],
                    100), ([50 if i == 0 else c for i, c in enumerate(good)],
                           100), (good, 30)]
            for counts, n_out in bad:
                buf = staged_cold(rng, bits, [max(c, 0) for c in counts], d,
                                  100, dev)
                buf[:len(bits)] = torch.tensor(counts, dtype=torch.int32)
                out = torch.full((n_out, d), 3.0, device=dev)
                cold_ops.cold_fill(out, buf, meta, alpha, beta)
                torch.cuda.synchronize()
                check(bool((out == 3.0).all()), f"cold grid: a bad buffer "
                      f"(counts {counts}, {n_out} rows) wrote")
                n += 1
            cut = staged_cold(rng, bits, good, d, 100, dev)[:len(bits) + 80]
            out = torch.full((100, d), 3.0, device=dev)
            cold_ops.cold_fill(out, cut, meta, alpha, beta)
            torch.cuda.synchronize()
            check(bool((out == 3.0).all()), "cold grid: a buffer short of its "
                  "words wrote")
            n += 1
    for d in (16, 50):
        emb = torch.from_numpy(rng.normal(0, 3e-3, (3000, d)).astype(np.float32))
        widx = torch.from_numpy(rng.integers(0, 7, 3000).astype(np.int32))
        alpha = torch.from_numpy(rng.uniform(5e-4, 2e-3, 7).astype(np.float32))
        beta = torch.from_numpy(rng.normal(0, 1e-4, d).astype(np.float32))
        table, meta = build_packed_table(emb.to(dev), widx.to(dev),
                                         alpha.to(dev), beta.to(dev),
                                         MPEConfig(bits=COLD_BUCKET_SETS[0]))
        store = TieredTableStore(table, meta, rng.random(3000), 0.0,
                                 device=dev)
        cold = np.nonzero(~store._is_hot_np)[0]
        for n_cold in (1, 18, 19, 20, 63, 64, 65, 1000):
            ids = rng.choice(cold, n_cold).astype(np.int32)
            got = store.lookup(ids)
            want = packed_lookup_ref(table, meta,
                                     torch.from_numpy(ids).to(dev))
            check(torch.equal(got, want), f"cold grid: DLRM widths d={d}, "
                  f"{n_cold} cold ids: the store's lookup vs the table's")
            n += 1
    return n


def phase_cold_grid(dev) -> float:
    """The cold-fill kernel against its plain version over b ∈ 1..8 ×
    d ∈ {8, 16, 50, 64} × cold counts {0, 1, 255, capacity}: bit for bit,
    and the filled rows equal to the monolithic lookup's; then
    ``cold_grid_buckets``' several live widths a buffer and bad buffers."""
    rng = np.random.default_rng(SEED)
    for b in range(1, 9):
        for d in (8, 16, 50, 64):
            for n_cold in (0, 1, 255, COLD_GRID_CAP):
                table, meta, store, ids, buf = cold_case(
                    rng, b, d, n_cold, dev, extra=COLD_GRID_CAP * 3)
                out = torch.full((n_cold + 7, d), 3.0, device=dev)
                want = cold_fill_ref(out.clone(), buf, meta["bits"], d,
                                     store.hot["alpha"], store.hot["beta"])
                cold_ops.cold_fill(out, buf, meta, store.hot["alpha"],
                                   store.hot["beta"])
                torch.cuda.synchronize()
                check(torch.equal(out, want),
                      f"cold grid b={b} d={d} cold={n_cold}: kernel vs plain")
                lookup = packed_lookup_ref(
                    table, meta, torch.from_numpy(ids).to(dev))
                check(torch.equal(out[:n_cold], lookup),
                      f"cold grid b={b} d={d} cold={n_cold}: vs the lookup")
    n = cold_grid_buckets(rng, dev)
    log(f"cold-fill grid: 128 single-width cases bit-identical to the plain "
        f"version and to the monolithic lookup; {n} cases over several "
        f"widths (DLRM's 7 buckets and 16), bad buffers and a DLRM-width "
        f"store as required")
    return 0.0


def store_bytes(store) -> dict:
    """Bytes a store holds on the card (the hot tier and its routing
    vectors) and on the host (the packed mirror and the routing vectors)."""
    dev = sum(t.numel() * t.element_size() for t in leaves(store.hot))
    host = sum(v.nbytes for v in store._mirror.values()) + sum(
        a.nbytes for a in (store._is_hot_np, store._width_idx_np,
                           store._tier_local_np, store._local_idx_np))
    return {"device": dev, "host": host,
            "device_subtables": sum(t.numel() * t.element_size() for t in
                                    store.hot["subtables"].values())}


def recount(store, gid_batches, meta) -> dict:
    """The store's counters recounted in numpy from its tier bits: hot and
    cold lookups and the cold rows' packed bytes."""
    hot = cold = nbytes = 0
    row = np.array([words_per_row(meta["d"], b) * 4 if b else 0
                    for b in meta["bits"]])
    for gids in gid_batches:
        flat = gids.reshape(-1)
        is_hot = store._is_hot_np[flat]
        hot += int(is_hot.sum())
        cold += int((~is_hot).sum())
        nbytes += int(row[store._width_idx_np[flat[~is_hot]]].sum())
    return {"hot_lookups": hot, "cold_lookups": cold, "bytes_moved": nbytes}


def tiered_launches(cache) -> dict:
    out = cache.launches()
    return {k: out.get(k, 0) for k in ("mpe_lookup", "tiered_cold")}


def check_tiered_cell(tc, ids, model, main_engine, table, dev,
                      what) -> dict:
    """One tiered cell on ``ids`` (its capacity's rows): the embeddings the
    cell's two kernels give (the hot lookup, then the cold fill over its
    zeros) equal the plain lookup of the monolithic table bit for bit; the
    cold fill equals its plain version bit for bit; the replay equals the
    eager step bit for bit and the monolithic cell within the serving
    contract. Returns the cold buffer (a clone of its used words) and K."""
    cfg, params, state, buffers = model
    store, meta = tc.store, tc.store.meta
    x, fill = tc.stage(ids)
    cold = tc.cold_input(fill)
    gids = torch.from_numpy(ids).to(dev) + buffers["offsets"][None, :]

    def kernels():
        with torch.inference_mode():
            base = tiered_hot_lookup(store.hot, meta["bits"], meta["d"], gids)
            got = cold_ops.cold_fill(base.clone(), cold, meta,
                                     store.hot["alpha"], store.hot["beta"])
            plain = cold_fill_ref(base.clone().view(-1, meta["d"]), cold,
                                  meta["bits"], meta["d"], store.hot["alpha"],
                                  store.hot["beta"])
            return got.view(-1, meta["d"]), plain
    got, plain = uncounted(kernels)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), f"{what}: cold fill kernel vs plain")
    want = packed_lookup_ref(table, meta, gids.reshape(-1))
    check(torch.equal(got, want), f"{what}: tiered embeddings vs the plain "
          f"lookup of the monolithic table")
    with torch.inference_mode():
        eager = tc.reg.celldef.step_fn(*tc.reg.bound, x, cold).cpu()
    replay = tc.reg.cell.compiled(x, cold).cpu()
    check(torch.equal(eager, replay), f"{what}: replay vs eager step")
    mono = torch.from_numpy(main_engine.score(ids, return_logits=True))
    err = compare(replay, mono, SCORE_TOL, SCORE_TOL,
                  f"{what}: tiered scores vs the monolithic cell")
    k = sum(fill.counts)
    used = fill.buffer.numel()
    return {"buffer": cold[:used].clone(), "k": k, "used": used,
            "max_abs_err": err}


def drift_sweep(dev) -> dict:
    """BENCH_prefetch.json's drift sweep on the card: a quick pipeline's
    table, a tiered cell of 128 rows, 48 open-loop requests of 256 rows at
    400 req/s under a TickClock, a popularity shift of 0.4 at request 12,
    writebacks every 8; the static split against the decay policy."""
    c = DRIFT
    serve_cfg, params, state, buffers, spec, res = \
        launch_serve.train_packed_dlrm(
            field_vocabs=c["vocabs"], train_steps=c["train_steps"],
            train_batch=c["train_batch"], seed=SEED, device=dev)
    freqs = SyntheticCTR(spec).expected_frequencies()
    master = res["final_params"]["embedding"]["emb"].detach().cpu().numpy()
    offs = buffers["offsets"].cpu().numpy().astype(np.int64)
    n, shift_at = c["requests"], c["shift_at"]
    steady_mark = shift_at + (n - shift_at) // 2
    points = {}
    for name in ("static", "decay"):
        store = TieredTableStore(res["packed_table"], res["packed_meta"],
                                 freqs, c["hot"], device=dev)
        engine = Engine(device=dev, clock=TickClock())
        engine.register_tiered_model("dlrm", DLRM, serve_cfg, params, state,
                                     buffers, store,
                                     shapes={"tiered": c["cell_rows"]})
        policy = (DecayAdmissionPolicy(store.meta["n"],
                                       halflife=c["halflife"],
                                       max_moves=c["max_moves"])
                  if name == "decay" else StaticTierPolicy())
        engine.attach_tier_policy(policy, every=c["every"])
        req_ds = DriftingCTR(spec._replace(batch_size=c["batch"]),
                             shift_at=shift_at, shift_frac=c["shift_frac"],
                             step0=10_000)
        snap = {}

        def on_submit(i, ids, engine=engine, store=store, snap=snap):
            if i == steady_mark:
                snap.update(store.counters())
            if i and i % c["writeback"] == 0:
                gids = np.unique(np.asarray(ids, np.int64) + offs[None, :])
                engine.writeback_embeddings(gids, master[gids])
        compiles0 = engine.compile_count
        ol = launch_serve.run_open_loop(
            engine, lambda i: req_ds.batch(10_000 + i)["ids"], n, c["qps"],
            kind="tiered", on_submit=on_submit)
        cnt = store.counters()
        hot_d = cnt["hot_lookups"] - snap["hot_lookups"]
        tot_d = hot_d + cnt["cold_lookups"] - snap["cold_lookups"]
        points[name] = {
            "hit_rate": cnt["hit_rate"], "steady_hit_rate": hot_d / tot_d,
            "reference_steady_hit_rate": REF_STEADY[name],
            **{k: cnt[k] for k in ("bytes_moved", "promotions", "demotions",
                                   "writebacks")},
            "completed": ol["completed"], "shed": ol["shed"],
            "captures_during_run": engine.compile_count - compiles0}
        check(points[name]["captures_during_run"] == 0
              and ol["completed"] == n, f"drift {name}: {points[name]}")
        log(f"drift sweep {name}: steady hit rate "
            f"{points[name]['steady_hit_rate']:.4f} (the reference's "
            f"{REF_STEADY[name]}); {json.dumps(points[name])}")
    s, a = (points[k]["steady_hit_rate"] for k in ("static", "decay"))
    check(a >= s + 0.25 and a > 0.5,
          f"drift sweep: decay {a:.4f} against static {s:.4f}")
    return points


def phase_tiered(main, dev) -> dict:
    """The tiered cache at full width on phase 4's table and prior: stores
    at hot fractions 0, 0.1 and 1.0 with their tiered cells checked and
    served; the launcher with the decay policy, writebacks and a shift; a
    PressureAdapter swap through ``refresh``; the drift sweep."""
    t_phase = time.perf_counter()
    model, spec, engine = main["model"], main["spec"], main["engine"]
    cfg, params, state, buffers = model
    table, meta = main["table"], main["meta"]
    stream = SyntheticCTR(spec._replace(batch_size=512))
    freqs = stream.expected_frequencies()
    offs = buffers["offsets"].cpu().numpy()
    n_top = int(np.ceil(0.1 * freqs.size))
    predicted = float(np.partition(freqs, freqs.size - n_top)[-n_top:].sum()
                      / freqs.sum())
    t0 = time.perf_counter()
    hot_feature_mask(freqs, 0.1)
    mask_s = time.perf_counter() - t0
    log(f"tiered: the prior puts {predicted:.4f} of the expected traffic on "
        f"the {n_top} hottest features (hot fraction 0.1; the hot mask, a "
        f"lexsort of every feature, took {mask_s:.2f} s)")
    stores, info = {}, {}
    for hf in TIERED_FRACTIONS:
        t0 = time.perf_counter()
        stores[hf] = TieredTableStore(table, meta, freqs, hf, device=dev)
        torch.cuda.synchronize()
        info[hf] = {"build_s": time.perf_counter() - t0,
                    "predicted_hit_rate": float(
                        freqs[stores[hf]._is_hot_np].sum() / freqs.sum()),
                    "storage": stores[hf].storage(),
                    "bytes": store_bytes(stores[hf])}
        log(f"store at hot fraction {hf}: {json.dumps(info[hf])}")
    cache = CellCache(dev)
    engines = {}
    for hf, store in stores.items():
        shapes = {"tiered_p99": SERVE_ROWS["serve_p99"]}
        if hf in TIERED_BULK:
            shapes["tiered_bulk"] = SERVE_ROWS["serve_bulk"]
        engines[hf] = Engine(cache=cache)
        engines[hf].register_tiered_model("dlrm", DLRM, cfg, params, state,
                                          buffers, store, shapes=shapes)
    compiles = cache.compiles
    check(compiles == 2 * len(TIERED_FRACTIONS) - 1,
          f"{compiles} tiered cells captured")
    for hf, e in engines.items():
        for shape, tc in e._tiered.items():
            check(tc.reg.cell.captured == {"mpe_lookup": 1, "tiered_cold": 1},
                  f"{shape} at {hf} captured {tc.reg.cell.captured}")

    # each cell at its capacity: embeddings, kernels, replay, scores
    bulk_ids = main["requests"][f"{BULK_ROWS} rows"]
    fills, cell_err = {}, 0.0
    for hf, e in engines.items():
        for shape, tc in e._tiered.items():
            rows = tc.reg.celldef.batch
            ids = (stream.batch(60_000)["ids"][:rows] if rows <= 512
                   else np.ascontiguousarray(bulk_ids[:rows]))
            r = check_tiered_cell(tc, ids, model, engine, table, dev,
                                  f"{shape} at hot fraction {hf}")
            cell_err = max(cell_err, r.pop("max_abs_err"))
            fills[(hf, shape)] = r
        stores[hf].reset_counters()
    log(f"tiered cells: embeddings bit-identical to the monolithic lookup at "
        f"hot fractions {TIERED_FRACTIONS}; replays equal their eager steps; "
        f"scores within {SCORE_TOL} of the monolithic cells (max |diff| "
        f"{cell_err:.3e})")

    # requests through score_tiered, overlap on and off, the counts at 0
    requests = [stream.batch(61_000 + i)["ids"][:rows]
                for i, rows in enumerate(TIERED_REQUESTS)] + [bulk_ids]
    mono = {}
    for i, ids in enumerate(requests):
        t0 = time.perf_counter()
        mono[i] = engine.score(ids, return_logits=True)
        mono[f"{i} ms"] = (time.perf_counter() - t0) * 1e3
    reset_lookup_counts(*engines.values())
    cold_ops.cold_fill.launches = 0
    rows_out, outs = {}, {}
    for hf, e in engines.items():
        for overlap in (True, False):
            for i, ids in enumerate(requests):
                e.rstats = RequestStats()
                t0 = time.perf_counter()
                outs[(hf, overlap, i)] = e.score_tiered(
                    ids, overlap=overlap, return_logits=True)
                ms = (time.perf_counter() - t0) * 1e3
                rs = e.request_summary()["tiered"]
                rows_out[(hf, overlap, i)] = {
                    "rows": int(ids.shape[0]), "ms": ms,
                    **{part: rs[part]["p50_ms"]
                       for part in ("assembly", "compute")}}
    launches = tiered_launches(cache)
    n_dispatch = dispatches(*engines.values())
    check(launches == {"mpe_lookup": n_dispatch, "tiered_cold": n_dispatch},
          f"tiered launches {launches} for {n_dispatch} dispatches")
    check(mpe_lookup_ops.packed_lookup.launches == 0
          and cold_ops.cold_fill.launches == 0,
          "a tiered request called a kernel wrapper outside its graph")
    worst = 0.0
    for (hf, overlap, i), got in outs.items():
        check(np.isfinite(got).all() and got.shape == (len(requests[i]),),
              f"bad tiered scores at {hf}")
        check(np.array_equal(got, outs[(hf, True, i)]),
              f"overlap on and off differ at {hf}, request {i}")
        worst = max(worst, within(torch.from_numpy(got),
                                  torch.from_numpy(mono[i]),
                                  {"rtol": SCORE_TOL, "atol": SCORE_TOL},
                                  f"tiered request {i} at {hf} vs the "
                                  f"monolithic cell"))
    gid_batches = [r.astype(np.int64) + offs[None, :] for r in requests] * 2
    served = {}
    for hf, store in stores.items():
        c = store.counters()
        want = recount(store, gid_batches, meta)
        check({k: c[k] for k in want} == want,
              f"counters at {hf}: {c} against the recount {want}")
        small = [rows_out[(hf, True, i)] for i in range(len(TIERED_REQUESTS))]
        bulk_on = rows_out[(hf, True, len(requests) - 1)]
        bulk_off = rows_out[(hf, False, len(requests) - 1)]
        served[hf] = {
            "hit_rate": c["hit_rate"],
            "predicted_hit_rate": info[hf]["predicted_hit_rate"],
            "bytes_moved": c["bytes_moved"], "recount": want,
            "request_p50_ms": p50([r["ms"] for r in small]),
            "request_assembly_p50_ms": p50([r["assembly"] for r in small]),
            "request_compute_p50_ms": p50([r["compute"] for r in small]),
            "monolithic_request_p50_ms": p50(
                [mono[f"{i} ms"] for i in range(len(TIERED_REQUESTS))]),
            "bulk_overlap": bulk_on, "bulk_sync": bulk_off,
            "monolithic_bulk_ms": mono[f"{len(requests) - 1} ms"]}
        log(f"tiered requests at hot fraction {hf}: {json.dumps(served[hf])}")

    # the bulk fills: H2D copy, host routing, and the kernel's time
    shapes = {}
    for hf in TIERED_BULK:
        tc = engines[hf]._tiered["tiered_bulk"]
        f = fills[(hf, "tiered_bulk")]
        used, k = f["used"], f["k"]
        # the copy a chunk's fill makes: pinned host words to the card
        host = torch.empty((used,), dtype=torch.int32, pin_memory=True)
        host.copy_(f["buffer"].cpu())
        dst = torch.empty_like(f["buffer"])
        h2d = cuda_ms(lambda: dst.copy_(host, non_blocking=True), 5)
        del host, dst
        chunk = np.ascontiguousarray(bulk_ids[:SERVE_ROWS["serve_bulk"]])
        t0 = time.perf_counter()
        tc.stage(chunk)
        torch.cuda.synchronize()
        route_ms = (time.perf_counter() - t0) * 1e3
        stores[hf].reset_counters()
        out = torch.zeros((chunk.size, meta["d"]), device=dev)
        alpha, beta = stores[hf].hot["alpha"], stores[hf].hot["beta"]
        buf = f["buffer"]

        def kernel(out=out, buf=buf, alpha=alpha, beta=beta):
            cold_ops.cold_fill(out, buf, meta, alpha, beta)

        def plain(out=out, buf=buf, alpha=alpha, beta=beta):
            cold_fill_ref(out, buf, meta["bits"], meta["d"], alpha, beta)
        ms = uncounted(lambda: cuda_ms(kernel, 20))
        plain_ms = cuda_ms(plain, 3)
        nbytes = cold_bytes(used, k, meta["d"])
        shapes[f"dlrm tiered_bulk at hot {hf}"] = {
            "cold_rows": k, "used_words": used, "bytes": nbytes,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "h2d_ms": h2d, "h2d_gb_per_s": 4 * used / h2d / 1e6,
            "route_and_gather_ms": route_ms}
        log(f"tiered_bulk at hot {hf}: "
            + json.dumps(shapes[f"dlrm tiered_bulk at hot {hf}"]))

    # the 512-row cell's fill on its own buffer, eager and in a graph replay
    for hf in TIERED_BULK:
        tc = engines[hf]._tiered["tiered_p99"]
        f = fills[(hf, "tiered_p99")]
        used, k = f["used"], f["k"]
        cold = torch.zeros_like(tc.reg.cell.inputs[1])
        cold[:used].copy_(f["buffer"])
        out = torch.zeros((tc.reg.celldef.batch * len(offs), meta["d"]),
                          device=dev)
        alpha, beta = stores[hf].hot["alpha"], stores[hf].hot["beta"]
        want = cold_fill_ref(out.clone(), cold, meta["bits"], meta["d"],
                             alpha, beta)

        def kernel(out=out, cold=cold, alpha=alpha, beta=beta):
            cold_ops.cold_fill(out, cold, meta, alpha, beta)
        uncounted(kernel)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"tiered_p99 fill at {hf}: kernel vs "
              f"plain")
        nbytes = cold_bytes(used, k, meta["d"])
        shapes[f"dlrm tiered_p99 at hot {hf}"] = {
            "cold_rows": k, "used_words": used,
            "buffer_words": cold.numel(), "bytes": nbytes,
            "ms": uncounted(lambda: cuda_ms(kernel, 50)),
            "graph_ms": uncounted(lambda: graph_ms(kernel, 50)),
            "plain_ms": cuda_ms(lambda: cold_fill_ref(
                out, cold, meta["bits"], meta["d"], alpha, beta), 3),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        log(f"tiered_p99 fill at hot {hf}: "
            + json.dumps(shapes[f"dlrm tiered_p99 at hot {hf}"]))
        del cold, out, want
    del fills

    # the launcher: decay policy, writebacks, a popularity shift
    argv = ["--arch", "dlrm-criteo", "--requests", str(LAUNCH_REQUESTS),
            "--batch", "300", "--hot-frac", "0.1", "--cache-policy", "decay",
            "--policy-every", str(LAUNCH_POLICY_EVERY), "--writeback", "4",
            "--shift-at", str(LAUNCH_REQUESTS // 2), "--seed", str(SEED)]
    log(f"tiered launcher: python -m repro_torch.launch.serve {' '.join(argv)}")
    plan_s, observe_s = [], []

    class TimedPolicy(DecayAdmissionPolicy):
        """The launcher's policy, each full-width plan and each chunk's
        observation timed."""
        def plan(self, store):
            t0 = time.perf_counter()
            out = super().plan(store)
            plan_s.append(time.perf_counter() - t0)
            return out

        def observe(self, ids):
            t0 = time.perf_counter()
            super().observe(ids)
            observe_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    launch_serve.DecayAdmissionPolicy = TimedPolicy
    try:
        r_engine = launch_serve.main(argv)
    finally:
        launch_serve.DecayAdmissionPolicy = DecayAdmissionPolicy
    launcher_s = time.perf_counter() - t0
    r_store = r_engine._tier_stores()[0]
    moves = dict(r_engine.tier_moves)
    check(r_engine.compile_count == 6, f"the launcher captured "
          f"{r_engine.compile_count} cells, not its 6: a capture mid-stream")
    check(moves["promotions"] > 0 and moves["plans"] == len(plan_s) > 0,
          f"the launcher's policy moved nothing: {moves}")
    launcher_launches = tiered_launches(r_engine.cache)
    log(f"tiered launcher: {launcher_s:.1f} s; moves {moves}; counters "
        f"{json.dumps(r_store.counters())}; its full-width plans "
        f"{[round(s, 3) for s in plan_s]} s, its observations p50 "
        f"{p50(observe_s) * 1e3:.3f} ms a chunk; launches {launcher_launches}")

    # a PressureAdapter swap through refresh, on the launcher's engine
    master = launch_serve.packed_master(cfg, seed=SEED, device=dev)
    planner, swapper = launch_serve.repack_tools(r_engine, master, freqs)
    hot_ptrs = [t.data_ptr() for t in leaves(r_store.hot)]
    ids = stream.batch(62_000)["ids"][:300]
    r_engine.score_tiered(ids)
    adapter = r_engine.attach_adapter(PressureAdapter(
        planner, swapper, master["group_bits"], every=1, promote_below=0.0))
    t0 = time.perf_counter()
    r_engine.sched_step()                 # the adapter plans and queues
    r_engine.sched_step()                 # the swap lands: refresh
    swap_s = time.perf_counter() - t0
    r_engine._adapters.remove(adapter)    # one swap is the check
    check(adapter.repacks == 1 and r_engine.swaps_applied == 1,
          f"the adapter's swap did not land ({adapter.repacks} repacks, "
          f"{r_engine.swaps_applied} swaps)")
    check(r_engine.compile_count == 6
          and [t.data_ptr() for t in leaves(r_store.hot)] == hot_ptrs,
          "the swap recaptured a cell or moved a hot-tier tensor")
    feature_bits = adapter.assignment[planner.gof]
    new_table, _ = swapper.build(feature_bits)
    got = torch.from_numpy(r_engine.score_tiered(ids, return_logits=True))
    new_model = (cfg, dict(params, embedding=new_table), state, buffers)
    adapter_err = compare(got, plain_scores(new_model, ids, dev), SCORE_TOL,
                          SCORE_TOL, "after the adapter's swap, tiered scores "
                          "vs plain lookup on the swapped table")
    gids = torch.from_numpy(ids).to(dev) + buffers["offsets"][None, :]
    check(torch.equal(
        r_store.lookup(ids + offs[None, :]).reshape(-1, meta["d"]),
        packed_lookup_ref(new_table, meta, gids.reshape(-1))),
        "after the swap the store's lookup differs from the swapped table")
    adapter_info = {"features_moved": int(
                        (feature_bits != master["feature_bits_idx"]).sum()),
                    "bytes_before": adapter.base_bytes,
                    "bytes_after": planner.bytes_packed(adapter.assignment),
                    "swap_and_refresh_s": swap_s, "max_abs_err": adapter_err}
    log(f"PressureAdapter: {json.dumps(adapter_info)}")
    del r_engine, r_store, master, planner, swapper, adapter, new_table
    del new_model

    drift = drift_sweep(dev)
    record = {"name": "tiered_cold", "route": "cuda", "source": COLD_SOURCE,
              "replaces": "no TPU kernel: the reference's cold path "
                          "src/repro/cache/tiers.py:509 (cold_part: jitted "
                          "unpack and scatter, eager dequantize) and its "
                          "jnp.where merge, src/repro/serve/cells.py:268",
              "launches": launches["tiered_cold"], "max_abs_err": 0.0,
              **{k: shapes["dlrm tiered_bulk at hot 0.1"][k]
                 for k in ("ms", "plain_ms", "bound_ms")},
              "bound_by": "bytes", "library_ms": None,
              "library_call": "no single PyTorch call", "shapes": shapes}
    log(f"tiered phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "launcher_launches": launcher_launches,
            "record": record, "stores": info, "served": served,
            "mask_s": mask_s, "plan_s": plan_s,
            "observe_p50_ms": p50(observe_s) * 1e3, "launcher_s": launcher_s,
            "moves": moves, "adapter": adapter_info, "drift": drift,
            "predicted_hit_rate_top_0.1": predicted}


def qat_inputs(gen, t, d, bits, dev, onehot=False):
    """Seeded inputs of the Eq. 9 mixture: rows (t, d), probs (t, m), α, β
    and an output cotangent g (t, d)."""
    m = len(bits)
    rows = 3e-3 * torch.randn((t, d), generator=gen, device=dev)
    if onehot:
        probs = torch.nn.functional.one_hot(
            torch.randint(0, m, (t,), generator=gen, device=dev), m).float()
    else:
        probs = torch.softmax(torch.randn((t, m), generator=gen, device=dev), -1)
    alpha = torch.tensor([quantizer.init_alpha(3e-3, b) for b in bits],
                         device=dev) * (0.7 + 0.6 * torch.rand(
                             m, generator=gen, device=dev))
    beta = 1e-4 * torch.randn((d,), generator=gen, device=dev)
    g = torch.randn((t, d), generator=gen, device=dev)
    return rows, probs, alpha, beta, g


def max_abs(got, want) -> float:
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_qat(rows, probs, alpha, beta, g, bits, what) -> tuple:
    """The ``mpe_qat`` kernels against their plain versions on the same
    inputs: ``out`` and ``drows`` bit-identical (the same IEEE division,
    rounding and fused multiply-adds), the sums (float64 in both, in other
    orders) at ``RED_TOL``; the backward run twice must give the same bits.
    Returns the largest |difference| of the forward and of the backward."""
    out = qat_ops.mixed_expectation_fwd(rows, probs, alpha, beta, bits)
    grads = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g, bits)
    again = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g, bits)
    torch.cuda.synchronize()
    want_out = mixed_expectation_fwd_ref(rows, probs, alpha, beta, bits)
    want = mixed_expectation_bwd_ref(rows, probs, alpha, beta, g, bits,
                                     sum_dtype=torch.float64)
    check(torch.equal(out, want_out), f"{what}: forward differs from the "
          f"plain version by {max_abs(out, want_out):.3e}")
    check(torch.equal(grads[0], want[0]), f"{what}: drows differs from the "
          f"plain version by {max_abs(grads[0], want[0]):.3e}")
    for name, x, w in zip(("dprobs", "dalpha", "dbeta"), grads[1:], want[1:]):
        check(bool(torch.isclose(x, w, **RED_TOL).all()),
              f"{what}: {name} outside rtol=1e-4 atol=1e-6 of the plain "
              f"version (max |diff| {max_abs(x, w):.3e})")
    check(all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"{what}: two backward runs gave different bits")
    return (max_abs(out, want_out),
            max(max_abs(x, w) for x, w in zip(grads, want)))


def phase_qat_grid(dev) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    widths = [(0, 1, 2, 3, 4, 5, 6)] + [(0, b) for b in range(1, 9)]
    one_width = [(b,) for b in range(1, 9)]   # probability 1: LSQ, ALPT
    fwd_err = bwd_err = 0.0
    cases = 0
    for onehot in (False, True):
        for bits in widths + ([] if onehot else one_width):
            for d in (8, 16, 32, 33, 50, 64):
                for t in (1, 255, 257, 4099):
                    f, b = check_qat(*qat_inputs(gen, t, d, bits, dev, onehot),
                                     bits, f"mpe_qat grid bits={bits} d={d} "
                                     f"rows={t} onehot={onehot}")
                    fwd_err, bwd_err = max(fwd_err, f), max(bwd_err, b)
                    cases += 1
    log(f"mpe_qat grid: {cases} cases, out and drows bit-identical to the "
        f"plain version, backward repeatable; max |diff| of the sums "
        f"{bwd_err:.3e}")
    return fwd_err, bwd_err


def reset_counts():
    for counter in COUNTERS.values():
        counter.launches = 0


def launched_since(before: dict) -> dict:
    return {name: n - before[name] for name, n in counts().items()}


def uncounted(fn):
    """``fn()``; the launches it makes are a comparison's and not counted."""
    before = counts()
    try:
        return fn()
    finally:
        for name, n in before.items():
            COUNTERS[name].launches = n


def phase_train_path(dev) -> dict:
    """The training entry point at full width, then the trained table served."""
    cfg = get_arch("dlrm-criteo").make_config(backbone="dnn")
    n_steps = SEARCH_STEPS + RETRAIN_STEPS
    argv = ["--arch", "dlrm-criteo", "--backbone", "dnn",
            "--batch", str(TRAIN_ROWS), "--steps", str(SEARCH_STEPS),
            "--retrain-steps", str(RETRAIN_STEPS), "--lam", str(LAM),
            "--seed", str(SEED), "--prefetch"]
    log(f"train path: python -m repro_torch.launch.train {' '.join(argv)}")
    torch.cuda.synchronize()
    live_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = launch_train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated()
    live_after = torch.cuda.memory_allocated()
    steps = res["search_history"] + res["retrain_history"]
    fwd = qat_ops.mixed_expectation_fwd.launches
    bwd = qat_ops.mixed_expectation_bwd.launches
    check(len(steps) == n_steps, f"{len(steps)} steps ran, not {n_steps}")
    check(fwd == n_steps and bwd == n_steps,
          f"{n_steps} steps launched the mpe_qat forward {fwd} and the "
          f"backward {bwd} times: each step must launch each once")
    # a search step sums two gathers' gradients (rows and probabilities), a
    # retrain step one; every step runs the Adam pass once a leaf
    seg, passes = counts()["segment_sum"], counts()["adam_step_"]
    want_passes = (len(leaves(res["search_params"])) * SEARCH_STEPS
                   + len(leaves(res["final_params"])) * RETRAIN_STEPS)
    check(seg == 2 * SEARCH_STEPS + RETRAIN_STEPS and passes == want_passes,
          f"the steps launched segment_sum {seg} and the Adam pass {passes} "
          f"times, not {2 * SEARCH_STEPS + RETRAIN_STEPS} and {want_passes}")
    check(all(np.isfinite(h["loss"]) for h in steps), "a loss was not finite")
    check(not any(h["skipped"] for h in steps), "a step was skipped")

    # serve the exported table: the packed compressor over the trained MLP
    table, meta = res["packed_table"], res["packed_meta"]
    params = {**res["final_params"], "embedding": table}
    buffers = {"offsets": res["buffers"]["offsets"], "embedding": {"meta": meta}}
    engine = build_engine(cfg, params, res["state"], buffers, device=dev)
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields), seed=SEED)
    served = 0
    with torch.inference_mode():
        for step, rows in enumerate((1, 300, 512, 3000), start=20_000):
            ids = SyntheticCTR(spec._replace(batch_size=rows)).batch(step)["ids"]
            before = lookup_launches(engine)
            got = engine.score(ids, return_logits=True)
            check(lookup_launches(engine) > before,
                  f"a {rows}-row request to the trained table launched no "
                  f"mpe_lookup kernel")
            check(got.shape == (rows,) and np.isfinite(got).all(),
                  f"bad scores for a {rows}-row request to the trained table")
            want = plain_scores((cfg, params, res["state"], buffers), ids,
                                dev)
            compare(torch.from_numpy(got), want, SCORE_TOL, SCORE_TOL,
                    f"trained table, {rows}-row request vs plain lookup")
            served += 1
    launches = {"mixed_expectation_fwd": fwd, "mixed_expectation_bwd": bwd,
                "mpe_lookup": lookup_launches(engine),
                "segment_sum": seg, "adam_step_": passes}
    table_bytes = cfg_table_bytes(res["final_params"]["embedding"]["emb"])
    sec = res["seconds"]
    out = {"launches": launches, "steps": n_steps, "requests_served": served,
           "train_s": train_s, "phase_s": sec, "peak_bytes": train_peak,
           "table_bytes": table_bytes, "peak_tables": train_peak / table_bytes,
           "live_bytes_before": live_before, "live_bytes_after": live_after,
           "search_step_ms": sec["search"] / SEARCH_STEPS * 1e3,
           "retrain_step_ms": sec["retrain"] / RETRAIN_STEPS * 1e3,
           "search_batch_ms": float(np.mean(
               [h["data_ms"] for h in res["search_history"]])),
           "retrain_batch_ms": float(np.mean(
               [h["data_ms"] for h in res["retrain_history"]])),
           "losses": [h["loss"] for h in steps],
           "storage_ratio": res["storage_ratio"], "avg_bits": res["avg_bits"],
           "eval": res["eval"]}
    log(f"train path: {n_steps} steps, launches {launches}; search "
        f"{out['search_step_ms']:.1f} ms/step, retrain "
        f"{out['retrain_step_ms']:.1f} ms/step (host clock to a synchronize; "
        f"making a batch on the host {out['search_batch_ms']:.1f} and "
        f"{out['retrain_batch_ms']:.1f} ms of them); "
        f"peak memory {train_peak / 1e9:.3f} GB, {train_peak / table_bytes:.2f}"
        f" tables (two trees: {TWO_TREE_PEAK_GB['dlrm']} GB; {live_before / 1e9:.3f} "
        f"GB live before, {live_after / 1e9:.3f} GB after); ratio "
        f"{res['storage_ratio']:.6f}, avg bits {res['avg_bits']:.3f}, eval "
        f"{res['eval']}; losses {[round(x, 5) for x in out['losses']]}")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()   # the cells' graph pool goes back
    return {**out, "res": res, "cfg": cfg}


def cfg_table_bytes(table: torch.Tensor) -> int:
    """Bytes of a float32 training table."""
    return table.numel() * table.element_size()


def composition(rows, probs, alpha, beta, g, bits):
    """Eq. 9 and its gradients by autograd through ``lsq_quantize``."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (rows, probs, alpha, beta)]
    out = quantizer.mixed_expectation(*leaves, bits)
    out.backward(g)
    return out.detach(), [x.grad for x in leaves]


def qat_bytes(t, d, m) -> dict:
    """Bytes the Eq. 9 forward and backward must move: each input read
    once, each output written once."""
    fwd = 4 * (t * d + t * m + m + d + t * d)
    bwd = 4 * (t * d + t * m + m + d + t * d + t * d + t * m + m + d)
    return {"fwd": fwd, "bwd": bwd}


MESH_SPLITS = ((1, 4), (2, 2))   # (dp, mp): the row splits held on one card
MESH_REQUESTS = (512, 262_144)   # rows of a request the bodies answer
MESH_SERVE_ROWS = (1, 300, 512, 20_000)
MESH_TRAIN_ROWS = 4096
MESH_TRAIN_STEPS = 2
MESH_QAT_ROWS = TRAIN_ROWS * 39 + 1  # a search step's rows, odd: padded
MESH_FLASH = (8, 256, 8, 2, 64)      # B, S, Hq, Hkv, hd
MESH_BAG = (1_000_000, 32, 65_536, 20)   # rows, d, bags, slots
MESH_HOT_FRAC = 0.1
MESH_TIMED_ITERS = 20


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_lookup(table, meta, gids, dp: int, mp: int, comms: str, cap,
                tiered: bool = False) -> torch.Tensor:
    """What ``sharded_packed_lookup`` (or, ``tiered``, the tiered hot
    lookup over a store's hot tier ``table``) returns on a dp×mp mesh, on
    one card: the wrapper itself on a ``LocalMesh``, which runs each data
    block's ids through every row shard's local body in turn and replaces
    the all_reduce, all_to_alls and all_gathers by what they compute."""
    from repro_torch.dist.shard import (LocalMesh, sharded_packed_lookup,
                                        sharded_tiered_hot_lookup)
    mesh = LocalMesh(dp, mp)
    if tiered:
        return sharded_tiered_hot_lookup(table, meta["bits"], meta["d"],
                                         gids, mesh=mesh, lookup_comms=comms,
                                         bucket_capacity=cap)
    return sharded_packed_lookup(table, meta, gids, mesh=mesh,
                                 lookup_comms=comms, bucket_capacity=cap)


def sum_bound(abs_sum, n_terms: int):
    """The float32 bound on the gap between two orders of one sum of
    ``n_terms`` terms whose absolute values sum to ``abs_sum``: each order
    is within γ_n·Σ|x| of the exact sum (γ_n = n·u / (1 - n·u), u = 2^-24,
    the recursive-summation bound), so the two are within twice that."""
    u = 2.0 ** -24
    return 2 * n_terms * u / (1 - n_terms * u) * abs_sum


def mesh_world_one(dev, cfg, res) -> dict:
    """(a) An NCCL group of one rank, from the environment the smoke sets
    for itself: a ``--mesh 1,1`` engine (sharded-lookup cells) beside an
    engine without a mesh over the trained table, and two ``Trainer``
    steps with and without the mesh at full width. Returns the mesh
    engine (for its launch counts) and what was compared."""
    import torch.distributed as dist
    from repro_torch.dist.mesh import init_distributed, parse_mesh_flag

    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        check(init_distributed(device=dev, timeout=120),
              "init_distributed brought up no process group")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        check(dist.get_backend() == backend and dist.get_world_size() == 1,
              f"a {dist.get_backend()} group of {dist.get_world_size()} "
              f"ranks, not {backend} at world size 1")
        mesh = parse_mesh_flag("1,1")
        check(mesh.device_mesh is not None and mesh.device_type == dev.type,
              f"the 1x1 mesh holds no DeviceMesh on {dev}")
        table, meta = res["packed_table"], res["packed_meta"]
        params = {**res["final_params"], "embedding": table}
        buffers = {"offsets": res["buffers"]["offsets"],
                   "embedding": {"meta": meta}}
        plain = build_engine(cfg, params, res["state"], buffers, device=dev)
        meshed = build_engine(cfg, params, res["state"], buffers, device=dev,
                              mesh=mesh, shard_lookup=True)
        spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields),
                       seed=SEED)
        requests = [SyntheticCTR(spec._replace(batch_size=rows)).batch(
            30_000 + i)["ids"] for i, rows in enumerate(MESH_SERVE_ROWS)]
        want = [uncounted(lambda ids=ids: plain.score(ids, return_logits=True))
                for ids in requests]
        for reg in meshed.registered_cells().values():
            reg.cell.replays = 0
        got = [meshed.score(ids, return_logits=True) for ids in requests]
        # a replay runs the kernels captured in its graph: counted by cell
        engine_launches = meshed.cache.launches().get("mpe_lookup", 0)
        check(engine_launches > 0, "the mesh engine launched no lookup")
        for rows, g, w in zip(MESH_SERVE_ROWS, got, want):
            check(g.shape == (rows,) and np.isfinite(g).all(),
                  f"mesh 1x1: bad scores for a {rows}-row request")
            check(np.array_equal(g, w), f"mesh 1x1: a {rows}-row request's "
                  f"scores differ from the engine without a mesh")
        del plain
        # two steps with the mesh, then the same two without it
        losses = {}
        tspec = spec._replace(batch_size=MESH_TRAIN_ROWS)
        ds = SyntheticCTR(tspec)
        build = dlrm_builder(cfg, ds.expected_frequencies(), lam=LAM,
                             device=dev)
        for name, m in (("mesh", mesh), ("none", None)):
            bundle = build(SEED, "mpe_search", MPEConfig(lam=LAM)._asdict())
            trainer = Trainer(bundle["loss_fn"], bundle["params"],
                              bundle["buffers"], bundle["state"],
                              adam(1e-3), mesh=m)
            run = (lambda t=trainer: t.run(ds.batch, MESH_TRAIN_STEPS,
                                           log_every=0))
            if m is None:
                uncounted(run)
            else:
                run()
            losses[name] = [h["loss"] for h in trainer.history]
            del trainer, bundle
            gc.collect()
        check(losses["mesh"] == losses["none"],
              f"mesh 1x1 trainer losses {losses['mesh']} differ from "
              f"{losses['none']}")
        check(all(np.isfinite(x) for x in losses["mesh"]),
              "a mesh 1x1 loss was not finite")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"mesh (a): {backend} at world size 1, --mesh 1,1: "
        f"{len(requests)} requests bit-identical to the engine without a "
        f"mesh, {MESH_TRAIN_STEPS} trainer steps with losses "
        f"{losses['mesh']} equal to those without")
    return {"engine": meshed, "engine_launches": engine_launches,
            "losses": losses["mesh"]}


def mesh_bodies(dev, cfg, res) -> dict:
    """(b) The local bodies at full width on the card, every shard of the
    1×4 and 2×2 row splits in turn, merged by what the collectives
    compute, against the single-device kernels: the lookup (psum; a2a at
    capacities none, a tight one that spills, and 1) and the tiered hot
    lookup bit-identical, ``mpe_qat`` on row blocks and flash on (batch,
    head) blocks bit-identical, the bag's partials within the float32
    summation bound of each bag (``sum_bound``), which a sum missing one
    shard's partials must break."""
    from repro_torch.dist.shard import (bag_grad_local, bag_partial,
                                        local_row_block)
    table, meta = res["packed_table"], res["packed_meta"]
    offsets = res["buffers"]["offsets"]
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields), seed=SEED)
    gids = {rows: request_gids(spec, {"offsets": offsets}, rows, 31_000, dev)
            .reshape(-1).contiguous() for rows in MESH_REQUESTS}
    cases = 0
    spills = {}
    for rows, ids in gids.items():
        want = uncounted(lambda: mpe_lookup_ops.packed_lookup(table, meta, ids))
        for dp, mp in MESH_SPLITS:
            slice_len = -(-(ids.numel() // dp) // mp)
            tight = max(1, slice_len // (2 * mp))
            for comms, cap in (("psum", None), ("a2a", None), ("a2a", tight),
                               ("a2a", 1)):
                got = mesh_lookup(table, meta, ids, dp, mp, comms, cap)
                check(torch.equal(got, want),
                      f"mesh {dp}x{mp} {comms} cap {cap}: the {rows}-row "
                      f"lookup differs from the single-device kernel's")
                cases += 1
            from repro_torch.dist.shard import lookup_route_stats
            stats = lookup_route_stats(table, meta, ids[:ids.numel() // dp],
                                       n_shards=mp, bucket_capacity=tight)
            spills[f"{rows} rows {dp}x{mp} cap {tight}"] = stats["spilled"]
            check(stats["spilled"] > 0, f"capacity {tight} spilled nothing")
    torch.cuda.synchronize()
    # the tiered hot body over a store of the trained table
    freqs = SyntheticCTR(spec).expected_frequencies()
    store = TieredTableStore(table, meta, freqs, MESH_HOT_FRAC, device=dev)
    hot_ids = gids[MESH_REQUESTS[0]]
    want = uncounted(lambda: tiered_hot_lookup(store.hot, meta["bits"],
                                               meta["d"], hot_ids))
    for dp, mp in MESH_SPLITS:
        for comms, cap in (("psum", None), ("a2a", None), ("a2a", 1)):
            got = mesh_lookup(store.hot, meta, hot_ids, dp, mp, comms, cap,
                              tiered=True)
            check(torch.equal(got, want), f"mesh {dp}x{mp} {comms}: the "
                  f"tiered hot lookup differs from the single-device one")
            cases += 1
    del store
    # mpe_qat on row blocks (rows over every axis: 4 blocks either split)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bits = tuple(MPEConfig().bits)
    rows, probs, alpha, beta, g = qat_inputs(gen, MESH_QAT_ROWS, 16, bits, dev)
    want_out = uncounted(lambda: qat_ops.mixed_expectation_fwd(
        rows, probs, alpha, beta, bits))
    want_b = uncounted(lambda: qat_ops.mixed_expectation_bwd(
        rows, probs, alpha, beta, g, bits))
    blocks = [[local_row_block(x, s, 4).contiguous() for x in (rows, probs, g)]
              for s in range(4)]
    out = torch.cat([qat_ops.mixed_expectation_fwd(r, p, alpha, beta, bits)
                     for r, p, _ in blocks])[:MESH_QAT_ROWS]
    grads = [qat_ops.mixed_expectation_bwd(r, p, alpha, beta, gb, bits)
             for r, p, gb in blocks]
    check(torch.equal(out, want_out), "mpe_qat on row blocks differs")
    for i in (0, 1):
        check(torch.equal(torch.cat([x[i] for x in grads])[:MESH_QAT_ROWS],
                          want_b[i]), f"mpe_qat's backward {i} on row blocks "
              f"differs")
    qat_sum_err = max(max_abs(sum(x[i] for x in grads), want_b[i])
                      for i in (2, 3))
    cases += 1
    del rows, probs, g, blocks, grads
    # flash on (batch, head) blocks, GQA expanded before the split
    b, s, hq, hkv, hd = MESH_FLASH
    q, k, v, do = (torch.randn((b, s, h, hd), generator=gen, device=dev)
                   for h in (hq, hkv, hkv, hq))
    k, v = (x.repeat_interleave(hq // hkv, dim=2).contiguous() for x in (k, v))
    o, lse = uncounted(lambda: flash_ops.flash_attention_fwd_stats(q, k, v))
    want_g = uncounted(lambda: flash_ops.flash_attention_bwd(q, k, v, o, lse,
                                                             do))
    for dp, mp in MESH_SPLITS:
        bb, hh = b // dp, hq // mp
        for i in range(dp):
            for j in range(mp):
                blk = [x[i * bb:(i + 1) * bb, :, j * hh:(j + 1) * hh]
                       .contiguous() for x in (q, k, v, do)]
                ob, lb = flash_ops.flash_attention_fwd_stats(*blk[:3])
                gb = flash_ops.flash_attention_bwd(*blk[:3], ob, lb, blk[3])
                sl = (slice(i * bb, (i + 1) * bb), slice(None),
                      slice(j * hh, (j + 1) * hh))
                check(torch.equal(ob, o[sl]) and torch.equal(
                    lb, lse[i * bb:(i + 1) * bb, j * hh:(j + 1) * hh]),
                      f"flash block ({i}, {j}) of {dp}x{mp} differs")
                check(all(torch.equal(x, w[sl]) for x, w in zip(gb, want_g)),
                      f"flash block ({i}, {j}) of {dp}x{mp}: gradients "
                      f"differ")
        cases += 1
    del q, k, v, do, o, lse, want_g
    # the bag's partials over row blocks, and its gradient's blocks
    n, d, nb, nl = MESH_BAG
    tab = torch.randn((n, d), generator=gen, device=dev)
    ids = torch.randint(0, n, (nb, nl), generator=gen, device=dev,
                        dtype=torch.int32)
    mask = torch.rand((nb, nl), generator=gen, device=dev) < 0.8
    gbag = torch.randn((nb, d), generator=gen, device=dev)
    want = uncounted(lambda: bag_ops.embedding_bag_fwd(tab, ids, mask))
    want_grad = uncounted(lambda: bag_ops.embedding_bag_bwd(gbag, ids, mask,
                                                            n))
    bound = sum_bound((tab.abs().double()[ids.long()]
                       * mask[..., None]).sum(1), nl)
    bag_err = bag_grad_err = bag_ratio = 0.0
    wrong_ratio = float("inf")
    for mp in (4, 2):
        parts = [bag_partial(local_row_block(tab, sh, mp), ids, mask, sh)
                 for sh in range(mp)]
        got = sum(parts)
        grad = torch.cat([bag_grad_local(gbag, ids, mask, sh, -(-n // mp))
                          for sh in range(mp)])[:n]
        bag_err = max(bag_err, max_abs(got, want))
        bag_ratio = max(bag_ratio, float(((got - want).abs().double()
                                          / bound).max()))
        # a wrong merge: the sum without shard 0's partials
        wrong_ratio = min(wrong_ratio, float(((got - parts[0] - want).abs()
                                              .double() / bound).max()))
        bag_grad_err = max(bag_grad_err, max_abs(grad, want_grad))
        cases += 1
    check(bag_ratio <= 1.0, f"the bag's partials sum {bag_err} off the bag, "
          f"{bag_ratio:.3g} of its summation bound")
    check(wrong_ratio > 1.0, f"a sum missing a shard's partials is within "
          f"the bound ({wrong_ratio:.3g} of it): the check cannot see it")
    check(bag_grad_err <= 1e-6, f"the bag gradient's blocks {bag_grad_err} "
          f"off the gradient")
    torch.cuda.synchronize()
    log(f"mesh (b): {cases} local-body cases on {dev} at full width "
        f"(1x4 and 2x2): lookups and the tiered hot lookup bit-identical at "
        f"{MESH_REQUESTS} rows, spilled ids {spills}; mpe_qat and flash "
        f"blocks bit-identical (dalpha/dbeta sums {qat_sum_err:.3g} off); "
        f"bag partials {bag_err:.3g} off ({bag_ratio:.3g} of the summation "
        f"bound; a shard's partials dropped: {wrong_ratio:.3g} of it), "
        f"gradient blocks {bag_grad_err:.3g} off")
    return {"cases": cases, "spilled": spills, "qat_sum_err": qat_sum_err,
            "bag_err": bag_err, "bag_bound_ratio": bag_ratio,
            "bag_wrong_ratio": wrong_ratio, "bag_grad_err": bag_grad_err,
            "gids": gids}


def phase_mesh(dev, train) -> dict:
    """The distribution layer on one card: (a) an NCCL group of one rank
    serving and training on ``--mesh 1,1``; (b) the local bodies of the
    1×4 and 2×2 splits at full width; (c) one rank's 262,144-row psum body
    timed beside the single-device lookup. The counts are set to 0 just
    before (a) and read after (b): the ``mesh`` path of
    ``launches_by_path``."""
    from repro_torch.dist.shard import local_row_block, packed_lookup_local
    cfg, res = train["cfg"], train["res"]
    t0 = time.perf_counter()
    reset_counts()
    one = mesh_world_one(dev, cfg, res)
    bodies = mesh_bodies(dev, cfg, res)
    launches = counts()
    launches["mpe_lookup"] += one["engine_launches"]   # the graphs' replays
    for name in ("mpe_lookup", "mixed_expectation_fwd",
                 "mixed_expectation_bwd", "segment_sum", "adam_step_",
                 "flash_attention_fwd_stats", "flash_attention_bwd",
                 "embedding_bag_fwd"):
        check(launches[name] > 0, f"{name} was not launched on the mesh path")
    # (c) one rank's work at 262,144 rows: shard 0 of 4, no collective
    table, meta = res["packed_table"], res["packed_meta"]
    ids = bodies["gids"][MESH_REQUESTS[-1]]
    subs = {k: local_row_block(v, 0, 4) for k, v in table["subtables"].items()}
    bits, d = tuple(meta["bits"]), int(meta["d"])

    def body():
        return packed_lookup_local(subs, table["local_idx"],
                                   table["width_idx"], table["alpha"],
                                   table["beta"], ids, bits=bits, d=d,
                                   shard=0)
    body_ms = uncounted(lambda: cuda_ms(body, MESH_TIMED_ITERS))
    single_ms = uncounted(lambda: cuda_ms(
        lambda: mpe_lookup_ops.packed_lookup(table, meta, ids),
        MESH_TIMED_ITERS))
    del one["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    out = {"launches": launches, "losses": one["losses"],
           "cases": bodies["cases"], "spilled": bodies["spilled"],
           "bag_err": bodies["bag_err"],
           "bag_bound_ratio": bodies["bag_bound_ratio"],
           "bag_wrong_ratio": bodies["bag_wrong_ratio"],
           "bag_grad_err": bodies["bag_grad_err"],
           "qat_sum_err": bodies["qat_sum_err"],
           "one_rank": {"label": "one rank's work, no collective",
                        "rows": MESH_REQUESTS[-1], "ids": ids.numel(),
                        "body": "psum body, shard 0 of 4",
                        "body_ms": body_ms, "single_device_lookup_ms":
                            single_ms},
           "phase_s": time.perf_counter() - t0}
    log(f"mesh: {out['phase_s']:.1f} s; launches {launches}; one rank's "
        f"work, no collective: {body_ms:.4f} ms (psum body, shard 0 of 4, "
        f"{ids.numel()} ids) beside the single-device lookup's "
        f"{single_ms:.4f} ms")
    return out


def phase_step_inputs(dev, train) -> dict:
    """A search step's and a retrain step's own inputs at the full shape:
    the kernels against the plain version and the composition, the kernel
    times, and one traced search step."""
    cfg, res = train["cfg"], train["res"]
    mpe = MPEConfig(lam=LAM)
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields),
                   batch_size=TRAIN_ROWS, seed=SEED)
    ds = SyntheticCTR(spec)
    build = dlrm_builder(cfg, ds.expected_frequencies(), lam=LAM, device=dev)
    bundle = build(SEED, "mpe_search", mpe._asdict())
    del bundle["params"]                      # the searched ones are used
    offsets = bundle["buffers"]["offsets"]
    gof = bundle["buffers"]["embedding"]["group_of_feature"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gids = (torch.from_numpy(ds.batch(0)["ids"]).to(dev)
            + offsets[None, :]).reshape(-1).long()
    # the pipeline's search results are host snapshots
    sp = {k: v.to(dev) for k, v in res["search_params"]["embedding"].items()}
    fp = res["final_params"]["embedding"]
    bits = tuple(mpe.bits)
    widx = res["buffers"]["embedding"]["bits_idx"][gids].long()
    cases = {
        "search": (sp["emb"][gids],
                   MPESearchEmbedding.probabilities(sp, mpe)[gof[gids].long()],
                   sp["alpha"], sp["beta"]),
        "retrain": (fp["emb"][gids],
                    torch.nn.functional.one_hot(widx, len(bits)).float(),
                    fp["alpha"], fp["beta"]),
    }
    errs = {"fwd": 0.0, "bwd": 0.0}
    for what, (rows, probs, alpha, beta) in cases.items():
        rows, probs = rows.contiguous(), probs.contiguous()
        g = torch.randn(rows.shape, generator=gen, device=dev)
        f, b = check_qat(rows, probs, alpha, beta, g, bits,
                         f"{what} step inputs ({rows.shape[0]} rows)")
        errs["fwd"], errs["bwd"] = max(errs["fwd"], f), max(errs["bwd"], b)
        out = qat_ops.mixed_expectation_fwd(rows, probs, alpha, beta, bits)
        grads = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g, bits)
        c_out, c_grads = composition(rows, probs, alpha, beta, g, bits)
        compare(out, c_out, FWD_TOL["rtol"], FWD_TOL["atol"],
                f"{what} step: forward kernel vs lsq_quantize composition")
        compare(grads[0], c_grads[0], FWD_TOL["rtol"], FWD_TOL["atol"],
                f"{what} step: drows kernel vs autograd of the composition")
        for name, x, w in zip(("dprobs", "dalpha", "dbeta"), grads[1:],
                              c_grads[1:]):
            compare(x, w, RED_TOL["rtol"], RED_TOL["atol"],
                    f"{what} step: {name} kernel vs autograd of the "
                    f"composition")
        del c_out, c_grads, out, grads
    rows, probs, alpha, beta = (x.contiguous() for x in cases["search"])
    g = torch.randn(rows.shape, generator=gen, device=dev)
    t, d = rows.shape
    moved = qat_bytes(t, d, len(bits))
    times = {
        "fwd": cuda_ms(lambda: qat_ops.mixed_expectation_fwd(
            rows, probs, alpha, beta, bits), 50),
        "fwd_plain": cuda_ms(lambda: mixed_expectation_fwd_ref(
            rows, probs, alpha, beta, bits), 10, warmup=1),
        "bwd": cuda_ms(lambda: qat_ops.mixed_expectation_bwd(
            rows, probs, alpha, beta, g, bits), 50),
        "bwd_plain": cuda_ms(lambda: mixed_expectation_bwd_ref(
            rows, probs, alpha, beta, g, bits, sum_dtype=torch.float64), 10,
            warmup=1),
    }
    bound = {k: v / HBM_BYTES_PER_S * 1e3 for k, v in moved.items()}
    for k in ("fwd", "bwd"):
        log(f"mpe_qat {k} at train_batch ({t} rows, d={d}, m={len(bits)}): "
            f"{times[k]:.4f} ms per call (plain {times[k + '_plain']:.4f} ms; "
            f"bound {bound[k]:.4f} ms for {moved[k]} bytes, "
            f"{bound[k] / times[k]:.1%} of it)")
    del cases, rows, probs, g

    # where the training path's peak memory comes from: the export of the
    # trained table, and one search step, each above what is live
    peaks = {}
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build_packed_table(fp["emb"], res["buffers"]["embedding"]["bits_idx"],
                       fp["alpha"], fp["beta"], mpe)
    torch.cuda.synchronize()
    peaks["export"] = torch.cuda.max_memory_allocated() - live
    # one traced search step from the searched parameters, its batch made
    # on the host included, as the training loop runs it
    trainer = Trainer(bundle["loss_fn"],
                      tree_map(lambda x: x.to(dev), res["search_params"]),
                      bundle["buffers"], bundle["state"], adam(1e-3))
    ptrs = [x.data_ptr() for x in leaves([trainer.params, trainer.carry["opt"]])]
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer.run(ds.batch, 1, log_every=0)             # warm
    peaks["search_step"] = torch.cuda.max_memory_allocated() - live
    peaks["live_at_step"] = live
    log(f"peak memory above what was live: export {peaks['export'] / 1e9:.3f} "
        f"GB, one search step {peaks['search_step'] / 1e9:.3f} GB "
        f"(with {live / 1e9:.3f} GB live, Adam's state included)")
    traced = trace(lambda: trainer.run(ds.batch, trainer.step + 1,
                                       log_every=0), 1)
    step_view = {k: traced[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                        "top")}
    step_view["batch_make_ms"] = trainer.history[-1]["data_ms"]
    log(f"traced search step: wall {traced['wall_ms']:.1f} ms (making its "
        f"batch {step_view['batch_make_ms']:.1f} ms), device busy "
        f"{traced['busy_ms']:.1f} ms (idle share {traced['idle_share']:.3f}); "
        f"top " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in traced["top"]))
    by_name = traced["by_name"].items()
    step_view["mpe_qat_ms"] = {
        "fwd": sum(ms for n, ms in by_name if "mpe_qat_fwd_kernel" in n),
        "bwd": sum(ms for n, ms in by_name if "mpe_qat_bwd_kernel" in n
                   or "mpe_qat_reduce_kernel" in n)}
    step_view["kernel_ms"] = step_kernel_ms(traced["by_name"])
    log(f"traced search step kernels (ms): {step_view['kernel_ms']}")
    prefetched = time_prefetched_steps(trainer, ds, step_view)

    # a search step's and a retrain step's own kernel inputs, recorded: the
    # mpe_qat backward, the gathers' segment sums (rows over the whole
    # table, group probabilities; the retrain step's rows) and the Adam
    # pass against their plain versions; in place, and a NaN step skipped
    def device_batch(k):
        return {key: torch.from_numpy(np.asarray(v)).to(dev)
                for key, v in ds.batch(k).items()}
    recorded = {}
    n_steps = SEARCH_STEPS + RETRAIN_STEPS
    recorded["dlrm search"] = check_step_inputs(
        trainer, device_batch(n_steps), trainer.step, "dlrm search")
    check_in_place_and_skip(trainer, device_batch(n_steps + 1),
                            trainer.step + 1, ptrs, "dlrm search")
    del trainer, bundle
    rb = build(SEED, "mpe_retrain", {**mpe._asdict(), "init_emb": fp["emb"],
                                     "alpha": fp["alpha"], "beta": fp["beta"],
                                     "bits_idx": res["buffers"]["embedding"][
                                         "bits_idx"]})
    del rb["params"]                          # the retrained ones are used
    trainer = Trainer(rb["loss_fn"],
                      tree_map(lambda x: x.to(dev, copy=True),
                               res["final_params"]),
                      res["buffers"],
                      tree_map(lambda x: x.to(dev, copy=True), res["state"]),
                      adam(1e-3))
    ptrs = [x.data_ptr() for x in leaves([trainer.params, trainer.carry["opt"]])]
    recorded["dlrm retrain"] = check_step_inputs(
        trainer, device_batch(n_steps + 2), RETRAIN_STEPS, "dlrm retrain")
    check_in_place_and_skip(trainer, device_batch(n_steps + 3),
                            RETRAIN_STEPS + 1, ptrs, "dlrm retrain")
    del trainer, rb
    for what, gathers in (("dlrm search", 2), ("dlrm retrain", 1)):
        r = recorded[what]
        check(len(r["mpe_qat"]) == 1 and len(r["segment_sum"]) == gathers,
              f"{what} step: {len(r['mpe_qat'])} mpe_qat backward and "
              f"{len(r['segment_sum'])} segment-sum calls recorded, not 1 "
              f"and {gathers}")
    return {"errs": errs, "times": times, "bytes": moved, "bound_ms": bound,
            "rows": t, "traced_step": step_view, "peaks": peaks,
            "step_inputs": recorded, "prefetched": prefetched}


def prefetch_depth() -> int:
    """Read-ahead workers the host's cores can feed: one core is the
    training loop's."""
    return max(2, min(PREFETCH_MAX_DEPTH, (os.cpu_count() or 2) - 1))


class TimedBatches:
    """``ds.batch`` with the host ms of each call kept, on whichever thread
    makes it: a batch made on a worker beside the step's thread shows here
    whether the two contend."""

    def __init__(self, batch_fn):
        self.batch_fn, self.ms, self._lock = batch_fn, [], threading.Lock()

    def __call__(self, step: int) -> dict:
        t0 = time.perf_counter()
        batch = self.batch_fn(step)
        with self._lock:
            self.ms.append((time.perf_counter() - t0) * 1e3)
        return batch


def timed_search_steps(trainer, ds, depth: int) -> dict:
    """``depth`` search steps untimed (a pipeline's read-ahead fills), then
    ``PREFETCH_STEPS`` timed, synchronous (``depth`` 0) or through a
    pre-built ``PrefetchPipeline(depth=depth)``: the wall ms a step (host
    clock to a synchronize), the ms each step waited for its batch
    (``Trainer.history``'s ``data_ms``) and the ms making a batch took."""
    make = TimedBatches(ds.batch)
    pipe = (PrefetchPipeline(make, depth=depth, device=trainer.device)
            if depth else False)
    try:
        trainer.run(make, trainer.step + max(depth, 1), log_every=0,
                    prefetch=pipe)
        torch.cuda.synchronize()
        first, made = len(trainer.history), len(make.ms)
        t0 = time.perf_counter()
        trainer.run(make, trainer.step + PREFETCH_STEPS, log_every=0,
                    prefetch=pipe)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PREFETCH_STEPS
        traced = (trace(lambda: trainer.run(make, trainer.step + 1,
                                            log_every=0, prefetch=pipe), 3)
                  if depth > 1 else None)
    finally:
        if pipe:
            pipe.close()
    data_ms = [h["data_ms"] for h in trainer.history[first:first + PREFETCH_STEPS]]
    make_ms = make.ms[made:made + PREFETCH_STEPS]
    out = {"depth": depth, "steps": PREFETCH_STEPS, "wall_ms": wall_ms,
           "data_ms": float(np.mean(data_ms)),
           "data_ms_max": float(np.max(data_ms)),
           "make_ms": float(np.mean(make_ms))}
    if traced is not None:
        out.update({"traced_wall_ms": traced["wall_ms"],
                    "busy_ms": traced["busy_ms"],
                    "idle_share": traced["idle_share"]})
    return out


def time_prefetched_steps(trainer, ds, sync_view: dict) -> dict:
    """Search steps at ``train_batch`` by one measure (``timed_search_steps``)
    synchronous, through a depth-1 pipeline (``prefetch=True``'s depth) and
    through a pre-built ``PrefetchPipeline(ds.batch, depth=k)`` passed as
    ``run(prefetch=...)``, in the order sync, 1, k, 1, sync so that a drift
    of the host shows; the depth-k steps also traced for the device's busy
    ms, beside the synchronous step traced above (``sync_view``)."""
    k = prefetch_depth()
    runs = [timed_search_steps(trainer, ds, depth) for depth in (0, 1, k, 1, 0)]
    for r in runs:
        log(f"search steps at depth {r['depth']}: {r['wall_ms']:.1f} ms a step "
            f"over {r['steps']} (waiting for the batch {r['data_ms']:.1f} ms, "
            f"at most {r['data_ms_max']:.1f}; making one {r['make_ms']:.1f} ms)")
    deep = runs[2]
    out = {"depth": k, "cpu_count": os.cpu_count(), "steps": PREFETCH_STEPS,
           "runs": runs, "wall_ms": deep["wall_ms"], "data_ms": deep["data_ms"],
           "data_ms_max": deep["data_ms_max"],
           "traced_wall_ms": deep["traced_wall_ms"], "busy_ms": deep["busy_ms"],
           "idle_share": deep["idle_share"],
           "sync_wall_ms": sync_view["wall_ms"],
           "sync_batch_make_ms": sync_view["batch_make_ms"],
           "sync_busy_ms": sync_view["busy_ms"]}
    for name, depth in (("sync", 0), ("depth1", 1)):
        out[f"{name}_steady_wall_ms"] = [r["wall_ms"] for r in runs
                                         if r["depth"] == depth]
    log(f"prefetched search steps (depth {k} on {os.cpu_count()} cores): "
        f"{deep['wall_ms']:.1f} ms a step; traced {deep['traced_wall_ms']:.1f} "
        f"ms, device busy {deep['busy_ms']:.1f} ms (idle share "
        f"{deep['idle_share']:.3f}); synchronous "
        f"{out['sync_steady_wall_ms']} ms, depth 1 "
        f"{out['depth1_steady_wall_ms']} ms a step; the synchronous step "
        f"traced above: {sync_view['wall_ms']:.1f} ms, its batch "
        f"{sync_view['batch_make_ms']:.1f} ms, busy {sync_view['busy_ms']:.1f} ms")
    return out


def step_inputs_by_model(step, sasrec_inputs, bst_inputs, extra=()) -> tuple:
    """(name, ``check_step_inputs`` result) of every recorded step: DLRM's
    search and retrain steps, a SASRec and a BST step, and the ``extra``
    (name, result) pairs (the Table-3 baselines' steps)."""
    return (*step["step_inputs"].items(), ("sasrec", sasrec_inputs),
            ("bst", bst_inputs), *extra)


def qat_records(grid_errs, train, step, sasrec_inputs, bst_inputs,
                extra=()) -> list:
    """The ``mpe_qat`` records: ms at DLRM's ``train_batch`` (as before),
    and under ``shapes`` at each lookup of a recorded DLRM search and
    retrain step, a SASRec step, a BST step and the baselines' steps."""
    recorded = step_inputs_by_model(step, sasrec_inputs, bst_inputs, extra)
    rec = []
    for k, line in (("fwd", 104), ("bwd", 126)):
        name = f"mixed_expectation_{k}"
        shapes = {"dlrm train_batch": {
            "rows": step["rows"], "ms": step["times"][k],
            "plain_ms": step["times"][k + "_plain"],
            "bound_ms": step["bound_ms"][k]}}
        for model, inputs in recorded:
            for i, r in enumerate(inputs["mpe_qat"]):
                shapes[f"{model} lookup {i}"] = {
                    "rows": r["rows"], "d": r["d"], "ms": r[k + "_ms"],
                    "plain_ms": r[k + "_plain_ms"],
                    "bound_ms": r[k + "_bound_ms"],
                    "max_abs_err": r["max_abs_err_" + k]}
        rec.append({"name": name, "route": "cuda", "source": QAT_SOURCE,
                    "replaces": f"src/repro/kernels/mpe_qat/kernel.py:{line}",
                    "launches": train["launches"][name],
                    "max_abs_err": max(grid_errs[k == "bwd"], step["errs"][k],
                                       *(inputs["errs"]["qat_" + k]
                                         for _, inputs in recorded)),
                    "ms": step["times"][k], "plain_ms": step["times"][k + "_plain"],
                    "bound_ms": step["bound_ms"][k], "bound_by": "bytes",
                    "library_ms": None, "bytes": step["bytes"][k],
                    "rows": step["rows"], "shapes": shapes})
    return rec


def segment_sum_record(train, step, sasrec_inputs, bst_inputs, extra=(),
                       grid=(), named=None) -> dict:
    """The gathers' backward: ms at the SASRec step's gather with the
    hottest segment, every gather of the recorded DLRM, SASRec, BST and
    baseline steps and the grid's cases under ``shapes``, with the
    ``named`` ones (GIN's scatters); the largest |difference| also as a
    share of its gather's largest |gradient|."""
    shapes = {f"{model} gather {i} ({r['rows']} x {r['w']} -> {r['n']})": r
              for model, inputs in step_inputs_by_model(step, sasrec_inputs,
                                                        bst_inputs, extra)
              for i, r in enumerate(inputs["segment_sum"])}
    shapes.update({f"grid ({r['rows']} x {r['w']} -> {r['n']})": r
                   for r in grid})
    shapes.update(named or {})
    head = max(sasrec_inputs["segment_sum"], key=lambda r: r["hot_segment"])
    return {"name": "segment_sum", "route": "cuda", "source": SEG_SOURCE,
            "replaces": "aten::embedding_dense_backward, the backward of the "
                        "lookups' two F.embedding gathers (no TPU kernel)",
            "launches": train["launches"]["segment_sum"],
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "max_err_over_max_want": max(r["max_err_over_max_want"]
                                         for r in shapes.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": head["library_ms"],
            "library_call": "torch.ops.aten.embedding_dense_backward(grad, ids, "
                            "n, -1, False)",
            "bytes": head["bytes"], "shapes": shapes}


def adam_record(train, step, sasrec_inputs, bst_inputs, extra=(),
                schedule=None) -> dict:
    """The in-place Adam pass: ms on the BST table, each recorded step's
    largest leaf under ``shapes`` (and a scheduled step's, ``schedule``);
    bit-identical to the plain chain (max_abs_err 0)."""
    bst = bst_inputs["adam"]
    return {"name": "adam_step_", "route": "cuda", "source": ADAM_SOURCE,
            "replaces": "the Trainer's elementwise passes over whole trees "
                        "(clip scaling, Adam moments, update, apply, the "
                        "guard's selects) in src/repro_torch/train/"
                        "optimizer.py and loop.py; no TPU kernel",
            "launches": train["launches"]["adam_step_"], "max_abs_err": 0.0,
            "ms": bst["ms"], "plain_ms": bst["plain_ms"],
            "bound_ms": bst["bound_ms"], "bound_by": "bytes",
            "library_ms": bst["library_ms"],
            "library_call": "torch._fused_adamw_ on the same leaf",
            "bytes": bst["bytes"],
            "shapes": {**{f"{model} largest leaf": inputs["adam"]
                          for model, inputs in step_inputs_by_model(
                              step, sasrec_inputs, bst_inputs, extra)},
                       **({"dlrm reduced, adam(warmup_cosine)": schedule}
                          if schedule else {})}}


def heads_flat(x: torch.Tensor) -> torch.Tensor:
    """The plain versions' layout: (B, S, H, hd) -> (B·H, S, hd); a
    (B·H, S, hd) tensor as it is."""
    if x.ndim == 4:
        b, s, h, hd = x.shape
        return x.transpose(1, 2).reshape(b * h, s, hd)
    return x


def flash_route(s: int) -> str:
    """The kernels' route for a sequence length (csrc/flash_attention.cu)."""
    return "staged" if s <= flash_ops.MAX_STAGED else "tiled"


def check_flash(q, k, v, do, causal: bool, what: str, errs: dict) -> None:
    """The three flash kernels on q, k, v, do ((BH, S, hd), or (B, S, H, hd)
    with lse (B, H, S)) against their plain versions on the same inputs: o
    and lse within ``FLASH_TOL``, dq, dk, dv within ``FLASH_BWD_TOL``, the
    backward twice bit-identical. Raises on a miss; records the largest
    |differences| in ``errs`` ({kind: float})."""
    o = flash_ops.flash_attention_fwd(q, k, v, causal)
    o2, lse = flash_ops.flash_attention_fwd_stats(q, k, v, causal)
    grads = flash_ops.flash_attention_bwd(q, k, v, o2, lse, do, causal)
    again = flash_ops.flash_attention_bwd(q, k, v, o2, lse, do, causal)
    torch.cuda.synchronize()
    if q.ndim == 4:
        lse = lse.reshape(-1, lse.shape[-1])
    flat = [heads_flat(x) for x in (q, k, v, do, o, o2)]
    want_o, want_lse = fwd_stats_ref(*flat[:3], causal)
    want = bwd_ref(*flat[:3], flat[5], lse, flat[3], causal)
    errs["fwd"] = max(errs["fwd"], within(flat[4], want_o, FLASH_TOL,
                                          f"{what}: o"))
    errs["fwd_stats"] = max(errs["fwd_stats"],
                            within(flat[5], want_o, FLASH_TOL, f"{what}: o (stats)"),
                            within(lse, want_lse, FLASH_TOL, f"{what}: lse"))
    for name, x, w in zip(("dq", "dk", "dv"), grads, want):
        errs["bwd"] = max(errs["bwd"], within(heads_flat(x), w, FLASH_BWD_TOL,
                                              f"{what}: {name}"))
    check(all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"{what}: two backward runs gave different bits")


def phase_flash_grid(dev) -> dict:
    """The three flash attention kernels against their plain versions, on
    (BH, S, hd) and on the models' (B, S, H, hd): at H = 8, and at the LM's
    H = 16 with hd 64 and 128 over S {65, 100, 127, 384, 1,024} (partial
    key tiles at 100 and 127); both routes (S <= 64 staged, S > 64 tiled).
    Returns the largest |differences| by kernel, and by route."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    routes = {r: {"S": set(), "cases": 0,
                  "errs": {"fwd": 0.0, "fwd_stats": 0.0, "bwd": 0.0}}
              for r in ("staged", "tiled")}
    cases = [((bh, s, hd), causal) for causal in (True, False)
             for bh in (1, 3, 37) for s in (8, 21, 32, 50, 64, 65, 128, 256)
             for hd in (4, 16, 50, 64, 128)]
    heads = [((b, s, 8, hd), causal) for causal in (True, False)
             for b in (1, 3) for s in (8, 21, 50, 64, 65, 128)
             for hd in (4, 16, 50)]
    heads += [((2, s, 16, hd), causal) for causal in (True, False)
              for s in (65, 100, 127, 384, 1024) for hd in (64, 128)]
    cases += heads
    for shape, causal in cases:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(4))
        route = routes[flash_route(shape[1])]
        check_flash(q, k, v, do, causal, f"flash {shape} causal={causal}",
                    route["errs"])
        route["S"].add(shape[1])
        route["cases"] += 1
    errs = {kind: max(r["errs"][kind] for r in routes.values())
            for kind in ("fwd", "fwd_stats", "bwd")}
    errs["routes"] = {name: {**r, "S": sorted(r["S"])}
                      for name, r in routes.items()}
    log(f"flash grid: {len(cases)} cases ({routes['staged']['cases']} staged, "
        f"{routes['tiled']['cases']} tiled; H = 8 and 16 through the (B, S, H, "
        f"hd) wrappers in {len(heads)}) within the contracts, the backward "
        f"repeatable; max |diff| o {errs['fwd']:.3e}, o and lse "
        f"{errs['fwd_stats']:.3e}, dq/dk/dv {errs['bwd']:.3e}")
    return errs


def zipf_prior(n: int) -> np.ndarray:
    """Zipf(1.1) access probabilities of items ranked by popularity."""
    p = np.arange(1, n + 1, dtype=np.float64) ** -ZIPF_A
    return p / p.sum()


def zipf_ids(rng, cdf: np.ndarray, shape) -> np.ndarray:
    ids = np.searchsorted(cdf, rng.random(shape), side="right")
    return np.minimum(ids, len(cdf) - 1).astype(np.int32)


def _plain_flash(q, k, v, *, n_kv_heads=None, causal=True):
    """``flash_attention`` through its plain version: the yardstick of the
    served scores."""
    b, s, h, hd = q.shape
    flat = [x.transpose(1, 2).reshape(b * h, s, hd) for x in (q, k, v)]
    return flash_attention_ref(*flat, causal).reshape(b, h, s, hd).transpose(1, 2)


def _plain_lookup(table, meta, ids):
    """The packed lookup through its plain version."""
    return packed_lookup_ref(table, meta, ids.reshape(-1)).reshape(
        *ids.shape, meta["d"])


def with_plain_kernels(fn):
    """``fn()`` with attention and the packed lookup through their plain
    versions; launches it makes are a comparison's and are not counted."""
    kernels, before = (attention_module.flash_attention,
                       compressors.packed_lookup), counts()
    attention_module.flash_attention = _plain_flash
    compressors.packed_lookup = _plain_lookup
    try:
        return fn()
    finally:
        attention_module.flash_attention, compressors.packed_lookup = kernels
        for name, n in before.items():
            COUNTERS[name].launches = n


def captured(fn, wrappers: dict, writes=None) -> dict:
    """``fn()`` with each kernel wrapper named in ``wrappers`` ({name: the
    module its caller looks it up in}) recording the arguments of its calls;
    returns {name: [args, ...]}, keyword arguments as a dict after the
    positional ones. A wrapper named in ``writes`` ({name: positions of the
    arguments it updates in place}) ends each record with host copies of
    those arguments taken before the call (a whole table's copies would
    not fit on the card beside it). The launches ``fn`` makes are a
    comparison's and are not counted."""
    calls, before = {name: [] for name in wrappers}, counts()
    writes = writes or {}

    def recorder(name):
        def call(*args, **kw):
            record = tuple(x.detach() if torch.is_tensor(x) else x
                           for x in args) + ((kw,) if kw else ())
            if name in writes:
                record += (tuple(args[i].detach().to("cpu", copy=True)
                                 for i in writes[name]),)
            calls[name].append(record)
            return COUNTERS[name](*args, **kw)
        call.launches = 0       # the wrapper counts under its module's name
        return call
    for name, module in wrappers.items():
        setattr(module, name, recorder(name))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for name, module in wrappers.items():
            setattr(module, name, COUNTERS[name])
        for name, n in before.items():
            COUNTERS[name].launches = n
    return calls


def time_qat(rows, probs, alpha, beta, g, bits, what: str) -> dict:
    """The ``mpe_qat`` kernels timed on a path's own inputs beside their
    plain versions and the byte bound (``qat_bytes``)."""
    t, d = rows.shape
    moved = qat_bytes(t, d, len(bits))
    iters = 50 if t * d < 50_000_000 else 20
    out = {"rows": t, "d": d, "bytes": moved}
    out.update(uncounted(lambda: {
        "fwd_ms": cuda_ms(lambda: qat_ops.mixed_expectation_fwd(
            rows, probs, alpha, beta, bits), iters),
        "fwd_plain_ms": cuda_ms(lambda: mixed_expectation_fwd_ref(
            rows, probs, alpha, beta, bits), 3, warmup=1),
        "bwd_ms": cuda_ms(lambda: qat_ops.mixed_expectation_bwd(
            rows, probs, alpha, beta, g, bits), iters),
        "bwd_plain_ms": cuda_ms(lambda: mixed_expectation_bwd_ref(
            rows, probs, alpha, beta, g, bits, sum_dtype=torch.float64), 3,
            warmup=1)}))
    for k in ("fwd", "bwd"):
        out[f"{k}_bound_ms"] = moved[k] / HBM_BYTES_PER_S * 1e3
        log(f"mpe_qat {k} at {what} ({t} x {d}): {out[k + '_ms']:.4f} ms a "
            f"call (plain {out[k + '_plain_ms']:.4f} ms; bound "
            f"{out[k + '_bound_ms']:.4f} ms for {moved[k]} bytes, "
            f"{out[k + '_bound_ms'] / out[k + '_ms']:.1%} of it)")
    return out


def segment_sum_bound(grad, ids, n, want) -> torch.Tensor:
    """The elementwise bound on |kernel - plain version| of ``SEG_RTOL``:
    2^-22·|want| + c·2^-52·Σ|rows| for a segment of c rows, 0 where a row
    has no id."""
    count = torch.bincount(ids, minlength=n).double()[:, None]
    bound = segment_sum_ref(grad.abs(), ids, n).double().mul_(count)
    del count
    return bound.mul_(2.0 ** -52).add_(want.abs().double(), alpha=SEG_RTOL)


def segment_sum_split(grad, ids, n, reps: int = 3) -> dict:
    """The segment sum's wrapper taken apart at one call's shape: the stable
    sort and the zeroed gradient timed alone with CUDA events, the chunk and
    combine kernels' device ms a launch from ``reps`` traced calls (the
    mean over the launches the trace holds: it now and then misses a
    window's first kernel), and the scratch bytes the kernel takes beside
    its output."""
    w = grad.shape[1]
    traced = uncounted(lambda: trace(
        lambda: seg_ops.segment_sum(grad, ids, n), reps))

    def per_launch(kernel: str) -> float:
        names = [k for k in traced["by_name"] if kernel in k]
        count = sum(traced["launches_by_name"][k] for k in names)
        total = sum(traced["by_name"][k] for k in names) * reps
        return total / count if count else 0.0
    return {"sort_ms": cuda_ms(lambda: torch.sort(ids.to(torch.int32),
                                                  stable=True), 3, warmup=1),
            "zeros_ms": cuda_ms(lambda: torch.zeros((n, w), device=grad.device),
                                3, warmup=1),
            "chunk_ms": per_launch("segment_chunk_kernel"),
            "combine_ms": per_launch("segment_combine_kernel"),
            "scratch_bytes": seg_ops.scratch_bytes(grad.shape[0], w)}


def check_segment_sums(calls, what: str) -> list:
    """Each recorded gather backward (grad, ids, n): the kernel against its
    plain version on the ids renumbered over the rows they touch (the same
    sums in a (rows touched, w) gradient: two float64 copies of a whole
    41.9 M x 64 table's would not fit beside the kernel's outputs), held to
    ``segment_sum_bound`` there (float64 in both, other orders, so a row of
    a rounding-size gradient is held to its own size); every row no id
    touches 0; twice bit-identical; then timed (its wrapper: the sort, the
    zeroed gradient and the kernels) beside the plain version, the
    library's dense backward in float32 (the call it replaces on the path)
    and the byte bound (the gradient rows, the ids, the dense output), and
    taken apart (``segment_sum_split``)."""
    out = []
    for grad, ids, n in calls:
        t, w = grad.shape
        label = f"{what}: segment_sum ({t} x {w} -> {n})"
        got, again = uncounted(lambda: (seg_ops.segment_sum(grad, ids, n),
                                        seg_ops.segment_sum(grad, ids, n)))
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{label}: two runs gave other bits")
        del again
        uniq, inv = torch.unique(ids.long(), return_inverse=True)
        want = segment_sum_ref(grad, inv, uniq.numel())
        diff = (got[uniq].double() - want.double()).abs()
        inside = bool((diff <= segment_sum_bound(grad, inv, uniq.numel(),
                                                 want)).all())
        err, top = float(diff.max()), float(want.abs().max())
        differ, nonzero = int((diff > 0).sum()), int((want != 0).sum())
        del diff
        got.index_fill_(0, uniq, 0.0)
        log(f"{label}: {differ} of {want.numel()} touched elements differ "
            f"({nonzero} nonzero), max |diff| {err:.3e}, "
            f"{err / max(top, 1e-30):.3e} of max |want| {top:.3e}")
        check(inside, f"{label}: outside 2^-22·|want| + c·2^-52·Σ|rows| of "
              f"the plain version (max |diff| {err:.3e})")
        check(not bool(got.any()), f"{label}: a row no id touches is not 0")
        hot = int(torch.bincount(inv).max())
        del got, want, uniq, inv
        nbytes = grad.numel() * 4 + ids.numel() * ids.element_size() + n * w * 4
        row = {"rows": t, "w": w, "n": n, "hot_segment": hot,
               "max_abs_err": err, "max_abs_want": top,
               "max_err_over_max_want": err / max(top, 1e-30),
               "elements_differ": differ, "bytes": nbytes,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        row.update(uncounted(lambda: {
            "ms": cuda_ms(lambda: seg_ops.segment_sum(grad, ids, n), 10),
            "plain_ms": cuda_ms(lambda: segment_sum_ref(grad, ids, n), 3,
                                warmup=1),
            "library_ms": cuda_ms(
                lambda: torch.ops.aten.embedding_dense_backward(
                    grad, ids, n, -1, False), 3, warmup=1)}))
        row["split"] = segment_sum_split(grad, ids, n)
        log(f"{label}, hot segment {hot} rows: {row['ms']:.4f} ms a call "
            f"(plain {row['plain_ms']:.4f} ms; library dense backward "
            f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms, "
            f"{row['bound_ms'] / row['ms']:.1%} of it); split {row['split']}")
        out.append(row)
    return out


def fused_adamw_ms(p, g, m, v, hyper) -> float | None:
    """``torch._fused_adamw_`` on copies of one leaf's tensors (timed only:
    the library's one call for an AdamW step; its decay and clip differ)."""
    ps, ms_, vs = p.clone(), m.clone(), v.clone()
    steps = [torch.ones((), device=p.device)]

    def call():
        torch._fused_adamw_([ps], [g], [ms_], [vs], [], steps, lr=hyper["lr"],
                            beta1=hyper["b1"], beta2=hyper["b2"],
                            weight_decay=hyper["weight_decay"],
                            eps=hyper["eps"], amsgrad=False, maximize=False)
    try:
        return cuda_ms(call, 10)
    except (AttributeError, RuntimeError, TypeError) as err:
        log(f"torch._fused_adamw_ not timed: {err}")
        return None


def leaf_slices(p) -> list:
    """Row ranges of about ``ADAM_SLICE`` elements of a leaf of two or more
    dimensions (a slice keeps the leaf's ndim, on which the decay keys);
    the whole leaf (``...``) otherwise."""
    if p.ndim < 2:
        return [...]
    rows = max(1, ADAM_SLICE // p[0].numel())
    return [slice(r, r + rows) for r in range(0, p.shape[0], rows)]


def check_adam(calls, what: str, timed: bool = True) -> dict:
    """Each recorded Adam pass (the live leaf, gradient and moments, and host
    copies of the leaf and moments from before the step; ``captured``
    with ``ADAM_WRITES``): what the step's own launch left, then what one
    more launch with the flag negated leaves (a skipped pass: every bit
    unchanged), each bit for bit against the plain chain on the host
    copies, one ``leaf_slices`` range at a time (a 2.7 G-element leaf's
    copies do not fit on the card beside it); the largest leaf timed on
    copies beside the plain chain, ``torch._fused_adamw_`` and the byte
    bound (p, m, v read and written, g read once)."""
    for p, g, m, v, scale, ok, bc1, bc2, hyper, pre in calls:
        flags = (ok, ~ok)
        for k, flag in enumerate(flags):
            if k:
                uncounted(lambda: adam_ops.adam_step_(p, g, m, v, scale, flag,
                                                      bc1, bc2, **hyper))
            for rows in leaf_slices(p):
                want = [x[rows].to(p.device, copy=True) for x in pre]
                for f in flags[:k + 1]:
                    adam_step_ref_(want[0], g[rows], want[1], want[2], scale,
                                   f, bc1, bc2, **hyper)
                check(all(torch.equal(x[rows], w)
                          for x, w in zip((p, m, v), want)),
                      f"{what}: the Adam pass on a {tuple(p.shape)} leaf "
                      f"differs from the plain chain (flag {bool(flag)}, "
                      f"{'one launch after ' if k else ''}the step's launch)")
                del want
    largest = max(calls, key=lambda c: c[0].numel())
    if not timed:
        log(f"{what}: Adam pass on {len(calls)} leaves bit-identical to the "
            f"plain chain, a skipped one bit-unchanged")
        return {"leaves": len(calls), **adam_leaf_row(largest, None)}
    base = adam_leaf_row(largest, what)
    row = {"leaves": len(calls), **base}
    dtypes = {c[0].dtype for c in calls}
    if len(dtypes) > 1:   # the largest leaf of each type (bf16 layers, the table)
        row["largest_by_dtype"] = {
            str(dt): base if dt == largest[0].dtype else adam_leaf_row(
                max((c for c in calls if c[0].dtype == dt),
                    key=lambda c: c[0].numel()), what)
            for dt in dtypes}
    log(f"{what}: Adam pass on {len(calls)} leaves bit-identical to the plain "
        f"chain, a skipped one bit-unchanged")
    return row


def adam_leaf_row(call, what: str | None) -> dict:
    """One recorded Adam pass's leaf: its bytes (p, m, v read and written,
    g read once) and byte bound and, where ``what`` is given, the pass timed
    on copies beside the plain chain and ``torch._fused_adamw_``."""
    p, g, m, v, scale, ok, bc1, bc2, hyper, _ = call
    nbytes = p.numel() * (3 * p.element_size() + 4 * m.element_size())
    row = {"elements": p.numel(), "dtype": str(p.dtype), "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "max_abs_err": 0.0}
    if what is None:
        return row
    p, m, v = (x.clone() for x in (p, m, v))
    row.update(uncounted(lambda: {
        "ms": cuda_ms(lambda: adam_ops.adam_step_(p, g, m, v, scale, ok, bc1,
                                                  bc2, **hyper), 10),
        "plain_ms": cuda_ms(lambda: adam_step_ref_(p, g, m, v, scale, ok, bc1,
                                                   bc2, **hyper), 3, warmup=1),
        "library_ms": fused_adamw_ms(p, g, m, v, hyper)}))
    log(f"{what}: the {tuple(p.shape)} {p.dtype} leaf's Adam pass "
        f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
        f"torch._fused_adamw_ {row['library_ms']} ms; bound "
        f"{row['bound_ms']:.4f} ms, {row['bound_ms'] / row['ms']:.1%} of it)")
    del p, m, v
    return row


def check_step_inputs(trainer, batch, step: int, what: str) -> dict:
    """One more training step with the ``mpe_qat`` backward, segment-sum and
    Adam wrappers recording their arguments; on those, each kernel against
    its plain version at the path's shapes, and timed. Returns the largest
    |difference| of each kernel and the times."""
    calls = captured(lambda: trainer.train_step(batch, step),
                     {"mixed_expectation_bwd": qat_ops, "segment_sum": seg_ops,
                      "adam_step_": optimizer_module}, writes=ADAM_WRITES)
    errs = {"qat_fwd": 0.0, "qat_bwd": 0.0}
    qat = []
    for i, (rows, probs, alpha, beta, g, bits) in enumerate(
            calls.pop("mixed_expectation_bwd")):
        label = f"{what} step: mpe_qat lookup {i} at {rows.shape[0]} x {rows.shape[1]}"
        f, b = uncounted(lambda: check_qat(rows, probs, alpha, beta, g, bits,
                                           label))
        errs["qat_fwd"], errs["qat_bwd"] = (max(errs["qat_fwd"], f),
                                            max(errs["qat_bwd"], b))
        qat.append({**time_qat(rows, probs, alpha, beta, g, bits, label),
                    "max_abs_err_fwd": f, "max_abs_err_bwd": b})
    seg = check_segment_sums(calls.pop("segment_sum"), f"{what} step")
    adam_row = check_adam(calls.pop("adam_step_"), f"{what} step")
    return {"errs": errs, "mpe_qat": qat, "segment_sum": seg, "adam": adam_row}


def step_kernel_ms(by_name: dict) -> dict:
    """Traced device ms of a step's ``mpe_qat``, segment-sum (and of that
    its combine pass), sort, Adam and library dense-embedding-backward
    kernels."""
    def total(*keys):
        return sum(ms for name, ms in by_name.items()
                   if any(k in name for k in keys))
    return {"mpe_qat_fwd": total("mpe_qat_fwd_kernel"),
            "mpe_qat_bwd": total("mpe_qat_bwd_kernel", "mpe_qat_reduce_kernel"),
            "segment_sum": total("segment_chunk_kernel",
                                 "segment_combine_kernel"),
            "segment_sum_combine": total("segment_combine_kernel"),
            "sort": total("RadixSort", "radix_sort"),
            "adam": total("adam_kernel"),
            "library_segment_sums": total(*LIBRARY_SEGMENT_KERNELS)}


def check_in_place_and_skip(trainer, batch, step: int, ptrs: list,
                            what: str) -> None:
    """Every parameter and moment leaf is still at the ``data_ptr`` it had
    when the trainer was made; a step whose loss is made NaN is skipped and
    leaves every leaf and Adam's step bit-unchanged."""
    carry = leaves([trainer.params, trainer.carry["opt"]])
    check([x.data_ptr() for x in carry] == ptrs,
          f"{what}: a parameter or moment leaf moved: not updated in place")
    before = [x.clone() for x in carry]
    loss_fn = trainer.loss_fn

    def nan_loss(*args, **kw):
        loss, aux = loss_fn(*args, **kw)
        return loss * torch.nan, aux
    trainer.loss_fn = nan_loss
    try:
        out = uncounted(lambda: trainer.train_step(batch, step))
    finally:
        trainer.loss_fn = loss_fn
    check(bool(out["skipped"]), f"{what}: a NaN step was not skipped")
    check(all(torch.equal(x, y) for x, y in zip(
        leaves([trainer.params, trainer.carry["opt"]]), before)),
          f"{what}: a skipped step changed a parameter or moment bit")
    log(f"{what}: {len(ptrs)} parameter and moment leaves updated in place; "
        f"a NaN step skipped, every bit kept (Adam's step "
        f"{int(trainer.carry['opt']['step'])})")


def serve_cfg(cfg, n: int):
    """The serving twin of a SASRec config: the packed table's meta."""
    mpe = as_mpe_config(cfg.comp_cfg)
    return cfg._replace(compressor="packed",
                        comp_cfg={"bits": mpe.bits, "d": cfg.d_embed, "n": n})


def check_scores(params, buffers, cfg, seq, cand, what: str) -> dict:
    """``score_candidates`` through the kernels: two plain flash forwards and
    no forward with stats per encode, the lookup launched; then the scores
    against the same model with the plain attention (``SCORE_TOL``), and
    the indices wherever neighbouring scores differ by more than that."""
    with torch.inference_mode():
        before = counts()
        vals, idx = SASRec.score_candidates(params, buffers, seq, cand, cfg,
                                            top_k=TOP_K)
        torch.cuda.synchronize()
        launched = launched_since(before)
        want_vals, want_idx = with_plain_kernels(
            lambda: SASRec.score_candidates(params, buffers, seq, cand, cfg,
                                            top_k=TOP_K))
    check(launched["flash_attention_fwd"] == cfg.n_blocks
          and launched["flash_attention_fwd_stats"] == 0
          and launched["mpe_lookup"] == 2,
          f"{what}: launches {launched}; an encode must launch the flash "
          f"forward once a block, the forward with stats never")
    b = seq.shape[0]
    check(vals.shape == idx.shape == (b, TOP_K)
          and bool(torch.isfinite(vals).all()), f"{what}: bad top-k")
    err, distinct = check_topk(vals, idx, want_vals, want_idx, what)
    return {"launches": launched, "max_abs_err": err,
            "distinct_indices": distinct}


def check_topk(vals, idx, want_vals, want_idx, what: str) -> tuple:
    """Top-k scores (rows of falling scores) against the plain kernels'
    (``SCORE_TOL``), and the indices wherever neighbouring scores differ by
    more than that. Returns the largest |difference| and the number of
    distinct indices."""
    err = compare(vals, want_vals, SCORE_TOL, SCORE_TOL,
                  f"{what}: top-{TOP_K} scores vs plain kernels")
    tol = SCORE_TOL + SCORE_TOL * want_vals.abs()
    gap = -(want_vals[..., 1:] - want_vals[..., :-1])
    distinct = torch.ones_like(want_vals, dtype=torch.bool)
    distinct[..., 1:] &= gap > tol[..., 1:]
    distinct[..., :-1] &= gap > tol[..., :-1]
    check(torch.equal(idx[distinct], want_idx[distinct]),
          f"{what}: top-k indices differ where the scores are distinct")
    log(f"{what}: {int(distinct.sum())} of {distinct.numel()} top-k indices "
        f"distinct by more than the tolerance, all equal")
    return err, int(distinct.sum())


def time_requests(fn, reps: int) -> list:
    """Host-clock ms of ``fn`` up to a synchronize, ``reps`` times."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def serve_sasrec(params, buffers, cfg, rng, cdf, what: str,
                 bulk: bool) -> dict:
    """The p99 and retrieval cells (and, with ``bulk``, the bulk encode),
    with the launch counts set to 0 before and read after."""
    n = cfg.item_vocab
    dev = params["pos"].device
    seq = {shape: torch.from_numpy(zipf_ids(rng, cdf, (rows, cfg.seq_len))).to(dev)
           for shape, rows in (("serve_p99", SERVE_ROWS["serve_p99"]),
                               ("retrieval_cand", 1))}
    cand = {"serve_p99": rng.choice(n, SERVE_CANDS, replace=False),
            "retrieval_cand": rng.choice(n, N_CANDIDATES, replace=False)}
    cand = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
            for k, v in cand.items()}
    out = {}
    reset_counts()
    for shape in ("serve_p99", "retrieval_cand"):
        out[shape] = check_scores(params, buffers, cfg, seq[shape],
                                  cand[shape], f"{what}, {shape}")
        with torch.inference_mode():
            check_lookup_bits(recorded_lookups(
                lambda s=shape: SASRec.score_candidates(
                    params, buffers, seq[s], cand[s], cfg, top_k=TOP_K)),
                f"{what}, {shape}")
        with torch.inference_mode():
            ms = time_requests(lambda s=shape: SASRec.score_candidates(
                params, buffers, seq[s], cand[s], cfg, top_k=TOP_K), 10)
        out[shape]["request_ms"] = ms
        log(f"{what}, {shape}: request p50 {np.percentile(ms, 50):.3f} ms, "
            f"max {max(ms):.3f} ms of 10 (host clock to a synchronize)")
    if bulk:
        rows = SERVE_ROWS["serve_bulk"]
        ids = torch.from_numpy(zipf_ids(rng, cdf, (rows, cfg.seq_len))).to(dev)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            before = counts()
            h = SASRec.encode(params, buffers, ids, cfg)
            torch.cuda.synchronize()
            launched = launched_since(before)
            check(launched["flash_attention_fwd"] == cfg.n_blocks
                  and launched["flash_attention_fwd_stats"] == 0,
                  f"{what}, serve_bulk encode: launches {launched}")
            check(h.shape == (rows, cfg.seq_len, cfg.d_embed)
                  and bool(torch.isfinite(h).all()),
                  f"{what}, serve_bulk encode: bad hidden states")
            del h
            ms = time_requests(lambda: SASRec.encode(params, buffers, ids, cfg), 3)
            traced = trace(lambda: SASRec.encode(params, buffers, ids, cfg), 1,
                           expect=FLASH_FWD_NAME)
        flash_ms = flash_kernel_ms(traced["by_name"], "fwd")
        check(flash_ms > 0, f"{what}, serve_bulk encode: no flash forward in "
              f"the trace")
        out["serve_bulk"] = {"encode_ms": ms, "launches": launched,
                             "peak_bytes": torch.cuda.max_memory_allocated(),
                             "flash_ms": flash_ms,
                             **{k: traced[k] for k in ("wall_ms", "busy_ms",
                                                       "idle_share", "top")}}
        # the lookup alone at the bulk encode's and the retrieval
        # candidates' ids, as the path calls it
        with torch.inference_mode():
            encode_calls = recorded_lookups(lambda: SASRec.encode(
                params, buffers, ids, cfg))
            check_lookup_bits(encode_calls, f"{what}, serve_bulk encode")
            cand_calls = recorded_lookups(lambda: SASRec.score_candidates(
                params, buffers, seq["retrieval_cand"],
                cand["retrieval_cand"], cfg, top_k=TOP_K))
            out["lookup"] = {
                "sasrec serve_bulk encode": time_lookup(
                    *encode_calls[0], f"{what}, serve_bulk encode"),
                "sasrec retrieval_cand candidates": time_lookup(
                    *cand_calls[-1], f"{what}, retrieval_cand candidates")}
        log(f"{what}, serve_bulk: encode of {rows} sequences {min(ms):.3f} ms "
            f"(best of 3), peak memory "
            f"{out['serve_bulk']['peak_bytes'] / 1e9:.3f} GB; traced: device "
            f"busy {traced['busy_ms']:.1f} of {traced['wall_ms']:.1f} ms, "
            f"flash forward {flash_ms:.2f} ms, top "
            + "; ".join(f"{n} {t:.2f} ms" for n, t in traced["top"]))
    out["launches"] = counts()
    log(f"{what}: launches {out['launches']}")
    return out


def phase_sasrec_serve(dev, prior) -> dict:
    cfg = get_arch("sasrec").make_config()
    n = cfg.item_vocab
    log(f"sasrec: {n} items, d={cfg.d_embed}, {cfg.n_blocks} causal blocks, "
        f"{cfg.n_heads} head, S={cfg.seq_len}")
    scfg = serve_cfg(cfg, n)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, buffers, _ = SASRec.init(scfg, prior["freqs"], seed=SEED, device=dev)
    torch.cuda.synchronize()
    table = params["embedding"]
    ratio = Packed.storage_ratio(table, buffers["embedding"], scfg.comp_cfg)
    log(f"sasrec random packed table on the card: {time.perf_counter() - t0:.1f}"
        f" s; storage ratio {ratio:.6f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    rng = np.random.default_rng(SEED)
    out = serve_sasrec(params, buffers, scfg, rng, prior["cdf"],
                       "sasrec random table", bulk=True)
    return {**out, "storage_ratio": ratio}


def sasrec_batches(rng, cdf, n_items: int, s: int, dev) -> list:
    """Training batches made once on the host and moved to the card:
    Zipf(1.1) sequences, positives the sequence shifted by one, uniform
    negatives, every position valid."""
    out = []
    for _ in range(SASREC_BATCHES):
        seq = zipf_ids(rng, cdf, (TRAIN_ROWS, s + 1))
        batch = {"seq_ids": seq[:, :-1], "pos_ids": seq[:, 1:],
                 "neg_ids": rng.integers(0, n_items, (TRAIN_ROWS, s),
                                         dtype=np.int32),
                 "mask": np.ones((TRAIN_ROWS, s), np.float32)}
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in batch.items()})
    return out


def phase_sasrec_train(dev, prior) -> dict:
    cfg = get_arch("sasrec").make_config()
    rng = np.random.default_rng(SEED + 1)
    t0 = time.perf_counter()
    batches = sasrec_batches(rng, prior["cdf"], cfg.item_vocab, cfg.seq_len, dev)
    batch_s = time.perf_counter() - t0
    params, buffers, state = SASRec.init(cfg, prior["freqs"], seed=SEED,
                                         device=dev)

    def loss_fn(p, bu, st, batch, *, step=None):
        return SASRec.loss_fn(p, bu, st, batch, cfg, lam=SASREC_LAM,
                              train=True, step=step)

    trainer = Trainer(loss_fn, params, buffers, state, adam(1e-3))
    del params
    ptrs = [x.data_ptr() for x in leaves([trainer.params, trainer.carry["opt"]])]
    table_bytes = cfg_table_bytes(trainer.params["embedding"]["emb"])
    torch.cuda.synchronize()
    live_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outs, step_ms = [], []
    per_step = {"flash_attention_fwd_stats": cfg.n_blocks,
                "flash_attention_bwd": cfg.n_blocks, "flash_attention_fwd": 0,
                "mixed_expectation_fwd": 3, "mixed_expectation_bwd": 3,
                "segment_sum": 6, "adam_step_": len(leaves(trainer.params))}
    t_all = time.perf_counter()
    for step in range(SASREC_STEPS):
        before = counts()
        t0 = time.perf_counter()
        outs.append(trainer.train_step(batches[step % SASREC_BATCHES], step))
        if step == 0:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launched = launched_since(before)
        check(all(launched[k] == v for k, v in per_step.items()),
              f"step {step} launched {launched}, not {per_step}")
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t_all) * 1e3 - step_ms[0]
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(o["loss"]) for o in outs]
    check(all(np.isfinite(x) for x in losses), f"a loss was not finite: {losses}")
    check(not any(bool(o["skipped"]) for o in outs), "a step was skipped")
    log(f"sasrec train: {SASREC_STEPS} steps at {TRAIN_ROWS} sequences, "
        f"launches {launches}; first step {step_ms[0]:.1f} ms, then "
        f"{steady_ms / (SASREC_STEPS - 1):.1f} ms a step (host clock to a "
        f"synchronize over {SASREC_STEPS - 1} steps); peak memory "
        f"{peak / 1e9:.3f} GB, {peak / table_bytes:.2f} tables (two trees: "
        f"{TWO_TREE_PEAK_GB['sasrec']} GB; {live_before / 1e9:.3f} GB live "
        f"before); batches made in {batch_s:.1f} s; losses "
        f"{[round(x, 5) for x in losses]}")
    step_inputs = check_step_inputs(trainer, batches[0], SASREC_STEPS, "sasrec")
    check_in_place_and_skip(trainer, batches[1], SASREC_STEPS + 1, ptrs,
                            "sasrec train")

    # Eq. 11 sampling and the packed export of the trained table, served
    mpe = as_mpe_config(cfg.comp_cfg)
    emb = trainer.params["embedding"]
    fb = feature_bits(sample_group_bits(emb, mpe),
                      buffers["embedding"]["group_of_feature"])
    table, meta = build_packed_table(emb["emb"], fb, emb["alpha"], emb["beta"],
                                     mpe)
    scfg = serve_cfg(cfg, cfg.item_vocab)
    sparams = {**trainer.params, "embedding": table}
    ratio = Packed.storage_ratio(table, {"meta": meta}, scfg.comp_cfg)
    log(f"sasrec trained table exported: storage ratio {ratio:.6f}")
    served = serve_sasrec(sparams, {"embedding": {"meta": meta}}, scfg, rng,
                          prior["cdf"], "sasrec trained table", bulk=False)
    del sparams, table

    traced = trace(lambda: trainer.train_step(batches[0], SASREC_STEPS), 1)
    step_view = {k: traced[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                        "top")}
    step_view["flash_ms"] = {kind: flash_kernel_ms(traced["by_name"], kind)
                             for kind in ("fwd", "bwd")}
    step_view["kernel_ms"] = step_kernel_ms(traced["by_name"])
    check(all(ms > 0 for ms in step_view["flash_ms"].values()),
          f"traced sasrec train step: flash kernels missing from the trace "
          f"({step_view['flash_ms']})")
    log(f"traced sasrec train step: wall {traced['wall_ms']:.1f} ms, device "
        f"busy {traced['busy_ms']:.1f} ms (idle share "
        f"{traced['idle_share']:.3f}); flash {step_view['flash_ms']}; "
        f"{step_view['kernel_ms']}; top "
        + "; ".join(f"{n} {ms:.2f} ms" for n, ms in traced["top"]))
    return {"launches": launches, "first_step_ms": step_ms[0],
            "step_ms": steady_ms / (SASREC_STEPS - 1), "peak_bytes": peak,
            "table_bytes": table_bytes, "peak_tables": peak / table_bytes,
            "live_bytes_before": live_before, "losses": losses,
            "storage_ratio": ratio, "served": served, "traced_step": step_view,
            "step_inputs": step_inputs}


def flash_work(bh: int, s: int, hd: int, kind: str, causal: bool = True) -> dict:
    """Bytes the function must move (each input read once, each output
    written once; the backward reads q, k, v, o, do and lse and writes dq,
    dk, dv, forming delta inside) and float32 operations of its products for
    these shapes (the causal ones skip the keys above the diagonal). The
    bound takes the products at the tensor pipe in split TF32 (three TF32
    products a product, the least the card needs for float32 accuracy);
    ``simt_bound_ms`` at the float32 rate outside the tensor cores, the
    bound earlier rows gave."""
    tensor, rows = 4 * bh * s * hd, 4 * bh * s
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    nbytes = {"fwd": 4 * tensor, "fwd_stats": 4 * tensor + rows,
              "bwd": 8 * tensor + rows}[kind]
    flops = (10 if kind == "bwd" else 4) * hd * pairs
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
            "simt_bound_ms": max(byte_ms, flops / F32_FLOPS_PER_S * 1e3)}


def bounds_text(row: dict) -> str:
    """A timed flash row's two bounds and its share of each."""
    return (f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} (tensor "
            f"pipe, split TF32): {row['bound_ms'] / row['ms']:.1%} of it; "
            f"SIMT bound {row['simt_bound_ms']:.4f} ms: "
            f"{row['simt_bound_ms'] / row['ms']:.1%}")


def sdpa_ms(q, k, v, do, iters: int, causal: bool) -> dict:
    """``F.scaled_dot_product_attention`` on the same inputs, as (B, H, S, hd)
    views ((BH, S, hd) as (BH, 1, S, hd)): forward alone, and forward plus
    backward. Timed only; the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (x.transpose(1, 2) if x.ndim == 4 else x.unsqueeze(1)
                       for x in (q, k, v, do))
    fwd = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=causal), iters)
    leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]

    def fwd_bwd():
        with torch.enable_grad():
            torch.autograd.grad(sdpa(*leaves, is_causal=causal), leaves, do4)
    return {"fwd": fwd, "fwd_bwd": cuda_ms(fwd_bwd, iters)}


def time_flash(q, k, v, do, causal: bool, kinds: tuple, iters: int,
               what: str) -> dict:
    """The flash kernels of ``kinds`` on these inputs ((BH, S, hd), or
    (B, S, H, hd) as the models call them), each held against its plain
    version on the same inputs (``FLASH_TOL``, ``FLASH_BWD_TOL``, the
    backward twice bit-identical), then CUDA-event ms per call beside its
    bound, its plain version (on (B·H, S, hd)) and SDPA."""
    flat = [heads_flat(x) for x in (q, k, v, do)]
    bh, s, hd = flat[0].shape
    plain_iters = max(iters // 4, 2)
    lib = sdpa_ms(q, k, v, do, iters, causal)
    row = {}
    if "fwd" in kinds:
        err = within(heads_flat(flash_ops.flash_attention_fwd(q, k, v, causal)),
                     flash_attention_ref(*flat[:3], causal), FLASH_TOL,
                     f"{what}: o")
        row["fwd"] = {
            **flash_work(bh, s, hd, "fwd", causal), "max_abs_err": err,
            "ms": cuda_ms(lambda: flash_ops.flash_attention_fwd(q, k, v, causal),
                          iters),
            "plain_ms": cuda_ms(lambda: flash_attention_ref(*flat[:3], causal),
                                plain_iters, warmup=1),
            "library_ms": lib["fwd"]}
    if "fwd_stats" in kinds:
        o, lse = flash_ops.flash_attention_fwd_stats(q, k, v, causal)
        flat_lse = lse.reshape(-1, s)
        want_o, want_lse = fwd_stats_ref(*flat[:3], causal)
        err = max(within(heads_flat(o), want_o, FLASH_TOL, f"{what}: o (stats)"),
                  within(flat_lse, want_lse, FLASH_TOL, f"{what}: lse"))
        del want_o, want_lse
        row["fwd_stats"] = {
            **flash_work(bh, s, hd, "fwd_stats", causal), "max_abs_err": err,
            "ms": cuda_ms(lambda: flash_ops.flash_attention_fwd_stats(
                q, k, v, causal), iters),
            "plain_ms": cuda_ms(lambda: fwd_stats_ref(*flat[:3], causal),
                                plain_iters, warmup=1),
            "library_ms": lib["fwd"]}
    if "bwd" in kinds:
        flat_o = heads_flat(o)
        grads = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
        want = bwd_ref(*flat[:3], flat_o, flat_lse, flat[3], causal)
        err = max(within(heads_flat(x), w, FLASH_BWD_TOL, f"{what}: {name}")
                  for name, x, w in zip(("dq", "dk", "dv"), grads, want))
        del want
        again = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"{what}: two backward runs gave different bits")
        del grads, again
        row["bwd"] = {
            **flash_work(bh, s, hd, "bwd", causal), "max_abs_err": err,
            "ms": cuda_ms(lambda: flash_ops.flash_attention_bwd(
                q, k, v, o, lse, do, causal), iters),
            "plain_ms": cuda_ms(lambda: bwd_ref(*flat[:3], flat_o, flat_lse,
                                                flat[3], causal),
                                plain_iters, warmup=1),
            "library_ms": lib["fwd_bwd"]}
    for kind, r in row.items():
        r.update({"S": s, "input_shape": list(q.shape), "causal": causal})
        log(f"flash {kind} at {what} (BH={bh}, S={s}, hd={hd}, "
            f"{'causal' if causal else 'not causal'}, {tuple(q.shape)}): "
            f"max |diff| {r['max_abs_err']:.3e} against the plain version; "
            f"{r['ms']:.4f} ms per call (plain {r['plain_ms']:.4f} ms; "
            f"{r['bytes']} bytes, {r['flops']} flops, {bounds_text(r)}; SDPA "
            f"{'forward + backward' if kind == 'bwd' else 'forward'} "
            f"{r['library_ms']:.4f} ms)")
    return row


def phase_flash_times(dev) -> dict:
    """Each kernel at the paths' shapes: SASRec's (S = hd = 50, causal, one
    head) at ``train_batch``, ``serve_bulk`` and ``serve_p99``; BST's
    (S = 21, 8 heads of width 4, not causal, on (B, S, H, hd)) at its bulk
    apply and its training step. Held against the plain versions, then
    timed (``time_flash``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    s = hd = 50
    for shape, bh in (("train_batch", TRAIN_ROWS),
                      ("serve_bulk", SERVE_ROWS["serve_bulk"]),
                      ("serve_p99", SERVE_ROWS["serve_p99"])):
        q, k, v, do = (torch.randn((bh, s, hd), generator=gen, device=dev)
                       for _ in range(4))
        iters = 200 if bh <= 512 else (5 if bh > TRAIN_ROWS else 20)
        kinds = ("fwd", "fwd_stats", "bwd") if shape == "train_batch" else ("fwd",)
        out[shape] = time_flash(q, k, v, do, True, kinds, iters, shape)
        del q, k, v, do
    cfg = get_arch("bst").make_config()
    s, h = cfg.seq_len + 1, cfg.n_heads
    hd = max(cfg.d_embed // h, 4)
    for shape, b, kinds in (("bst_bulk_apply", SERVE_ROWS["serve_bulk"], ("fwd",)),
                            ("bst_train_step", TRAIN_ROWS, ("fwd_stats", "bwd"))):
        q, k, v, do = (torch.randn((b, s, h, hd), generator=gen, device=dev)
                       for _ in range(4))
        out[shape] = time_flash(q, k, v, do, False, kinds, 20, shape)
        del q, k, v, do
    return out


FLASH_FWD_NAME = "(anonymous namespace)::flash_fwd_"


def flash_kernel_ms(by_name: dict, kind: str) -> float:
    """Traced device ms of the port's flash kernels of ``kind`` ("fwd" or
    "bwd"), both routes: ``flash_fwd_kernel``, ``flash_fwd_tiled_kernel``,
    ``flash_bwd_kernel`` and the tiled backward's ``flash_bwd_dq_kernel``
    and ``flash_bwd_dkdv_kernel`` (not PyTorch's own ``pytorch_flash::``)."""
    return sum(ms for name, ms in by_name.items()
               if f"(anonymous namespace)::flash_{kind}_" in name)


def flash_records(grid_errs, serve, train, times, bst_errs) -> list:
    bulk, tb = times["serve_bulk"]["fwd"], times["train_batch"]
    rows = (("flash_attention_fwd", 214, "fwd", bulk,
             serve["launches"]["flash_attention_fwd"],
             "scaled_dot_product_attention, forward"),
            ("flash_attention_fwd_stats", 141, "fwd_stats", tb["fwd_stats"],
             train["launches"]["flash_attention_fwd_stats"],
             "scaled_dot_product_attention, forward (no logsumexp rows out)"),
            ("flash_attention_bwd", 176, "bwd", tb["bwd"],
             train["launches"]["flash_attention_bwd"],
             "scaled_dot_product_attention, forward + backward (no call for "
             "the backward alone)"))
    return [{"name": name, "route": "cuda", "source": FLASH_SOURCE,
             "replaces": f"src/repro/kernels/flash_attention/kernel.py:{line}",
             "launches": launches,
             "max_abs_err": max(grid_errs[kind], bst_errs.get(kind, 0.0), *(
                 row[kind]["max_abs_err"] for row in times.values()
                 if kind in row)),
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "simt_bound_ms": r["simt_bound_ms"],
             "library_ms": r["library_ms"],
             "library_call": call, "bytes": r["bytes"], "flops": r["flops"],
             "shapes": {shape: row[kind] for shape, row in times.items()
                        if kind in row},
             "routes": {route: {"S": g["S"], "grid_cases": g["cases"],
                                "max_abs_err": g["errs"][kind],
                                "timed": [shape for shape, row in times.items()
                                          if kind in row and flash_route(
                                              row[kind]["S"]) == route]}
                        for route, g in grid_errs["routes"].items()}}
            for name, line, kind, r, launches, call in rows]


def bag_case(gen, n, b, l, d, dev, id_dtype, float_mask):
    """Seeded bag inputs: a table (n, d), ids (b, l) of ``id_dtype``, a mask
    with random holes in which every fourth bag (1, 5, ...) is all masked,
    as bools or as float32 weights, and a cotangent (b, d)."""
    table = torch.randn((n, d), generator=gen, device=dev)
    ids = torch.randint(0, n, (b, l), generator=gen, device=dev).to(id_dtype)
    mask = torch.rand((b, l), generator=gen, device=dev) < 0.7
    mask[1::4] = False
    if float_mask:
        mask = mask * (0.5 + torch.rand((b, l), generator=gen, device=dev))
    g = torch.randn((b, d), generator=gen, device=dev)
    return table, ids, mask, g


def check_bag(table, ids, mask, g, what: str) -> tuple:
    """The bag kernel against its plain version on the same inputs, forward
    and backward within ``BAG_TOL``; both run twice give the same bits.
    Returns the largest |difference| of the forward and of the backward."""
    n = table.shape[0]
    out = bag_ops.embedding_bag_fwd(table, ids, mask)
    out2 = bag_ops.embedding_bag_fwd(table, ids, mask)
    grad = bag_ops.embedding_bag_bwd(g, ids, mask, n)
    grad2 = bag_ops.embedding_bag_bwd(g, ids, mask, n)
    torch.cuda.synchronize()
    fwd = within(out, embedding_bag_ref(table, ids, mask), BAG_TOL,
                 f"{what}: forward")
    bwd = within(grad, embedding_bag_bwd_ref(g, ids, mask, n), BAG_TOL,
                 f"{what}: backward")
    check(torch.equal(out, out2), f"{what}: two forward runs gave different bits")
    check(torch.equal(grad, grad2),
          f"{what}: two backward runs gave different bits")
    return fwd, bwd


def phase_bag_grid(dev) -> dict:
    """The bag kernel against its plain version over B × L × d × id type ×
    mask type."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"fwd": 0.0, "bwd": 0.0}
    cases = 0
    for id_dtype in (torch.int32, torch.int64):
        for float_mask in (False, True):
            for b in (1, 4, 16, 1024):
                for l in (1, 3, 7, 20, 50):
                    for d in (4, 8, 16, 32, 50, 64, 128):
                        f, bw = check_bag(*bag_case(gen, 5000, b, l, d, dev,
                                                    id_dtype, float_mask),
                                          f"bag grid b={b} l={l} d={d} "
                                          f"{id_dtype} float_mask={float_mask}")
                        errs["fwd"], errs["bwd"] = (max(errs["fwd"], f),
                                                    max(errs["bwd"], bw))
                        cases += 1
    log(f"bag grid: {cases} cases within rtol 1e-5 / atol 1e-6, forward and "
        f"backward repeatable; max |diff| forward {errs['fwd']:.3e}, backward "
        f"{errs['bwd']:.3e}")
    return errs


def bst_prior(cfg) -> dict:
    """Expected lookups a row of every feature of the BST table: the
    sequence and the target draw items from Zipf(1.1) over popularity
    ranks, each context field one of its ids uniformly."""
    items = zipf_prior(cfg.item_vocab)
    ctx = [np.full(f.vocab, 1.0 / f.vocab) for f in cfg.ctx_fields]
    return {"freqs": np.concatenate([(cfg.seq_len + 1) * items, *ctx]),
            "cdf": np.cumsum(items)}


def bst_batch(rng, cdf, cfg, rows: int, dev, *, one_history=False) -> dict:
    """A BST batch on the card: Zipf(1.1) histories and targets, uniform
    context ids, Bernoulli(0.5) labels. With ``one_history``, every row has
    the first row's history and context and its own target: one user's
    history against ``rows`` candidates."""
    hist = 1 if one_history else rows
    seq = zipf_ids(rng, cdf, (hist, cfg.seq_len))
    ctx = np.stack([rng.integers(0, f.vocab, hist, dtype=np.int32)
                    for f in cfg.ctx_fields], axis=1)
    target = (rng.choice(cfg.item_vocab, rows, replace=False).astype(np.int32)
              if one_history else zipf_ids(rng, cdf, (rows,)))
    batch = {"seq_ids": np.repeat(seq, rows // hist, axis=0),
             "target_id": target,
             "ctx_ids": np.repeat(ctx, rows // hist, axis=0),
             "label": (rng.random(rows) < 0.5).astype(np.int32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def bst_logits_plain(params, buffers, state, batch, cfg) -> torch.Tensor:
    """The same model with attention and the lookup through their plain
    versions, in chunks of rows (eval mode: rows are independent)."""
    rows = batch["label"].shape[0]
    out = []
    for lo in range(0, rows, BST_PLAIN_CHUNK):
        part = {k: v[lo:lo + BST_PLAIN_CHUNK] for k, v in batch.items()}
        out.append(with_plain_kernels(lambda p=part: BST.apply(
            params, buffers, state, p, cfg)[0]))
    return torch.cat(out)


def serve_bst(params, buffers, state, cfg, rng, cdf, what: str,
              shapes: tuple) -> dict:
    """BST served at ``shapes`` through the kernels, with the launch counts
    set to 0 before and read after: each apply must launch ``mpe_lookup``
    twice and the plain flash forward once a block; the logits (and at
    ``retrieval_cand`` the top 100) must equal the same model's with the
    plain attention and lookup (``SCORE_TOL``)."""
    dev = params["pos"].device
    out = {}
    reset_counts()
    for shape in shapes:
        one = shape == "retrieval_cand"
        rows = N_CANDIDATES if one else SERVE_ROWS[shape]
        batch = bst_batch(rng, cdf, cfg, rows, dev, one_history=one)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            before = counts()
            logits = BST.apply(params, buffers, state, batch, cfg)[0]
            top = torch.topk(logits, TOP_K) if one else None
            torch.cuda.synchronize()
            launched = launched_since(before)
            peak = torch.cuda.max_memory_allocated()
            check(launched["mpe_lookup"] == 2
                  and launched["flash_attention_fwd"] == cfg.n_blocks
                  and launched["flash_attention_fwd_stats"] == 0,
                  f"{what}, {shape}: launches {launched}; an apply must launch "
                  f"mpe_lookup twice and the plain flash forward once a block")
            check(logits.shape == (rows,) and bool(torch.isfinite(logits).all()),
                  f"{what}, {shape}: bad logits")
            want = bst_logits_plain(params, buffers, state, batch, cfg)
            cell = {"launches": launched, "peak_bytes": peak,
                    "max_abs_err": compare(logits, want, SCORE_TOL, SCORE_TOL,
                                           f"{what}, {shape}: logits vs plain "
                                           f"kernels")}
            if one:
                want_top = torch.topk(want, TOP_K)
                cell["distinct_indices"] = check_topk(
                    top.values, top.indices, want_top.values, want_top.indices,
                    f"{what}, {shape}")[1]
            del logits, want
            reps = 10 if rows <= SERVE_ROWS["serve_p99"] else 3

            def request(b=batch, one=one):
                logits = BST.apply(params, buffers, state, b, cfg)[0]
                return torch.topk(logits, TOP_K) if one else logits
            cell["request_ms"] = time_requests(request, reps)
            calls = recorded_lookups(request)
            check_lookup_bits(calls, f"{what}, {shape}")
            if shape == "serve_bulk":  # the apply's two lookups alone
                items, ctx = calls
                out["lookup"] = {
                    "bst serve_bulk items": time_lookup(
                        *items, f"{what}, serve_bulk items"),
                    "bst serve_bulk context": time_lookup(
                        *ctx, f"{what}, serve_bulk context")}
            if shape in ("serve_bulk", "retrieval_cand"):
                traced = trace(request, 1, expect=FLASH_FWD_NAME)
                cell.update({k: traced[k] for k in ("wall_ms", "busy_ms",
                                                    "idle_share", "top")})
                cell["flash_ms"] = flash_kernel_ms(traced["by_name"], "fwd")
                check(cell["flash_ms"] > 0, f"{what}, {shape}: no flash "
                      f"forward in the trace")
        out[shape] = cell
        log(f"{what}, {shape} ({rows} rows): request p50 "
            f"{np.percentile(cell['request_ms'], 50):.3f} ms, max "
            f"{max(cell['request_ms']):.3f} ms of {reps} (host clock to a "
            f"synchronize); peak memory {peak / 1e9:.3f} GB"
            + (f"; traced: device busy {cell['busy_ms']:.1f} of "
               f"{cell['wall_ms']:.1f} ms, flash forward {cell['flash_ms']:.2f}"
               f" ms, top " + "; ".join(f"{n} {t:.2f} ms" for n, t in cell["top"])
               if "top" in cell else ""))
        del batch
    out["launches"] = counts()
    log(f"{what}: launches {out['launches']}")
    return out


def phase_bst_serve(dev, prior) -> dict:
    cfg = get_arch("bst").make_config()
    n = total_vocab(fields(cfg))
    log(f"bst: {cfg.item_vocab} items + {len(cfg.ctx_fields)} context fields "
        f"= {n} features, d={cfg.d_embed}, {cfg.n_blocks} block of "
        f"{cfg.n_heads} heads, S={cfg.seq_len}+1, MLP {cfg.mlp_hidden}")
    scfg = serve_cfg(cfg, n)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, buffers, state = BST.init(scfg, prior["freqs"], seed=SEED, device=dev)
    torch.cuda.synchronize()
    ratio = Packed.storage_ratio(params["embedding"], buffers["embedding"],
                                 scfg.comp_cfg)
    log(f"bst random packed table on the card: {time.perf_counter() - t0:.1f} s; "
        f"storage ratio {ratio:.6f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    rng = np.random.default_rng(SEED + 3)
    out = serve_bst(params, buffers, state, scfg, rng, prior["cdf"],
                    "bst random table", ("serve_p99", "serve_bulk",
                                         "retrieval_cand"))
    return {**out, "storage_ratio": ratio}


def check_bst_step_inputs(trainer, batch, step: int, cfg) -> dict:
    """One more BST training step with the flash and ``mpe_qat`` backward
    wrappers recording their arguments (the forwards' inputs and outputs
    saved for the backward, and the cotangents): on those, each kernel
    against its plain version at the path's shapes — the flash forward with
    stats (o and lse at ``FLASH_TOL``; its o and lse also equal to the
    step's own) and backward (``FLASH_BWD_TOL`` at the step's do brought
    to unit RMS by ``unit_rms``, twice bit-identical), the
    ``mpe_qat`` forward and backward by ``check_qat``. Returns the largest
    |difference| of each kernel and the shapes."""
    calls = captured(lambda: trainer.train_step(batch, step),
                     {"flash_attention_bwd": flash_ops,
                      "mixed_expectation_bwd": qat_ops})
    errs = {"fwd_stats": 0.0, "bwd": 0.0, "qat_fwd": 0.0, "qat_bwd": 0.0}
    hd = max(cfg.d_embed // cfg.n_heads, 4)
    want_shape = (TRAIN_ROWS, cfg.seq_len + 1, cfg.n_heads, hd)
    flash = calls["flash_attention_bwd"]
    check(len(flash) == cfg.n_blocks, f"bst step: {len(flash)} flash "
          f"backward calls, not {cfg.n_blocks}")
    shapes, do_rms = {"flash": [], "mpe_qat": []}, []
    for q, k, v, o, lse, do, causal in flash:
        what = f"bst step: flash at {tuple(q.shape)}, causal={causal}"
        do, rms = unit_rms(do)
        do_rms.append(rms)
        check(tuple(q.shape) == want_shape and not causal,
              f"{what}: not the path's non-causal (B, S, H, hd) {want_shape}")
        shapes["flash"].append(list(q.shape))
        o2, lse2 = flash_ops.flash_attention_fwd_stats(q, k, v, causal)
        check(torch.equal(o2, o) and torch.equal(lse2, lse),
              f"{what}: the forward with stats gave other bits than in the step")
        flat = [heads_flat(x) for x in (q, k, v, o, do)]
        flat_lse = lse.reshape(-1, lse.shape[-1])
        want_o, want_lse = fwd_stats_ref(*flat[:3], causal)
        errs["fwd_stats"] = max(errs["fwd_stats"],
                                within(flat[3], want_o, FLASH_TOL, f"{what}: o"),
                                within(flat_lse, want_lse, FLASH_TOL,
                                       f"{what}: lse"))
        del o2, lse2, want_o, want_lse
        grads = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
        again = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
        want = bwd_ref(*flat[:4], flat_lse, flat[4], causal)
        errs["bwd"] = max(errs["bwd"], *(
            within(heads_flat(x), w, FLASH_BWD_TOL, f"{what}: {name}")
            for name, x, w in zip(("dq", "dk", "dv"), grads, want)))
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"{what}: two backward runs gave different bits")
        del grads, again, want, flat
    qat = calls["mixed_expectation_bwd"]
    want_rows = sorted([TRAIN_ROWS * (cfg.seq_len + 1),
                        TRAIN_ROWS * len(cfg.ctx_fields)])
    check(sorted(args[0].shape[0] for args in qat) == want_rows
          and all(args[0].shape[1] == cfg.d_embed for args in qat),
          f"bst step: mpe_qat backward rows "
          f"{[tuple(args[0].shape) for args in qat]}, not {want_rows} x "
          f"{cfg.d_embed}")
    for rows, probs, alpha, beta, g, bits in qat:
        shapes["mpe_qat"].append(list(rows.shape))
        f, b = check_qat(rows, probs, alpha, beta, g, bits,
                         f"bst step: mpe_qat at {rows.shape[0]} x "
                         f"{rows.shape[1]}")
        errs["qat_fwd"], errs["qat_bwd"] = (max(errs["qat_fwd"], f),
                                            max(errs["qat_bwd"], b))
    del calls, flash, qat
    log(f"bst step inputs: flash {shapes['flash']} non-causal, o and lse "
        f"within 3e-5 (max |diff| {errs['fwd_stats']:.3e}), dq/dk/dv within "
        f"2e-4 ({errs['bwd']:.3e}) at do scaled to unit RMS (the step's RMS "
        f"{min(do_rms):.3e}-{max(do_rms):.3e}), backward "
        f"repeatable; mpe_qat "
        f"{shapes['mpe_qat']}: out and drows bit-identical to the plain "
        f"version, sums max |diff| {errs['qat_bwd']:.3e}, backward repeatable")
    return {"errs": errs, "shapes": shapes, "do_rms": do_rms}


def phase_bst_train(dev, prior) -> dict:
    """8 ``Trainer`` steps of full-width BST under ``mpe_search``, the
    trained table exported and served, one step traced. Returns the
    trained search table and the steps' batches for the bag's full-width
    phase."""
    cfg = get_arch("bst").make_config()
    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    batches = [bst_batch(rng, prior["cdf"], cfg, TRAIN_ROWS, dev)
               for _ in range(BST_BATCHES)]
    batch_s = time.perf_counter() - t0
    params, buffers, state = BST.init(cfg, prior["freqs"], seed=SEED, device=dev)

    def loss_fn(p, bu, st, batch, *, step=None):
        return BST.loss_fn(p, bu, st, batch, cfg, lam=BST_LAM, train=True,
                           step=step)

    trainer = Trainer(loss_fn, params, buffers, state, adam(1e-3))
    del params
    ptrs = [x.data_ptr() for x in leaves([trainer.params, trainer.carry["opt"]])]
    table_bytes = cfg_table_bytes(trainer.params["embedding"]["emb"])
    torch.cuda.synchronize()
    live_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    per_step = {"flash_attention_fwd_stats": cfg.n_blocks,
                "flash_attention_bwd": cfg.n_blocks, "flash_attention_fwd": 0,
                "mixed_expectation_fwd": 2, "mixed_expectation_bwd": 2,
                "mpe_lookup": 0, "embedding_bag_fwd": 0, "segment_sum": 4,
                "adam_step_": len(leaves(trainer.params)), "tiered_cold": 0,
                "kv_cache_write": 0, "decode_attention": 0}
    outs, step_ms = [], []
    t_all = time.perf_counter()
    for step in range(BST_STEPS):
        before = counts()
        t0 = time.perf_counter()
        outs.append(trainer.train_step(batches[step % BST_BATCHES], step))
        if step == 0:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launched = launched_since(before)
        check(launched == per_step, f"bst step {step} launched {launched}, "
              f"not {per_step}")
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t_all) * 1e3 - step_ms[0]
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(o["loss"]) for o in outs]
    check(all(np.isfinite(x) for x in losses), f"a loss was not finite: {losses}")
    check(not any(bool(o["skipped"]) for o in outs), "a step was skipped")
    log(f"bst train: {BST_STEPS} steps at {TRAIN_ROWS} rows, launches "
        f"{launches}; first step {step_ms[0]:.1f} ms, then "
        f"{steady_ms / (BST_STEPS - 1):.1f} ms a step (host clock to a "
        f"synchronize over {BST_STEPS - 1} steps); peak memory "
        f"{peak / 1e9:.3f} GB, {peak / table_bytes:.2f} tables (two trees: "
        f"{TWO_TREE_PEAK_GB['bst']} GB; {live_before / 1e9:.3f} GB live before); "
        f"batches made in {batch_s:.1f} s; losses {[round(x, 5) for x in losses]}")
    step_inputs = check_bst_step_inputs(trainer, batches[0], BST_STEPS, cfg)
    more = check_step_inputs(trainer, batches[1], BST_STEPS + 1, "bst")
    errs = step_inputs["errs"]
    errs.update({k: max(v, errs[k]) for k, v in more.pop("errs").items()})
    step_inputs.update(more)
    check_in_place_and_skip(trainer, batches[0], BST_STEPS + 2, ptrs,
                            "bst train")

    # Eq. 11 sampling and the packed export of the trained table, served
    mpe = as_mpe_config(cfg.comp_cfg)
    emb = trainer.params["embedding"]
    fb = feature_bits(sample_group_bits(emb, mpe),
                      buffers["embedding"]["group_of_feature"])
    table, meta = build_packed_table(emb["emb"], fb, emb["alpha"], emb["beta"],
                                     mpe)
    scfg = serve_cfg(cfg, total_vocab(fields(cfg)))
    sparams = {**trainer.params, "embedding": table}
    sbuffers = {**buffers, "embedding": {"meta": meta}}
    ratio = Packed.storage_ratio(table, {"meta": meta}, scfg.comp_cfg)
    log(f"bst trained table exported: storage ratio {ratio:.6f}")
    served = serve_bst(sparams, sbuffers, trainer.state, scfg, rng,
                       prior["cdf"], "bst trained table",
                       ("serve_p99", "retrieval_cand"))
    del sparams, table

    traced = trace(lambda: trainer.train_step(batches[0], BST_STEPS + 3), 1)
    step_view = {k: traced[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                        "top")}
    step_view["kernel_ms"] = {
        f"flash_{kind}": flash_kernel_ms(traced["by_name"], kind)
        for kind in ("fwd", "bwd")}
    step_view["kernel_ms"].update({
        kind: sum(ms for name, ms in traced["by_name"].items() if kind in name)
        for kind in ("mpe_qat_fwd_kernel", "mpe_qat_bwd_kernel")})
    step_view["kernel_ms"].update(step_kernel_ms(traced["by_name"]))
    check(step_view["kernel_ms"]["flash_fwd"] > 0
          and step_view["kernel_ms"]["flash_bwd"] > 0,
          f"traced bst train step: flash kernels missing from the trace "
          f"({step_view['kernel_ms']})")
    log(f"traced bst train step: wall {traced['wall_ms']:.1f} ms, device busy "
        f"{traced['busy_ms']:.1f} ms (idle share {traced['idle_share']:.3f}); "
        f"kernels {step_view['kernel_ms']}; top "
        + "; ".join(f"{n} {ms:.2f} ms" for n, ms in traced["top"]))
    return {"launches": launches, "first_step_ms": step_ms[0],
            "step_ms": steady_ms / (BST_STEPS - 1), "peak_bytes": peak,
            "table_bytes": table_bytes, "peak_tables": peak / table_bytes,
            "live_bytes_before": live_before, "losses": losses,
            "storage_ratio": ratio, "served": served, "traced_step": step_view,
            "step_inputs": step_inputs,
            "table": trainer.params["embedding"]["emb"].detach(),
            "seq_ids": batches[0]["seq_ids"]}


def bag_work(table, ids, mask) -> dict:
    """Bytes the bag's forward and backward must move: the forward reads
    each distinct row once, each id and mask entry once and writes (B, d);
    the backward reads the cotangent (B, d), the ids and the mask once and
    writes the dense (N, d) gradient."""
    (n, d), (b, _) = table.shape, ids.shape
    rows = int(torch.unique(ids).numel())
    idx = ids.numel() * ids.element_size() + mask.numel() * mask.element_size()
    fwd = rows * 4 * d + idx + b * d * 4
    bwd = b * d * 4 + idx + n * d * 4
    return {"distinct_rows": rows, "fwd_bytes": fwd, "bwd_bytes": bwd,
            "fwd_bound_ms": fwd / HBM_BYTES_PER_S * 1e3,
            "bwd_bound_ms": bwd / HBM_BYTES_PER_S * 1e3}


def phase_bag_path(dev, table, train_seqs) -> dict:
    """The bag over the full-width BST search table, its bags the BST
    training batch's histories (``train_batch``) and Zipf(1.1) histories at
    ``serve_bulk``, with ragged lengths uniform in 1..20. With the counts at
    0, ``embeddings.embedding_bag`` sum and mean, forward and backward,
    must launch the kernel once each; then the kernel against its plain
    version, and the times."""
    cfg = get_arch("bst").make_config()
    rng = np.random.default_rng(SEED + 4)
    cdf = np.cumsum(zipf_prior(cfg.item_vocab))
    l = cfg.seq_len
    cells = {"train_batch": train_seqs.to(torch.int32),
             "serve_bulk": torch.from_numpy(zipf_ids(
                 rng, cdf, (SERVE_ROWS["serve_bulk"], l))).to(dev)}
    masks = {shape: torch.from_numpy(np.arange(l)[None, :] < rng.integers(
        1, l + 1, (ids.shape[0], 1))).to(dev) for shape, ids in cells.items()}
    leaf = table.detach().requires_grad_(True)
    reset_counts()
    for shape, ids in cells.items():
        for combine in ("sum", "mean"):
            out = embedding_bag(leaf, ids, masks[shape], combine=combine)
            (grad,) = torch.autograd.grad(out.square().sum(), leaf)
            check(out.shape == (ids.shape[0], cfg.d_embed)
                  and bool(torch.isfinite(out).all())
                  and bool(torch.isfinite(grad).all()),
                  f"bag {combine} at {shape}: bad output or gradient")
            del out, grad
    torch.cuda.synchronize()
    launches = counts()
    check(launches["embedding_bag_fwd"] == 2 * len(cells)
          and launches["segment_sum"] == 2 * len(cells),
          f"the bag path launched {launches}, not the bag kernel and the "
          f"segment sum {2 * len(cells)} times each")
    log(f"bag path: launches {launches}")
    # the backward under the profiler: the segment sum, no library sum
    ids, mask = cells["train_batch"], masks["train_batch"]
    traced = uncounted(lambda: trace(lambda: torch.autograd.grad(
        embedding_bag(leaf, ids, mask).square().sum(), leaf), 1))
    library = {name: ms for name, ms in traced["by_name"].items()
               if any(k in name for k in LIBRARY_SEGMENT_KERNELS)
               or "embedding_dense" in name or "embedding_backward" in name}
    check(not library and any("segment_chunk_kernel" in name
                              for name in traced["by_name"]),
          f"the bag's backward ran {library or 'no segment-sum kernel'}")
    log("bag backward traced: the segment-sum kernels, no library dense "
        "embedding backward")
    del leaf

    gen = torch.Generator(device=dev).manual_seed(SEED)
    library_bag = torch.nn.functional.embedding_bag
    out = {}
    for shape, ids in cells.items():
        mask = masks[shape]
        b = ids.shape[0]
        g = torch.randn((b, cfg.d_embed), generator=gen, device=dev)
        fwd_err, bwd_err = check_bag(table, ids, mask, g,
                                     f"bag at {shape} ({b} x {l})")
        work = bag_work(table, ids, mask)
        weights = mask.to(torch.float32)
        lib_leaf = table.detach().requires_grad_(True)

        port_leaf = table.detach().requires_grad_(True)
        flat_ids = ids.reshape(-1)

        def library_fwd_bwd():
            torch.autograd.grad(library_bag(ids, lib_leaf, mode="sum",
                                          per_sample_weights=weights),
                                lib_leaf, g)

        def port_fwd_bwd():
            torch.autograd.grad(bag_ops.embedding_bag_kernel(
                port_leaf, ids, mask), port_leaf, g)

        def materialized_bwd():  # the products written out, then summed
            seg_ops.segment_sum((g[:, None, :] * weights[..., None]).reshape(
                -1, cfg.d_embed), flat_ids, table.shape[0])
        traced = trace(lambda: bag_ops.embedding_bag_fwd(table, ids, mask), 50)
        row = {**work, "bags": b, "slots": l, "max_abs_err_fwd": fwd_err,
               "max_abs_err_bwd": bwd_err,
               "fwd_device_ms": sum(ms for name, ms in traced["by_name"].items()
                                    if "embedding_bag_kernel" in name),
               "fwd_ms": cuda_ms(lambda: bag_ops.embedding_bag_fwd(
                   table, ids, mask), 50),
               "fwd_plain_ms": cuda_ms(lambda: embedding_bag_ref(
                   table, ids, mask), 10, warmup=1),
               "fwd_library_ms": cuda_ms(lambda: library_bag(
                   ids, table, mode="sum", per_sample_weights=weights), 50),
               "bwd_ms": cuda_ms(lambda: bag_ops.embedding_bag_bwd(
                   g, ids, mask, table.shape[0]), 10),
               "bwd_materialized_ms": cuda_ms(materialized_bwd, 10),
               "bwd_plain_ms": cuda_ms(lambda: embedding_bag_bwd_ref(
                   g, ids, mask, table.shape[0]), 5, warmup=1),
               "fwd_bwd_ms": cuda_ms(port_fwd_bwd, 10),
               "fwd_bwd_library_ms": cuda_ms(library_fwd_bwd, 10)}
        row["bwd_library_ms"] = row["fwd_bwd_library_ms"]  # no call for it alone
        row["fwd_bwd_bound_ms"] = row["fwd_bound_ms"] + row["bwd_bound_ms"]
        del lib_leaf, port_leaf
        out[shape] = row
        for kind, call in (("fwd", "F.embedding_bag forward"),
                           ("bwd", "F.embedding_bag forward + backward"),
                           ("fwd_bwd", "F.embedding_bag forward + backward")):
            log(f"bag {kind} at {shape} ({b} bags x {l}, d={cfg.d_embed}, "
                f"{work['distinct_rows']} distinct rows of {table.shape[0]}): "
                f"{row[kind + '_ms']:.4f} ms per call ("
                + (f"plain {row[kind + '_plain_ms']:.4f} ms; "
                   if kind + "_plain_ms" in row else "")
                + f"{call} {row[kind + '_library_ms']:.4f} ms; bound "
                f"{row[kind + '_bound_ms']:.4f} ms, "
                f"{row[kind + '_bound_ms'] / row[kind + '_ms']:.1%} of it)")
        log(f"bag fwd at {shape}: {row['fwd_device_ms']:.4f} ms a call on "
            f"the device (traced); bag bwd: the products written out and "
            f"then summed {row['bwd_materialized_ms']:.4f} ms, formed in the "
            f"kernel {row['bwd_ms']:.4f} ms")
    return {"launches": launches, "shapes": out}


def bag_record(grid_errs, bag) -> dict:
    tb = bag["shapes"]["train_batch"]
    return {"name": "embedding_bag_fwd", "route": "cuda", "source": BAG_SOURCE,
            "replaces": "src/repro/kernels/embedding_bag/kernel.py:33",
            "launches": bag["launches"]["embedding_bag_fwd"],
            "max_abs_err": max(grid_errs["fwd"], *(
                row["max_abs_err_fwd"] for row in bag["shapes"].values())),
            "ms": tb["fwd_ms"], "plain_ms": tb["fwd_plain_ms"],
            "bound_ms": tb["fwd_bound_ms"], "bound_by": "bytes",
            "library_ms": tb["fwd_library_ms"],
            "library_call": "F.embedding_bag(ids, table, mode='sum', "
                            "per_sample_weights=mask.float())",
            "bytes": tb["fwd_bytes"], "shapes": bag["shapes"],
            "backward_max_abs_err": max(grid_errs["bwd"], *(
                row["max_abs_err_bwd"] for row in bag["shapes"].values()))}


def phase_segment_grid(dev) -> list:
    """The segment sum at the shapes the baselines and Wide & Deep add: width
    1 (OptFS's gates, the wide vector) with a hot segment, and QR's k = 2
    remainder table, where every id falls into one of two segments; against
    the plain version (``segment_sum_bound``), twice bit-identical, timed."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 5)
    calls = []
    for t, n, w, hot in ((1_500_000, 200_000, 1, True), (2_500_000, 2, 16, False),
                         (2_500_000, 2, 1, False), (300_000, 1000, 16, True)):
        ids = (rng.zipf(1.2, t) % n).astype(np.int64)
        if hot:
            ids[rng.random(t) < 0.75] = n // 3
        calls.append((torch.randn((t, w), generator=gen, device=dev),
                      torch.from_numpy(ids).to(dev), n))
    return uncounted(lambda: check_segment_sums(calls, "segment-sum grid"))


class CheckedTrainer(Trainer):
    """The launcher's ``Trainer``, watched after every step through its
    post-update hook (wrapped, the launcher's own hook, ``hook``, run
    first): each step's launch counts, whether every parameter and moment
    leaf is still at its ``data_ptr``, and, for ALPT, whether the table is
    on its grid — kept as device flags and read after the run, so no step
    waits for the host. The wrapper holds the carry, not the trainer: a
    reference cycle would keep every run's tables alive until the cyclic
    garbage collector ran."""

    def __init__(self, *args, post_update=None, **kw):
        super().__init__(*args, post_update=post_update, **kw)
        self.hook = post_update
        carry = self.carry
        ptrs = [x.data_ptr() for x in leaves([carry["params"], carry["opt"]])]
        step_launches, moved, off_grid = [], [], []
        self.step_launches, self.moved, self.off_grid = step_launches, moved, off_grid
        before = [counts()]

        def watched(params):
            if post_update is not None:
                params = post_update(params)
                emb, alpha = params["embedding"]["emb"], params["embedding"]["alpha"]
                codes = torch.round(emb / alpha)
                off_grid.append((alpha * codes != emb).any()
                                | (codes.amin() < -128) | (codes.amax() > 127))
                del codes
            step_launches.append(launched_since(before[0]))
            before[0] = counts()
            moved.append([x.data_ptr() for x in leaves(
                [params, carry["opt"]])] != ptrs)
            return params
        self.post_update = watched

    def step_and_hook(self, batch):
        """One step as ``run`` takes it: ``train_step`` and the launcher's
        own post-update hook (ALPT's projection)."""
        self.train_step(batch, self.step)
        if self.hook is not None:
            self.carry["params"] = self.hook(self.carry["params"])


def baseline_batches(cfg, dev) -> tuple:
    """The stream the launcher trains on, and two of its ``train_batch``
    batches on the card (steps past the runs'), made once for every
    baseline's recorded and traced step."""
    ds = SyntheticCTR(CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields),
                              batch_size=TRAIN_ROWS, seed=SEED))
    return [{k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in ds.batch(1_000 + i).items()} for i in range(2)]


def phase_table3(dev) -> dict:
    """Paper Table 3's rows other than MPE at full DLRM width: the backbone
    and the five baselines, each through ``launch.train.main`` with
    ``--prefetch`` for ``BASELINE_STEPS`` steps at ``train_batch``, the
    counts at 0. Each step must launch ``mpe_qat`` forward and backward once
    (LSQ, ALPT) or never, the segment sum once a gather and the Adam pass
    once a leaf; every loss finite, no step skipped, every leaf in place,
    ALPT's table on its grid after every step. Then one traced step (no
    library dense embedding backward: the segment sum) and, for the
    baselines whose kernels see new shapes, one more step with its kernels'
    arguments recorded and held against their plain versions."""
    cfg = get_arch("dlrm-criteo").make_config(backbone="dnn")
    batches = baseline_batches(cfg, dev)
    table_bytes = total_vocab(cfg.fields) * cfg.d_embed * 4
    runs, recorded = {}, []
    launch_train.Trainer = CheckedTrainer
    try:
        for name in BASELINES:
            argv = ["--arch", "dlrm-criteo", "--backbone", "dnn",
                    "--compressor", name, "--batch", str(TRAIN_ROWS),
                    "--steps", str(BASELINE_STEPS), "--lam", str(LAM),
                    "--seed", str(SEED), "--prefetch"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            res = launch_train.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            trainer = res["trainer"]
            hist = res["history"]
            n_leaves = len(leaves(trainer.params))
            want = {"mixed_expectation_fwd": int(name in ONE_WIDTH),
                    "mixed_expectation_bwd": int(name in ONE_WIDTH),
                    "segment_sum": BASELINE_GATHERS[name],
                    "adam_step_": n_leaves, "mpe_lookup": 0}
            check(len(hist) == BASELINE_STEPS
                  and len(trainer.step_launches) == BASELINE_STEPS,
                  f"{name}: {len(hist)} steps ran, not {BASELINE_STEPS}")
            for i, launched in enumerate(trainer.step_launches):
                got = {k: launched[k] for k in want}
                check(got == want, f"{name} step {i}: launches {got}, not {want}")
            check(all(np.isfinite(h["loss"]) for h in hist),
                  f"{name}: a loss was not finite")
            check(not any(h["skipped"] for h in hist), f"{name}: a step was skipped")
            check(not any(trainer.moved), f"{name}: a leaf moved: not in place")
            check(not any(bool(x) for x in trainer.off_grid),
                  f"{name}: the table left ALPT's grid after a step")
            check(len(trainer.off_grid) == (BASELINE_STEPS if name == "alpt" else 0),
                  f"{name}: the grid was checked {len(trainer.off_grid)} times")
            traced = uncounted(lambda: trace(
                lambda: trainer.step_and_hook(batches[0]), 1))
            library = {k: ms for k, ms in traced["by_name"].items()
                       if any(x in k for x in LIBRARY_SEGMENT_KERNELS)
                       or "embedding_dense" in k or "embedding_backward" in k}
            check(not library and any("segment_chunk_kernel" in k
                                      for k in traced["by_name"]),
                  f"{name}: a traced step ran {library or 'no segment sum'}")
            row = {"losses": [h["loss"] for h in hist],
                   "storage_ratio": res["storage_ratio"], "eval": res["eval"],
                   "step_ms": res["train_s"] / BASELINE_STEPS * 1e3,
                   "data_ms": float(np.mean([h["data_ms"] for h in hist])),
                   "run_s": run_s, "peak_bytes": peak,
                   "peak_tables": peak / table_bytes,
                   "launches_per_step": want,
                   "launches": {k: sum(s[k] for s in trainer.step_launches)
                                for k in want},
                   "traced_step": {k: traced[k] for k in
                                   ("wall_ms", "busy_ms", "idle_share", "top")},
                   "traced_kernel_ms": step_kernel_ms(traced["by_name"])}
            log(f"table 3 {name}: {BASELINE_STEPS} steps at {TRAIN_ROWS} rows, "
                f"launches a step {want}; ratio {row['storage_ratio']:.6f}; "
                f"{row['step_ms']:.1f} ms a step (host clock, the first step "
                f"and the read-ahead's start included; waiting for the batch "
                f"{row['data_ms']:.1f} ms); traced step wall "
                f"{traced['wall_ms']:.1f} ms, busy {traced['busy_ms']:.1f} ms; "
                f"peak {peak / 1e9:.3f} GB, {row['peak_tables']:.2f} tables; "
                f"no library dense embedding backward; losses "
                f"{[round(x, 5) for x in row['losses']]}; eval {res['eval']}")
            if name in RECORDED_BASELINES:
                inputs = check_step_inputs(trainer, batches[1], trainer.step,
                                           f"table 3 {name}")
                recorded.append((f"table3 {name}", inputs))
                row["step_inputs"] = {k: inputs[k] for k in ("errs", "adam")}
            runs[name] = row
            del res, trainer, hist
    finally:
        launch_train.Trainer = Trainer
    log("table 3 at full DLRM width (H100, chip_smoke.py):\n"
        + "\n".join(f"  {n:6s} ratio {r['storage_ratio']:.6f}  step "
                    f"{r['step_ms']:8.1f} ms  busy "
                    f"{r['traced_step']['busy_ms']:6.1f} ms  peak "
                    f"{r['peak_bytes'] / 1e9:7.3f} GB ({r['peak_tables']:.2f} "
                    f"tables)" for n, r in runs.items()))
    return {"runs": runs, "recorded": recorded}


def wide_deep_batch(spec, rows: int, step: int, dev) -> dict:
    batch = SyntheticCTR(spec._replace(batch_size=rows)).batch(step)
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}


def phase_wide_deep(dev) -> dict:
    """Wide & Deep at full width: the MPE pipeline through
    ``launch.train --arch wide-deep`` (``WD_STEPS`` search and retrain steps
    at ``train_batch``, Eq. 11 sampling, the packed export, eval), the
    counts at 0; then ``WideDeep.apply`` under the ``packed`` compressor at
    ``serve_p99`` and ``serve_bulk``: each apply launches ``mpe_lookup``
    once, its logits equal the same model's with the plain lookup
    (``SCORE_TOL``) and its lookups the plain version bit for bit; the
    lookup timed at both cells."""
    cfg = get_arch("wide-deep").make_config()
    n = total_vocab(cfg.fields)
    table_bytes = n * cfg.d_embed * 4
    log(f"wide-deep: {len(cfg.fields)} fields, {n} features, d={cfg.d_embed}, "
        f"MLP {cfg.mlp_hidden}; the table {table_bytes / 1e9:.2f} GB: a step "
        f"holds about 5-6 tables ({5 * table_bytes / 1e9:.1f}-"
        f"{6 * table_bytes / 1e9:.1f} GB), DLRM's export peaked at 12.3 "
        f"({12.3 * table_bytes / 1e9:.1f} GB)")
    argv = ["--arch", "wide-deep", "--batch", str(TRAIN_ROWS), "--steps",
            str(WD_STEPS), "--retrain-steps", str(WD_STEPS), "--lam", str(LAM),
            "--seed", str(SEED), "--prefetch"]
    log(f"wide-deep train: python -m repro_torch.launch.train {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = launch_train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = res["search_history"] + res["retrain_history"]
    launched = counts()
    # a search step sums three gathers' gradients (rows, probabilities, the
    # wide vector), a retrain step two
    want = {"mixed_expectation_fwd": 2 * WD_STEPS,
            "mixed_expectation_bwd": 2 * WD_STEPS,
            "segment_sum": 3 * WD_STEPS + 2 * WD_STEPS,
            "adam_step_": (len(leaves(res["search_params"]))
                           + len(leaves(res["final_params"]))) * WD_STEPS}
    check(len(steps) == 2 * WD_STEPS, f"wide-deep: {len(steps)} steps ran")
    check({k: launched[k] for k in want} == want,
          f"wide-deep: launches {launched}, not {want}")
    check(all(np.isfinite(h["loss"]) for h in steps), "wide-deep: a loss was "
          "not finite")
    check(not any(h["skipped"] for h in steps), "wide-deep: a step was skipped")
    train = {"launches": {k: launched[k] for k in want}, "train_s": train_s,
             "phase_s": res["seconds"], "peak_bytes": peak,
             "table_bytes": table_bytes, "peak_tables": peak / table_bytes,
             "search_step_ms": res["seconds"]["search"] / WD_STEPS * 1e3,
             "retrain_step_ms": res["seconds"]["retrain"] / WD_STEPS * 1e3,
             "losses": [h["loss"] for h in steps],
             "storage_ratio": res["storage_ratio"], "avg_bits": res["avg_bits"],
             "eval": res["eval"]}
    log(f"wide-deep train: {2 * WD_STEPS} steps, launches {train['launches']}; "
        f"search {train['search_step_ms']:.1f} ms/step, retrain "
        f"{train['retrain_step_ms']:.1f} ms/step, export "
        f"{res['seconds']['export']:.1f} s; peak {peak / 1e9:.3f} GB, "
        f"{train['peak_tables']:.2f} tables; ratio {res['storage_ratio']:.6f}, "
        f"avg bits {res['avg_bits']:.3f}, eval {res['eval']}; losses "
        f"{[round(x, 5) for x in train['losses']]}")

    # the exported table served: packed lookups through the kernel
    table, meta, state = res["packed_table"], res["packed_meta"], res["state"]
    params = {k: v for k, v in res["final_params"].items() if k != "embedding"}
    params["embedding"] = table
    buffers = {"offsets": res["buffers"]["offsets"], "embedding": {"meta": meta}}
    del res                              # the retrained full-precision table
    scfg = cfg._replace(compressor="packed", comp_cfg={
        "bits": meta["bits"], "d": meta["d"], "n": meta["n"]})
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields), seed=SEED)
    serve, lookup = {}, {}
    for shape, rows in SERVE_ROWS.items():
        batch = wide_deep_batch(spec, rows, 30_000 + rows, dev)
        with torch.inference_mode():
            before = counts()
            logits = WideDeep.apply(params, buffers, state, batch, scfg)[0]
            torch.cuda.synchronize()
            got_launches = launched_since(before)
            check(got_launches["mpe_lookup"] == 1,
                  f"wide-deep {shape}: launches {got_launches}; an apply must "
                  f"launch mpe_lookup once")
            check(logits.shape == (rows,) and bool(torch.isfinite(logits).all()),
                  f"wide-deep {shape}: bad logits")
            want_logits = with_plain_kernels(lambda: torch.cat([
                WideDeep.apply(params, buffers, state,
                               {k: v[lo:lo + WD_PLAIN_CHUNK]
                                for k, v in batch.items()}, scfg)[0]
                for lo in range(0, rows, WD_PLAIN_CHUNK)]))
            err = compare(logits, want_logits, SCORE_TOL, SCORE_TOL,
                          f"wide-deep {shape}: logits vs plain lookup")
            calls = recorded_lookups(lambda: WideDeep.apply(params, buffers,
                                                            state, batch, scfg))
            n_ids = check_lookup_bits(calls, f"wide-deep {shape}")
        gids = batch["ids"] + buffers["offsets"][None, :]
        lookup[f"wide-deep {shape}"] = time_lookup(table, meta, gids,
                                                   f"wide-deep {shape}",
                                                   plain=True)
        serve[shape] = {"rows": rows, "launches": got_launches,
                        "max_abs_err": err, "ids_bit_equal": n_ids}
        del batch, logits, want_logits, calls
    log(f"wide-deep serve: {serve}")
    serve_launches = {name: sum(r["launches"][name] for r in serve.values())
                      for name in COUNTERS}
    return {"train": train, "serve": serve, "lookup": lookup,
            "serve_launches": serve_launches}


def reduced_trainer(build, opt=None, **kw) -> Trainer:
    b = build(SEED, "mpe_search", MPEConfig(lam=LAM)._asdict())
    return Trainer(b["loss_fn"], b["params"], b["buffers"], b["state"],
                   opt or adam(1e-3), **kw)


def phase_reduced_checks(dev) -> dict:
    """On the card at the reduced DLRM config (8 fields of 1,000 ids, MLP
    (32, 16), 4,096 rows): the losses of prefetched runs (depth 1 and the
    pre-built depth ``prefetch_depth()``) bit-identical to the synchronous
    run's; ``adam(warmup_cosine(...))``'s pass held against its plain
    version bit for bit, a skipped one bit-unchanged; ``Trainer(
    grad_compression=True)`` 4 finite steps; 6 steps against 3, ``save``, a
    fresh ``Trainer``, ``restore()`` and 3 more: the same losses."""
    cfg = get_arch("dlrm-criteo").make_config(reduced=True)
    ds = SyntheticCTR(CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields),
                              batch_size=REDUCED_ROWS, seed=SEED))
    build = dlrm_builder(cfg, ds.expected_frequencies(), lam=LAM, device=dev)
    out = {}
    reset_counts()
    k = prefetch_depth()
    losses = {}
    for name in ("sync", "depth 1", f"depth {k}"):
        tr = reduced_trainer(build)
        pipe = (PrefetchPipeline(ds.batch, depth=k, device=dev)
                if name == f"depth {k}" else name == "depth 1")
        try:
            tr.run(ds.batch, 6, log_every=0, prefetch=pipe)
        finally:
            if not isinstance(pipe, bool):
                pipe.close()
        losses[name] = [h["loss"] for h in tr.history]
    check(all(v == losses["sync"] for v in losses.values()),
          f"prefetched losses differ from the synchronous run's: {losses}")
    log(f"reduced dlrm: prefetched runs (depth 1, depth {k}) give the "
        f"synchronous run's losses bit for bit: {losses['sync']}")
    out["prefetch_losses"] = losses

    sched = warmup_cosine(1e-3, 2, 8, 1e-5)
    tr = reduced_trainer(build, adam(sched, weight_decay=3e-6))
    tr.run(ds.batch, 3, log_every=0)
    batch = {key: torch.from_numpy(np.asarray(v)).to(dev)
             for key, v in ds.batch(3).items()}
    calls = captured(lambda: tr.train_step(batch, 3),
                     {"adam_step_": optimizer_module}, writes=ADAM_WRITES)
    rates = [c[-2]["lr"] for c in calls["adam_step_"]]
    check(all(torch.is_tensor(r) and r.device == batch["ids"].device
              for r in rates),
          "the scheduled Adam pass was not handed its rate on the card")
    out["schedule"] = check_adam(calls["adam_step_"], "reduced dlrm "
                                 "adam(warmup_cosine)", timed=False)
    out["schedule"]["lr_t"] = float(rates[0])
    log(f"reduced dlrm: adam(warmup_cosine(1e-3, 2, 8, 1e-5)) at Adam's step "
        f"4: lr_t {out['schedule']['lr_t']!r} read on the card")

    tr = reduced_trainer(build, grad_compression=True)
    tr.run(ds.batch, 4, log_every=0)
    ef = [h["loss"] for h in tr.history]
    check(all(np.isfinite(ef)) and not any(h["skipped"] for h in tr.history),
          f"error feedback: losses {ef}")
    out["error_feedback_losses"] = ef
    log(f"reduced dlrm: Trainer(grad_compression=True) 4 steps: {ef}")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        whole = reduced_trainer(build)
        whole.run(ds.batch, 6, log_every=0)
        first = reduced_trainer(build, ckpt_dir=CKPT_DIR)
        first.run(ds.batch, 3, log_every=0)            # saves step 3
        second = reduced_trainer(build, ckpt_dir=CKPT_DIR)
        check(second.restore() and second.step == 3, "restore found no step 3")
        second.run(ds.batch, 6, log_every=0)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    resumed = [h["loss"] for h in first.history + second.history]
    check(resumed == [h["loss"] for h in whole.history],
          f"resumed losses {resumed} differ from the uninterrupted "
          f"{[h['loss'] for h in whole.history]}")
    check(all(torch.equal(a, b) for a, b in zip(leaves(second.params),
                                                leaves(whole.params))),
          "resumed parameters differ from the uninterrupted run's")
    out["resume_losses"] = resumed
    log(f"reduced dlrm: 3 steps, save, restore, 3 steps: the losses and "
        f"parameters of 6 steps in one run, bit for bit")
    return out


# ---------------------------------------------------------------------------
# phase 20: two-tower retrieval at full width
# ---------------------------------------------------------------------------

def two_tower_prior(cfg) -> dict:
    """Zipf(1.1) over each field's ids ranked by popularity: the expected
    lookups a row of every feature (MPE's grouping prior), each field's CDF
    for drawing ids, and each vocabulary's log probabilities, from which an
    item's log sampling probability (logQ) is the sum over its fields."""
    by_vocab = {f.vocab: zipf_prior(f.vocab)
                for f in (*cfg.user_fields, *cfg.item_fields)}
    return {"freqs": np.concatenate([by_vocab[f.vocab] for f in
                                     (*cfg.user_fields, *cfg.item_fields)]),
            "cdf": {v: np.cumsum(p) for v, p in by_vocab.items()},
            "logp": {v: np.log(p).astype(np.float32)
                     for v, p in by_vocab.items()}}


def two_tower_batch(rng, prior, cfg, rows: int, dev) -> dict:
    """A training batch on the card: Zipf(1.1) user and item ids per field,
    and each item's logQ under the item prior."""
    def ids(fields):
        return np.stack([zipf_ids(rng, prior["cdf"][f.vocab], rows)
                         for f in fields], axis=1)
    user, item = ids(cfg.user_fields), ids(cfg.item_fields)
    logq = sum(prior["logp"][f.vocab][item[:, i]]
               for i, f in enumerate(cfg.item_fields)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in
            (("user_ids", user), ("item_ids", item), ("item_logq", logq))}


def whole_matrix_ce(u, v, logq, temperature: float) -> torch.Tensor:
    """The reference's in-batch softmax: the whole (B, B) logits."""
    logits = (u @ v.T) / temperature - logq[None, :]
    return torch.mean(-torch.log_softmax(logits, dim=-1).diagonal())


def check_blocked_loss(trainer, buffers, batch, cfg) -> dict:
    """At ``TT_CHECK_ROWS`` rows of a training batch, the model's loss by
    blocks of ``TT_CHECK_BLOCK`` rows (a non-divisor) against the whole
    (B, B) matrix on the same towers' outputs: the cross-entropy at rtol
    1e-5 and the towers' gradients at rtol 1e-5, atol 1e-7 of the largest;
    then ``loss_fn`` itself by blocks against the whole matrix."""
    part = {k: v[:TT_CHECK_ROWS] for k, v in batch.items()}
    params, state = trainer.params, trainer.state

    def towers():
        with torch.no_grad():
            u, _ = TwoTower.user_tower(params, buffers, state,
                                       part["user_ids"], cfg, train=True)
            v, _ = TwoTower.item_tower(params, buffers, state,
                                       part["item_ids"], cfg, train=True)
        return u, v
    u, v = uncounted(towers)
    block = two_tower_module.LOSS_BLOCK_ROWS
    two_tower_module.LOSS_BLOCK_ROWS = TT_CHECK_BLOCK
    try:
        got_in = [x.clone().requires_grad_(True) for x in (u, v)]
        want_in = [x.clone().requires_grad_(True) for x in (u, v)]
        got = in_batch_softmax(*got_in, part["item_logq"], cfg.temperature)
        want = whole_matrix_ce(*want_in, part["item_logq"], cfg.temperature)
        got_g = torch.autograd.grad(got, got_in)
        want_g = torch.autograd.grad(want, want_in)
        model_ce = uncounted(lambda: TwoTower.loss_fn(
            params, buffers, state, part, cfg, lam=TT_LAM)[1][1])
    finally:
        two_tower_module.LOSS_BLOCK_ROWS = block
    torch.cuda.synchronize()
    rel = abs(float(got) - float(want)) / abs(float(want))
    check(rel <= 1e-5, f"two-tower: the blocked loss {float(got)} is not the "
          f"whole-matrix loss {float(want)} (rtol 1e-5)")
    model_rel = abs(float(model_ce) - float(want)) / abs(float(want))
    check(model_rel <= 1e-5, f"two-tower: loss_fn's cross-entropy "
          f"{float(model_ce)} by blocks is not the whole-matrix one "
          f"{float(want)}")
    top = max(float(g.abs().max()) for g in want_g)
    grad_err = max(max_abs(g, w) for g, w in zip(got_g, want_g))
    for g, w in zip(got_g, want_g):
        check(bool(torch.isclose(g, w, rtol=1e-5, atol=1e-7 * top).all()),
              f"two-tower: the blocked loss's gradients differ from the "
              f"whole matrix's by {max_abs(g, w):.3e}")
    log(f"two-tower: the loss at {TT_CHECK_ROWS} rows by blocks of "
        f"{TT_CHECK_BLOCK} {float(got):.7f}, the whole matrix "
        f"{float(want):.7f} (rel {rel:.2e}; loss_fn {float(model_ce):.7f}); "
        f"gradients within {grad_err:.3e} (largest {top:.3e})")
    return {"rows": TT_CHECK_ROWS, "block": TT_CHECK_BLOCK,
            "blocked": float(got), "whole": float(want), "rel": rel,
            "loss_fn": float(model_ce), "grad_max_abs_err": grad_err}


def two_tower_plain_scores(params, buffers, state, cfg, user, cands):
    """Every candidate's score through the plain lookup, in chunks of
    ``TT_PLAIN_CHUNK`` candidates, on the card: the yardstick of the
    engine's top-k."""
    def run():
        with torch.inference_mode():
            u, _ = TwoTower.user_tower(params, buffers, state, user, cfg)
            out = []
            for lo in range(0, cands.shape[0], TT_PLAIN_CHUNK):
                v, _ = TwoTower.item_tower(params, buffers, state,
                                           cands[lo:lo + TT_PLAIN_CHUNK], cfg)
                out.append((v @ u[0]) / cfg.temperature)
            return torch.cat(out)
    return with_plain_kernels(run)


def serve_two_tower(sparams, sbuffers, state, scfg, rng, prior, dev) -> dict:
    """``retrieval_cand`` through ``Engine.register(two_tower_retrieval_cell
    (..., n_cands=1,048,576, top_k=100))`` and ``engine.retrieve``: the
    graph holds one lookup a tower; each request of ``TT_REQUESTS``
    candidates equals the plain lookup's route (top-100 scores within
    ``SCORE_TOL``, indices where the scores are distinct), then is timed
    ``TT_REQUEST_REPS`` times with the counts at 0, each replay launching
    two lookups."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved_before = torch.cuda.memory_reserved()
    engine = Engine(device=dev)
    t0 = time.perf_counter()
    reg = engine.register(two_tower_retrieval_cell(
        TwoTower, scfg, sparams, state, sbuffers, n_cands=N_CANDIDATES,
        top_k=TOP_K, arch="two-tower-retrieval"))
    capture_s = time.perf_counter() - t0
    check(reg.cell.captured == {"mpe_lookup": 2},
          f"two-tower retrieval cell captured {reg.cell.captured}, not one "
          f"mpe_lookup a tower")
    pool = engine.cache.pool_bytes()
    log(f"two-tower retrieval cell ({N_CANDIDATES} candidates, top "
        f"{TOP_K}) captured in {capture_s:.2f} s: {reg.cell.captured}; the "
        f"graph pool {pool / 1e9:.3f} GB")
    user = np.stack([zipf_ids(rng, prior["cdf"][f.vocab], 1)
                     for f in scfg.user_fields], axis=1)
    most = max(TT_REQUESTS)
    cands = np.stack([rng.integers(0, f.vocab, most, dtype=np.int32)
                      for f in scfg.item_fields], axis=1)
    out = {"capture_s": capture_s, "pool_bytes": pool, "captured":
           reg.cell.captured, "requests": {}}
    user_t = torch.from_numpy(user).to(dev)
    # the cell's step run eagerly on a full corpus chunk: both lookups
    # equal the plain version bit for bit; the items' lookup timed
    staged = reg.cell.stage(user, cands[:N_CANDIDATES],
                            np.ones((N_CANDIDATES,), bool))

    def step():
        with torch.inference_mode():
            return reg.celldef.step_fn(*reg.bound, *staged)
    calls = recorded_lookups(step)
    check(len(calls) == 2, f"two-tower retrieval step: {len(calls)} lookups, "
          f"not one a tower")
    check_lookup_bits(calls, "two-tower retrieval_cand")
    out["lookup"] = {"two-tower retrieval_cand items": time_lookup(
        *calls[1], "two-tower retrieval_cand items", plain=True)}
    del calls, staged
    for size in TT_REQUESTS:
        part = cands[:size]
        got_s, got_i = engine.retrieve(user, part)
        want = two_tower_plain_scores(sparams, sbuffers, state, scfg, user_t,
                                      torch.from_numpy(part).to(dev))
        want_s, want_i = torch.topk(want, min(TOP_K, size))
        del want
        err, distinct = check_topk(torch.from_numpy(got_s).to(dev),
                                   torch.from_numpy(got_i).to(dev),
                                   want_s, want_i,
                                   f"two-tower retrieve of {size} candidates")
        out["requests"][size] = {"max_abs_err": err,
                                 "distinct_indices": distinct}
    reset_lookup_counts(engine)
    replays = 0
    for size in TT_REQUESTS:
        part = cands[:size]
        ms = time_requests(lambda p=part: engine.retrieve(user, p),
                           TT_REQUEST_REPS)
        replays += TT_REQUEST_REPS * -(-size // N_CANDIDATES)
        row = out["requests"][size]
        row.update({"chunks": -(-size // N_CANDIDATES), "ms": ms,
                    "p50_ms": p50(ms), "max_ms": max(ms)})
        log(f"two-tower retrieve of {size} candidates ({row['chunks']} "
            f"chunk(s)): p50 {row['p50_ms']:.3f} ms, max {row['max_ms']:.3f} "
            f"ms of {TT_REQUEST_REPS} (host clock, the engine's synchronize "
            f"and the top-k's read included)")
    launches = lookup_launches(engine)
    check(reg.cell.replays == replays and launches == 2 * replays,
          f"two-tower serve: {reg.cell.replays} replays and {launches} "
          f"lookups, not {replays} and {2 * replays}")
    out["launches"] = {**{name: 0 for name in COUNTERS},
                       "mpe_lookup": launches}
    out["peak_reserved_bytes"] = (torch.cuda.max_memory_reserved()
                                  - reserved_before)
    log(f"two-tower serve: {replays} replays, {launches} mpe_lookup "
        f"launches (two a replay); serving reserved "
        f"{out['peak_reserved_bytes'] / 1e9:.3f} GB above what was reserved "
        f"before")
    del engine, reg
    gc.collect()
    return out


def phase_two_tower(dev) -> dict:
    """Two-tower retrieval at full width: 8 ``Trainer`` steps at 65,536
    rows, the blocked loss against the whole matrix, Eq. 11 sampling and
    the packed export of the whole table, then ``retrieval_cand`` through
    the engine."""
    cfg = get_arch("two-tower-retrieval").make_config()
    fields_ = (*cfg.user_fields, *cfg.item_fields)
    n = total_vocab(fields_)
    log(f"two-tower: {len(cfg.user_fields)} user fields x "
        f"{cfg.user_fields[0].vocab} + {len(cfg.item_fields)} item fields x "
        f"{cfg.item_fields[0].vocab} = {n} rows, d={cfg.d_embed}, towers "
        f"{cfg.tower_hidden}, {cfg.compressor}")
    t0 = time.perf_counter()
    prior = two_tower_prior(cfg)
    rng = np.random.default_rng(SEED + 20)
    batches = [two_tower_batch(rng, prior, cfg, TRAIN_ROWS, dev)
               for _ in range(TT_BATCHES)]
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, buffers, state = TwoTower.init(cfg, prior["freqs"], seed=SEED,
                                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def loss_fn(p, bu, st, batch, *, step=None):
        return TwoTower.loss_fn(p, bu, st, batch, cfg, lam=TT_LAM, train=True,
                                step=step)

    trainer = Trainer(loss_fn, params, buffers, state, adam(1e-3))
    del params
    table_bytes = cfg_table_bytes(trainer.params["embedding"]["emb"])
    log(f"two-tower: prior and {TT_BATCHES} batches of {TRAIN_ROWS} rows on "
        f"the host in {batch_s:.1f} s; init on the card {init_s:.1f} s; "
        f"table {table_bytes / 1e9:.3f} GB")
    blocked = check_blocked_loss(trainer, buffers, batches[0], cfg)
    torch.cuda.synchronize()
    live_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # a step: one lookup a tower (the mpe_qat forward and backward once
    # each), the two gathers of each lookup summed back (rows and group
    # probabilities), the Adam pass once a leaf
    per_step = {**{name: 0 for name in COUNTERS},
                "mixed_expectation_fwd": 2, "mixed_expectation_bwd": 2,
                "segment_sum": 4, "adam_step_": len(leaves(trainer.params))}
    outs, step_ms = [], []
    t_all = time.perf_counter()
    for step in range(TT_STEPS):
        before = counts()
        t0 = time.perf_counter()
        outs.append(trainer.train_step(batches[step % TT_BATCHES], step))
        if step == 0:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launched = launched_since(before)
        check(launched == per_step, f"two-tower step {step} launched "
              f"{launched}, not {per_step}")
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t_all) * 1e3 - step_ms[0]
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(o["loss"]) for o in outs]
    check(all(np.isfinite(x) for x in losses), f"a loss was not finite: {losses}")
    check(not any(bool(o["skipped"]) for o in outs), "a step was skipped")
    check(peak < TT_PEAK_LIMIT_GB * 1e9, f"two-tower step peak "
          f"{peak / 1e9:.3f} GB, not under {TT_PEAK_LIMIT_GB} GB")
    log(f"two-tower train: {TT_STEPS} steps at {TRAIN_ROWS} rows, launches "
        f"{launches}; first step {step_ms[0]:.1f} ms, then "
        f"{steady_ms / (TT_STEPS - 1):.1f} ms a step (host clock to a "
        f"synchronize over {TT_STEPS - 1} steps); peak memory "
        f"{peak / 1e9:.3f} GB, {peak / table_bytes:.2f} tables "
        f"({live_before / 1e9:.3f} GB live before); losses "
        f"{[round(x, 5) for x in losses]}")
    traced = trace(lambda: trainer.train_step(batches[0], TT_STEPS), 1)
    step_view = {k: traced[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                        "top")}
    step_view["kernel_ms"] = step_kernel_ms(traced["by_name"])
    log(f"traced two-tower train step: wall {traced['wall_ms']:.1f} ms, "
        f"device busy {traced['busy_ms']:.1f} ms (idle share "
        f"{traced['idle_share']:.3f}); kernels {step_view['kernel_ms']}; top "
        + "; ".join(f"{name} {ms:.2f} ms" for name, ms in traced["top"]))
    # one more step's mpe_qat, segment-sum and Adam arguments, held against
    # their plain versions (the segment sums once the trainer is gone: the
    # plain version's float64 gradient of the whole table is 21.5 GB)
    calls = captured(lambda: trainer.train_step(batches[1], TT_STEPS + 1),
                     {"mixed_expectation_bwd": qat_ops,
                      "segment_sum": seg_ops, "adam_step_": optimizer_module},
                     writes=ADAM_WRITES)
    # the table leaf's pass (41,943,040 x 64, past 2^31 elements) is timed
    # in the traced step only: copies of its p, m, v do not fit beside it
    adam_row = {**check_adam(calls.pop("adam_step_"), "two-tower step",
                             timed=False),
                "traced_step_ms_all_leaves": step_view["kernel_ms"]["adam"]}
    qat, qat_errs = [], [0.0, 0.0]
    for i, (rows, probs, alpha, beta, g, bits) in enumerate(
            calls["mixed_expectation_bwd"]):
        label = f"two-tower step: mpe_qat tower {i} at {rows.shape[0]} x {rows.shape[1]}"
        f, b = uncounted(lambda: check_qat(rows, probs, alpha, beta, g, bits,
                                           label))
        qat_errs = [max(qat_errs[0], f), max(qat_errs[1], b)]
        qat.append({**time_qat(rows, probs, alpha, beta, g, bits, label),
                    "max_abs_err_fwd": f, "max_abs_err_bwd": b})
    del calls["mixed_expectation_bwd"]

    # Eq. 11 sampling and the packed export of the whole table
    mpe = as_mpe_config(cfg.comp_cfg)
    trainer.carry["opt"] = None         # Adam's moments: two tables
    emb = trainer.params["embedding"]
    t0 = time.perf_counter()
    fb = feature_bits(sample_group_bits(emb, mpe),
                      buffers["embedding"]["group_of_feature"])
    table, meta = build_packed_table(emb["emb"], fb, emb["alpha"], emb["beta"],
                                     mpe)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    scfg = serve_cfg(cfg, n)
    ratio = Packed.storage_ratio(table, {"meta": meta}, scfg.comp_cfg)
    sparams = {k: v for k, v in trainer.params.items() if k != "embedding"}
    sparams = {**tree_map(lambda x: x.detach(), sparams), "embedding": table}
    sstate = trainer.state
    sbuffers = {**{k: v for k, v in buffers.items() if k != "embedding"},
                "embedding": {"meta": meta}}
    del trainer, emb, fb, outs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"two-tower export: Eq. 11 sampling and the packed table of {n} rows "
        f"in {export_s:.2f} s; storage ratio {ratio:.6f}; "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB live after the "
        f"training trees were freed")
    seg = uncounted(lambda: check_segment_sums(calls.pop("segment_sum"),
                                               "two-tower step"))
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    served = serve_two_tower(sparams, sbuffers, sstate, scfg, rng, prior, dev)
    return {"launches": launches, "first_step_ms": step_ms[0],
            "step_ms": steady_ms / (TT_STEPS - 1), "peak_bytes": peak,
            "table_bytes": table_bytes, "peak_tables": peak / table_bytes,
            "live_bytes_before": live_before, "losses": losses,
            "blocked_loss": blocked, "traced_step": step_view,
            "storage_ratio": ratio, "export_s": export_s, "init_s": init_s,
            "served": served,
            "step_inputs": {"errs": {"qat_fwd": qat_errs[0],
                                     "qat_bwd": qat_errs[1]},
                            "mpe_qat": qat, "segment_sum": seg,
                            "adam": adam_row}}


# ---------------------------------------------------------------------------
# phase 21: GIN at full width
# ---------------------------------------------------------------------------

def gin_per_step(cfg, n_leaves: int) -> dict:
    """The launches one GIN step makes: a segment sum for each layer's
    message scatter and, on graph readout, the pooling (forwards); one for
    each message gather whose input takes a gradient (every layer's but the
    first on dense features, which take none) and, on categorical input,
    the lookup's two gathers (backwards); the ``mpe_qat`` forward and
    backward once on categorical input; the Adam pass once a leaf."""
    categorical = cfg.input_mode == "categorical"
    seg = (cfg.n_layers + (cfg.readout == "graph")
           + cfg.n_layers - (not categorical) + 2 * categorical)
    return {**{name: 0 for name in COUNTERS},
            "mixed_expectation_fwd": int(categorical),
            "mixed_expectation_bwd": int(categorical),
            "segment_sum": seg, "adam_step_": n_leaves}


def gin_device_graph(graph: dict, dev) -> dict:
    """The graph's arrays on the card (the static counts dropped)."""
    return {k: torch.from_numpy(v).to(dev) for k, v in graph.items()
            if isinstance(v, np.ndarray)}


def train_gin(shape: str, batches: list, dev, *, n_steps: int) -> dict:
    """``n_steps`` ``Trainer`` steps of full-width GIN on ``shape``'s cell
    (``batches`` in turn), each step's launches checked against
    ``gin_per_step``; returns the trainer, the per-step ms, the launches and
    the peak memory."""
    cfg = get_arch("gin-tu").make_config(shape=shape)
    cell = GRAPH_CELLS[shape]
    freqs = (zipf_prior(cfg.atom_vocab)
             if cfg.input_mode == "categorical" else None)
    params, buffers = GIN.init(cfg, freqs, seed=SEED, device=dev)
    n_graphs = cell.n_graphs

    def loss_fn(p, bu, st, batch, *, step=None):
        graph = dict(batch, n_graphs=n_graphs) if n_graphs else batch
        loss, ce = GIN.loss_fn(p, bu, graph, cfg, lam=GIN_LAM, train=True,
                               step=step)
        return loss, (st, ce)

    trainer = Trainer(loss_fn, params, buffers, {}, adam(1e-3))
    per_step = gin_per_step(cfg, len(leaves(trainer.params)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outs, step_ms = [], []
    for step in range(n_steps):
        before = counts()
        t0 = time.perf_counter()
        outs.append(trainer.train_step(batches[step % len(batches)], step))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launched = launched_since(before)
        check(launched == per_step, f"gin {shape} step {step} launched "
              f"{launched}, not {per_step}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(o["loss"]) for o in outs]
    check(all(np.isfinite(x) for x in losses),
          f"gin {shape}: a loss was not finite: {losses}")
    check(not any(bool(o["skipped"]) for o in outs),
          f"gin {shape}: a step was skipped")
    eps = [float(layer["eps"]) for layer in trainer.params["layers"]]
    check(all(e != 0.0 for e in eps), f"gin {shape}: an ε did not move: {eps}")
    log(f"gin {shape}: {n_steps} steps, {per_step['segment_sum']} segment "
        f"sums and {per_step['adam_step_']} Adam passes a step; step ms "
        f"{[round(x, 2) for x in step_ms]} (host clock to a synchronize); "
        f"peak memory {peak / 1e9:.3f} GB; losses "
        f"{[round(x, 5) for x in losses]}; ε {[round(e, 6) for e in eps]}")
    return {"trainer": trainer, "cfg": cfg, "buffers": buffers,
            "launches": launches, "step_ms": step_ms, "peak_bytes": peak,
            "losses": losses, "eps": eps, "per_step": per_step}


def scatter_record(x, seg, n: int, what: str, plain_cols: int) -> dict:
    """``scatter_sum`` forward at a path's shape held against its plain
    version bit for bit (the plain version by column tiles of
    ``plain_cols``: its float64 copy of the whole may not fit), twice
    bit-identical; then timed beside the tiled plain version,
    ``index_add_`` (one PyTorch call for the same sums, in float32; timed
    only) and the byte bound (x read once, the segment ids, the output
    written once)."""
    t, w = x.shape
    label = f"{what}: scatter_sum ({t} x {w} -> {n})"
    got, again = uncounted(lambda: (seg_ops.scatter_sum(x, seg, n),
                                    seg_ops.scatter_sum(x, seg, n)))
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{label}: two runs gave other bits")
    del again
    differ = 0
    for c in range(0, w, plain_cols):
        want = segment_sum_ref(x[:, c:c + plain_cols], seg, n)
        differ += int((got[:, c:c + plain_cols] != want).sum())
        del want
    check(differ == 0, f"{label}: {differ} elements differ from the plain "
          f"version")
    hot = int(torch.bincount(seg, minlength=n).max())
    del got
    nbytes = t * w * 4 + t * seg.element_size() + n * w * 4

    def plain():
        for c in range(0, w, plain_cols):
            segment_sum_ref(x[:, c:c + plain_cols], seg, n)

    row = {"rows": t, "w": w, "n": n, "hot_segment": hot, "max_abs_err": 0.0,
           "max_abs_want": None, "max_err_over_max_want": 0.0,
           "elements_differ": 0, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "plain_by_columns": plain_cols}
    row.update(uncounted(lambda: {
        "ms": cuda_ms(lambda: seg_ops.scatter_sum(x, seg, n), 5, warmup=1),
        "plain_ms": cuda_ms(plain, 1, warmup=0),
        "library_ms": cuda_ms(lambda: torch.zeros(
            (n, w), device=x.device).index_add_(0, seg, x), 3, warmup=1)}))
    row["split"] = segment_sum_split(x, seg, n)
    log(f"{label}: bit-identical to the plain version, twice; hot segment "
        f"{hot} rows; {row['ms']:.4f} ms a call, the sort included (plain "
        f"{row['plain_ms']:.4f} ms by {plain_cols} columns; index_add_ "
        f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms, "
        f"{row['bound_ms'] / row['ms']:.1%} of it); split {row['split']}")
    return row


def phase_gin(dev) -> dict:
    """GIN at full width (5 layers, d 64, learnable ε): the molecule cell,
    ``full_graph_sm`` (cora's geometry: its 1,433-wide first scatter) and
    ``ogb_products`` (61.9 M edges), each step's launches checked; one
    traced ``ogb_products`` step; the scatter at ``ogb_products``' shape
    and at w = 1,433 held against its plain version and timed."""
    out = {}
    cell = GRAPH_CELLS["molecule"]
    mol = [make_molecule_batch(cell.n_graphs, cell.n_nodes, cell.n_edges,
                               atom_vocab=cell.atom_vocab, seed=SEED + s)
           for s in range(GIN_STEPS["molecule"])]
    mol = [gin_device_graph(b, dev) for b in mol]
    res = train_gin("molecule", mol, dev, n_steps=GIN_STEPS["molecule"])
    step = check_step_inputs(res["trainer"], mol[0], GIN_STEPS["molecule"],
                             "gin molecule")
    cfg = res["cfg"]
    mpe = as_mpe_config(cfg.comp_cfg)
    emb = res["trainer"].params["embedding"]
    fb = feature_bits(sample_group_bits(emb, mpe),
                      res["buffers"]["embedding"]["group_of_feature"])
    bits = average_bits(fb, mpe)
    log(f"gin molecule: Eq. 11 sampling, the atom table's average width "
        f"{bits:.4f} bits (ratio {bits / 32:.4f})")
    out["molecule"] = {k: res[k] for k in ("launches", "step_ms", "peak_bytes",
                                           "losses", "eps")}
    out["molecule"].update({"avg_bits": bits, "step_inputs": step})
    del res, mol

    cell = GRAPH_CELLS["full_graph_sm"]
    cora = make_sbm_graph(cell.n_nodes, cell.n_edges, cell.d_feat,
                          cell.n_classes, seed=SEED)
    cora_dev = gin_device_graph(cora, dev)
    res = train_gin("full_graph_sm", [cora_dev], dev,
                    n_steps=GIN_STEPS["full_graph_sm"])
    step = check_step_inputs(res["trainer"], cora_dev,
                             GIN_STEPS["full_graph_sm"], "gin cora")
    widths = sorted({r["w"] for r in step["segment_sum"]})
    check(max(widths) == cell.d_feat, f"gin cora: no {cell.d_feat}-wide "
          f"scatter among the step's segment sums ({widths})")
    out["full_graph_sm"] = {k: res[k] for k in ("launches", "step_ms",
                                                "peak_bytes", "losses", "eps")}
    out["full_graph_sm"]["step_inputs"] = step
    del res
    scatter = {"cora w 1433": scatter_record(
        torch.from_numpy(cora["x"]).to(dev)[cora_dev["edge_src"].long()],
        cora_dev["edge_dst"], cell.n_nodes, "gin cora", 128)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    wide = torch.randn((GIN_WIDE_ROWS, cell.d_feat), generator=gen, device=dev)
    wide_seg = torch.randint(0, GIN_WIDE_SEGMENTS, (GIN_WIDE_ROWS,),
                             generator=gen, device=dev).to(torch.int32)
    scatter[f"w 1433, {GIN_WIDE_ROWS} rows"] = scatter_record(
        wide, wide_seg, GIN_WIDE_SEGMENTS, "gin wide", 128)
    del wide, wide_seg, cora, cora_dev
    gc.collect()
    torch.cuda.empty_cache()

    cell = GRAPH_CELLS["ogb_products"]
    t0 = time.perf_counter()
    products = make_sbm_graph(cell.n_nodes, cell.n_edges, cell.d_feat,
                              cell.n_classes, seed=SEED)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    products_dev = gin_device_graph(products, dev)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    del products
    log(f"gin ogb_products: the graph ({cell.n_nodes} nodes, {cell.n_edges} "
        f"edges, {cell.d_feat} features) made on the host in {graph_s:.1f} s "
        f"(make_sbm_graph), copied to the card in {copy_s:.2f} s")
    res = train_gin("ogb_products", [products_dev], dev,
                    n_steps=GIN_STEPS["ogb_products"])
    trainer = res["trainer"]
    traced = trace(lambda: trainer.train_step(products_dev,
                                              GIN_STEPS["ogb_products"]), 1)
    kernel_ms = step_kernel_ms(traced["by_name"])
    library = {name: ms for name, ms in traced["by_name"].items()
               if any(k in name for k in GIN_LIBRARY_SCATTERS)}
    check(kernel_ms["segment_sum"] > 0, "traced gin ogb_products step: no "
          "segment-sum kernel in the trace")
    check(not library, f"traced gin ogb_products step: library scatter "
          f"kernels ran: {library}")
    step_view = {k: traced[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                        "top")}
    step_view["kernel_ms"] = kernel_ms
    log(f"traced gin ogb_products step: wall {traced['wall_ms']:.1f} ms, "
        f"device busy {traced['busy_ms']:.1f} ms (idle share "
        f"{traced['idle_share']:.3f}); kernels {kernel_ms}; no library "
        f"scatter; top " + "; ".join(f"{name} {ms:.2f} ms"
                                     for name, ms in traced["top"]))
    out["ogb_products"] = {k: res[k] for k in ("launches", "step_ms",
                                               "peak_bytes", "losses", "eps")}
    out["ogb_products"].update({"graph_host_s": graph_s, "copy_s": copy_s,
                                "traced_step": step_view})
    del res, trainer
    gc.collect()
    torch.cuda.empty_cache()
    x = torch.randn((cell.n_edges, cell.d_feat), generator=gen, device=dev)
    scatter["ogb_products"] = scatter_record(
        x, products_dev["edge_dst"], cell.n_nodes, "gin ogb_products", 20)
    del x, products_dev
    gc.collect()
    torch.cuda.empty_cache()
    out["scatter"] = scatter
    return out


# -- the LM: its kernels' grid, flash at its shapes, and its serving paths ---

KVW_SOURCE = "src/repro_torch/csrc/kv_cache_write.cu"
DECODE_ATT_SOURCE = "src/repro_torch/csrc/decode_attention.cu"
LM_ARCH, MOE_ARCH = "internlm2-1.8b", "deepseek-moe-16b"
MOE_LAYERS = 2                  # of deepseek-moe-16b's 28
LM_SLOTS, LM_MAX_LEN = 8, 32768  # decode_32k cut to one card: 8 slots
LM_REQUESTS = 24
LM_PROMPT = (16, 128)           # prompt lengths, both ends included
LM_NEW = (16, 32)               # max_new, both ends included
LM_DEADLINE_MS = 60_000.0       # on every third request
LM_CHECK_EVERY = 8              # slotted steps between plain-route checks
LM_PREFILL = 32768              # prefill_32k cut to one sequence
LM_FLASH_S = 4096               # a prefill short enough for the plain version
LM_DECODE_STEPS = 8
LONG_LEN, LONG_STEPS = 524288, 4
LONG_PROBE = 256                # the prefill that calibrates long_500k's scales
LONG_SCALE_MARGIN = 1.5         # its scales over the probe's
LONG_CODE_STD = 127 / 4         # its codes ~ N(0, 127/4): absmax near 127
LONG_FILL_CHUNK = 1 << 28       # codes drawn at a time
MOE_PREFILL, MOE_STEPS = 4096, 8
LM_LOGIT_TOL = 0.1              # |kernel - plain| over the row's max |plain|
LM_PLAIN_CHUNK = 4096           # blocks of the plain long-sequence route
LM_TIMED_STEPS = 20
DECODE_ATT_F32_TOL = dict(rtol=3e-5, atol=3e-5)   # float32 queries
DECODE_GRID_B = (1, 3, 8)
DECODE_GRID_T = (1, 63, 64, 65, 4096, 8193)
DECODE_GRID_GROUPS = ((1, 1), (2, 1), (8, 1), (16, 8))   # (Hq, Hkv)
DECODE_GRID_HD = (16, 64, 128)
DECODE_GRID_KINDS = (("int8", torch.bfloat16), ("int8", torch.float32),
                     ("bf16", torch.bfloat16), ("f32", torch.float32))
CACHE_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16,
                "f32": torch.float32}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(torch.clamp_min(x.abs(), 2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def decode_attention_error(got, q, k, v, ks, vs, off, valid, want,
                           what: str) -> float:
    """``got`` against the plain ``want`` under the contract: within 3e-5
    (rtol and atol) with float32 queries; with bf16 ones within one bf16
    ulp of the output plus one bf16 step of each probability (2^-8) weighted
    by |v| — both round float32 probabilities to bf16, and their float32
    sums, taken in other orders, move one across a rounding boundary now
    and then. Returns the largest |difference|."""
    g, w = got.float(), want.float()
    if q.dtype == torch.float32:
        return within(g, w, DECODE_ATT_F32_TOL, what)
    weight = decode_attention_ref(q, k, v.abs(), ks, vs, off, valid).float()
    tol = bf16_ulp(w) + 2.0 ** -8 * weight
    check(bool(((g - w).abs() <= tol).all()),
          f"{what}: outside one bf16 ulp (max |diff| {max_abs(g, w):.3e})")
    return max_abs(g, w)


def lm_cache_case(gen, b, t, h, hd, s, kind, q_dtype, dev):
    """A cache of ``kind`` holding random content (its scales between
    0.01 and 0.05), new values (one row in two four times louder than its
    scale holds) and mixed lengths: fresh (0), at the end (T - s), past it
    (T), between."""
    dtype = CACHE_DTYPES[kind]
    if dtype == torch.int8:
        cache = torch.randint(-127, 128, (b, t, h, hd), generator=gen,
                              device=dev, dtype=torch.int8)
        scale = 0.01 + 0.04 * torch.rand((b, 1, h, 1), generator=gen,
                                         device=dev)
    else:
        cache = torch.randn((b, t, h, hd), generator=gen, device=dev).to(dtype)
        scale = None
    loud = torch.where(torch.rand((b, 1, h, 1), generator=gen, device=dev)
                       < 0.5, 4.0, 0.1)
    vals = (torch.randn((b, s, h, hd), generator=gen, device=dev)
            * loud).to(q_dtype)
    picks = [0, t - s, t, max(t - s - 1, 0), (t - s) // 2]
    lens = torch.tensor([picks[i % len(picks)] for i in range(b)],
                        dtype=torch.int32, device=dev)
    return cache, scale, vals, lens


KV_PIECE_T = (4097, 8193, 32768)   # past one piece of the re-projection
KV_PIECE_S = (1, 3, 64)            # the decode route, and past it at hd 128


def piece_lengths(t: int, s: int, dev) -> torch.Tensor:
    """Eight rows' lengths across the re-projection's pieces: fresh, one
    piece and more, several, half of T, T - s, past T - s, T."""
    return torch.tensor([0, 1500, 4100, t // 2 + 7, t - s, min(t - s + 3, t),
                         t, 2049], dtype=torch.int32, device=dev)


def kv_pair_grid(gen, dev) -> int:
    """A layer's keys and values in one ``kv_cache_write_kv`` call over
    caches longer than one piece (T ``KV_PIECE_T`` × s ``KV_PIECE_S``, 8
    rows at ``piece_lengths``, 2 heads of 128; int8 with bf16 and float32
    values, and bf16), per-row and shared lengths, loud rows growing their
    scales: bit for bit the plain version on keys, then values, in
    ``kernels_a_call`` launches. Then one write captured in a CUDA graph
    and replayed twice, louder the second time (every grown scale grows
    again), at s 1 and 64: bit for bit both times."""
    n = 0
    h, hd = 2, 128
    for t in KV_PIECE_T:
        for s in KV_PIECE_S:
            for kind, q_dtype in (("int8", torch.bfloat16),
                                  ("int8", torch.float32),
                                  ("bf16", torch.bfloat16)):
                k = lm_cache_case(gen, 8, t, h, hd, s, kind, q_dtype, dev)
                v = lm_cache_case(gen, 8, t, h, hd, s, kind, q_dtype, dev)
                lens = piece_lengths(t, s, dev)
                for ln in (lens, lens[3:4].reshape(())):
                    got = [None if x is None else x.clone()
                           for x in (k[0], k[1], v[0], v[1])]
                    want = [None if x is None else x.clone() for x in got]
                    before = kvw_ops.kv_cache_write.launches
                    kvw_ops.kv_cache_write_kv(got[0], got[1], k[2], got[2],
                                              got[3], v[2], ln)
                    kernels = kvw_ops.kv_cache_write.launches - before
                    kv_cache_write_ref(want[0], want[1], k[2], ln)
                    kv_cache_write_ref(want[2], want[3], v[2], ln)
                    what = f"kv_cache_write_kv T={t} s={s} {kind} {q_dtype}"
                    check(kernels == kvw_ops.kernels_a_call(
                        s, hd, CACHE_DTYPES[kind]), f"{what}: {kernels} "
                        f"launches")
                    check(all(g is None or torch.equal(g, w)
                              for g, w in zip(got, want)),
                          f"{what}: not bit-identical")
                    if kind == "int8":
                        check(bool((got[1] > k[1]).any()),
                              f"{what}: no scale grew")
                    n += 1
                del k, v
    t, h = 8193, 8
    for s in (1, 64):
        k = lm_cache_case(gen, 8, t, h, hd, s, "int8", torch.bfloat16, dev)
        v = lm_cache_case(gen, 8, t, h, hd, s, "int8", torch.bfloat16, dev)
        lens = piece_lengths(t, s, dev)
        kx, vx = k[2].clone(), v[2].clone()
        caches = [x.clone() for x in (k[0], k[1], v[0], v[1])]

        def write():
            kvw_ops.kv_cache_write_kv(caches[0], caches[1], kx, caches[2],
                                      caches[3], vx, lens)
        replay = capture_graph(write)
        for x, y in zip(caches, (k[0], k[1], v[0], v[1])):
            x.copy_(y)
        eager = [x.clone() for x in caches]
        for loud in (4.0, 16.0):
            kx.copy_((k[2].float() * loud).to(kx.dtype))
            vx.copy_((v[2].float() * loud).to(vx.dtype))
            before = caches[1].clone()
            replay()
            kv_cache_write_ref(eager[0], eager[1], kx, lens)
            kv_cache_write_ref(eager[2], eager[3], vx, lens)
            torch.cuda.synchronize()
            check(all(torch.equal(g, w) for g, w in zip(caches, eager)),
                  f"kv_cache_write_kv in a CUDA graph, s={s}, replay at "
                  f"{loud}x: not bit-identical")
            check(bool((caches[1] > before).any()),
                  f"kv_cache_write_kv in a CUDA graph, s={s}: no scale grew")
            n += 1
        del replay, k, v, caches, eager
    return n


def phase_lm_grid(dev) -> dict:
    """``kv_cache_write`` and ``decode_attention`` against their plain
    versions: B {1, 3, 8} × T {1, 63, 64, 65, 4096} × mixed lengths × hd
    {16, 64, 128}; the write over H {1, 2, 8} × s {1, T} × int8, bf16 and
    float32 caches (values bf16 or float32), bit for bit, a shared length
    too, then ``kv_pair_grid``'s keys and values in one call over several
    pieces and twice in a graph; attention over (Hq, Hkv) {(1, 1), (2, 1),
    (8, 1), (16, 8)} × s {1, 4} × int8 (bf16 and float32 queries), bf16 and
    float32 caches, under ``decode_attention_error``'s contract."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_write = n_att = 0
    worst = {"kv_cache_write": 0.0, "decode_attention": 0.0}
    for b in DECODE_GRID_B:
        for t in DECODE_GRID_T:
            for hd in DECODE_GRID_HD:
                for kind, q_dtype in DECODE_GRID_KINDS:
                    for h in (1, 8):
                        for s in sorted({1, t}):
                            cache, scale, vals, lens = lm_cache_case(
                                gen, b, t, h, hd, s, kind, q_dtype, dev)
                            for ln in (lens, lens[:1].reshape(())):
                                c1, c2 = cache.clone(), cache.clone()
                                s1, s2 = ((None, None) if scale is None
                                          else (scale.clone(), scale.clone()))
                                before = kvw_ops.kv_cache_write.launches
                                kvw_ops.kv_cache_write(c1, s1, vals, ln)
                                check(kvw_ops.kv_cache_write.launches - before
                                      == kvw_ops.kernels_a_call(
                                          s, hd, cache.dtype),
                                      f"kv_cache_write s={s} hd={hd}: "
                                      f"launches")
                                kv_cache_write_ref(c2, s2, vals, ln)
                                check(torch.equal(c1, c2) and (
                                    s1 is None or torch.equal(s1, s2)),
                                    f"kv_cache_write B={b} T={t} H={h} "
                                    f"hd={hd} s={s} {kind}: not bit-identical")
                                n_write += 1
                    for hq, hkv in DECODE_GRID_GROUPS:
                        for s in sorted({1, min(4, t)}):
                            k, ks, _, lens = lm_cache_case(
                                gen, b, t, hkv, hd, s, kind, q_dtype, dev)
                            v, vs, _, _ = lm_cache_case(
                                gen, b, t, hkv, hd, s, kind, q_dtype, dev)
                            q = torch.randn((b, s, hq, hd), generator=gen,
                                            device=dev).to(q_dtype)
                            off = torch.clamp(lens, max=t - s)
                            got = da_ops.decode_attention(
                                q, k, v, ks, vs, q_offset=off,
                                kv_valid_len=off + s)
                            want = decode_attention_ref(q, k, v, ks, vs, off,
                                                        off + s)
                            worst["decode_attention"] = max(
                                worst["decode_attention"],
                                decode_attention_error(
                                    got, q, k, v, ks, vs, off, off + s, want,
                                    f"decode_attention B={b} T={t} "
                                    f"({hq}, {hkv}) hd={hd} s={s} {kind} "
                                    f"q {q_dtype}"))
                            n_att += 1
    n_pair = kv_pair_grid(gen, dev)
    n_write += n_pair
    torch.cuda.synchronize()
    log(f"LM kernel grid: kv_cache_write {n_write} cases bit-identical to "
        f"its plain version ({n_pair} of them keys and values in one call, "
        f"over several pieces and replayed in a graph); decode_attention "
        f"{n_att} cases within the contract, max |diff| "
        f"{worst['decode_attention']:.3e}")
    return {**worst, "cases": {"kv_cache_write": n_write,
                               "decode_attention": n_att}}


def lm_flash_row(q, k, v, what: str, slices=None) -> dict:
    """The flash forward (causal) at one of the LM's shapes, (B, S, H, hd)
    with the kv heads repeated to the query heads as ``flash_attention``
    hands them over: held against its plain version (on every head, or on
    the ``slices`` (b, h) alone where S × S float32 logits of every head
    would not fit), timed beside its bound, the plain version over every
    head one after another, and SDPA."""
    b, s, h, hd = q.shape
    o = flash_ops.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    heads = slices or [(i, j) for i in range(b) for j in range(h)]
    err = 0.0
    for i, j in heads:
        want = flash_attention_ref(q[i:i + 1, :, j], k[i:i + 1, :, j],
                                   v[i:i + 1, :, j], True)
        err = max(err, within(o[i:i + 1, :, j], want, FLASH_TOL,
                              f"{what}: o at (b, h) = ({i}, {j})"))
        del want
    del o
    iters = 3 if s > 8192 else 10

    def plain():
        for i in range(b):
            for j in range(h):
                flash_attention_ref(q[i:i + 1, :, j], k[i:i + 1, :, j],
                                    v[i:i + 1, :, j], True)
    row = {**flash_work(b * h, s, hd, "fwd", True), "max_abs_err": err,
           "ms": cuda_ms(lambda: flash_ops.flash_attention_fwd(q, k, v, True),
                         iters, warmup=1),
           "plain_ms": cuda_ms(plain, 1, warmup=0),
           "library_ms": sdpa_fwd_ms(q, k, v, iters),
           "S": s, "input_shape": list(q.shape), "causal": True,
           "checked_heads": len(heads)}
    log(f"flash fwd at {what} ({tuple(q.shape)}, tiled route): max |diff| "
        f"{err:.3e} on {len(heads)} (b, h); {row['ms']:.3f} ms ("
        f"plain {row['plain_ms']:.3f}, "
        f"SDPA {row['library_ms']:.3f}); {bounds_text(row)}")
    return row


def sdpa_fwd_ms(q, k, v, iters: int) -> float:
    """``F.scaled_dot_product_attention``'s causal forward on (B, H, S, hd)
    views of the same inputs. Timed only; the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))
    return cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True), iters, warmup=1)


def phase_lm_flash(dev) -> dict:
    """The flash forward at internlm2-1.8b's prefill shapes (16 heads of
    128): S = 4,096, every head against the plain version, and S = 32,768,
    two (b, h) slices against it."""
    cfg = get_arch(LM_ARCH).make_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    last = (0, cfg.n_heads - 1)
    for s, slices in ((LM_FLASH_S, None), (LM_PREFILL, [(0, 0), last])):
        q, k, v = (torch.randn((1, s, cfg.n_heads, cfg.head_dim),
                               generator=gen, device=dev) for _ in range(3))
        out[f"lm_prefill_{s // 1024}k"] = {"fwd": lm_flash_row(
            q, k, v, f"internlm2 prefill S={s}", slices)}
        del q, k, v
    return out


def _plain_kv_write_kv(k_cache, k_scale, k, v_cache, v_scale, v, lens):
    lens = as_lengths(lens, k_cache.shape[0], k_cache.device)
    return (kv_cache_write_ref(k_cache, k_scale, k, lens),
            kv_cache_write_ref(v_cache, v_scale, v, lens))


def _plain_decode_attention(q, k, v, k_scale=None, v_scale=None, *,
                            q_offset, kv_valid_len, causal=True):
    b = q.shape[0]
    return decode_attention_ref(q, k, v, k_scale, v_scale,
                                as_lengths(q_offset, b, q.device),
                                as_lengths(kv_valid_len, b, q.device), causal)


def _plain_long_attention(q, k, v, *, n_kv_heads=None, causal=True):
    """The long-sequence route's plain version: ``chunked_gqa_attention``
    by blocks of ``LM_PLAIN_CHUNK`` (the whole (S × S) logits of a 32k
    prompt would not fit)."""
    s = q.shape[1]
    chunk = LM_PLAIN_CHUNK if s % LM_PLAIN_CHUNK == 0 else s
    return chunked_gqa_attention(q, k, v, n_kv_heads=k.shape[2],
                                 causal=causal, q_chunk=chunk, kv_chunk=chunk)


def _twin_decode_attention(q, k, v, k_scale=None, v_scale=None, *,
                           q_offset, kv_valid_len, causal=True):
    """The plain decode attention with its probabilities kept in float32 (v
    widened first): a second plain route, one rounding fewer, whose gap to
    the first is the bf16 model's own spread."""
    if k.dtype == torch.int8:
        k = dequantize_symmetric(k, k_scale, q.dtype)
        v = dequantize_symmetric(v, v_scale, q.dtype)
    b = q.shape[0]
    return grouped_attention(q, k, v.to(torch.float32), causal=causal,
                             q_offset=as_lengths(q_offset, b, q.device),
                             kv_valid_len=as_lengths(kv_valid_len, b,
                                                     q.device))


def with_plain_lm(fn, twin: bool = False):
    """``fn()`` with the LM's kernels through their plain versions: the
    cache write, decode attention (``_twin_decode_attention`` with
    ``twin``), the long-sequence attention (chunked), the packed lookup and
    the MoE combine. Its launches are not counted."""
    swaps = [(transformer_module, "kv_cache_write_kv", _plain_kv_write_kv),
             (transformer_module, "decode_attention",
              _twin_decode_attention if twin else _plain_decode_attention),
             (transformer_module, "flash_attention", _plain_long_attention),
             (compressors, "packed_lookup", _plain_lookup),
             (moe_module, "scatter_sum", segment_sum_ref)]
    old = [getattr(module, name) for module, name, _ in swaps]
    before = counts()
    for module, name, fn_ in swaps:
        setattr(module, name, fn_)
    try:
        return fn()
    finally:
        for (module, name, _), fn_ in zip(swaps, old):
            setattr(module, name, fn_)
        for name, n in before.items():
            COUNTERS[name].launches = n


def logit_gap(got, want) -> float:
    """The largest |got - want| of a row over that row's largest |want|."""
    g, w = got.float().reshape(-1, got.shape[-1]), \
        want.float().reshape(-1, want.shape[-1])
    return float(((g - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp_min(1e-30)).max())


def check_logits(got, want, what: str, twin=None) -> dict:
    """The kernel route's logits against the plain route's: each row within
    ``LM_LOGIT_TOL`` of its largest |plain logit|, or within twice the gap
    of the plain route's twin (``_twin_decode_attention``, one rounding
    fewer, on the same step) where that is larger — the bf16 model's own
    spread, which 24 layers of random weights amplify; and the greedy token
    the same wherever the plain route's top-2 margin exceeds the
    tolerance."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    check(bool(torch.isfinite(g).all()), f"{what}: logits not finite")
    gap = logit_gap(g, w)
    floor = None if twin is None else logit_gap(twin, w)
    tol = LM_LOGIT_TOL if floor is None else max(LM_LOGIT_TOL, 2 * floor)
    check(gap <= tol, f"{what}: logits {gap:.3e} of the row's largest apart, "
          f"more than {tol:.3e} (the twin's gap {floor})")
    scale = w.abs().amax(-1)
    top2 = w.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol * scale
    same = g.argmax(-1) == w.argmax(-1)
    check(bool(same[decided].all()),
          f"{what}: a greedy token differs where the margin decides it")
    return {"gap": gap, "twin_gap": floor, "tolerance": tol,
            "rows": int(g.shape[0]), "decided": int(decided.sum()),
            "same_token": int(same.sum())}


def plain_and_twin(run, mirror):
    """``run(mirror)`` through the plain route, then through its twin on the
    same caches where the plain step grew no int8 scale (it wrote only the
    new position, which the twin writes again): → (plain logits, twin
    logits or None)."""
    scales = {k: mirror[k].clone() for k in ("k_scale", "v_scale")
              if k in mirror}
    want = with_plain_lm(lambda: run(mirror))[0]
    if any(not torch.equal(x, mirror[k]) for k, x in scales.items()):
        return want, None
    return want, with_plain_lm(lambda: run(mirror), twin=True)[0]


def lm_model(arch: str, dev, n_layers: int | None = None):
    """``arch``'s full-width config (its first ``n_layers`` where given)
    initialised from the seed on the card, its token table packed:
    ``Packed.init`` — the MPE search layer over ``TokenStream``'s expected
    Zipf frequencies, Eq. 11 widths from a random γ, ``build_packed_table``
    — all on the card."""
    cfg = get_arch(arch).make_config()
    if n_layers is not None:
        cfg = cfg._replace(n_layers=n_layers)
    cfg = cfg._replace(compressor="packed")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    freqs = TokenStream(cfg.vocab, 1, 1).expected_frequencies()
    t0 = time.perf_counter()
    params, buffers = LM.init(gen, cfg, freqs=freqs)
    torch.cuda.synchronize()
    meta = buffers["embedding"]["meta"]
    table = params["embedding"]
    wpr = [words_per_row(meta["d"], b) if b else 0 for b in meta["bits"]]
    n_params = sum(x.numel() for x in leaves(params["layers"])) \
        + params["lm_head"].numel() + params["ln_f"]["scale"].numel()
    table_bytes = sum(x.numel() * x.element_size() for x in leaves(table))
    log(f"{arch} ({cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} "
        f"heads / {cfg.n_kv_heads} kv of {cfg.head_dim}, vocab "
        f"{cfg.vocab}, {cfg.dtype}) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s: {n_params} parameters outside "
        f"the token table; packed table widths {meta['bits']}, words a row "
        f"{wpr}, {table_bytes} bytes")
    return cfg, params, buffers


def param_bytes(params) -> int:
    """Bytes a forward reads of the weights outside the token table."""
    return sum(x.numel() * x.element_size()
               for x in leaves({k: v for k, v in params.items()
                                if k != "embedding"}))


def step_bound_ms(params, cfg, valid_keys: int, rows: int) -> float:
    """The least time a decode step could take: every weight read once
    (the token table's rows are a few kilobytes) and each row's valid int8
    keys and values read once, with their scales, over 3.35 TB/s."""
    kv = valid_keys * 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
    scales = 2 * cfg.n_layers * rows * cfg.n_kv_heads * 4
    return (param_bytes(params) + kv + scales) / HBM_BYTES_PER_S * 1e3


def decode_attention_bytes(q, k, valid: torch.Tensor, quant: bool) -> int:
    """Bytes decode attention must move: each row's valid keys and values
    read once (with the scales), the queries read and the output written."""
    b, t, hkv, hd = k.shape
    keys = int(torch.clamp(valid, max=t).sum()) if valid.ndim else \
        b * min(int(valid), t)
    per_key = 2 * hkv * hd * k.element_size()
    return (keys * per_key + 2 * q.numel() * q.element_size()
            + (2 * b * hkv * 4 if quant else 0))


def sdpa_masked_ms(q, k, v, valid, iters: int) -> float:
    """``F.scaled_dot_product_attention`` over a bf16 cache with a boolean
    key mask (the valid lengths) and ``enable_gqa``, on (B, H, S, hd)
    views: one library call for decode attention's function (timed only,
    never on the port's path; it takes no int8 cache)."""
    t = k.shape[1]
    mask = (torch.arange(t, device=q.device)[None, :]
            < valid[:, None])[:, None, None, :]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask, enable_gqa=True),
                   iters)


def kv_write_bytes(vals, lens, t: int, grows: bool) -> int:
    """Bytes a write of ``vals`` (B, s, H, hd) into one int8 cache must
    move: the values read and their codes written once, the scales read
    and written, the lengths; where the scale grows also the stored prefix
    [0, start) of each row read and written once."""
    b, s, h, hd = vals.shape
    starts = torch.clamp(lens.to(torch.int64).reshape(-1).expand(b), 0, t - s)
    prefix = int(starts.sum()) if grows else 0
    return (vals.numel() * (vals.element_size() + 1) + 8 * b * h
            + 2 * prefix * h * hd + 4 * lens.numel())


def time_layer_write(k, ks, kx, v, vs, vx, lens, what: str) -> dict:
    """One layer's ``kv_cache_write_kv`` (keys and values in one call) on
    copies of these int8 caches and scales: held against the plain version
    (keys, then values) bit for bit, its kernels counted, then timed eager
    and replayed in a CUDA graph, the scales restored before each call
    (the restore timed alone) where the write changes them, beside the
    byte bound (``kv_write_bytes``; a changed scale at a length 0 moves
    no prefix) and the plain version."""
    t = k.shape[1]
    caches = [k.clone(), ks.clone(), v.clone(), vs.clone()]
    plain = [x.clone() for x in caches]
    saved = [ks.clone(), vs.clone()]
    before = kvw_ops.kv_cache_write.launches
    kvw_ops.kv_cache_write_kv(caches[0], caches[1], kx, caches[2], caches[3],
                              vx, lens)
    kernels = kvw_ops.kv_cache_write.launches - before
    kv_cache_write_ref(plain[0], plain[1], kx, lens)
    kv_cache_write_ref(plain[2], plain[3], vx, lens)
    check(all(torch.equal(a, b) for a, b in zip(caches, plain)),
          f"kv_cache_write_kv at {what}: not bit-identical to its plain "
          f"version")
    check(kernels == kvw_ops.kernels_a_call(kx.shape[1], kx.shape[3],
                                            torch.int8),
          f"kv_cache_write_kv at {what}: {kernels} launches")
    changed = not (torch.equal(caches[1], saved[0])
                   and torch.equal(caches[3], saved[1]))
    del plain

    def restore():
        caches[1].copy_(saved[0])
        caches[3].copy_(saved[1])

    def call():
        if changed:
            restore()
        kvw_ops.kv_cache_write_kv(caches[0], caches[1], kx, caches[2],
                                  caches[3], vx, lens)

    def plain_call():
        kv_cache_write_ref(caches[0], caches[1], kx, lens)
        kv_cache_write_ref(caches[2], caches[3], vx, lens)
    nbytes = 2 * kv_write_bytes(kx, lens, t, changed)
    row = {"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": 0.0, "kernels_a_layer": kernels,
           "scales_changed": changed,
           "ms": uncounted(lambda: cuda_ms(call, 50)),
           "graph_ms": uncounted(lambda: graph_ms(call, 50)),
           "plain_ms": cuda_ms(plain_call, 3, warmup=1),
           "library_ms": None, "shape": list(k.shape),
           "new_positions": kx.shape[1]}
    if changed:
        row["restore_ms"] = cuda_ms(restore, 50)
    del caches
    log(f"kv_cache_write_kv at {what}: {row['ms']:.4f} ms eager, "
        f"{row['graph_ms']:.4f} in a graph (plain {row['plain_ms']:.4f}); "
        f"{kernels} kernel(s); bound {row['bound_ms']:.4f} ms for {nbytes} "
        f"bytes" + (f"; the scales' restore {row['restore_ms']:.4f} ms "
                    f"of each call" if changed else ""))
    return row


def time_decode_kernels(params, cfg, caches, lens, what: str,
                        bf16_cache: bool = False, grow: bool = False) -> dict:
    """Layer 0's ``decode_attention`` and ``kv_cache_write_kv`` (its keys
    and values in one call) at one decode step's shapes on these caches
    and lengths (the write's values small, so no scale grows; with
    ``grow`` also loud ones that grow every scale: ``time_layer_write``),
    CUDA-event ms beside their byte bounds and their plain versions; with
    ``bf16_cache`` also
    ``decode_attention`` over layer 0's cache dequantized to bf16, held
    against its plain version (the bf16 contract) and timed beside
    ``sdpa_masked_ms`` on the same inputs."""
    dev = caches["k"].device
    b, t = caches["k"].shape[1:3]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((b, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    vals = (1e-3 * torch.randn((b, 1, cfg.n_kv_heads, cfg.head_dim),
                               generator=gen, device=dev)).to(torch.bfloat16)
    k, v = caches["k"][0], caches["v"][0]
    ks, vs = caches["k_scale"][0], caches["v_scale"][0]
    off = torch.clamp(lens, max=t - 1)
    valid = off + 1
    got = da_ops.decode_attention(q, k, v, ks, vs, q_offset=off,
                                  kv_valid_len=valid)
    want = decode_attention_ref(q, k, v, ks, vs, off, valid)
    err = decode_attention_error(got, q, k, v, ks, vs, off, valid, want,
                                 f"decode_attention at {what}")
    del got, want
    traced = uncounted(lambda: trace(lambda: da_ops.decode_attention(
        q, k, v, ks, vs, q_offset=off, kv_valid_len=valid), 5))
    passes = {p: sum(ms for name, ms in traced["by_name"].items()
                     if f"{p}_kernel" in name)
              for p in ("scores", "sums", "values", "combine")}
    att_bytes = decode_attention_bytes(q, k, valid, True)
    att = {"bytes": att_bytes, "bound_ms": att_bytes / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": err,
           "ms": uncounted(lambda: cuda_ms(lambda: da_ops.decode_attention(
               q, k, v, ks, vs, q_offset=off, kv_valid_len=valid), 20)),
           "plain_ms": cuda_ms(lambda: decode_attention_ref(
               q, k, v, ks, vs, off, valid), 5, warmup=1),
           "library_ms": None, "shape": [b, t, cfg.n_kv_heads, cfg.head_dim],
           "query_heads": cfg.n_heads, "valid_keys": int(valid.sum()),
           "passes_ms": passes}
    vals_v = (1e-3 * torch.randn(vals.shape, generator=gen, device=dev)
              ).to(torch.bfloat16)
    write = time_layer_write(k, ks, vals, v, vs, vals_v, off, what)
    if grow:
        loud = [(40.0 * torch.randn(vals.shape, generator=gen, device=dev))
                .to(torch.bfloat16) for _ in range(2)]
        write["scale_grows"] = time_layer_write(
            k, ks, loud[0], v, vs, loud[1], off, f"{what}, every scale grows")
    out = {"decode_attention": att, "kv_cache_write": write}
    if bf16_cache:
        kb, vb = (dequantize_symmetric(x, s_, torch.bfloat16)
                  for x, s_ in ((k, ks), (v, vs)))
        got = da_ops.decode_attention(q, kb, vb, q_offset=off,
                                      kv_valid_len=valid)
        want = decode_attention_ref(q, kb, vb, None, None, off, valid)
        err = decode_attention_error(got, q, kb, vb, None, None, off, valid,
                                     want, f"decode_attention at {what}, "
                                           f"bf16 cache")
        del got, want
        nbytes = decode_attention_bytes(q, kb, valid, False)
        out["decode_attention_bf16"] = {
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err,
            "ms": uncounted(lambda: cuda_ms(lambda: da_ops.decode_attention(
                q, kb, vb, q_offset=off, kv_valid_len=valid), 20)),
            "plain_ms": cuda_ms(lambda: decode_attention_ref(
                q, kb, vb, None, None, off, valid), 5, warmup=1),
            "library_ms": sdpa_masked_ms(q, kb, vb, valid, 20),
            "library_call": "F.scaled_dot_product_attention(q, k, v, "
                            "attn_mask=key mask, enable_gqa=True)",
            "shape": list(kb.shape), "query_heads": cfg.n_heads,
            "valid_keys": int(valid.sum())}
        del kb, vb
    for name, r in out.items():
        log(f"{name} at {what}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}"
            + (f"; SDPA {r['library_ms']:.4f}" if r.get("library_ms") else "")
            + f"); bound {r['bound_ms']:.4f} ms for {r['bytes']} bytes: "
            f"{r['bound_ms'] / r['ms']:.1%} of it"
            + (f"; traced passes {passes}" if name == "decode_attention"
               else ""))
    return out


def request_prompts(cfg):
    """``LM_REQUESTS`` prompts from ``TokenStream`` (lengths uniform in
    ``LM_PROMPT``), their ``max_new`` (uniform in ``LM_NEW``) and a deadline
    on every third."""
    rng = np.random.default_rng(SEED)
    rows = TokenStream(cfg.vocab, LM_REQUESTS, LM_PROMPT[1],
                       seed=SEED).batch_at(0)["tokens"]
    lengths = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    max_new = rng.integers(LM_NEW[0], LM_NEW[1] + 1, LM_REQUESTS)
    return [(rows[i, :lengths[i]], int(max_new[i]),
             LM_DEADLINE_MS if i % 3 == 0 else None)
            for i in range(LM_REQUESTS)]


def serve_requests(engine, requests) -> tuple:
    """Every request through ``submit_decode``, drained → (tokens of each,
    wall seconds)."""
    t0 = time.perf_counter()
    tickets = [engine.submit_decode(p, m, deadline_ms=dl)
               for p, m, dl in requests]
    check(all(t is not None for t in tickets), "a decode request was shed")
    engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = [engine.poll(t) for t in tickets]
    return out, wall


def phase_lm_slotted(dev, model) -> dict:
    """The continuous-batching lane at internlm2-1.8b's full width: the
    slotted cell (8 slots × 32,768, int8 caches) captured as a CUDA graph,
    24 requests served through ``submit_decode`` twice — first with every
    ``LM_CHECK_EVERY``-th step held against the plain route on a copy of
    the caches from before it, then with the counts at 0 (the same tokens
    again) — then the step timed and traced at full context."""
    cfg, params, buffers = model
    engine = Engine(device=dev)
    t0 = time.perf_counter()
    reg = engine.register(lm_decode_slotted_cell(
        cfg, params, buffers, batch=LM_SLOTS, max_len=LM_MAX_LEN,
        arch=LM_ARCH))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    session = engine.scheduler.sessions[LM_ARCH]
    caches = session.caches
    check(caches is reg.cell.inputs[2], "the session's caches are not the "
          "graph's")
    check(not bool(caches["k"].any()) and not bool(caches["v"].any())
          and bool((caches["k_scale"] == 0.05).all()),
          "the graph's caches were not reset to fresh ones")
    want_captured = {"mpe_lookup": 1, "kv_cache_write": cfg.n_layers,
                     "decode_attention": cfg.n_layers}
    check(reg.cell.captured == want_captured,
          f"the slotted cell captured {reg.cell.captured}, not "
          f"{want_captured}")
    requests = request_prompts(cfg)
    mirror = {k: torch.empty_like(x) for k, x in caches.items()}
    real = engine._timed_call
    checks, steps = [], [0]

    def checked(reg_, tokens, lens, cache):
        n = steps[0]
        steps[0] += 1
        if n % LM_CHECK_EVERY:
            return real(reg_, tokens, lens, cache)
        for k, x in cache.items():
            mirror[k].copy_(x)
        tok, ln = tokens.clone(), lens.clone()
        out, ms = real(reg_, tokens, lens, cache)
        want, twin = plain_and_twin(lambda c: LM.decode_step_slotted(
            params, buffers, tok, ln, c, cfg), mirror)
        checks.append(check_logits(out[0], want, f"slotted step {n}", twin))
        return out, ms

    engine._timed_call = checked
    first, _ = serve_requests(engine, requests)
    engine._timed_call = real
    del mirror
    torch.cuda.empty_cache()
    reset_counts()
    reg.cell.replays = 0
    steps_before = session.steps
    engine.stats = LatencyStats()
    engine.rstats = RequestStats()
    torch.cuda.reset_peak_memory_stats()
    tokens, wall = serve_requests(engine, requests)
    launches = {**counts(), **reg.cell.launches}
    replays = reg.cell.replays
    for name, per in want_captured.items():
        check(launches[name] == replays * per,
              f"slotted lane: {name} launched {launches[name]} times, not "
              f"{replays} replays × {per}")
    for got, want, (_, m, _) in zip(tokens, first, requests):
        check(got is not None and len(got) == m
              and bool((got >= 0).all() and (got < cfg.vocab).all()),
              "a request did not complete with its tokens")
        check(np.array_equal(got, want), "the second run's tokens differ "
              "from the first's")
    summary = engine.summary()[reg.celldef.name]
    req = engine.request_summary()["decode"]
    peak = torch.cuda.max_memory_reserved()
    # the step at full context: every slot holding 32,768 keys
    stage = reg.cell.stage(np.zeros((LM_SLOTS, 1), np.int32),
                           np.full((LM_SLOTS,), LM_MAX_LEN - 1, np.int32))
    full_ms = cuda_ms(lambda: reg.cell.compiled(stage[0], stage[1], caches),
                      LM_TIMED_STEPS)
    traced = trace(lambda: reg.cell.compiled(stage[0], stage[1], caches), 5)
    bound = step_bound_ms(params, cfg, LM_SLOTS * LM_MAX_LEN, LM_SLOTS)
    kernels = time_decode_kernels(params, cfg, caches, stage[1],
                                  "decode_32k (8 x 32,768)", bf16_cache=True,
                                  grow=True)
    # a step at the requests' contexts: each slot a prompt and some tokens
    short = torch.tensor([len(p) + 16 for p, _, _ in requests[:LM_SLOTS]],
                         dtype=torch.int32, device=dev)
    kernels_short = time_decode_kernels(params, cfg, caches, short,
                                        "slotted short contexts")
    out = {"capture_s": capture_s, "requests": LM_REQUESTS,
           "steps": session.steps - steps_before, "replays": replays,
           "wall_s": wall, "step_p50_ms": summary["p50_ms"],
           "step_p99_ms": summary["p99_ms"],
           "occupancy": summary.get("occupancy"),
           "request_p50_ms": req["latency"]["p50_ms"],
           "tokens_per_s": sum(len(t) for t in tokens) / wall,
           "full_context_step_ms": full_ms, "full_context_bound_ms": bound,
           "busy_ms": traced["busy_ms"], "idle_share": traced["idle_share"],
           "top": traced["top"], "peak_reserved_bytes": peak,
           "pool_bytes": engine.cache.pool_bytes(), "checks": checks,
           "launches": launches,
           "kernels": kernels, "kernels_short": kernels_short}
    log(f"slotted lane: {LM_REQUESTS} requests in {wall:.2f} s over "
        f"{out['steps']} steps ({replays} replays), step p50 "
        f"{out['step_p50_ms']:.3f} ms, request p50 "
        f"{out['request_p50_ms']:.1f} ms, {out['tokens_per_s']:.1f} tokens/s; "
        f"{len(checks)} steps held against the plain route, worst logit gap "
        f"{max(c['gap'] for c in checks):.3e} (the plain route against its "
        f"twin: {twin_gaps(checks)}); at full context "
        f"{full_ms:.3f} ms a step (bound {bound:.3f} ms: "
        f"{bound / full_ms:.1%}), device busy {traced['busy_ms']:.3f} of "
        f"{traced['wall_ms']:.3f} ms; peak reserved {peak / 1e9:.2f} GB; "
        f"top kernels {traced['top']}")
    del engine, reg, session, caches, stage
    return out


def twin_gaps(checks) -> str:
    gaps = [c["twin_gap"] for c in checks if c["twin_gap"] is not None]
    return (f"{len(gaps)} steps, {min(gaps):.3e}–{max(gaps):.3e}" if gaps
            else "not measured: every checked step grew a scale")


def decode_steps(engine, params, buffers, cfg, first_tok, caches,
                 n_steps: int, what: str) -> dict:
    """``n_steps`` of ``Engine.decode`` from ``caches`` (the greedy token
    fed back), each held against the plain route's ``LM.decode_step`` (and
    its twin) on a copy of the caches from before it."""
    reg = next(iter(engine._decode.values()))
    static = reg.cell.inputs[1]
    tok = first_tok
    checks, outs = [], None
    for step in range(n_steps):
        mirror = {k: x.clone() for k, x in caches.items()}
        logits, outs = engine.decode(tok, caches)
        tok_t = torch.from_numpy(tok).to(caches["k"].device)
        want, twin = plain_and_twin(lambda c: LM.decode_step(
            params, buffers, tok_t, c, cfg), mirror)
        checks.append(check_logits(
            torch.from_numpy(logits), want.cpu(), f"{what} decode step {step}",
            None if twin is None else twin.cpu()))
        del mirror
        check(all(outs[k] is static[k] for k in static if k != "len"),
              "the caches Engine.decode returned are not the cell's own")
        caches = outs
        tok = logits.argmax(-1)[:, None].astype(np.int32)
    return {"checks": checks, "caches": caches, "last_token": tok}


def phase_lm_prefill(dev, model, arch: str = LM_ARCH,
                     n_prompt: int | None = None,
                     n_steps: int | None = None) -> dict:
    """``LM.prefill`` of one prompt of ``n_prompt`` tokens into an int8
    cache, against the plain route (the long-sequence attention chunked);
    then ``n_steps`` of ``Engine.decode`` on ``lm_decode_cell`` (batch 1),
    the first from the prefill's caches (copied into the cell's), the rest
    from the caches it returned (the cell's own, copied no more), each held
    against the plain route; launches counted with the counts at 0."""
    cfg, params, buffers = model
    n_prompt = LM_PREFILL if n_prompt is None else n_prompt
    n_steps = LM_DECODE_STEPS if n_steps is None else n_steps
    toks = torch.from_numpy(TokenStream(cfg.vocab, 1, n_prompt, seed=SEED)
                            .batch_at(1)["tokens"]).to(dev)
    max_len = n_prompt + n_steps
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = LM.prefill(params, buffers, toks, cfg, max_len,
                                torch.int8)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = counts()
    peak = torch.cuda.max_memory_allocated()
    want_launches = {"mpe_lookup": 1, "flash_attention_fwd": cfg.n_layers,
                     "kv_cache_write": cfg.n_layers * kvw_ops.kernels_a_call(
                         n_prompt, cfg.head_dim, torch.int8),
                     "decode_attention": 0,
                     "segment_sum": cfg.n_layers if cfg.moe else 0}
    for name, n in want_launches.items():
        check(prefill_launches[name] == n, f"{arch} prefill: {name} launched "
              f"{prefill_launches[name]} times, not {n}")
    t0 = time.perf_counter()
    want, want_caches = with_plain_lm(lambda: LM.prefill(
        params, buffers, toks, cfg, max_len, torch.int8))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    prefill_check = check_logits(logits, want, f"{arch} prefill")
    # layer 0 reads the same inputs in both routes: its cache is the same
    check(torch.equal(caches["k"][0], want_caches["k"][0])
          and torch.equal(caches["k_scale"][0], want_caches["k_scale"][0])
          and torch.equal(caches["v"][0], want_caches["v"][0]),
          f"{arch} prefill: layer 0's int8 cache differs from the plain "
          f"route's")
    del want_caches, want
    lookup = time_lookup(params["embedding"], buffers["embedding"]["meta"],
                         toks.reshape(-1), f"{arch} prefill ({n_prompt} "
                         f"tokens, d={cfg.d_model})", plain=True)
    # one layer's prefill write alone: keys and values into empty caches
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kv_shape = (1, n_prompt, cfg.n_kv_heads, cfg.head_dim)
    kx, vx = (torch.randn(kv_shape, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    empty = torch.zeros((1, max_len, cfg.n_kv_heads, cfg.head_dim),
                        dtype=torch.int8, device=dev)
    fresh = torch.full((1, 1, cfg.n_kv_heads, 1), 0.05, device=dev)
    write = time_layer_write(empty, fresh, kx, empty, fresh, vx,
                             torch.zeros((), dtype=torch.int32, device=dev),
                             f"{arch} prefill ({n_prompt} into {max_len})")
    del kx, vx, empty
    engine = Engine(device=dev)
    reg = engine.register(lm_decode_cell(cfg, params, buffers, batch=1,
                                         max_len=max_len, arch=arch))
    want_captured = {"mpe_lookup": 1, "kv_cache_write": cfg.n_layers,
                     "decode_attention": cfg.n_layers,
                     **({"segment_sum": cfg.n_layers} if cfg.moe else {})}
    check(reg.cell.captured == want_captured,
          f"{arch} decode cell captured {reg.cell.captured}")
    reset_counts()
    reg.cell.replays = 0
    first = logits.float().argmax(-1)[:, None].cpu().numpy().astype(np.int32)
    run = decode_steps(engine, params, buffers, cfg, first, caches, n_steps,
                       arch)
    launches = {**counts(), **reg.cell.launches}
    check(reg.cell.replays == n_steps, "a decode step did not replay")
    summary = engine.summary()[reg.celldef.name]
    caches, tok = run["caches"], run["last_token"]
    traced = trace(lambda: engine.decode(tok, caches), 3)
    step_bound = step_bound_ms(params, cfg, max_len, 1)
    out = {"prompt": n_prompt, "prefill_s": prefill_s, "plain_s": plain_s,
           "prefill_peak_bytes": peak, "prefill_check": prefill_check,
           "prefill_launches": prefill_launches,
           "decode_checks": run["checks"], "decode_launches": launches,
           "step_p50_ms": summary["p50_ms"], "step_bound_ms": step_bound,
           "cache_len": int(run["caches"]["len"]), "lookup": lookup,
           "write": write, "busy_ms": traced["busy_ms"],
           "wall_ms": traced["wall_ms"], "top": traced["top"]}
    log(f"{arch} prefill of {n_prompt} tokens: {prefill_s:.2f} s (plain "
        f"route {plain_s:.2f} s), logit gap {prefill_check['gap']:.3e}, "
        f"peak {peak / 1e9:.2f} GB; {n_steps} decode steps p50 "
        f"{out['step_p50_ms']:.3f} ms (bound {step_bound:.3f} ms), worst "
        f"gap {max(c['gap'] for c in run['checks']):.3e} (the plain route "
        f"against its twin: {twin_gaps(run['checks'])}); a traced step busy "
        f"{traced['busy_ms']:.3f} of {traced['wall_ms']:.3f} ms, top "
        f"{traced['top']}")
    del engine, reg, caches, run
    return out


def phase_lm_long(dev, model) -> dict:
    """long_500k: the decode cell at one sequence of 524,288, its int8
    cache filled from the seed in place (codes ~ N(0, 127/4) rounded and
    clipped, as a real prefix's spread over its absmax; each layer's and
    head's scales 1.5 times those a ``LONG_PROBE``-token prefill
    calibrates, so that the model's new keys fit the grid as they would a
    real prefix's; length 524,284; no prefill of that length), one step
    held against the plain route on a copy, then ``LONG_STEPS`` steps
    timed, and layer 0's kernels timed."""
    cfg, params, buffers = model
    toks = torch.from_numpy(TokenStream(cfg.vocab, 1, LONG_PROBE, seed=SEED)
                            .batch_at(2)["tokens"]).to(dev)
    _, probe = LM.prefill(params, buffers, toks, cfg, LONG_PROBE, torch.int8)
    engine = Engine(device=dev)
    reg = engine.register(lm_decode_cell(cfg, params, buffers, batch=1,
                                         max_len=LONG_LEN, arch=LM_ARCH))
    caches = reg.cell.inputs[1]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name in ("k", "v"):
        codes = caches[name].view(-1)
        for i in range(0, codes.numel(), LONG_FILL_CHUNK):
            part = codes[i:i + LONG_FILL_CHUNK]
            part.copy_(torch.clamp(torch.round(
                torch.randn(part.shape, generator=gen, device=dev)
                * LONG_CODE_STD), -127, 127))
        caches[f"{name}_scale"].copy_(LONG_SCALE_MARGIN
                                      * probe[f"{name}_scale"])
    del probe
    caches["len"].fill_(LONG_LEN - LONG_STEPS)
    tok = np.asarray([[7]], np.int32)
    run = decode_steps(engine, params, buffers, cfg, tok, caches, 1,
                       "long_500k")
    torch.cuda.empty_cache()
    reset_counts()
    reg.cell.replays = 0
    engine.stats = LatencyStats()
    caches = run["caches"]
    caches["len"] = caches["len"].clone()
    caches["len"].fill_(LONG_LEN - LONG_STEPS)
    tok = run["last_token"]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LONG_STEPS):
        logits, caches = engine.decode(tok, caches)
        tok = logits.argmax(-1)[:, None].astype(np.int32)
    check(bool(np.isfinite(logits).all()), "long_500k: logits not finite")
    launches = {**counts(), **reg.cell.launches}
    summary = engine.summary()[reg.celldef.name]
    bound = step_bound_ms(params, cfg, LONG_LEN, 1)
    lens = torch.full((1,), LONG_LEN - 1, dtype=torch.int32, device=dev)
    traced = trace(lambda: engine.decode(tok, caches), 2)
    kernels = time_decode_kernels(params, cfg, reg.cell.inputs[1], lens,
                                  "long_500k (1 x 524,288)", grow=True)
    out = {"check": run["checks"][0], "step_p50_ms": summary["p50_ms"],
           "step_mean_ms": summary["mean_ms"],
           "step_bound_ms": bound, "busy_ms": traced["busy_ms"],
           "idle_share": traced["idle_share"], "top": traced["top"],
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "launches": launches, "kernels": kernels}
    log(f"long_500k: {LONG_STEPS} steps p50 {out['step_p50_ms']:.3f} ms "
        f"(bound {bound:.3f} ms: {bound / out['step_p50_ms']:.1%}), busy "
        f"{traced['busy_ms']:.3f} of {traced['wall_ms']:.3f} ms, logit gap "
        f"{out['check']['gap']:.3e}")
    del engine, reg, caches, run
    return out


def lm_records(grid, slotted, long, prefill, moe) -> list:
    """The two decode kernels' records: ms, plain ms and bound at
    decode_32k's full context (8 × 32,768), long_500k's and the slotted
    lane's short contexts beside; ``kv_cache_write``'s (a layer's keys and
    values) also where every scale grows at both full contexts and at the
    prefills of internlm2 and deepseek-moe; ``decode_attention``'s over a
    bf16 cache with SDPA's time as its library call."""
    out = []
    for name, source in (("kv_cache_write", KVW_SOURCE),
                         ("decode_attention", DECODE_ATT_SOURCE)):
        r = slotted["kernels"][name]
        shapes = {"decode_32k": r, "long_500k": long["kernels"][name],
                  "slotted short contexts": slotted["kernels_short"][name]}
        if name == "decode_attention":
            shapes["decode_32k bf16 cache"] = \
                slotted["kernels"]["decode_attention_bf16"]
        else:
            shapes["decode_32k, every scale grows"] = r.pop("scale_grows")
            shapes["long_500k, every scale grows"] = \
                long["kernels"][name].pop("scale_grows")
            shapes[f"internlm2 prefill {prefill['prompt']}"] = prefill["write"]
            shapes[f"deepseek-moe prefill {moe['prompt']}"] = moe["write"]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": ("no TPU kernel: the reference's jnp cache write "
                         "(src/repro/models/lm/transformer.py:196-245)"
                         if name == "kv_cache_write" else
                         "no TPU kernel: the reference's jnp gqa_attention "
                         "over its dequantized cache "
                         "(src/repro/nn/attention.py:82)"),
            "launches": slotted["launches"][name],
            "max_abs_err": max(grid[name], *(x["max_abs_err"]
                                             for x in shapes.values())),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shapes": shapes,
            "grid_cases": grid["cases"][name]})
    return out


def phase_moe(dev) -> dict:
    """deepseek-moe-16b at full width, 2 of its 28 layers: a prefill of
    4,096 tokens and 8 decode steps, as ``phase_lm_prefill``; the MoE
    combine runs on the segment-sum kernel, once a layer."""
    model = lm_model(MOE_ARCH, dev, n_layers=MOE_LAYERS)
    out = phase_lm_prefill(dev, model, arch=MOE_ARCH, n_prompt=MOE_PREFILL,
                           n_steps=MOE_STEPS)
    del model
    return out


LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 4096   # train_4k's 256 sequences cut to 8
LM_TRAIN_STEPS = 4
LM_TRAIN_BATCHES = 2            # made once, reused in turn
LM_PEAK_LIMIT_GB = 70.0         # a train_4k step's reserved peak must stay under it
LM_FIRST_LOSS_RTOL = 1e-4       # the first loss against the plain kernels' step
# each token's cross-entropy at init, the training forward's kernel against
# the plain route: within the larger of this and LM_XENT_TWIN_FACTOR times
# the plain route's gap to its float64 twin (the model's own spread)
LM_XENT_TOKEN_TOL = 0.05
LM_XENT_TWIN_FACTOR = 2.0
LM_LOSS_NEAR = 1.0              # |first loss - ln V|: random logits of std
#                                 0.02·√2048 ≈ 0.9 add about σ²/2 ≈ 0.4 to ln V
LM_FLASH_SLICES = ((0, 0), (3, 7), (7, 15))   # (b, h) held against the plain version
XENT_TOL = dict(rtol=1e-5, atol=1e-6)        # the chunked loss against the whole one
XENT_GRAD_SHARE = 1e-2          # its bf16 gradients, of the largest |value|
VOCAB_STEPS = 4
VOCAB_LAM = 1e-5                # examples/lm_vocab_mpe.py's MPEConfig
MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 2, 2
WIDE_QAT_D = (257, 512, 1000, 2048, 6144)    # up to grok-1-314b's d_model
WIDE_QAT_T = (1, 255, 256, 4097, 32768)
WIDE_QAT_BITS = ((0, 1, 2, 3, 4, 5, 6), (6,))  # the paper's widths; one width
ADAM_BF16_SIZES = (1, 7, 4099, (1 << 26) + 5)


def library_scatter_adds(by_name: dict) -> dict:
    """The traced kernels of ``by_name`` that are a library scatter-add
    (``segment_sum``'s ``is_library_scatter_add``)."""
    return {n: ms for n, ms in by_name.items()
            if seg_ops.is_library_scatter_add(n)}


def phase_lm_train_grid(dev) -> dict:
    """The training path's kernels at their new shapes against their plain
    versions: ``mpe_qat`` over d {257, 512, 1,000, 2,048, 6,144} × rows
    {1, 255, 256, 4,097, 32,768} × the paper's widths and one width alone
    (``check_qat``: out and drows bit-identical, the sums at rtol 1e-4 /
    atol 1e-6, the backward twice bit-identical); the Adam pass on bf16
    leaves (float32 moments) of 1, 7, 4,099 and 2^26 + 5 elements and a
    4,099 × 8 matrix with weight decay, a constant rate and a schedule's,
    the flag true and false: bit for bit the plain chain's."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fwd_err = bwd_err = 0.0
    cases = 0
    for d in WIDE_QAT_D:
        for t in WIDE_QAT_T:
            for bits in WIDE_QAT_BITS:
                f, b = check_qat(*qat_inputs(gen, t, d, bits, dev), bits,
                                 f"mpe_qat wide rows bits={bits} d={d} "
                                 f"rows={t}")
                fwd_err, bwd_err = max(fwd_err, f), max(bwd_err, b)
                cases += 1
    log(f"mpe_qat wide-row grid: {cases} cases, out and drows bit-identical "
        f"to the plain version, backward repeatable; max |diff| of the sums "
        f"{bwd_err:.3e}")
    scale = torch.full((), 0.37, device=dev)
    bc1 = torch.full((), 0.1, device=dev)
    bc2 = torch.full((), 0.001, device=dev)
    n_adam = 0
    for shape, wd in [((n,), 0.0) for n in ADAM_BF16_SIZES] + [((4099, 8), 0.1)]:
        p = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        g = (3e-2 * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)
        m = 1e-3 * torch.randn(shape, generator=gen, device=dev)
        v = 1e-4 * torch.rand(shape, generator=gen, device=dev)
        for lr in (1e-3, torch.full((), 7.25e-4, device=dev)):
            hyper = dict(lr=lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
            for ok in (True, False):
                flag = torch.full((), ok, device=dev)
                got = [x.clone() for x in (p, m, v)]
                want = [x.clone() for x in (p, m, v)]
                uncounted(lambda got=got, g=g, flag=flag, hyper=hyper:
                          adam_ops.adam_step_(got[0], g, got[1], got[2], scale,
                                              flag, bc1, bc2, **hyper))
                adam_step_ref_(want[0], g, want[1], want[2], scale, flag, bc1,
                               bc2, **hyper)
                check(all(torch.equal(x, y) for x, y in zip(got, want)),
                      f"Adam pass on a bf16 {shape} leaf (lr {lr}, wd {wd}, "
                      f"flag {ok}) differs from the plain chain")
                # a taken step moves the moments (a bf16 leaf may round
                # back to its value); a skipped one leaves every bit
                check(torch.equal(got[1], m) != ok and (ok or all(
                    torch.equal(x, x0) for x, x0 in zip(got, (p, m, v)))),
                      f"Adam pass on a bf16 {shape} leaf: flag {ok} wrote "
                      f"{'nothing' if ok else 'something'}")
                n_adam += 1
                del got, want
        del p, g, m, v
    torch.cuda.synchronize()
    log(f"Adam pass on bf16 leaves: {n_adam} cases bit-identical to the plain "
        f"chain, a skipped pass bit-unchanged")
    return {"qat_cases": cases, "qat_fwd_err": fwd_err,
            "qat_bwd_err": bwd_err, "adam_bf16_cases": n_adam}


def lm_train_batches(cfg, n: int, batch: int, dev) -> list:
    """``n`` TokenStream batches of ``batch`` × ``LM_TRAIN_SEQ`` on the card,
    made once (steps past the other phases' streams)."""
    stream = TokenStream(cfg.vocab, batch, LM_TRAIN_SEQ, seed=SEED)
    return [{k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(100 + s).items()} for s in range(n)]


def lm_model_and_loss(cfg, dev, lam: float = 0.0, freqs=None):
    """``cfg`` initialised from the seed on the card and its ``Trainer``
    (``adam(1e-3)``, clip 10, the NaN guard): ``LM.loss_fn`` (the chunked
    cross-entropy, aux weight 0.01), plus λ times the vocabulary search's
    regulariser where ``lam`` is set (``examples/lm_vocab_mpe.py``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, buffers = LM.init(gen, cfg, freqs=freqs)
    mpe = as_mpe_config(cfg.comp_cfg) if lam else None

    def loss_fn(p, bu, st, batch, *, step=None):
        loss, ce = LM.loss_fn(p, bu, batch, cfg, train=True, step=step)
        if mpe is not None:
            loss = loss + lam * MPESearchEmbedding.reg_loss(
                p["embedding"], bu["embedding"], mpe)
        return loss, (st, ce)
    return params, buffers, loss_fn


def lm_train_steps(trainer, batches, n_steps: int, per_step: dict,
                   what: str) -> dict:
    """``n_steps`` of ``trainer`` on ``batches`` in turn with the counts at 0:
    each step's launches held to ``per_step``, every loss finite, no step
    skipped; host ms a step (to a synchronize), the reserved peak."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outs, step_ms = [], []
    t_all = time.perf_counter()
    for step in range(n_steps):
        before = counts()
        t0 = time.perf_counter()
        outs.append(trainer.train_step(batches[step % len(batches)], step))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launched = launched_since(before)
        check(all(launched[k] == v for k, v in per_step.items()),
              f"{what} step {step} launched {launched}, not {per_step}")
    total_s = time.perf_counter() - t_all
    launches = counts()
    losses = [float(o["loss"]) for o in outs]
    check(all(np.isfinite(x) for x in losses),
          f"{what}: a loss was not finite: {losses}")
    check(not any(bool(o["skipped"]) for o in outs), f"{what}: a step was "
          f"skipped")
    out = {"losses": losses, "step_ms": step_ms, "launches": launches,
           "per_step": per_step, "total_s": total_s,
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "grad_norms": [float(o["grad_norm"]) for o in outs]}
    log(f"{what}: {n_steps} steps, ms {[round(x, 1) for x in step_ms]}, "
        f"losses {[round(x, 5) for x in losses]}, peak reserved "
        f"{out['peak_reserved_bytes'] / 1e9:.2f} GB (allocated "
        f"{out['peak_allocated_bytes'] / 1e9:.2f} GB); launches {launches}")
    return out


def recorded_flash(trainer, batch, step: int, n_layers: int) -> dict:
    """One more step with the flash wrappers keeping the arguments and
    outputs of a few calls: the forward with statistics of layer 0 and of
    the last layer (its first run and its recompute in the backward, the
    next call) and the first backward (the last layer's). Its launches are
    a comparison's and are not counted."""
    keep = {"flash_attention_fwd_stats": (0, n_layers - 1, n_layers),
            "flash_attention_bwd": (0,)}
    seen = {name: {} for name in keep}
    before = counts()

    def recorder(name):
        real, calls = COUNTERS[name], [0]

        def call(*args):
            out = real(*args)
            if calls[0] in keep[name]:
                seen[name][calls[0]] = (
                    tuple(a.detach() if torch.is_tensor(a) else a
                          for a in args), out)
            calls[0] += 1
            return out
        call.launches = 0
        return call
    for name in keep:
        setattr(flash_ops, name, recorder(name))
    try:
        trainer.train_step(batch, step)
        torch.cuda.synchronize()
    finally:
        for name in keep:
            setattr(flash_ops, name, COUNTERS[name])
        for name, n in before.items():
            COUNTERS[name].launches = n
    return seen


def lm_flash_train_rows(seen: dict, n_layers: int, what: str) -> dict:
    """The flash forward with statistics and the backward on a step's own
    arguments at (8, 4,096, 16, 128), causal (``recorded_flash``): the
    kernels on the whole batch held against their plain versions on the
    (b, h) slices of ``LM_FLASH_SLICES`` (o and lse within 3e-5, dq, dk, dv
    within 2e-4 at the step's do brought to unit RMS by ``unit_rms``; the
    backward twice bit-identical); the last layer's
    recomputed forward bit-identical to its first run (inputs, o and lse),
    so the backward is repeatable under remat; then each timed beside its
    bound, its plain version over every head (one sequence at a time) and
    SDPA's forward and forward plus backward on (B, H, S, hd) views."""
    (q, k, v, _), (o1, lse1) = seen["flash_attention_fwd_stats"][n_layers - 1]
    (q2, k2, v2, _), (o2, lse2) = seen["flash_attention_fwd_stats"][n_layers]
    recompute_same = (torch.equal(q, q2) and torch.equal(k, k2)
                      and torch.equal(v, v2) and torch.equal(o1, o2)
                      and torch.equal(lse1, lse2))
    check(recompute_same, f"{what}: the last layer's recomputed flash "
          f"forward differs from its first run")
    del q2, k2, v2, o2, lse2, o1, lse1
    (q, k, v, causal), _ = seen["flash_attention_fwd_stats"][0]
    (bq, bk, bv, bo, blse, bdo, _), _ = seen["flash_attention_bwd"][0]
    bdo, do_rms = unit_rms(bdo)
    b, s, h, hd = q.shape
    rows = {}
    o, lse = flash_ops.flash_attention_fwd_stats(q, k, v, True)
    grads = flash_ops.flash_attention_bwd(bq, bk, bv, bo, blse, bdo, True)
    again = flash_ops.flash_attention_bwd(bq, bk, bv, bo, blse, bdo, True)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"{what}: two flash backward runs gave different bits")
    del again
    f_err = b_err = 0.0
    for i, j in LM_FLASH_SLICES:
        sl = [x[i:i + 1, :, j] for x in (q, k, v, o, bq, bk, bv, bo, bdo)]
        want_o, want_lse = fwd_stats_ref(*sl[:3], True)
        f_err = max(f_err, within(sl[3], want_o, FLASH_TOL,
                                  f"{what}: o at (b, h) = ({i}, {j})"),
                    within(lse[i:i + 1, j], want_lse, FLASH_TOL,
                           f"{what}: lse at (b, h) = ({i}, {j})"))
        want = bwd_ref(*sl[4:8], blse[i:i + 1, j], sl[8], True)
        for name, x, w in zip(("dq", "dk", "dv"), grads, want):
            b_err = max(b_err, within(x[i:i + 1, :, j], w, FLASH_BWD_TOL,
                                      f"{what}: {name} at (b, h) = ({i}, {j})"))
        del want_o, want_lse, want, sl
    del grads, o, lse

    def plain_fwd():
        for i in range(b):
            fwd_stats_ref(*(heads_flat(x[i:i + 1]) for x in (q, k, v)), True)

    def plain_bwd():
        for i in range(b):
            bwd_ref(*(heads_flat(x[i:i + 1]) for x in (bq, bk, bv, bo)),
                    blse[i], heads_flat(bdo[i:i + 1]), True)
    lib = uncounted(lambda: sdpa_ms(bq, bk, bv, bdo, 3, True))
    for kind, err, fn, plain in (
            ("fwd_stats", f_err,
             lambda: flash_ops.flash_attention_fwd_stats(q, k, v, True),
             plain_fwd),
            ("bwd", b_err,
             lambda: flash_ops.flash_attention_bwd(bq, bk, bv, bo, blse, bdo,
                                                   True),
             plain_bwd)):
        row = {**flash_work(b * h, s, hd, kind, True), "max_abs_err": err,
               "ms": uncounted(lambda fn=fn: cuda_ms(fn, 5, warmup=1)),
               "plain_ms": cuda_ms(plain, 1, warmup=0),
               "library_ms": lib["fwd"] if kind == "fwd_stats" else lib["fwd_bwd"],
               "sdpa_fwd_ms": lib["fwd"], "sdpa_fwd_bwd_ms": lib["fwd_bwd"],
               "S": s, "input_shape": list(q.shape), "causal": True,
               "checked_heads": len(LM_FLASH_SLICES)}
        if kind == "bwd":
            row["step_do_rms"] = do_rms
        rows[kind] = row
        at = (f" at do scaled to unit RMS (the step's {do_rms:.3e})"
              if kind == "bwd" else "")
        log(f"flash {kind} at {what} ({tuple(q.shape)}, causal, tiled "
            f"route): max |diff| {err:.3e} on {len(LM_FLASH_SLICES)} (b, h)"
            f"{at}; {row['ms']:.3f} ms a call (plain {row['plain_ms']:.3f} "
            f"ms; SDPA forward {lib['fwd']:.3f}, forward + backward "
            f"{lib['fwd_bwd']:.3f} ms); {bounds_text(row)}")
    rows["recompute_bit_identical"] = recompute_same
    return rows


def _stats_attention(q, k, v, *, n_kv_heads=None, causal=True):
    """``flash_attention``'s training route outside autograd: the flash
    forward with statistics (kv heads repeated as the wrapper repeats
    them), its o."""
    hq = q.shape[2]
    k, v = (x.repeat_interleave(hq // x.shape[2], dim=2).contiguous()
            for x in (k, v))
    return flash_ops.flash_attention_fwd_stats(q.contiguous(), k, v,
                                               causal)[0]


def _twin_long_attention(q, k, v, *, n_kv_heads=None, causal=True):
    """Attention computed whole in float64 and rounded once to q's type: a
    second plain route with no float32 rounding inside, whose gap to
    ``_plain_long_attention`` is the model's own spread."""
    hq, s = q.shape[2], q.shape[1]
    q64, k64, v64 = (x.double().transpose(1, 2) for x in (q, k, v))
    k64, v64 = (x.repeat_interleave(hq // x.shape[1], dim=1)
                for x in (k64, v64))
    logits = (q64 @ k64.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits.masked_fill_(~keep, -math.inf)
    out = torch.softmax(logits, dim=-1) @ v64
    return out.transpose(1, 2).to(q.dtype)


def _zero_attention(q, k, v, *, n_kv_heads=None, causal=True):
    """A wrong attention kernel: zeros."""
    return torch.zeros_like(q)


def token_xent(params, buffers, batch, cfg, attention) -> torch.Tensor:
    """Each token's cross-entropy (B, S) at ``params``, with the trunk's
    attention ``attention``: one sequence at a time, its (S, V) logits in
    the model's type, the log-softmax in float32 (as the chunked loss
    takes it)."""
    old = transformer_module.flash_attention
    transformer_module.flash_attention = attention
    try:
        rows = []
        for b in range(batch["tokens"].shape[0]):
            x, _ = LM.hidden_states(params, buffers, batch["tokens"][b:b + 1],
                                    cfg)
            logits = (x[0] @ params["lm_head"]).to(torch.float32)
            label = batch["labels"][b].long()[:, None]
            rows.append(torch.logsumexp(logits, -1)
                        - logits.gather(-1, label)[:, 0])
            del x, logits
        return torch.stack(rows)
    finally:
        transformer_module.flash_attention = old


def check_token_xent(params, buffers, batch, cfg) -> dict:
    """Each token's cross-entropy at init through the training forward's
    kernel (``_stats_attention``) against the plain route's
    (``_plain_long_attention``) on the same batch: the largest |difference|
    within ``LM_XENT_TOKEN_TOL`` or ``LM_XENT_TWIN_FACTOR`` times the plain
    route's gap to its float64 twin, whichever is larger; a route whose
    attention returns zeros (a wrong kernel) outside it. The mean loss
    cannot tell these apart: at init it is about ln V + σ²/2 whatever the
    trunk computes."""
    with torch.no_grad():
        ce = {name: uncounted(lambda: token_xent(params, buffers, batch, cfg,
                                                 attention))
              for name, attention in (("kernel", _stats_attention),
                                      ("plain", _plain_long_attention),
                                      ("twin", _twin_long_attention),
                                      ("zero", _zero_attention))}
    check(all(bool(torch.isfinite(x).all()) for x in ce.values()),
          "train_4k: a token's cross-entropy is not finite")
    gaps = {name: float((ce[name] - ce["plain"]).abs().max())
            for name in ("kernel", "twin", "zero")}
    mean_gaps = {name: float((ce[name] - ce["plain"]).abs().mean())
                 for name in ("kernel", "twin", "zero")}
    tol = max(LM_XENT_TOKEN_TOL, LM_XENT_TWIN_FACTOR * gaps["twin"])
    log(f"train_4k: each token's cross-entropy at init against the plain "
        f"route's, largest |diff| (mean): kernel {gaps['kernel']:.4e} "
        f"({mean_gaps['kernel']:.4e}), float64 twin {gaps['twin']:.4e} "
        f"({mean_gaps['twin']:.4e}), zero attention {gaps['zero']:.4e} "
        f"({mean_gaps['zero']:.4e}); tolerance {tol:.4e}")
    check(gaps["kernel"] <= tol, f"train_4k: a token's cross-entropy "
          f"{gaps['kernel']:.4e} from the plain route's, more than {tol:.4e}")
    check(gaps["zero"] > tol, f"train_4k: attention of zeros gives tokens' "
          f"cross-entropies within {tol:.4e} of the plain route's: the check "
          f"would not see a wrong kernel")
    return {"max_gap": gaps, "mean_gap": mean_gaps, "tolerance": tol,
            "tokens": int(ce["plain"].numel())}


def check_chunked_xent(params, buffers, tokens, labels, cfg) -> dict:
    """The chunked cross-entropy (``nn/chunked.py``, chunks of
    ``cfg.ce_chunk``) against the whole (S, V) logit matrix on one
    sequence's hidden states: the loss within ``XENT_TOL``, its gradients in
    the hidden states and the head within ``XENT_GRAD_SHARE`` of their
    largest |value| (bf16 products rounded in other places)."""
    with torch.no_grad():
        x, _ = LM.hidden_states(params, buffers, tokens[:1], cfg)
    head = params["lm_head"].detach()
    runs = []
    for chunked in (True, False):
        xs, w = (t.clone().requires_grad_(True) for t in (x, head))
        with torch.enable_grad():
            if chunked:
                loss = chunked_softmax_xent(xs, w, labels[:1],
                                            chunk=cfg.ce_chunk)
            else:
                logits = (xs @ w).to(torch.float32)
                loss = torch.nn.functional.cross_entropy(
                    logits.reshape(-1, logits.shape[-1]),
                    labels[:1].reshape(-1).long())
            loss.backward()
        runs.append((loss.detach(), xs.grad.float(), w.grad.float()))
        del xs, w
    (got, gx, gw), (want, wx, ww) = runs
    err = within(got, want, XENT_TOL, "chunked cross-entropy: loss")
    gaps = {name: max_abs(a, b) / max(float(b.abs().max()), 1e-30)
            for name, a, b in (("dx", gx, wx), ("dlm_head", gw, ww))}
    check(all(gap <= XENT_GRAD_SHARE for gap in gaps.values()),
          f"chunked cross-entropy: gradients {gaps} of their largest apart")
    log(f"chunked cross-entropy on one sequence ({tokens.shape[1]} tokens, "
        f"chunks of {cfg.ce_chunk}): {float(got):.6f} against the whole "
        f"logit matrix's {float(want):.6f} (|diff| {err:.3e}); gradients "
        f"{gaps} of their largest apart")
    return {"loss": float(got), "whole_loss": float(want),
            "max_abs_err": err, "grad_gaps": gaps}


def lm_per_step(cfg, trainer, gathers: int, qat: int = 0) -> dict:
    """A training step's launches: the flash forward with statistics twice
    a layer (remat: the forward and its recompute), the backward once, the
    plain forward never; the segment sum once a gather (and, in an MoE,
    the combine's scatter twice and its two gathers' backward once a
    layer); ``mpe_qat`` ``qat`` times each way; Adam once a leaf."""
    moe = 4 * cfg.n_layers if cfg.moe is not None else 0
    return {"flash_attention_fwd_stats": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers, "flash_attention_fwd": 0,
            "segment_sum": gathers + moe, "mixed_expectation_fwd": qat,
            "mixed_expectation_bwd": qat,
            "adam_step_": len(leaves(trainer.params)), "mpe_lookup": 0,
            "kv_cache_write": 0, "decode_attention": 0}


def traced_train_step(trainer, batch, step: int, what: str) -> dict:
    traced = trace(lambda: trainer.train_step(batch, step), 1)
    view = {k: traced[k] for k in ("wall_ms", "busy_ms", "idle_share", "top")}
    view["flash_ms"] = {kind: flash_kernel_ms(traced["by_name"], kind)
                        for kind in ("fwd", "bwd")}
    view["kernel_ms"] = step_kernel_ms(traced["by_name"])
    view["library_scatter_adds"] = library_scatter_adds(traced["by_name"])
    gemm = sum(ms for n, ms in traced["by_name"].items()
               if any(k in n.lower() for k in ("gemm", "cutlass", "xmma",
                                               "nvjet")))
    view["matmul_ms"] = gemm
    check(all(ms > 0 for ms in view["flash_ms"].values()),
          f"traced {what} step: flash kernels missing from the trace "
          f"({view['flash_ms']})")
    log(f"traced {what} step: wall {traced['wall_ms']:.1f} ms, device busy "
        f"{traced['busy_ms']:.1f} ms (idle share {traced['idle_share']:.3f}); "
        f"flash {view['flash_ms']}; matrix products {gemm:.1f} ms; "
        f"{view['kernel_ms']}; library scatter-adds "
        f"{view['library_scatter_adds']}; top "
        + "; ".join(f"{n} {ms:.2f} ms" for n, ms in traced["top"]))
    return view


def phase_lm_train(dev) -> dict:
    """internlm2-1.8b's ``train_4k`` at full width (24 layers, d 2,048,
    16 / 8 heads of 128, d_ff 8,192, vocab 92,544, bf16 layers and head,
    float32 token table) and depth, 8 sequences of 4,096 (of the cell's
    256): each token's cross-entropy at init against the plain route's
    (``check_token_xent``); the first loss against the same forward on the
    plain kernels (``with_plain_lm``) and ln V; four ``Trainer`` steps with their
    launches; one more step with its segment-sum and Adam arguments
    recorded (``check_step_inputs``) and one with its flash arguments
    (``recorded_flash``), each kernel held against its plain version and
    timed; the chunked cross-entropy against the whole logit matrix; every
    leaf still where it was; one traced step; the reserved peak under
    ``LM_PEAK_LIMIT_GB``."""
    cfg = get_arch(LM_ARCH).make_config()
    params, buffers, loss_fn = lm_model_and_loss(cfg, dev)
    batches = lm_train_batches(cfg, LM_TRAIN_BATCHES, LM_TRAIN_BATCH, dev)
    n_params = sum(x.numel() for x in leaves(params))
    with torch.no_grad():
        plain_loss = float(with_plain_lm(
            lambda: loss_fn(params, buffers, {}, batches[0], step=None))[0])
    torch.cuda.empty_cache()
    token_gaps = check_token_xent(params, buffers, batches[0], cfg)
    torch.cuda.empty_cache()
    trainer = Trainer(loss_fn, params, buffers, {}, adam(1e-3))
    del params
    ptrs = [x.data_ptr() for x in leaves([trainer.params, trainer.carry["opt"]])]
    per_step = lm_per_step(cfg, trainer, gathers=1)
    run = lm_train_steps(trainer, batches, LM_TRAIN_STEPS, per_step,
                         "internlm2-1.8b train_4k")
    first = run["losses"][0]
    gap = abs(first - plain_loss) / abs(plain_loss)
    check(gap <= LM_FIRST_LOSS_RTOL, f"train_4k: first loss {first} against "
          f"the plain kernels' {plain_loss}: {gap:.3e} apart")
    check(abs(first - math.log(cfg.vocab)) <= LM_LOSS_NEAR,
          f"train_4k: first loss {first} not near ln V = "
          f"{math.log(cfg.vocab):.4f}")
    peak_gb = run["peak_reserved_bytes"] / 1e9
    check(peak_gb < LM_PEAK_LIMIT_GB, f"train_4k: reserved peak {peak_gb:.2f}"
          f" GB, not under {LM_PEAK_LIMIT_GB}")
    log(f"train_4k: {n_params} parameters, first loss {first:.6f} (plain "
        f"kernels {plain_loss:.6f}, {gap:.3e} apart; ln V "
        f"{math.log(cfg.vocab):.4f})")
    step = LM_TRAIN_STEPS
    inputs = check_step_inputs(trainer, batches[0], step, "internlm2 train_4k")
    seen = recorded_flash(trainer, batches[1], step + 1, cfg.n_layers)
    flash = lm_flash_train_rows(seen, cfg.n_layers,
                                "internlm2 train_4k (8, 4,096, 16, 128)")
    del seen
    xent = check_chunked_xent(trainer.params, buffers, batches[0]["tokens"],
                              batches[0]["labels"], cfg)
    check([x.data_ptr() for x in leaves([trainer.params,
                                         trainer.carry["opt"]])] == ptrs,
          "train_4k: a parameter or moment leaf moved: not updated in place")
    check(all(m.dtype == torch.float32
              for m in leaves(trainer.carry["opt"]["mu"])),
          "train_4k: a moment is not float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    traced = traced_train_step(trainer, batches[0], step + 2, "train_4k")
    traced["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    check(traced["peak_reserved_bytes"] / 1e9 < LM_PEAK_LIMIT_GB,
          f"train_4k traced step: reserved peak "
          f"{traced['peak_reserved_bytes'] / 1e9:.2f} GB")
    out = {**run, "plain_first_loss": plain_loss, "first_loss_gap": gap,
           "token_xent": token_gaps, "params": n_params, "tokens_per_step": LM_TRAIN_BATCH * LM_TRAIN_SEQ,
           "step_inputs": inputs, "flash": flash, "xent": xent,
           "traced_step": traced}
    del trainer, buffers, batches
    return out


def phase_lm_vocab_search(dev) -> dict:
    """internlm2-1.8b at full width and depth under ``mpe_search`` on the
    token table, set up as ``examples/lm_vocab_mpe.py`` sets it up
    (``MPEConfig(lam=1e-5, embed_std=0.02)``, ``TokenStream``'s expected
    frequencies: 723 groups of 128), λ times the regulariser in the loss:
    four ``Trainer`` steps at 8 × 4,096 with their launches; one more
    step's ``mpe_qat`` (32,768 × 2,048), segment-sum and Adam arguments
    held against their plain versions and timed (``check_step_inputs``);
    Eq. 11's widths: the table's average bits and those of the frequent
    and the rare quartile of groups."""
    mpe = MPEConfig(lam=VOCAB_LAM, embed_std=0.02)
    cfg = get_arch(LM_ARCH).make_config()._replace(
        compressor="mpe_search", comp_cfg=mpe._asdict(), embed_std=0.02)
    freqs = TokenStream(cfg.vocab, 1, 1).expected_frequencies()
    params, buffers, loss_fn = lm_model_and_loss(cfg, dev, lam=VOCAB_LAM, freqs=freqs)
    groups = int(params["embedding"]["gamma"].shape[0])
    batches = lm_train_batches(cfg, LM_TRAIN_BATCHES, LM_TRAIN_BATCH, dev)
    trainer = Trainer(loss_fn, params, buffers, {}, adam(1e-3))
    del params
    per_step = lm_per_step(cfg, trainer, gathers=2, qat=1)
    run = lm_train_steps(trainer, batches, VOCAB_STEPS, per_step,
                         "internlm2-1.8b vocabulary search")
    inputs = check_step_inputs(trainer, batches[0], VOCAB_STEPS,
                               "internlm2 vocab search")
    gb = sample_group_bits(trainer.params["embedding"], mpe)
    fb = feature_bits(gb, buffers["embedding"]["group_of_feature"])
    widths = np.asarray(mpe.bits)[gb.cpu().numpy()]
    quarter = len(widths) // 4
    out = {**run, "groups": groups, "step_inputs": inputs,
           "average_bits": average_bits(fb, mpe),
           "frequent_quartile_bits": float(widths[:quarter].mean()),
           "rare_quartile_bits": float(widths[-quarter:].mean())}
    log(f"vocabulary search: {groups} groups; vocab-table avg bits "
        f"{out['average_bits']:.4f} (ratio {out['average_bits'] / 32:.6f}); "
        f"frequent-quartile groups {out['frequent_quartile_bits']:.4f} bits, "
        f"rare-quartile {out['rare_quartile_bits']:.4f}")
    del trainer, buffers, batches
    return out


def phase_moe_train(dev) -> dict:
    """deepseek-moe-16b at full width, 2 of its 28 layers, 2 × 4,096
    tokens: two ``Trainer`` steps with the aux loss (weight 0.01), each
    launching the segment sum for the combine's scatter (twice a layer under
    remat) and the dispatch's and the combine's gathers' backward; one more
    step with its segment-sum and Adam arguments recorded and each held
    against its plain version and timed (``check_step_inputs``: the sums of
    E·cap rows into T tokens and of T·k rows into E·cap slots, the 3-D bf16
    expert leaves); one traced step that runs the segment-sum kernels and no
    library scatter-add."""
    cfg = get_arch(MOE_ARCH).make_config()._replace(n_layers=MOE_LAYERS)
    params, buffers, loss_fn = lm_model_and_loss(cfg, dev)
    batches = lm_train_batches(cfg, 1, MOE_TRAIN_BATCH, dev)
    trainer = Trainer(loss_fn, params, buffers, {}, adam(1e-3))
    del params
    per_step = lm_per_step(cfg, trainer, gathers=1)
    run = lm_train_steps(trainer, batches, MOE_TRAIN_STEPS, per_step,
                         "deepseek-moe-16b train (2 layers)")
    inputs = check_step_inputs(trainer, batches[0], MOE_TRAIN_STEPS,
                               "deepseek-moe train")
    traced = traced_train_step(trainer, batches[0], MOE_TRAIN_STEPS + 1,
                               "deepseek-moe-16b train")
    check(traced["kernel_ms"]["segment_sum"] > 0,
          "moe train: no segment-sum kernel in the traced step")
    check(not traced["library_scatter_adds"],
          f"moe train: library scatter-adds in the traced step: "
          f"{traced['library_scatter_adds']}")
    del trainer, buffers, batches
    return {**run, "step_inputs": inputs, "traced_step": traced}


def lm_train_records(records: list, train: dict, grid: dict) -> None:
    """The training path's numbers into the kernels' records: ``mpe_qat``'s
    wide-row grid into its error; the flash forward with statistics and
    the backward at ``train_4k``'s shape under ``lm train_4k``."""
    by_name = {r["name"]: r for r in records}
    for k, err in (("fwd", grid["qat_fwd_err"]), ("bwd", grid["qat_bwd_err"])):
        rec = by_name[f"mixed_expectation_{k}"]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["wide_grid_cases"] = grid["qat_cases"]
    for name, kind in (("flash_attention_fwd_stats", "fwd_stats"),
                       ("flash_attention_bwd", "bwd")):
        rec, row = by_name[name], train["flash"][kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], row["max_abs_err"])
        rec["shapes"]["lm train_4k"] = row
    by_name["adam_step_"]["bf16_grid_cases"] = grid["adam_bf16_cases"]


DRY_CELLS = (("dlrm-criteo", "serve_p99"), ("internlm2-1.8b", "decode_32k"))


def phase_staticcheck(dev) -> dict:
    """The checker over the tiny corpus on the card (the counts at 0 after
    the corpus's build and just before the walks, read just after them:
    the ``staticcheck`` path) and on the CPU: zero findings, the same
    kernel regions cell by cell, each region's kernel launched on the
    card at least once for each walk that showed the region; then the dry
    run of ``DRY_CELLS`` on the 16×16 mesh (meta tensors: static
    counts)."""
    import repro_torch.analysis as A
    from repro_torch.analysis.budgets import load_budgets
    from repro_torch.analysis.corpus import build_corpus
    from repro_torch.launch.dryrun import run_cell
    t0 = time.perf_counter()
    budgets = load_budgets()
    engine = build_corpus(device=dev)
    build_s = time.perf_counter() - t0
    # the corpus's build trains and captures (its warm-up calls launch
    # every serving kernel): only the walks' launches are counted
    reset_counts()
    card = A.check_engine(engine, budgets=budgets)
    launches = counts()
    card_s = time.perf_counter() - t0 - build_s
    del engine
    cpu = A.check_engine(build_corpus(device="cpu"), budgets=budgets)
    lint = A.lint_tree(ROOT)
    for what, found in (("the card's corpus", card.findings),
                        ("the CPU's corpus", cpu.findings),
                        ("the source lint", lint)):
        check(not found, f"staticcheck: {len(found)} finding(s) on {what}: "
              + "; ".join(f.render() for f in found[:5]))
    check(card.n_cells == cpu.n_cells == 8,
          f"staticcheck: {card.n_cells} cells on the card, {cpu.n_cells} "
          f"on the CPU, not 8")
    check(card.regions == cpu.regions,
          f"staticcheck: the card's kernel regions {card.regions} differ "
          f"from the CPU's {cpu.regions}")
    seen = sorted({r for names in card.regions.values() for r in names})
    check(sorted(card.region_walks) == seen,
          f"staticcheck: walks counted for {sorted(card.region_walks)}, "
          f"regions {seen}")
    for name in seen:
        check(launches.get(name, 0) >= card.region_walks[name],
              f"staticcheck: region {name} shown by "
              f"{card.region_walks[name]} walks on the card, but its kernel "
              f"launched {launches.get(name, 0)} times in them")
    log(f"staticcheck: 0 findings over {card.n_cells} cells on the card "
        f"({card_s:.1f} s of walks after the corpus's {build_s:.1f} s "
        f"build) and on the CPU, 0 lint findings; kernel regions {seen}, "
        f"the same on both; walks showing each "
        f"{json.dumps(card.region_walks, sort_keys=True)}, launches in them "
        f"{json.dumps({k: launches.get(k, 0) for k in seen}, sort_keys=True)}")
    dry = {}
    for arch, shape in DRY_CELLS:
        res = run_cell(arch, shape, verbose=False)
        coll = res["collectives_per_device"]
        dry[res["cell"]] = {k: res[k] for k in (
            "mesh", "flops_per_device", "hbm_bytes_per_device",
            "kernel_flops_per_device", "kernel_bytes_per_device", "kernels",
            "memory")}
        dry[res["cell"]]["collective_bytes_per_device"] = coll["total_bytes"]
        check(res["flops_per_device"] > 0 and res["kernels"],
              f"dry run {res['cell']}: no work walked")
        log(f"dryrun {res['cell']} on {res['mesh']} (meta tensors, static "
            f"counts, not card times): flops/device "
            f"{res['flops_per_device']:.6e}, bytes/device "
            f"{res['hbm_bytes_per_device']:.6e}, collective bytes/device "
            f"{coll['total_bytes']:.6e}, kernels {res['kernels']}, memory "
            f"{res['memory']}")
    out = {"launches": launches, "region_walks": card.region_walks,
           "regions": card.regions, "build_s": build_s, "walks_s": card_s,
           "phase_s": time.perf_counter() - t0, "dryrun": dry}
    log(f"staticcheck phase: {out['phase_s']:.1f} s")
    return out


def phase_api(dev) -> dict:
    """Phase 32: the reference's last public functions through the port's
    package names, on the card against the CPU (no kernel of their own)."""
    from repro_torch.embeddings import field_offsets, globalize_ids
    from repro_torch.train import (apply_updates, binary_accuracy,
                                   clip_by_global_norm)
    t0 = time.perf_counter()
    rng = np.random.default_rng(32)
    cfg = get_arch("dlrm-criteo").make_config()
    rows = SERVE_ROWS["serve_bulk"]
    local = torch.from_numpy(np.stack(
        [rng.integers(0, f.vocab, rows) for f in cfg.fields], 1
    ).astype(np.int32))
    offsets = field_offsets(cfg.fields)
    want = globalize_ids(local, offsets)
    got = globalize_ids(local.to(dev), offsets)
    check(got.dtype == want.dtype == torch.int32
          and torch.equal(got.cpu(), want),
          "api: globalize_ids on the card differs from the CPU's")
    labels = torch.from_numpy(rng.integers(0, 2, rows).astype(np.float32))
    probs = torch.from_numpy(rng.uniform(0, 1, rows).astype(np.float32))
    probs[::7] = 0.5                                  # ties at the threshold
    want = binary_accuracy(labels, probs)
    got = binary_accuracy(labels.to(dev), probs.to(dev))
    check(torch.equal(got.cpu(), want),
          f"api: binary_accuracy {got.item()!r} on the card, "
          f"{want.item()!r} on the CPU")
    d_in = len(cfg.fields) * cfg.d_embed
    widths = (d_in, *cfg.mlp_hidden, 1)

    def tree(seed):
        g = torch.Generator().manual_seed(seed)
        return {"layers": [torch.randn(a, b, generator=g)
                           for a, b in zip(widths, widths[1:])],
                "bias": torch.randn(widths[1], generator=g).bfloat16()}
    params, updates = tree(0), tree(1)
    updates["bias"] = updates["bias"].float()   # float32 into bfloat16

    def on_dev(t):
        return {"layers": [x.to(dev) for x in t["layers"]],
                "bias": t["bias"].to(dev)}

    def same(a, b):
        return all(x.dtype == y.dtype and torch.equal(x.cpu(), y)
                   for x, y in zip(leaves(a), leaves(b)))
    check(same(apply_updates(on_dev(params), on_dev(updates)),
               apply_updates(params, updates)),
          "api: apply_updates on the card differs from the CPU's")
    errs = {}
    for name, max_norm in (("below", 1e6), ("above", 1.0)):
        want, want_norm = clip_by_global_norm(params, max_norm)
        got, gnorm = clip_by_global_norm(on_dev(params), max_norm)
        err = abs(gnorm.item() - want_norm.item()) / want_norm.item()
        check(err <= 1e-6, f"api: clip {name}: norm {gnorm.item()!r} on "
              f"the card, {want_norm.item()!r} on the CPU")
        errs[name] = err
        if name == "below":
            check(same(got, want), "api: clip below its norm differs")
            continue
        for x, y in zip(leaves(got), leaves(want)):
            check(x.dtype == y.dtype == torch.float32, "api: clip dtype")
            torch.testing.assert_close(x.cpu(), y, rtol=1e-6, atol=0)
    out = {"rows": rows, "fields": len(cfg.fields),
           "leaves": len(leaves(params)), "clip_norm_rel_err": errs,
           "phase_s": time.perf_counter() - t0}
    log(f"api: globalize_ids, binary_accuracy, apply_updates and "
        f"clip_by_global_norm on the card equal the CPU's "
        f"({json.dumps(out)})")
    return out


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    grid_err = phase_kernel_grid(dev)
    phase_cold_grid(dev)
    qat_grid_errs = phase_qat_grid(dev)
    flash_grid_errs = phase_flash_grid(dev)
    bag_grid_errs = phase_bag_grid(dev)
    reset_counts()
    main_path = phase_main_path(dev)
    kernel = phase_kernel_times(main_path, grid_err)
    traced = phase_trace(main_path)
    lifecycle = phase_lifecycle(main_path, dev)
    log(json.dumps({"lifecycle": lifecycle}))
    tiered = phase_tiered(main_path, dev)
    log(json.dumps({"tiered": {k: v for k, v in tiered.items()
                               if k != "record"}}))
    log(json.dumps({"storage_ratio": main_path["ratio"],
                    "request_p50_ms": main_path["request_p50_ms"],
                    "bulk_request_ms": main_path["bulk_request_ms"],
                    "serve_peak_bytes": main_path["serve_peak_bytes"],
                    "serve_peak_allocated_bytes":
                        main_path["serve_peak_allocated_bytes"],
                    "cells": main_path["cells"], "traced": traced}))
    main_launches = main_path["launches"]
    del main_path
    gc.collect()
    torch.cuda.empty_cache()   # the cells' graph pool goes back
    train = phase_train_path(dev)
    step = phase_step_inputs(dev, train)
    mesh = phase_mesh(dev, train)
    del train["res"]
    log(json.dumps({"train": {k: v for k, v in train.items() if k != "cfg"},
                    "traced_step": step["traced_step"],
                    "peaks": step["peaks"]}))
    n_items = get_arch("sasrec").make_config().item_vocab
    freqs = zipf_prior(n_items)
    prior = {"freqs": freqs, "cdf": np.cumsum(freqs)}
    sasrec_serve = phase_sasrec_serve(dev, prior)
    sasrec_train = phase_sasrec_train(dev, prior)
    flash_times = phase_flash_times(dev)
    log(json.dumps({"sasrec_serve": sasrec_serve, "sasrec_train": sasrec_train,
                    "flash_times": flash_times}))
    prior = bst_prior(get_arch("bst").make_config())
    bst_serve = phase_bst_serve(dev, prior)
    bst_train = phase_bst_train(dev, prior)
    bag = phase_bag_path(dev, bst_train.pop("table"), bst_train.pop("seq_ids"))
    log(json.dumps({"bst_serve": bst_serve, "bst_train": bst_train,
                    "bag": bag}))
    reduced = phase_reduced_checks(dev)
    seg_grid = phase_segment_grid(dev)
    table3 = phase_table3(dev)
    wide_deep = phase_wide_deep(dev)
    log(json.dumps({"reduced": reduced, "prefetched": step["prefetched"],
                    "table3": table3["runs"], "wide_deep": {
                        k: v for k, v in wide_deep.items() if k != "lookup"}}))
    gc.collect()
    torch.cuda.empty_cache()
    two_tower = phase_two_tower(dev)
    gin = phase_gin(dev)
    log(json.dumps({"two_tower": {k: v for k, v in two_tower.items()
                                  if k != "step_inputs"},
                    "gin": {shape: {k: v for k, v in run.items()
                                    if k != "step_inputs"}
                            for shape, run in gin.items()}}))
    gc.collect()
    torch.cuda.empty_cache()
    lm_grid = phase_lm_grid(dev)
    flash_times.update(phase_lm_flash(dev))
    lm = lm_model(LM_ARCH, dev)
    slotted = phase_lm_slotted(dev, lm)
    gc.collect()
    torch.cuda.empty_cache()
    prefill = phase_lm_prefill(dev, lm)
    gc.collect()
    torch.cuda.empty_cache()
    long = phase_lm_long(dev, lm)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(dev)
    log(json.dumps({"lm_slotted": slotted, "lm_prefill": prefill,
                    "lm_long_500k": long, "moe": moe}))
    gc.collect()
    torch.cuda.empty_cache()
    lm_train_grid = phase_lm_train_grid(dev)
    lm_train = phase_lm_train(dev)
    gc.collect()
    torch.cuda.empty_cache()
    vocab = phase_lm_vocab_search(dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe_train = phase_moe_train(dev)
    log(json.dumps({"lm_train_grid": lm_train_grid, "lm_train": lm_train,
                    "lm_vocab_search": vocab, "moe_train": moe_train}))
    gc.collect()
    torch.cuda.empty_cache()
    static = phase_staticcheck(dev)
    log(json.dumps({"staticcheck": {k: v for k, v in static.items()
                                    if k != "launches"}}))
    phase_api(dev)
    bst_errs = bst_train["step_inputs"]["errs"]
    kernel["shapes"].update({**sasrec_serve.pop("lookup"),
                             **bst_serve.pop("lookup"),
                             **wide_deep.pop("lookup"),
                             **two_tower["served"].pop("lookup"),
                             "internlm2 prefill": prefill["lookup"],
                             "deepseek-moe prefill": moe["lookup"]})
    extra = [*table3["recorded"],
             ("gin molecule", gin["molecule"]["step_inputs"]),
             ("gin cora", gin["full_graph_sm"]["step_inputs"]),
             ("two-tower", two_tower["step_inputs"]),
             ("internlm2 train_4k", lm_train["step_inputs"]),
             ("internlm2 vocab search", vocab["step_inputs"]),
             ("deepseek-moe train", moe_train["step_inputs"])]
    records = [kernel, *qat_records(qat_grid_errs, train, step,
                                    sasrec_train["step_inputs"],
                                    bst_train["step_inputs"], extra),
               segment_sum_record(train, step, sasrec_train["step_inputs"],
                                  bst_train["step_inputs"], extra, seg_grid,
                                  {f"gin scatter {name}": row for name, row
                                   in gin["scatter"].items()}),
               adam_record(train, step, sasrec_train["step_inputs"],
                           bst_train["step_inputs"], extra,
                           reduced["schedule"]),
               bag_record(bag_grid_errs, bag), tiered["record"],
               *flash_records(flash_grid_errs, sasrec_serve, sasrec_train,
                              flash_times, bst_errs),
               *lm_records(lm_grid, slotted, long, prefill, moe)]
    lm_train_records(records, lm_train, lm_train_grid)
    by_path = {"dlrm serve": main_launches,
               "dlrm lifecycle": lifecycle["launches"],
               "dlrm tiered": tiered["launches"],
               "dlrm tiered launcher": tiered["launcher_launches"],
               "dlrm train": train["launches"],
               "sasrec serve": sasrec_serve["launches"],
               "sasrec train": sasrec_train["launches"],
               "bst serve": bst_serve["launches"],
               "bst train": bst_train["launches"], "bag": bag["launches"],
               **{f"table3 {name}": run["launches"]
                  for name, run in table3["runs"].items()},
               "wide-deep train": wide_deep["train"]["launches"],
               "wide-deep serve": wide_deep["serve_launches"],
               "two-tower train": two_tower["launches"],
               "two-tower serve": two_tower["served"]["launches"],
               "gin molecule train": gin["molecule"]["launches"],
               "gin cora train": gin["full_graph_sm"]["launches"],
               "gin products train": gin["ogb_products"]["launches"],
               "lm slotted": slotted["launches"],
               "lm prefill": prefill["prefill_launches"],
               "lm decode": prefill["decode_launches"],
               "lm long_500k": long["launches"],
               "moe prefill": moe["prefill_launches"],
               "moe decode": moe["decode_launches"],
               "lm train": lm_train["launches"],
               "lm vocab search": vocab["launches"],
               "moe train": moe_train["launches"],
               "mesh": mesh["launches"],
               "staticcheck": static["launches"]}
    for rec in records:
        rec["launches_by_path"] = {path: launches.get(rec["name"], 0)
                                   for path, launches in by_path.items()}
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"mesh": mesh["one_rank"], "card": smi}))
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
